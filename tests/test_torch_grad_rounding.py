"""The port's loss gradient against `jax.grad` of the reference's on the
reference's own mask (`tests/test_grad.py:160-187`): every pixel where
both frames hit with min_t within 1e-4 relative, grazing pixels
included, the position plane weighted 1 + 0.1 k.

t = tca - sqrt(r^2 - d^2) cancels in f32 at grazing incidence, where
dt/dtheta ~ 1/|n.d| magnifies each package's rounding. XLA's CPU backend
contracts multiply-adds into FMAs; the port's eager torch rounds every
product. With the reference's contraction off
(`XLA_FLAGS=--xla_cpu_max_isa=SSE4_2`, set in a subprocess, since XLA
reads its flags once) every leaf holds at rtol = 1e-2, atol = 1e-4, the
bar of `tests/test_grad.py:187`, on binned, pallas and fast alike.

Run as a script, it prints one JSON line: per algorithm, the pixels
weighed and, per leaf, the largest |port - reference| over the
reference's largest |gradient| (`relative_gap`) and over the bar
1e-4 + 1e-2 |reference| (`bar_ratio`: the bar holds at <= 1), for the
XLA_FLAGS it was started with (`--algorithm NAME` for one algorithm);
`--out FILE.npz` also writes the weights and the reference's gradients:

    python tests/test_torch_grad_rounding.py
    XLA_FLAGS=--xla_cpu_max_isa=SSE4_2 python tests/test_torch_grad_rounding.py
"""

import json
import os
import subprocess
import sys

import numpy as np

if __name__ == "__main__":
    _here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.dirname(_here), _here]
    import jax

    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402
import torch  # noqa: E402

from sphereflake_tpu_torch.config import RenderConfig  # noqa: E402
from sphereflake_tpu_torch.render import render_gbuffer  # noqa: E402

from _torch_helpers import port_scene  # noqa: E402
from test_torch_grad import ALGORITHMS, POSITION_WEIGHTS, _kw  # noqa: E402

NO_FMA = "--xla_cpu_max_isa=SSE4_2"


def reference_case(algorithm):
    """(weights [H, W, 3], the reference's 15 leaf gradients) of the
    position-plane loss on the reference's mask."""
    import jax
    import jax.numpy as jnp

    from sphereflake_tpu.config import RenderConfig as RefConfig
    from sphereflake_tpu.config import default_scene as ref_default_scene
    from sphereflake_tpu.render import render_gbuffer as ref_render

    ref_scene = ref_default_scene()
    ref_cfg = RefConfig(**_kw(algorithm))

    def plane(s):
        gb = ref_render(s, ref_cfg)
        return gb.position, (gb.hit, gb.min_t)

    _p, vjp_fn, (hit, min_t) = jax.jit(
        lambda s: jax.vjp(plane, s, has_aux=True)
    )(ref_scene)
    cfg = RenderConfig(**_kw(algorithm))
    gb = render_gbuffer(port_scene(ref_scene), cfg, device="cpu")
    mask = (
        np.asarray(hit) & gb.hit.numpy()
        & np.isclose(np.asarray(min_t), gb.min_t.numpy(), rtol=1e-4,
                     atol=0.0)
    )
    w = (mask[..., None] * POSITION_WEIGHTS
         / (cfg.width * cfg.height)).astype(np.float32)
    (grads,) = jax.jit(lambda f, ct: f(ct))(vjp_fn, jnp.asarray(w))
    return w, [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


def port_grads(algorithm, w):
    """The port's 15 leaf gradients of the same loss (None -> zeros)."""
    from sphereflake_tpu.config import default_scene as ref_default_scene

    scene = port_scene(ref_default_scene())
    leaves = scene.leaves()
    for leaf in leaves:
        leaf.requires_grad_(True)
    gb = render_gbuffer(scene, RenderConfig(**_kw(algorithm)), device="cpu")
    got = torch.autograd.grad(
        torch.sum(gb.position * torch.from_numpy(w)), leaves,
        allow_unused=True,
    )
    return [torch.zeros(leaf.shape) if g is None else g
            for g, leaf in zip(got, leaves)]


def main(argv):
    out = argv[argv.index("--out") + 1] if "--out" in argv else None
    algorithms = (
        (argv[argv.index("--algorithm") + 1],) if "--algorithm" in argv
        else ALGORITHMS
    )
    report, arrays = {"xla_flags": os.environ.get("XLA_FLAGS", "")}, {}
    for algorithm in algorithms:
        w, want = reference_case(algorithm)
        got = port_grads(algorithm, w)
        report[algorithm] = dict(
            pixels=int((w[..., 0] > 0).sum()),
            relative_gap=[
                float(np.abs(g.numpy() - r).max() / max(np.abs(r).max(), 1e-30))
                for g, r in zip(got, want)
            ],
            bar_ratio=[
                float(np.max(np.abs(g.numpy() - r) / (1e-4 + 1e-2 * np.abs(r))))
                for g, r in zip(got, want)
            ],
        )
        arrays[f"{algorithm}/w"] = w
        arrays.update({f"{algorithm}/{i}": r for i, r in enumerate(want)})
    if out:
        np.savez(out, **arrays)
    print(json.dumps(report))


@pytest.fixture(scope="module")
def reference_without_fma(tmp_path_factory):
    """The reference's weights and gradients, computed by this file run
    as a script with XLA's FMA contraction off: one process per
    algorithm, all three at once."""
    tmp = tmp_path_factory.mktemp("rounding")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = f"{env.get('XLA_FLAGS', '')} {NO_FMA}".strip()
    procs = {
        algorithm: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--algorithm",
             algorithm, "--out", str(tmp / f"{algorithm}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for algorithm in ALGORITHMS
    }
    arrays = {}
    for algorithm, proc in procs.items():
        _out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        with np.load(tmp / f"{algorithm}.npz") as f:
            arrays.update({k: f[k] for k in f.files})
    return arrays


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_position_gradient_matches_reference_without_fma(
    algorithm, reference_without_fma
):
    w = reference_without_fma[f"{algorithm}/w"]
    want = [reference_without_fma[f"{algorithm}/{i}"] for i in range(15)]
    assert (w[..., 0] > 0).sum() > 500  # the whole agreed mask
    got = port_grads(algorithm, w)
    for i, (g, r) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            g.numpy(), r, rtol=1e-2, atol=1e-4, err_msg=f"{algorithm} leaf {i}"
        )
    assert all(np.abs(r).max() > 0 for r in want[:4])


if __name__ == "__main__":
    main(sys.argv[1:])
