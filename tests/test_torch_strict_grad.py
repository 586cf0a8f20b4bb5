"""Gradients of the port's parity traversal ("strict", plain torch
autograd through `ops/traversal.trace_tile`), on the reference's
gradient-test frame (64x32, depth 2: `tests/test_grad.py:27-36`).

- The pallas-vs-strict check of `tests/test_grad.py:154-191`, in the
  port: on the pixels where both paths hit and `min_t` agrees within
  rtol 1e-4, the 15 leaf gradients of the weighted position loss agree
  within rtol = 1e-2, atol = 1e-4 (the reference's bar).
- The port's strict leaf gradients against `jax.grad` of the
  reference's strict loss, on the pixels both packages hit with the
  same `min_t` (rtol 1e-4), within rtol = 1e-2, atol = 1e-4: a seeded
  loss on both planes away from grazing incidence (|n.d| > 0.5), and
  the reference test's position loss down to |n.d| > 0.2 (as
  `tests/test_torch_grad.py` holds the other paths: t = tca -
  sqrt(r^2 - d^2) cancels in f32, and XLA's FMA contraction moves the
  last grazing pixels).
- Per-pixel d position / d yaw (forward mode) against central
  differences on the stable set: |g - fd| <= 5 % |fd| + 0.1.
"""

import numpy as np
import pytest
import torch

from sphereflake_tpu_torch.config import RenderConfig, default_scene
from sphereflake_tpu_torch.render import render_gbuffer

from _torch_helpers import port_scene
from test_torch_grad import (
    POSITION_WEIGHTS,
    _ndotd,
    _perturbed,
    _position_jvp,
)


def _kw(algorithm):
    tile = (dict(tile_h=32, tile_w=32) if algorithm == "pallas"
            else dict(tile_h=16, tile_w=64))
    return dict(width=64, height=32, max_depth=2, max_frontier=128,
                algorithm=algorithm, **tile)


def _leaf_grads(scene, cfg, weights):
    """The 15 leaf gradients of sum(position * weights) (None -> 0)."""
    leaves = scene.leaves()
    for leaf in leaves:
        leaf.requires_grad_(True)
    gb = render_gbuffer(scene, cfg, device="cpu")
    loss = torch.sum(gb.position * weights)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [
        torch.zeros_like(leaf) if g is None else g
        for g, leaf in zip(got, leaves)
    ]


def test_pallas_gradient_matches_strict_gradient():
    """The pallas path's straight-through gradient (the traversal kernel's
    plain version, then the path-code resolve) against the strict path's
    autograd, where both picked the same winner."""
    from sphereflake_tpu_torch.ops import pallas_traversal as ptrav

    cfg_s = RenderConfig(**_kw("strict"))
    cfg_p = RenderConfig(**_kw("pallas"))
    scene = default_scene("cpu")
    g_s = render_gbuffer(scene, cfg_s, device="cpu")
    g_p = render_gbuffer(scene, cfg_p, device="cpu")
    mask = (g_s.hit & g_p.hit & torch.isclose(
        g_s.min_t, g_p.min_t, rtol=1e-4, atol=0.0
    ))[..., None]
    assert int(mask.sum()) > 300
    w = torch.from_numpy(POSITION_WEIGHTS) * mask / (cfg_s.width
                                                      * cfg_s.height)
    gs = _leaf_grads(default_scene("cpu"), cfg_s, w)
    ptrav.trace_tiles_pallas_soa.launches = 0
    gp = _leaf_grads(default_scene("cpu"), cfg_p, w)
    assert ptrav.trace_tiles_pallas_soa.launches == 0  # its plain version
    assert any(float(g.abs().max()) > 0 for g in gs)
    for i, (a, b) in enumerate(zip(gs, gp)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-2,
                                   atol=1e-4, err_msg=f"leaf {i}")


@pytest.fixture(scope="module")
def reference_strict_grads():
    """`jax.vjp` of the reference's strict G-buffer, and the two
    cotangents: the seeded weights on both planes (|n.d| > 0.5) and the
    reference test's position weights (|n.d| > 0.2), each masked to the
    pixels both packages agree on."""
    import jax
    import jax.numpy as jnp

    from sphereflake_tpu.config import RenderConfig as RefConfig
    from sphereflake_tpu.config import default_scene as ref_default_scene
    from sphereflake_tpu.render import render_gbuffer as ref_render

    ref_scene = ref_default_scene()
    ref_cfg = RefConfig(**_kw("strict"))

    def planes(s):
        gb = ref_render(s, ref_cfg)
        return (gb.position, gb.normal), (gb.hit, gb.min_t)

    _planes, vjp_fn, (hit, min_t) = jax.vjp(planes, ref_scene, has_aux=True)
    scene, cfg = port_scene(ref_scene), RenderConfig(**_kw("strict"))
    gb = render_gbuffer(scene, cfg, device="cpu")
    agreed = (
        np.asarray(hit) & gb.hit.numpy()
        & np.isclose(np.asarray(min_t), gb.min_t.numpy(), rtol=1e-4, atol=0.0)
    )
    ndotd = _ndotd(scene, gb, cfg)
    n_px = cfg.width * cfg.height
    mask = agreed & (ndotd > 0.5)
    rng = np.random.default_rng(7)  # the weights of test_torch_grad.py
    w = rng.uniform(0.5, 1.5, (2, cfg.height, cfg.width, 3))
    w = (w * mask[None, ..., None] / n_px).astype(np.float32)
    pmask = agreed & (ndotd > 0.2)
    wp = (pmask[..., None] * POSITION_WEIGHTS / n_px).astype(np.float32)
    leaves = lambda ct: [
        np.asarray(g) for g in jax.tree_util.tree_leaves(vjp_fn(ct)[0])
    ]
    return dict(
        weighted=(w, mask, leaves((jnp.asarray(w[0]), jnp.asarray(w[1])))),
        position=(np.stack([wp, np.zeros_like(wp)]), pmask,
                  leaves((jnp.asarray(wp), jnp.zeros_like(jnp.asarray(wp))))),
    )


@pytest.mark.parametrize("loss", ["weighted", "position"])
def test_strict_loss_gradient_matches_reference(reference_strict_grads, loss):
    from sphereflake_tpu.config import default_scene as ref_default_scene

    w, mask, want = reference_strict_grads[loss]
    assert mask.sum() > 300
    scene = port_scene(ref_default_scene())
    leaves = scene.leaves()
    for leaf in leaves:
        leaf.requires_grad_(True)
    gb = render_gbuffer(scene, RenderConfig(**_kw("strict")), device="cpu")
    total = (torch.sum(gb.position * torch.from_numpy(w[0]))
             + torch.sum(gb.normal * torch.from_numpy(w[1])))
    got = torch.autograd.grad(total, leaves, allow_unused=True)
    assert len(got) == len(want) == 15
    for i, (g, r) in enumerate(zip(got, want)):
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(g, r, rtol=1e-2, atol=1e-4,
                                   err_msg=f"{loss} leaf {i}")
    assert all(np.abs(r).max() > 0 for r in want[:4])
    assert all(g is None for g in got[9:])  # no post: no ssao gradient


def test_strict_pixel_gradient_matches_central_differences():
    scene = default_scene("cpu")
    cfg = RenderConfig(**_kw("strict"))
    eps = 1e-3

    def plane(x):
        gb = render_gbuffer(_perturbed(scene, "yaw", torch.tensor(x)), cfg,
                            device="cpu")
        return gb.position.numpy(), gb.min_t.numpy(), gb.hit.numpy()

    pos_p, t_p, hp = plane(eps)
    pos_m, t_m, hm = plane(-eps)
    gb0 = render_gbuffer(scene, cfg, device="cpu")
    h0 = gb0.hit.numpy()
    tp, tm = np.where(hp, t_p, 0.0), np.where(hm, t_m, 0.0)
    t0 = np.where(h0, gb0.min_t.numpy(), 0.0)
    stable = (
        hp & hm & h0
        & (np.abs(tp - tm) < 0.05)
        & (np.abs(tp + tm - 2 * t0) < 1e-3)
        & (_ndotd(scene, gb0, cfg) > 0.2)
    )
    assert stable.sum() > 200
    fd = ((pos_p - pos_m) / (2 * eps))[stable]
    g = _position_jvp(scene, "yaw", cfg)[stable]
    ok = np.abs(g - fd) <= 0.05 * np.abs(fd) + 0.1
    assert ok.all(), f"{int((~ok).sum())} of {ok.size} pixel gradients"
