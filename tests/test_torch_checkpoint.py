"""Checkpoints of the port (`sphereflake_tpu_torch.runtime.checkpoint`):
bit-identical resumption (the reference's `tests/test_checkpoint.py`,
held on the port) and files that pass between the two packages in both
directions — a scene, both frameless states, and optax's Adam state
with and without the cosine schedule's count.

Tolerances: loaded leaves equal exactly (same dtype, shape, bits). The
Adam step after a crossing: parameters within rtol = atol = 1e-6 of the
other package's step on the same gradients, the moments within
rtol = 1e-5 (the same formula in a different float order)."""

import dataclasses

import numpy as np
import pytest
import torch

from sphereflake_tpu_torch.config import (
    RenderConfig,
    SceneParams,
    default_scene,
)
from sphereflake_tpu_torch.fit import (
    AdamState,
    adam,
    adam_init,
    adam_state,
    fit,
)
from sphereflake_tpu_torch.render import render_gbuffer
from sphereflake_tpu_torch.runtime.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from sphereflake_tpu_torch.runtime.progressive import (
    progressive_init,
    progressive_prepare_trimmed,
    progressive_step,
    progressive_tiles_init,
    progressive_tiles_step,
)

from _torch_helpers import port_scene


def _cfg(**kw):
    base = dict(width=64, height=32, max_depth=2, tile_h=16, tile_w=64,
                max_frontier=128, algorithm="fast")
    base.update(kw)
    return RenderConfig(**base)


def _assert_same_state(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        else:
            assert x == y, f.name


def test_progressive_resume_bit_identical(tmp_path):
    cfg = _cfg()
    scene = default_scene("cpu")
    path = str(tmp_path / "prog.npz")
    s = progressive_init(cfg, seed=7, device="cpu")
    for _ in range(5):
        s = progressive_step(s, scene, cfg, batch_size=512)
    a = progressive_init(cfg, seed=7, device="cpu")
    for _ in range(3):
        a = progressive_step(a, scene, cfg, batch_size=512)
    save_checkpoint(path, progressive=a)
    b = load_checkpoint(
        path, {"progressive": progressive_init(cfg, seed=0, device="cpu")}
    )["progressive"]
    _assert_same_state(a, b)
    for _ in range(2):
        b = progressive_step(b, scene, cfg, batch_size=512)
    _assert_same_state(s, b)


def test_tile_progressive_resume_bit_identical(tmp_path):
    cfg = RenderConfig(width=96, height=64, max_depth=2, tile_h=32,
                       tile_w=32, algorithm="binned")
    scene = default_scene("cpu")
    prepared = progressive_prepare_trimmed(scene, cfg, device="cpu")
    path = str(tmp_path / "tiles.npz")

    def run(state, n):
        for _ in range(n):
            state = progressive_tiles_step(
                state, scene, cfg, tiles_per_step=2, prepared=prepared
            )
        return state

    s = run(progressive_tiles_init(cfg, seed=5, device="cpu"), 4)
    a = run(progressive_tiles_init(cfg, seed=5, device="cpu"), 2)
    save_checkpoint(path, progressive_tiles=a)
    b = load_checkpoint(
        path, {"progressive_tiles": progressive_tiles_init(cfg, device="cpu")}
    )["progressive_tiles"]
    _assert_same_state(run(b, 2), s)


def test_fit_state_resume_identical(tmp_path):
    cfg = _cfg()
    scene = default_scene("cpu")
    target = render_gbuffer(scene, cfg, device="cpu")
    off = dataclasses.replace(scene, camera=dataclasses.replace(
        scene.camera, yaw=scene.camera.yaw + 0.02))
    path = str(tmp_path / "fit.npz")
    kw = dict(optimizer=adam(1e-3), keep_best=False, device="cpu")
    r = fit(off, target.position, target.normal, cfg, steps=6, **kw)
    r1 = fit(off, target.position, target.normal, cfg, steps=3, **kw)
    save_checkpoint(path, scene=r1.scene, opt_state=r1.opt_state)
    loaded = load_checkpoint(path, {"scene": off, "opt_state": adam_init(off)})
    r2 = fit(loaded["scene"], target.position, target.normal, cfg, steps=3,
             opt_state=loaded["opt_state"], **kw)
    for a, b in zip(r.scene.leaves(), r2.scene.leaves()):
        assert torch.equal(a, b)
    assert r2.losses[0] < r.losses[0]  # it continued, not restarted


def test_checkpoint_rejects_wrong_structure(tmp_path):
    path = str(tmp_path / "x.npz")
    scene = default_scene("cpu")
    save_checkpoint(path, scene=scene,
                    opt_state=adam_init(scene, schedule=True))
    with pytest.raises(KeyError):
        load_checkpoint(path, {"other": scene})
    with pytest.raises(ValueError, match="31 leaves but checkpoint stores 32"):
        # a constant-rate template for the scheduled state
        load_checkpoint(path, {"opt_state": adam_init(scene)})
    with pytest.raises(ValueError):
        save_checkpoint(path, **{"a/b": scene})


# ---- files between the packages ---------------------------------------


def _ref_scene(seed=3):
    """A reference scene with every leaf moved off its default."""
    import jax

    from sphereflake_tpu.config import default_scene as ref_default_scene

    rng = np.random.default_rng(seed)
    scene = ref_default_scene()
    return jax.tree_util.tree_map(
        lambda x: x + rng.normal(0.0, 0.01, np.shape(x)).astype(np.float32),
        scene,
    )


def _ref_leaves(tree):
    import jax

    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _assert_leaves_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")


def test_scene_passes_between_packages(tmp_path):
    from sphereflake_tpu.config import default_scene as ref_default_scene
    from sphereflake_tpu.runtime import checkpoint as ref_ckpt

    ref = _ref_scene()
    path = str(tmp_path / "ref.npz")
    ref_ckpt.save_checkpoint(path, scene=ref)
    got = load_checkpoint(path, {"scene": default_scene("cpu")})["scene"]
    assert isinstance(got, SceneParams)
    _assert_leaves_equal([x.numpy() for x in got.leaves()], _ref_leaves(ref))

    port = port_scene(_ref_scene(seed=4))
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, scene=port)
    back = ref_ckpt.load_checkpoint(path, {"scene": ref_default_scene()})
    _assert_leaves_equal(
        _ref_leaves(back["scene"]), [x.numpy() for x in port.leaves()]
    )


def _progressive_pair(unit):
    """(reference state, port template) with the cursor near the 2^32
    wrap and seeded planes."""
    import jax.numpy as jnp

    from sphereflake_tpu.config import RenderConfig as RefConfig
    from sphereflake_tpu.runtime import progressive as ref_prog

    kw = dict(width=64, height=32, max_depth=2, tile_h=32, tile_w=32,
              algorithm="binned")
    rng = np.random.default_rng(11)
    if unit == "progressive":
        ref = ref_prog.progressive_init(RefConfig(**kw), seed=2**31 + 9)
        planes = ("position", "normal", "min_t")
        template = progressive_init(RenderConfig(**kw), device="cpu")
    else:
        ref = ref_prog.progressive_tiles_init(RefConfig(**kw), seed=2**31 + 9)
        planes = ("rows",)
        template = progressive_tiles_init(RenderConfig(**kw), device="cpu")
    fill = {
        p: jnp.asarray(
            rng.normal(size=np.shape(getattr(ref, p))).astype(np.float32)
        )
        for p in planes
    }
    if unit == "progressive_tiles":
        fill["covered"] = jnp.asarray(rng.random(ref.covered.shape) < 0.5)
    ref = dataclasses.replace(
        ref, **fill,
        sample_lo=jnp.uint32(2**32 - 3), sample_hi=jnp.uint32(5),
        closest_distance=jnp.float32(7.25),
        samples_traced=jnp.uint32(4_000_000_000),
        overflow=jnp.int32(17),
    )
    return ref, template


@pytest.mark.parametrize("unit", ["progressive", "progressive_tiles"])
def test_frameless_state_passes_between_packages(unit, tmp_path):
    from sphereflake_tpu.runtime import checkpoint as ref_ckpt

    ref, template = _progressive_pair(unit)
    path = str(tmp_path / "ref.npz")
    ref_ckpt.save_checkpoint(path, **{unit: ref})
    got = load_checkpoint(path, {unit: template})[unit]
    assert type(got) is type(template)
    assert (got.sample_lo, got.sample_hi, got.samples_traced) == (
        2**32 - 3, 5, 4_000_000_000
    )
    assert got.seed == 2**31 + 9
    assert isinstance(got.sample_lo, int) and got.overflow.dtype == torch.int32
    for f in dataclasses.fields(got):
        x = getattr(got, f.name)
        if isinstance(x, torch.Tensor):
            want = np.asarray(getattr(ref, f.name))
            assert x.numpy().dtype == want.dtype, f.name
            np.testing.assert_array_equal(x.numpy(), want, err_msg=f.name)

    # ... and back: the port's file fills the reference's fresh state,
    # leaf for leaf in the reference's dtypes (uint32 cursor).
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, **{unit: got})
    fresh = dataclasses.replace(
        ref, **{f.name: getattr(ref, f.name) * 0
                for f in dataclasses.fields(ref)}
    )
    back = ref_ckpt.load_checkpoint(path, {unit: fresh})[unit]
    _assert_leaves_equal(_ref_leaves(back), _ref_leaves(ref))


def _grads(seed):
    """Seeded gradient leaves in the scene's shapes."""
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=x.shape).astype(np.float32)
        for x in default_scene("cpu").leaves()
    ]


def _port_adam_steps(leaves, state, grads_list, schedule):
    """Torch Adam steps from `state` on the given gradient lists."""
    xs = [torch.tensor(np.asarray(x)).requires_grad_(True) for x in leaves]
    opt, sched = adam(2e-3, 10 if schedule else None)(xs, state)
    for grads in grads_list:
        for x, g in zip(xs, grads):
            x.grad = torch.from_numpy(g)
        opt.step()
        if sched is not None:
            sched.step()
    return [x.detach().numpy() for x in xs], adam_state(opt, sched, xs)


@pytest.mark.parametrize("schedule", [False, True])
def test_adam_state_passes_between_packages(schedule, tmp_path):
    """Two optax steps, the state through a file, the third step in
    torch — and two torch steps, the state through a file, the third in
    optax: each third step equals the other package's."""
    import jax
    import jax.numpy as jnp
    import optax

    from sphereflake_tpu.runtime import checkpoint as ref_ckpt

    ref = _ref_scene()
    treedef = jax.tree_util.tree_structure(ref)
    lr = optax.cosine_decay_schedule(2e-3, 10) if schedule else 2e-3
    opt = optax.adam(lr)
    g = [_grads(s) for s in (1, 2, 3)]
    as_tree = lambda leaves: jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(x) for x in leaves]
    )

    def optax_steps(params, state, grads_list):
        for grads in grads_list:
            updates, state = opt.update(as_tree(grads), state, params)
            params = optax.apply_updates(params, updates)
        return params, state

    p2, s2 = optax_steps(ref, opt.init(ref), g[:2])
    n_leaves = 32 if schedule else 31
    assert len(jax.tree_util.tree_leaves(s2)) == n_leaves
    p3, _ = optax_steps(p2, s2, g[2:])

    path = str(tmp_path / "ref.npz")
    ref_ckpt.save_checkpoint(path, scene=p2, opt_state=s2)
    scene0 = port_scene(ref)
    loaded = load_checkpoint(path, {
        "scene": scene0, "opt_state": adam_init(scene0, schedule=schedule),
    })
    st = loaded["opt_state"]
    assert isinstance(st, AdamState) and int(st.count) == 2
    assert (st.schedule_count is not None) == schedule
    got3, _ = _port_adam_steps(
        [x.numpy() for x in loaded["scene"].leaves()], st, g[2:], schedule
    )
    for a, b in zip(got3, _ref_leaves(p3)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)

    # ... and back.
    port2, pst2 = _port_adam_steps(_ref_leaves(ref), None, g[:2], schedule)
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, scene=SceneParams.from_leaves(
        [torch.from_numpy(x) for x in port2]), opt_state=pst2)
    back = ref_ckpt.load_checkpoint(
        path, {"scene": ref, "opt_state": opt.init(ref)}
    )
    back_leaves, want_leaves = _ref_leaves(back["opt_state"]), _ref_leaves(s2)
    assert len(back_leaves) == n_leaves
    for a, b in zip(back_leaves, want_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-12)
    q3, _ = optax_steps(back["scene"], back["opt_state"], g[2:])
    for a, b in zip(_ref_leaves(q3), got3):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
