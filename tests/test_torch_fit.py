"""The port's fitting loop (`sphereflake_tpu_torch.fit`) on the
reference's gradient-test frame (64x32, depth 2, `fast`), held against
the reference's `fit` (optax Adam) and against the reference's own fit
tests (`tests/test_grad.py`: the fit converges, the image loss recovers
the SSAO uniforms).

The first three Adam steps: losses within rtol = 1e-3 and parameters
within atol = 1e-4 (5 % of one step of lr = 2e-3) of the reference's
on the camera with the CLI's cosine schedule, within atol = 1e-3 (half
a step; measured 5.4e-4 on the pitch) when every leaf moves — the
fractal leaves move the silhouettes of every level. Both
packages apply the same Adam formula — `test_torch_checkpoint.py` holds
the two optimizers to 1e-6 on identical gradients — but the fit loss is
dominated by silhouette pixels, where the straight-through gradient
meets grazing rays and each package's f32 rounding (`test_torch_grad.py`):
its gradient leaves lie up to ~6 % apart at the start (camera position
z: 0.0548 vs 0.0518), and Adam's first steps move every leaf by about
lr = 2e-3 whatever its gradient's size, so a small, noisy leaf carries
the difference into its second and third steps.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from sphereflake_tpu_torch.config import RenderConfig, default_scene
from sphereflake_tpu_torch.fit import (
    AdamState,
    adam,
    adam_init,
    adam_state,
    camera_only,
    cosine_decay,
    fit,
    fit_step,
    gbuffer_loss,
    image_loss,
    ssao_only,
)
from sphereflake_tpu_torch.render import render_frame, render_gbuffer

from _torch_helpers import port_scene

_KW = dict(width=64, height=32, max_depth=2, max_frontier=128,
           algorithm="fast", tile_h=16, tile_w=64)


def _cfg():
    return RenderConfig(**_KW)


def _yaw_off(scene, dyaw=0.02):
    return dataclasses.replace(scene, camera=dataclasses.replace(
        scene.camera, yaw=scene.camera.yaw + dyaw))


def test_fit_loop_converges():
    """Config 4: a short Adam run reduces the loss (camera recovery)."""
    scene = default_scene("cpu")
    cfg = _cfg()
    target = render_gbuffer(scene, cfg, device="cpu")
    res = fit(
        _yaw_off(scene), target.position, target.normal, cfg, steps=30,
        optimizer=adam(2e-3, 30), param_filter=camera_only, device="cpu",
    )
    best = float(gbuffer_loss(res.scene, target.position, target.normal,
                              cfg, device="cpu"))
    assert best < res.losses[0] * 0.5, (best, res.losses)
    assert best == pytest.approx(min(res.losses), rel=1e-6)
    # camera_only: the fractal and SSAO leaves never moved.
    for got, want in zip(res.scene.leaves()[5:], scene.leaves()[5:]):
        assert torch.equal(got, want)


def test_image_loss_fit_recovers_ssao_params():
    """`fit(loss="image")` differentiates the whole post chain and must
    recover a perturbed intensity and bias."""
    scene = default_scene("cpu")
    cfg = _cfg()
    target_image, _ = render_frame(scene, cfg, device="cpu")
    off = dataclasses.replace(scene, ssao=dataclasses.replace(
        scene.ssao, intensity=scene.ssao.intensity + 0.3,
        bias=scene.ssao.bias - 0.1))
    l_start = float(image_loss(off, target_image, cfg, device="cpu"))
    res = fit(
        off, None, None, cfg, steps=40, optimizer=adam(2e-2),
        param_filter=ssao_only, loss="image", target_image=target_image,
        device="cpu",
    )
    l_best = float(image_loss(res.scene, target_image, cfg, device="cpu"))
    assert l_best < l_start * 0.05, (l_start, l_best, res.losses[-5:])
    d_int0 = abs(float(off.ssao.intensity - scene.ssao.intensity))
    d_int1 = abs(float(res.scene.ssao.intensity - scene.ssao.intensity))
    assert d_int1 < 0.5 * d_int0, (d_int0, d_int1)
    assert torch.equal(res.scene.camera.position, scene.camera.position)


@pytest.fixture(scope="module")
def reference_fits():
    """Three steps of the reference's `fit` from the same start, with the
    cosine schedule on the camera and with a constant rate on every
    leaf: (losses, leaves of the scene after each run)."""
    import jax
    import optax

    from sphereflake_tpu.config import RenderConfig as RefConfig
    from sphereflake_tpu.config import default_scene as ref_default_scene
    from sphereflake_tpu.fit import camera_only as ref_camera_only
    from sphereflake_tpu.fit import fit as ref_fit
    from sphereflake_tpu.render import render_gbuffer as ref_render

    cfg = RefConfig(**_KW)
    scene = ref_default_scene()
    target = ref_render(scene, cfg)
    off = _yaw_off(scene)
    runs = {}
    for name, opt, flt in (
        ("camera_cosine", optax.adam(optax.cosine_decay_schedule(2e-3, 30)),
         ref_camera_only),
        ("all_constant", optax.adam(2e-3), None),
    ):
        res = ref_fit(off, target.position, target.normal, cfg, steps=3,
                      optimizer=opt, param_filter=flt, keep_best=False)
        runs[name] = (
            res.losses,
            [np.asarray(x) for x in jax.tree_util.tree_leaves(res.scene)],
        )
    return (
        off, np.asarray(target.position), np.asarray(target.normal), runs
    )


@pytest.mark.parametrize("name", ["camera_cosine", "all_constant"])
def test_first_adam_steps_match_reference(name, reference_fits):
    off, tgt_pos, tgt_nrm, runs = reference_fits
    want_losses, want_leaves = runs[name]
    opt, flt, atol = {
        "camera_cosine": (adam(2e-3, 30), camera_only, 1e-4),
        "all_constant": (adam(2e-3), None, 1e-3),
    }[name]
    res = fit(
        port_scene(off), torch.from_numpy(tgt_pos), torch.from_numpy(tgt_nrm),
        _cfg(), steps=3, optimizer=opt, param_filter=flt, keep_best=False,
        device="cpu",
    )
    np.testing.assert_allclose(res.losses, want_losses, rtol=1e-3)
    for i, (got, want) in enumerate(zip(res.scene.leaves(), want_leaves)):
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0.0, atol=atol, err_msg=f"leaf {i}"
        )
    # The start moved: a step is about lr, far above the tolerance.
    yaw0 = float(port_scene(off).camera.yaw)
    assert abs(float(res.scene.camera.yaw) - yaw0) > 2e-3


def test_masked_leaves_keep_one_step_count():
    """A masked leaf gets a zero gradient, not None: every leaf's Adam
    step count stays optax's single count, and its moments stay 0."""
    scene = default_scene("cpu")
    cfg = _cfg()
    target = render_gbuffer(scene, cfg, device="cpu")
    res = fit(_yaw_off(scene), target.position, target.normal, cfg, steps=2,
              optimizer=adam(2e-3, 10), param_filter=camera_only,
              device="cpu")
    st = res.opt_state
    assert isinstance(st, AdamState)
    assert int(st.count) == 2 and int(st.schedule_count) == 2
    assert len(st.mu) == len(st.nu) == 15
    assert all(float(m.abs().max()) == 0.0 for m in st.mu[5:])
    assert any(float(m.abs().max()) > 0.0 for m in st.mu[:5])


def test_keep_best_returns_the_iterate_before_its_update():
    """`keep_best` returns the scene the best loss was scored at: its
    loss re-evaluates to exactly that value."""
    scene = default_scene("cpu")
    cfg = _cfg()
    target = render_gbuffer(scene, cfg, device="cpu")
    res = fit(_yaw_off(scene), target.position, target.normal, cfg, steps=6,
              optimizer=adam(5e-3), param_filter=camera_only, device="cpu")
    again = float(gbuffer_loss(res.scene, target.position, target.normal,
                               cfg, device="cpu"))
    assert again == min(res.losses)
    final = fit(_yaw_off(scene), target.position, target.normal, cfg,
                steps=1, optimizer=adam(5e-3), param_filter=camera_only,
                keep_best=True, device="cpu")
    assert torch.equal(final.scene.camera.yaw, _yaw_off(scene).camera.yaw)


def test_cosine_schedule_matches_optax():
    import optax

    sched = optax.cosine_decay_schedule(2e-3, 7)
    factor = cosine_decay(7)
    for t in range(10):
        assert math.isclose(2e-3 * factor(t), float(sched(t)), rel_tol=1e-6,
                            abs_tol=1e-12)
    # LambdaLR stepped after each update: update i uses lr * factor(i).
    x = torch.zeros(1, requires_grad=True)
    opt, lr_sched = adam(2e-3, 7)([x])
    seen = []
    for _ in range(4):
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        lr_sched.step()
    assert seen == pytest.approx([2e-3 * factor(t) for t in range(4)])


@pytest.mark.parametrize("t", [0, 1, 3, 9])
def test_resumed_schedule_continues_the_uninterrupted_one(t):
    """`adam(lr, steps)` built from the state of a run t updates in
    (`adam_state`) sets the same rate, schedule count and Adam count as
    that run, and its next steps follow the same rates (past `steps`,
    the factor stays 0)."""
    x = torch.zeros(3, requires_grad=True)
    opt, sched = adam(2e-3, 7)([x])
    for _ in range(t):
        x.grad = torch.ones(3)
        opt.step()
        sched.step()
    state = adam_state(opt, sched, [x])
    assert int(state.count) == t and int(state.schedule_count) == t
    y = x.detach().clone().requires_grad_(True)
    opt2, sched2 = adam(2e-3, 7)([y], state)
    assert sched2.last_epoch == t
    for _ in range(3):
        assert opt2.param_groups[0]["lr"] == opt.param_groups[0]["lr"]
        for p, o, sc in ((x, opt, sched), (y, opt2, sched2)):
            p.grad = torch.ones(3)
            o.step()
            sc.step()
        assert torch.equal(x, y)
    assert opt.param_groups[0]["lr"] == pytest.approx(
        2e-3 * cosine_decay(7)(t + 3), abs=1e-15)


def test_fit_step_returns_zero_not_none_for_unused_leaves():
    scene = default_scene("cpu")
    cfg = _cfg()
    target = render_gbuffer(scene, cfg, device="cpu")
    loss, grads = fit_step(_yaw_off(scene), target.position, target.normal,
                           cfg, device="cpu")
    assert float(loss) > 0.0
    leaves = grads.leaves()
    assert all(g is not None for g in leaves)
    assert all(float(g.abs().max()) == 0.0 for g in leaves[9:])
    assert float(grads.camera.yaw.abs()) > 0.0


def test_adam_init_leaf_layout():
    scene = default_scene("cpu")
    assert isinstance(adam_init(scene), AdamState)
    assert adam_init(scene).schedule_count is None
    assert int(adam_init(scene, schedule=True).schedule_count) == 0


def test_sharded_fit_is_not_ported():
    """The sharded fit is ported: `fit(mesh=...)` over two CPU cells
    takes the single-device fit's steps (the blocks' gradients summed in
    another order: rtol 1e-5)."""
    from sphereflake_tpu_torch.parallel import make_mesh

    cfg = _cfg()
    target = render_gbuffer(default_scene("cpu"), cfg, device="cpu")
    scene = default_scene("cpu")
    scene = dataclasses.replace(scene, camera=dataclasses.replace(
        scene.camera, yaw=scene.camera.yaw + 0.02))
    mesh = make_mesh(["cpu", "cpu"], shape=(1, 2))
    got = fit(scene, target.position, target.normal, cfg, steps=2, mesh=mesh)
    want = fit(scene, target.position, target.normal, cfg, steps=2,
               device="cpu")
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    for a, b in zip(got.scene.leaves(), want.scene.leaves()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_fit_needs_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    scene = default_scene("cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        fit(scene, torch.zeros(32, 64, 3), torch.zeros(32, 64, 3), _cfg(),
            steps=1)
