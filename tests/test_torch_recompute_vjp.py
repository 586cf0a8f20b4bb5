"""The fit's backward kernel (`sphereflake_tpu_torch/ops/recompute_vjp.py`,
`csrc/recompute_vjp.cu`) through its plain version, on the CPU.

- The plain version's gradients of the ray directions, the root frame, the
  child templates and the two fractal scalars against `torch.autograd.grad`
  through the plain chain it replaces (`ops/binned.py:_shade_codes`, the
  path-code resolve and the shading), under seeded upstream gradients:
  elementwise within RTOL of autograd's plus ATOL of autograd's largest
  magnitude. The frame walk is differentiated in closed form and the rays
  are summed in the kernel's order, so the two round differently: on these
  frames by at most ~1.2e-5 of the largest magnitude, and by up to ~6e-4
  of a small template entry's own size. Frames: 64x32 depth 2 (the
  reference's gradient frame; also tiled 30 times over, so that a thread
  of the kernel's grid takes two rays), and the dive pose at depths 7 and
  8, whose deep winners carry hi-lane codes.
- Two calls give the same bits; on the CPU route the backward counts no
  `gbuffer.vjp_kernel` and launches nothing; a tensor on any device but
  the CPU never reaches the plain version; `BinnedGBuffer.jvp` still is
  the plain chain in forward mode, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from sphereflake_tpu_torch import spans
from sphereflake_tpu_torch.config import (
    RenderConfig,
    SceneParams,
    default_scene,
)
from sphereflake_tpu_torch.models.sphereflake import child_templates, root_frame
from sphereflake_tpu_torch.ops import binned
from sphereflake_tpu_torch.ops import recompute_vjp as rv
from sphereflake_tpu_torch.render import render_gbuffer

from _torch_helpers import port_scene

RTOL, ATOL = 1e-4, 1e-4  # ATOL: a share of autograd's largest magnitude
NAMES = ("dx", "dy", "dz", "root", "templates", "radius_ratio",
         "root_radius")


def _case(scene, cfg, tile: int = 1):
    """The band's codes from the primal, its front under grad (leaves,
    rays, root, templates, level radii; rays and codes repeated `tile`
    times) and seeded upstream gradients."""
    outs = binned._gbuffer_primal(cfg, binned.band_fronts(
        scene, cfg, cfg.width, cfg.height, 0.0, [0.0])[0])
    lo, hi = outs[8].repeat(tile), outs[9].repeat(tile)
    leaves = [x.detach().clone().requires_grad_(True) for x in scene.leaves()]
    s = SceneParams.from_leaves(leaves)
    rays = [d.repeat(tile) for d in binned._band_rays(
        cfg, cfg.width, cfg.height, s, (0.0, 0.0))]
    front = (*rays, root_frame(s.camera.position), child_templates(s.fractal),
             s.fractal.radius_ratio, s.fractal.root_radius,
             rv.level_radii(s.fractal, cfg.max_depth))
    rng = np.random.default_rng(11)
    grads = [torch.from_numpy(rng.uniform(-1.0, 1.0, lo.shape).astype(
        np.float32)) for _ in range(7)]
    # min_t is BIG where the ray missed: the fit never weighs it there.
    grads[0] = torch.where((lo >= 1) | (hi >= 1), grads[0], 0.0)
    return dict(cfg=cfg, s=s, lo=lo, hi=hi, front=front, grads=grads)


def _dive_cfg(depth):
    return RenderConfig(width=64, height=32, max_depth=depth, tile_h=32,
                        tile_w=32, global_cap=1 << 15, algorithm="binned")


@pytest.fixture(scope="module")
def cases():
    from test_binned import dive_scene

    shallow = RenderConfig(width=64, height=32, max_depth=2, tile_h=32,
                           tile_w=32, algorithm="binned")
    dive = port_scene(dive_scene())
    return {
        "depth2": _case(default_scene("cpu"), shallow),
        "depth2_two_rays_a_thread": _case(default_scene("cpu"), shallow, 30),
        "depth7": _case(dive, _dive_cfg(7)),
        "depth8": _case(dive, _dive_cfg(8)),
    }


def _plain(c):
    x = [f.detach() for f in c["front"]]
    return rv.recompute_vjp(*x[:3], c["lo"], c["hi"], c["grads"], *x[3:],
                            depth=c["cfg"].max_depth)


@pytest.mark.parametrize("name", ["depth2", "depth2_two_rays_a_thread",
                                  "depth7", "depth8"])
def test_plain_gradients_match_autograd(cases, name):
    c = cases[name]
    cfg, lo, hi, front = c["cfg"], c["lo"], c["hi"], c["front"]
    if name == "depth2_two_rays_a_thread":
        assert lo.shape[0] > rv.GRID_BLOCKS * rv.THREADS
    if cfg.max_depth >= 7:
        assert int((hi >= 1).sum()) > 500  # deep winners, hi-lane codes
    dx, dy, dz, root, templates, ratio, radius0, rhit = front
    outs = binned._shade_codes(dx, dy, dz, lo, hi, root, templates,
                               c["s"].fractal, cfg)
    inputs = [dx, dy, dz, root, templates, ratio, radius0]
    want = torch.autograd.grad(outs, inputs, c["grads"], retain_graph=True)
    got = _plain(c)
    # The level radii's gradient reaches the two scalars through autograd.
    via_rhit = torch.autograd.grad(rhit, [ratio, radius0], got[7],
                                   retain_graph=True)
    got = [*got[:5], got[5] + via_rhit[0], got[6] + via_rhit[1]]
    for n, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, n
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=RTOL,
            atol=ATOL * float(w.abs().max()), err_msg=f"{name}: {n}",
        )
    assert all(float(w.abs().max()) > 0 for w in want)


def test_plain_version_is_deterministic(cases):
    for name in ("depth2_two_rays_a_thread", "depth8"):
        a, b = _plain(cases[name]), _plain(cases[name])
        for x, y in zip(a, b):
            assert torch.equal(x.contiguous().view(torch.int32),
                               y.contiguous().view(torch.int32)), name


def test_cpu_route_counts_no_kernel():
    cfg = RenderConfig(width=64, height=32, max_depth=2, tile_h=32,
                       tile_w=32, algorithm="binned")
    leaves = default_scene("cpu").leaves()
    for leaf in leaves:
        leaf.requires_grad_(True)
    before = rv.recompute_vjp.launches
    with spans.unit("vjp_test"):
        gb = render_gbuffer(SceneParams.from_leaves(leaves), cfg,
                            device="cpu")
        loss = torch.sum(gb.position ** 2) + torch.sum(gb.normal ** 2)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert rv.recompute_vjp.launches == before
    if spans.ENABLED:
        rec = spans.records("vjp_test")[-1]
        assert rec["counts"].get("gbuffer.vjp_kernel", 0) == 0
        assert rec["spans"].get("gbuffer.recompute", 0) > 0
    assert all(g is not None for g in grads[:9])
    assert all(g is None for g in grads[9:])


def test_no_device_but_the_cpu_reaches_the_plain_version(cases, monkeypatch):
    c = cases["depth2"]
    x = [f.detach() for f in c["front"]]
    args = (*x[:3], c["lo"], c["hi"], c["grads"], *x[3:])

    def plain(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(rv, "recompute_vjp_plain", plain)
    meta = [t.to("meta") for t in (*x[:3], c["lo"], c["hi"])]
    with pytest.raises(ValueError, match="cuda"):
        rv.recompute_vjp(*meta, [g.to("meta") for g in c["grads"]],
                         *(t.to("meta") for t in x[3:]), depth=2)
    with pytest.raises(ValueError, match="lies on"):
        rv.recompute_vjp(*meta, c["grads"], *x[3:], depth=2)
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    # Without a card the kernel's route fails: it builds and launches, or
    # raises, and never computes on the CPU.
    with pytest.raises((RuntimeError, ValueError, AssertionError)):
        rv._launch_recompute_vjp(*args, 2)
    with pytest.raises((RuntimeError, AssertionError)):
        rv.recompute_vjp(*(t.to("cuda") for t in x[:3]), c["lo"], c["hi"],
                         c["grads"], *x[3:], depth=2)


def test_wrapper_rejects_what_the_kernel_does_not_take(cases):
    c = cases["depth2"]
    x = [f.detach() for f in c["front"]]
    lo, hi, g = c["lo"], c["hi"], c["grads"]
    with pytest.raises(ValueError, match="7 tensors"):
        rv.recompute_vjp(*x[:3], lo, hi, g[:6], *x[3:], depth=2)
    with pytest.raises(ValueError, match="shape"):
        rv.recompute_vjp(*x[:3], lo[:-1], hi, g, *x[3:], depth=2)
    with pytest.raises(ValueError, match="shape"):  # rhit is [depth + 1]
        rv.recompute_vjp(*x[:3], lo, hi, g, *x[3:], depth=3)
    with pytest.raises(TypeError, match="float32"):
        rv.recompute_vjp(x[0].double(), *x[1:3], lo, hi, g, *x[3:], depth=2)
    with pytest.raises(ValueError, match="contiguous"):
        rv.recompute_vjp(*x[:3], lo, hi, g, x[3].t().contiguous().t(),
                         *x[4:], depth=2)
    with pytest.raises(ValueError, match="depth"):
        rv.recompute_vjp(*x[:3], lo, hi, g, *x[3:], depth=14)
    # No rays: empty ray gradients, zero leaf gradients.
    empty = rv.recompute_vjp(*(t[:0] for t in x[:3]), lo[:0], hi[:0],
                             [t[:0] for t in g], *x[3:], depth=2)
    assert empty[0].shape == (0,)
    assert all(float(t.abs().max()) == 0 for t in empty[3:])


def test_forward_mode_keeps_the_plain_chain(cases):
    """`BinnedGBuffer.jvp` (forward mode: `render_gbuffer` under dual
    tensors) equals `_gbuffer_recompute`, the plain chain, in forward mode
    bit for bit; and the kernel's forward mode's plain version is that
    chain too."""
    c = cases["depth2"]
    cfg = c["cfg"]
    scene = default_scene("cpu")
    front = binned.band_fronts(scene, cfg, cfg.width, cfg.height, 0.0,
                               [0.0])[0]
    outs = binned._gbuffer_primal(cfg, front)
    with fwAD.dual_level():
        x = fwAD.make_dual(torch.zeros(()), torch.ones(()))
        moved = dataclasses.replace(scene, camera=dataclasses.replace(
            scene.camera, yaw=scene.camera.yaw + x))
        via_jvp = binned.binned_gbuffer(cfg, cfg.width, cfg.height, moved,
                                        (0.0, 0.0), front)
        plain = binned._gbuffer_recompute(cfg, cfg.width, cfg.height, moved,
                                          (0.0, 0.0), outs[8], outs[9])
        for a, b in zip(via_jvp[:7], plain):
            ta, tb = fwAD.unpack_dual(a).tangent, fwAD.unpack_dual(b).tangent
            assert torch.equal(ta.view(torch.int32), tb.view(torch.int32))
        assert any(float(fwAD.unpack_dual(a).tangent.abs().max()) > 0
                   for a in via_jvp[1:4])
    front = [f.detach() for f in c["front"]]
    got = rv.recompute_forward(*front[:3], c["lo"], c["hi"], front[3],
                               front[4], c["s"].fractal, cfg)
    want = torch.stack(binned._shade_codes(*front[:3], c["lo"], c["hi"],
                                           front[3], front[4],
                                           c["s"].fractal, cfg))
    assert torch.equal(got, want.detach())
