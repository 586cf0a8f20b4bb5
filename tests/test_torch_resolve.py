"""The port's path-code resolve (`resolve_codes_soa`, `resolve_codes`,
plain torch) vs the reference package's (plain XLA), on codes from a
real trace: the port's own full-grid trace of the reference pose at
depth 3 and of a dive pose at depth 8, where winners carry real
hi-lane codes.

Tolerance: hit masks equal exactly (integer tests on the codes); the
re-derived centres within atol = 1e-5 (a chain of up to 8 f32 frame
compositions, XLA's contracted against eager torch's); min_t within
rtol = atol = 1e-4 on >= 99.5 % of hits — t = tca - sqrt(r^2 - d^2)
cancels near silhouettes, where the contraction difference shows."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphereflake_tpu.config import RenderConfig as RefConfig
from sphereflake_tpu.config import default_scene
from sphereflake_tpu.models.sphereflake import (
    child_templates as ref_templates,
)
from sphereflake_tpu.models.sphereflake import root_frame as ref_root
from sphereflake_tpu.ops import pallas_traversal as ref_pt
from sphereflake_tpu_torch.config import RenderConfig as PortConfig
from sphereflake_tpu_torch.models import sphereflake as port_model
from sphereflake_tpu_torch.ops import binned as port_binned
from sphereflake_tpu_torch.ops import pallas_traversal as port_pt

from _torch_helpers import port_scene
from test_binned import dive_scene

_BIG = np.float32(3.0e38)


def _traced_codes(scene, cfg):
    """(dirs [N, 3], code_lo [N], code_hi [N] or None, centre [N, 3]) of
    the port's full-grid trace."""
    root = port_model.root_frame(scene.camera.position)
    templates = port_model.child_templates(scene.fractal)
    pairs, starts, lens, _ = port_binned.binned_pairs(scene, cfg, root, templates)
    cam = port_binned.camera_vector(scene, cfg)
    T = cfg.tiles_x * cfg.tiles_y
    dx, dy, dz = port_binned._tile_raygen(
        cam, torch.arange(T, dtype=torch.int32), cfg
    )
    deep = cfg.max_depth >= 7
    bt, blo, bhi, bcx, bcy, bcz = port_binned._walk_pairs(
        dx, dy, dz, pairs, starts, lens, deep
    )
    dirs = torch.stack([dx, dy, dz], dim=-1).reshape(-1, 3)
    centre = torch.stack([bcx, bcy, bcz], dim=-1).reshape(-1, 3)
    return (dirs, blo.reshape(-1), bhi.reshape(-1) if deep else None,
            centre, bt.reshape(-1), root, templates)


@pytest.mark.parametrize(
    "name,make_scene,kw",
    [
        ("depth3", default_scene, dict(width=128, height=96, max_depth=3)),
        ("depth8", dive_scene,
         dict(width=64, height=32, max_depth=8, global_cap=1 << 15)),
    ],
)
def test_resolve_matches_reference(name, make_scene, kw):
    kw = dict(tile_h=32, tile_w=32, algorithm="binned", **kw)
    ref_scene = make_scene()
    scene, cfg, ref_cfg = port_scene(ref_scene), PortConfig(**kw), RefConfig(**kw)
    dirs, lo, hi, centre, bt, root, templates = _traced_codes(scene, cfg)
    got = port_pt.resolve_codes_soa(
        dirs[:, 0], dirs[:, 1], dirs[:, 2], lo, root, templates,
        scene.fractal, cfg, code_hi_f=hi,
    )
    ref_fn = jax.jit(functools.partial(ref_pt.resolve_codes_soa, cfg=ref_cfg))
    d = jnp.asarray(dirs.numpy())
    want = ref_fn(
        d[:, 0], d[:, 1], d[:, 2], jnp.asarray(lo.numpy()),
        ref_root(ref_scene.camera.position), ref_templates(ref_scene.fractal),
        ref_scene.fractal,
        code_hi_f=None if hi is None else jnp.asarray(hi.numpy()),
    )
    g_mt, g_cx, g_cy, g_cz, g_hit = (x.numpy() for x in got)
    w_mt, w_cx, w_cy, w_cz, w_hit = (np.asarray(x) for x in want)
    assert g_hit.dtype == np.bool_ and g_hit.mean() > 0.05
    np.testing.assert_array_equal(g_hit, w_hit)
    for g, w in ((g_cx, w_cx), (g_cy, w_cy), (g_cz, w_cz)):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    close = np.isclose(g_mt[g_hit], w_mt[w_hit], rtol=1e-4, atol=1e-4)
    assert close.mean() >= 0.995
    assert (g_mt[~g_hit] == _BIG).all() and (w_mt[~w_hit] == _BIG).all()
    # The resolve re-derives what the trace itself carried along.
    np.testing.assert_allclose(
        np.stack([g_cx, g_cy, g_cz], -1)[g_hit], centre.numpy()[g_hit],
        atol=1e-5, rtol=0,
    )
    t_close = np.isclose(g_mt[g_hit], bt.numpy()[g_hit], rtol=1e-4, atol=1e-4)
    assert t_close.mean() >= 0.995
    if hi is not None:
        assert (hi.numpy() >= 1).mean() > 0.05  # hi-lane winners present

    # The AoS wrapper, on a [T, 1024] layout.
    T = cfg.tiles_x * cfg.tiles_y
    mt2, c2, hit2 = port_pt.resolve_codes(
        dirs.reshape(T, 1024, 3), lo.reshape(T, 1024), root, templates,
        scene.fractal, cfg,
        code_hi_f=None if hi is None else hi.reshape(T, 1024),
    )
    assert mt2.shape == (T, 1024) and c2.shape == (T, 1024, 3)
    np.testing.assert_array_equal(mt2.reshape(-1).numpy(), g_mt)
    np.testing.assert_array_equal(hit2.reshape(-1).numpy(), g_hit)
    np.testing.assert_array_equal(c2.reshape(-1, 3)[:, 1].numpy(), g_cy)


@pytest.mark.parametrize("depth", [3, 8])
def test_sky_codes_resolve_to_sky(depth):
    cfg = PortConfig(width=64, height=32, max_depth=depth, tile_h=32,
                     tile_w=32, algorithm="binned")
    scene = port_scene(default_scene())
    root = port_model.root_frame(scene.camera.position)
    templates = port_model.child_templates(scene.fractal)
    n = 16
    d = torch.zeros(n)
    zero = torch.zeros(n)
    mt, cx, cy, cz, hit = port_pt.resolve_codes_soa(
        d, d, d - 1.0, zero, root, templates, scene.fractal, cfg,
        code_hi_f=zero if depth >= 7 else None,
    )
    assert not hit.any()
    assert (mt == 3.0e38).all()
    assert (cx == 0).all() and (cy == 0).all() and (cz == 0).all()
    # Code 1 is the root sphere: centre = root translation.
    mt, cx, cy, cz, hit = port_pt.resolve_codes_soa(
        d, d, d - 1.0, zero + 1.0, root, templates, scene.fractal, cfg
    )
    assert hit.all()
    np.testing.assert_allclose(
        torch.stack([cx, cy, cz], -1).numpy(),
        np.broadcast_to(root[:, 3].numpy(), (n, 3)), atol=1e-6,
    )


def test_gradients_flow_through_the_resolve():
    """The codes are detached; root, templates and the fractal's scalars
    receive gradients (no in-place op on the way)."""
    cfg = PortConfig(width=64, height=32, max_depth=3, tile_h=32, tile_w=32,
                     algorithm="binned")
    scene = port_scene(default_scene())
    dirs, lo, _hi, _c, _bt, root, templates = _traced_codes(scene, cfg)
    root = root.clone().requires_grad_(True)
    templates = templates.clone().requires_grad_(True)
    ratio = scene.fractal.radius_ratio.clone().requires_grad_(True)
    import dataclasses

    fractal = dataclasses.replace(scene.fractal, radius_ratio=ratio)
    mt, cx, cy, cz, hit = port_pt.resolve_codes_soa(
        dirs[:, 0], dirs[:, 1], dirs[:, 2], lo.requires_grad_(True), root,
        templates, fractal, cfg,
    )
    loss = mt[hit].sum() + (cx + cy + cz).sum()
    loss.backward()
    for leaf in (root, templates, ratio):
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all()
        assert float(leaf.grad.abs().sum()) > 0
    assert lo.grad is None or float(lo.grad.abs().sum()) == 0
