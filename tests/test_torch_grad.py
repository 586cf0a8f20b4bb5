"""Gradients of the port's frame (`sphereflake_tpu_torch`) on the
binned, pallas and fast paths, on the reference's gradient-test frame
(64x32, depth 2, `tests/test_grad.py`).

- Per-pixel position gradients (forward mode, `torch.autograd.forward_ad`;
  on the binned path through `BinnedGBuffer.jvp`) against the port's
  own central differences on the stable set of `tests/test_grad.py`:
  per pixel |g - fd| <= 5 % |fd| + 0.1; the binned frame also cut in
  two bands, whose tangents and leaf gradients equal the unbanded ones.
- Loss gradients against `jax.grad` of the reference's, leaf by leaf,
  within rtol = 1e-2, atol = 1e-4 (the bar of `tests/test_grad.py:187`),
  on pixels where both packages hit the same sphere (min_t within 1e-4
  relative): a seeded weighted loss on both planes away from grazing
  incidence (|n.d| > 0.5), and the position plane weighted as the
  reference's test weighs it down to |n.d| > 0.2. t = tca -
  sqrt(r^2 - d^2) cancels in f32, so dt/dtheta ~ 1/|n.d| carries each
  package's rounding; on the last grazing pixels XLA's FMA contraction
  puts the reference a little over 1 % away, which
  `test_torch_grad_rounding.py` holds apart.
- The SSAO uniforms and the radius law through `render_frame`, the
  silhouette-region loss, a depth-7 frame whose winners carry hi-lane
  codes, and the no-grad frame (no graph).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from sphereflake_tpu_torch.camera import pixel_grid, ray_directions
from sphereflake_tpu_torch.config import (
    RenderConfig,
    SceneParams,
    default_scene,
)
from sphereflake_tpu_torch.ops import binned as port_binned
from sphereflake_tpu_torch.render import render_frame, render_gbuffer

from _torch_helpers import port_scene

ALGORITHMS = ("binned", "pallas", "fast")
# The position plane weighted as `tests/test_grad.py:171` weighs it.
POSITION_WEIGHTS = 1.0 + 0.1 * np.arange(3, dtype=np.float32)


def _kw(algorithm):
    if algorithm == "binned_banded":
        # Two bands of one 16x64 tile row, the second at y offset 16, as
        # `render._binned_rows` cuts the 4K frame: one `BinnedGBuffer`
        # (forward and recompute) per band.
        return dict(width=64, height=32, max_depth=2, algorithm="binned",
                    tile_h=16, tile_w=64, band_tile_rows=1)
    tile = (
        dict(tile_h=32, tile_w=32)
        if algorithm in ("pallas", "binned")
        else dict(tile_h=16, tile_w=64)
    )
    return dict(width=64, height=32, max_depth=2, max_frontier=128,
                algorithm=algorithm, **tile)


def _cfg(algorithm):
    return RenderConfig(**_kw(algorithm))


def _perturbed(scene, param, x):
    """`scene` with `param` moved by x (a 0-d tensor, possibly dual)."""
    if param == "yaw":
        return dataclasses.replace(scene, camera=dataclasses.replace(
            scene.camera, yaw=scene.camera.yaw + x))
    if param == "position_x":
        unit = torch.tensor([1.0, 0.0, 0.0])
        return dataclasses.replace(scene, camera=dataclasses.replace(
            scene.camera, position=scene.camera.position + unit * x))
    assert param == "radius_ratio"
    return dataclasses.replace(scene, fractal=dataclasses.replace(
        scene.fractal, radius_ratio=scene.fractal.radius_ratio + x))


def _position_jvp(scene, param, cfg):
    """d position / d param per pixel, forward mode."""
    with fwAD.dual_level():
        x = fwAD.make_dual(torch.zeros(()), torch.ones(()))
        gb = render_gbuffer(_perturbed(scene, param, x), cfg, device="cpu")
        tangent = fwAD.unpack_dual(gb.position).tangent
    assert tangent is not None, "no tangent reached the position plane"
    return tangent.numpy()


def _ndotd(scene, gb, cfg):
    xs, ys = pixel_grid(cfg.width, cfg.height, device="cpu")
    dirs = ray_directions(scene.camera, xs, ys, cfg.width, cfg.height)
    return np.abs(torch.sum(gb.normal * dirs, dim=-1).numpy())


@pytest.mark.parametrize("algorithm", ALGORITHMS + ("binned_banded",))
@pytest.mark.parametrize("param", ["yaw", "position_x", "radius_ratio"])
def test_pixel_gradients_match_central_differences(algorithm, param):
    scene = default_scene("cpu")
    cfg = _cfg(algorithm)
    eps = 1e-3

    def plane(x):
        gb = render_gbuffer(
            _perturbed(scene, param, torch.tensor(x)), cfg, device="cpu"
        )
        return gb.position.numpy(), gb.min_t.numpy(), gb.hit.numpy()

    pos_p, t_p, hp = plane(eps)
    pos_m, t_m, hm = plane(-eps)
    gb0 = render_gbuffer(scene, cfg, device="cpu")
    h0 = gb0.hit.numpy()
    tp = np.where(hp, t_p, 0.0)
    tm = np.where(hm, t_m, 0.0)
    t0 = np.where(h0, gb0.min_t.numpy(), 0.0)
    stable = (
        hp & hm & h0
        & (np.abs(tp - tm) < 0.05)
        & (np.abs(tp + tm - 2 * t0) < 1e-3)
        & (_ndotd(scene, gb0, cfg) > 0.2)
    )
    assert stable.sum() > 200
    fd = (pos_p - pos_m) / (2 * eps)
    g = _position_jvp(scene, param, cfg)[stable]
    d = fd[stable]
    ok = np.abs(g - d) <= 0.05 * np.abs(d) + 0.1
    assert ok.all(), (
        f"{param}/{algorithm}: {int((~ok).sum())} of {ok.size} pixel "
        f"gradients disagree (max abs err {np.abs(g - d).max():.4g})"
    )


@pytest.fixture(scope="module")
def reference_loss_grads():
    """Per algorithm: the seeded weights (masked to the pixels both
    packages agree on), and `jax.grad` of the reference's weighted
    G-buffer loss — one reference trace and two backwards per
    algorithm, through `jax.vjp`: the seeded loss on both planes away
    from grazing incidence (|n.d| > 0.5), and the position plane
    weighted as the reference's own test weighs it on every agreed
    pixel with |n.d| > 0.2."""
    import jax
    import jax.numpy as jnp

    from sphereflake_tpu.config import RenderConfig as RefConfig
    from sphereflake_tpu.config import default_scene as ref_default_scene
    from sphereflake_tpu.render import render_gbuffer as ref_render

    ref_scene = ref_default_scene()
    out = {}
    for algorithm in ALGORITHMS:
        ref_cfg = RefConfig(**_kw(algorithm))

        def planes(s):
            gb = ref_render(s, ref_cfg)
            return (gb.position, gb.normal), (gb.hit, gb.min_t)

        _planes, vjp_fn, (hit, min_t) = jax.jit(
            lambda s: jax.vjp(planes, s, has_aux=True)
        )(ref_scene)
        scene = port_scene(ref_scene)
        cfg = _cfg(algorithm)
        gb = render_gbuffer(scene, cfg, device="cpu")
        agreed = (
            np.asarray(hit) & gb.hit.numpy()
            & np.isclose(np.asarray(min_t), gb.min_t.numpy(),
                         rtol=1e-4, atol=0.0)
        )
        ndotd = _ndotd(scene, gb, cfg)
        mask = agreed & (ndotd > 0.5)
        rng = np.random.default_rng(7)
        w = rng.uniform(0.5, 1.5, (2, cfg.height, cfg.width, 3))
        w = (w * mask[None, ..., None] / (cfg.width * cfg.height)).astype(
            np.float32
        )
        pmask = agreed & (ndotd > 0.2)
        wp = (pmask[..., None] * POSITION_WEIGHTS
              / (cfg.width * cfg.height)).astype(np.float32)
        vjp = jax.jit(lambda f, ct: f(ct))
        leaves = lambda ct: [
            np.asarray(g) for g in jax.tree_util.tree_leaves(vjp(vjp_fn, ct)[0])
        ]
        out[algorithm] = dict(
            weighted=(w, mask, leaves((jnp.asarray(w[0]), jnp.asarray(w[1])))),
            position=(wp, pmask,
                      leaves((jnp.asarray(wp), jnp.zeros_like(jnp.asarray(wp))))),
        )
    return out


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_loss_gradient_matches_reference(algorithm, reference_loss_grads):
    from sphereflake_tpu.config import default_scene as ref_default_scene

    w, mask, want = reference_loss_grads[algorithm]["weighted"]
    assert mask.sum() > 300
    scene = port_scene(ref_default_scene())
    leaves = scene.leaves()
    for leaf in leaves:
        leaf.requires_grad_(True)
    gb = render_gbuffer(scene, _cfg(algorithm), device="cpu")
    loss = (
        torch.sum(gb.position * torch.from_numpy(w[0]))
        + torch.sum(gb.normal * torch.from_numpy(w[1]))
    )
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert len(got) == len(want) == 15
    for i, (g, r) in enumerate(zip(got, want)):
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(
            g, r, rtol=1e-2, atol=1e-4, err_msg=f"{algorithm} leaf {i}"
        )
    # The camera and fractal leaves carry signal; ssao none (no post).
    assert all(np.abs(r).max() > 0 for r in want[:4])
    assert all(g is None for g in got[9:])


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_position_loss_gradient_matches_reference_near_grazing(
    algorithm, reference_loss_grads
):
    """The position plane weighted as the reference's own test weighs it
    (1 + 0.1 k), on every pixel both packages hit with the same min_t
    and |n.d| > 0.2: grazing pixels down to 78 degrees from the normal
    count, within rtol = 1e-2, atol = 1e-4. (On the reference's whole
    mask, the last grazing pixels included, the two packages meet that
    bar only with XLA's FMA contraction off:
    `test_torch_grad_rounding.py`.)"""
    from sphereflake_tpu.config import default_scene as ref_default_scene

    wp, pmask, want = reference_loss_grads[algorithm]["position"]
    _w, mask, _want = reference_loss_grads[algorithm]["weighted"]
    assert pmask.sum() > mask.sum() + 100
    scene = port_scene(ref_default_scene())
    leaves = scene.leaves()
    for leaf in leaves:
        leaf.requires_grad_(True)
    gb = render_gbuffer(scene, _cfg(algorithm), device="cpu")
    loss = torch.sum(gb.position * torch.from_numpy(wp))
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    for i, (g, r) in enumerate(zip(got, want)):
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(
            g, r, rtol=1e-2, atol=1e-4, err_msg=f"{algorithm} leaf {i}"
        )
    assert all(np.abs(r).max() > 0 for r in want[:4])


def test_banded_gradients_equal_unbanded():
    """The banded binned frame (two bands, the second at y offset 16)
    against the same frame in one block: the forward planes and the
    per-pixel tangents of yaw, position_x and radius_ratio (each band's
    `BinnedGBuffer.jvp`, its recompute's rays offset by the band) equal
    bit for bit, and the leaf gradients of a seeded loss (each band's
    backward, summed) within rtol = 1e-5, atol = 1e-7 — the order of
    the pixel sum is all that differs."""
    one = RenderConfig(**dict(_kw("binned_banded"), band_tile_rows=None))
    banded = _cfg("binned_banded")
    assert banded.effective_band_rows == 1 and banded.tiles_y == 2
    scene = default_scene("cpu")
    g1 = render_gbuffer(scene, one, device="cpu")
    gb = render_gbuffer(scene, banded, device="cpu")
    assert torch.equal(g1.position, gb.position)
    assert torch.equal(g1.min_t, gb.min_t)
    assert g1.hit[16:].sum() > 100  # the second band has hits
    for param in ("yaw", "position_x", "radius_ratio"):
        np.testing.assert_array_equal(
            _position_jvp(scene, param, banded),
            _position_jvp(scene, param, one), err_msg=param,
        )
    w = torch.from_numpy(np.random.default_rng(3).uniform(
        0.5, 1.5, (2, one.height, one.width, 3)).astype(np.float32))

    def grads(cfg):
        leaves = default_scene("cpu").leaves()
        for leaf in leaves:
            leaf.requires_grad_(True)
        gb = render_gbuffer(SceneParams.from_leaves(leaves), cfg, device="cpu")
        loss = (torch.sum(gb.position * w[0])
                + torch.sum(gb.normal * w[1])) / (cfg.width * cfg.height)
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    with_grad = []
    for i, (a, b) in enumerate(zip(grads(banded), grads(one))):
        assert (a is None) == (b is None), i
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=f"leaf {i}")
            with_grad.append(i)
    assert with_grad == list(range(9))  # camera and fractal; ssao none


@pytest.mark.parametrize("param", ["intensity", "scale", "bias"])
def test_ssao_param_gradients_match_central_differences(param):
    """Through the full composite (trace -> SSAO -> blur -> final)."""
    scene = default_scene("cpu")
    cfg = _cfg("fast")

    def perturb(x):
        return dataclasses.replace(scene, ssao=dataclasses.replace(
            scene.ssao, **{param: getattr(scene.ssao, param) + x}))

    def loss(x):
        image, _ = render_frame(perturb(x), cfg, device="cpu")
        return torch.sum(image * image)

    eps = 1e-2
    fd = (float(loss(torch.tensor(eps))) - float(loss(torch.tensor(-eps)))) / (
        2 * eps
    )
    x = torch.zeros((), requires_grad=True)
    (g,) = torch.autograd.grad(loss(x), x)
    assert np.isclose(float(g), fd, rtol=3e-2, atol=1e-3), (param, float(g), fd)
    assert float(g) != 0.0


def test_closest_distance_carries_gradient():
    """The radius law's input (SSAO sample radius = multiplier x the
    frame's closest distance) is differentiable in the camera pose. The
    radius only places nearest-texel taps, so — as in the reference —
    it adds no gradient to the image itself."""
    scene = default_scene("cpu")
    pos = scene.camera.position.clone().requires_grad_(True)
    sc = dataclasses.replace(
        scene, camera=dataclasses.replace(scene.camera, position=pos)
    )
    _image, gb = render_frame(sc, _cfg("binned"), device="cpu")
    (g,) = torch.autograd.grad(gb.metrics.closest_distance, pos)
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0.0


def test_silhouette_region_gradient_matches_fd():
    """The region-integrated loss over an 8x8 window straddling a
    silhouette: autograd of the summed loss against central FD of the
    same scalar at eps = 1e-4 (rtol 5 %), and a step against the
    gradient lowers the loss (`tests/test_grad.py`, the region test)."""
    scene = default_scene("cpu")
    cfg = _cfg("binned")
    tgt_pos = render_gbuffer(
        _perturbed(scene, "yaw", torch.tensor(0.02)), cfg, device="cpu"
    ).position
    hit = render_gbuffer(scene, cfg, device="cpu").hit.numpy()
    window = None
    for y0 in range(0, cfg.height - 8, 4):
        for x0 in range(0, cfg.width - 8, 4):
            if 0.3 <= hit[y0:y0 + 8, x0:x0 + 8].mean() <= 0.7:
                window = (y0, x0)
                break
        if window:
            break
    assert window is not None
    y0, x0 = window

    def loss(dyaw):
        gb = render_gbuffer(_perturbed(scene, "yaw", dyaw), cfg, device="cpu")
        w = gb.position[y0:y0 + 8, x0:x0 + 8]
        t = tgt_pos[y0:y0 + 8, x0:x0 + 8]
        return torch.sum((w - t) ** 2)

    eps = 1e-4
    fd = (float(loss(torch.tensor(eps))) - float(loss(torch.tensor(-eps)))) / (
        2 * eps
    )
    x = torch.zeros((), requires_grad=True)
    (g,) = torch.autograd.grad(loss(x), x)
    g = float(g)
    assert np.isclose(g, fd, rtol=0.05), (g, fd)
    l0 = float(loss(torch.tensor(0.0)))
    l1 = float(loss(torch.tensor(-1e-4 * float(np.sign(g)))))
    assert l1 < l0, (l0, l1)


def test_binned_gradients_flow():
    scene = default_scene("cpu")
    leaves = scene.leaves()
    for leaf in leaves:
        leaf.requires_grad_(True)
    cfg = _cfg("binned")
    gb = render_gbuffer(scene, cfg, device="cpu")
    loss = torch.sum(gb.position) / (cfg.width * cfg.height)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    total = sum(float(g.abs().sum()) for g in got if g is not None)
    assert np.isfinite(total) and total > 0.0
    # The graph reaches the leaves through the Function's node.
    assert "BinnedGBufferBackward" in _graph_names(gb.position)


def _graph_names(t):
    seen, stack, names = set(), [t.grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


def test_forward_grad_switch_is_there():
    """`BinnedGBuffer.jvp` switches forward grad back on (a custom
    Function's jvp runs with it off) through the private
    `torch.autograd.forward_ad._set_fwd_grad_enabled`, checked on torch
    2.11 and 2.13. A release that drops or changes it fails here, by
    name, before the forward-mode gradient tests do."""
    switch = getattr(fwAD, "_set_fwd_grad_enabled", None)
    assert switch is not None, (
        "torch.autograd.forward_ad._set_fwd_grad_enabled is gone: "
        "BinnedGBuffer.jvp needs another way to enable forward grad"
    )
    with fwAD.dual_level():
        x = fwAD.make_dual(torch.ones(()), torch.full((), 2.0))
        with switch(False):
            assert fwAD.unpack_dual(x * 3.0).tangent is None
        with switch(True):
            assert float(fwAD.unpack_dual(x * 3.0).tangent) == 6.0


@pytest.fixture(scope="module")
def deep_frame():
    """A depth-7 binned frame at the dive pose (winners at level 7 carry
    hi-lane codes), its codes, and the pallas frame of the same pose."""
    from test_binned import dive_scene

    scene = port_scene(dive_scene())
    kw = dict(width=64, height=32, max_depth=7, tile_h=32, tile_w=32,
              global_cap=1 << 15)
    cfg = RenderConfig(algorithm="binned", **kw)
    outs = port_binned._gbuffer_primal(cfg, port_binned.band_fronts(
        scene, cfg, cfg.width, cfg.height, 0.0, [0.0])[0])
    return scene, cfg, RenderConfig(algorithm="pallas", **kw), outs


def test_depth7_recompute_resolves_the_hi_lane(deep_frame):
    """The backward's recompute passes the hi lane: from the kernel's
    (lo, hi) codes it re-derives the kernel's own hits and distances,
    level-7 winners included."""
    scene, cfg, _pcfg, outs = deep_frame
    lo, hi = outs[8], outs[9]
    assert int((hi >= 1).sum()) > 50  # level-7 winners present
    rec = port_binned._gbuffer_recompute(
        cfg, cfg.width, cfg.height, scene, (0.0, 0.0), lo, hi
    )
    hit = (lo >= 1) | (hi >= 1)
    deep = hi >= 1
    for k, (a, b) in enumerate(zip(rec[:4], outs[:4])):
        close = torch.isclose(a, b, rtol=1e-4, atol=1e-5)
        assert float(close[hit].float().mean()) >= 0.995, k
        assert float(close[deep].float().mean()) >= 0.995, k


def test_depth7_gradient_matches_pallas_path(deep_frame):
    """Per-pixel yaw tangents of the binned recompute (the surface
    `BinnedGBuffer` differentiates, fed the kernel's lo and hi codes)
    equal the pallas frame's (one-lane codes) on the pixels where both
    paths hit the same sphere (distances within 1e-5 relative) —
    level-7 winners included."""
    from sphereflake_tpu_torch.render import _untile

    scene, cfg, pcfg, outs = deep_frame
    T = cfg.tiles_x * cfg.tiles_y
    with fwAD.dual_level():
        x = fwAD.make_dual(torch.zeros(()), torch.ones(()))
        rec = port_binned._gbuffer_recompute(
            cfg, cfg.width, cfg.height, _perturbed(scene, "yaw", x),
            (0.0, 0.0), outs[8], outs[9],
        )
        tb = np.stack([
            _untile(fwAD.unpack_dual(c).tangent.reshape(T, 1024), cfg)
            .numpy() for c in rec[1:4]
        ], axis=-1)
        gb = render_gbuffer(_perturbed(scene, "yaw", x), pcfg, device="cpu")
        tp = fwAD.unpack_dual(gb.position).tangent.numpy()
    mb = _untile(outs[0].reshape(T, 1024), cfg).numpy()
    deep = _untile(outs[9].reshape(T, 1024), cfg).numpy() >= 1
    same = (gb.hit.numpy() & (mb < 1e30)
            & np.isclose(mb, gb.min_t.numpy(), rtol=1e-5, atol=0.0))
    assert same.sum() > 500 and (same & deep).sum() > 50
    np.testing.assert_allclose(tb[same], tp[same], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_no_grad_frame_builds_no_graph(algorithm):
    cfg = _cfg(algorithm)
    scene = default_scene("cpu")
    image, gb = render_frame(scene, cfg, device="cpu")
    for t in (image, gb.position, gb.normal, gb.min_t):
        assert t.grad_fn is None and not t.requires_grad
    for leaf in scene.leaves():
        leaf.requires_grad_(True)
    with torch.no_grad():
        image, gb = render_frame(scene, cfg, device="cpu")
    assert image.grad_fn is None and gb.position.grad_fn is None
    image, gb = render_frame(scene, cfg, device="cpu")
    assert image.requires_grad and gb.position.requires_grad
