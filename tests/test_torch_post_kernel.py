"""The post chain's kernels (`sphereflake_tpu_torch/ops/post.py`,
`csrc/post_kernel.cu`) as far as the CPU reaches them: the routing, the
wrapper's f32 arguments, its refusals, and the plain versions' block and
fused forms that the kernels repeat. The kernels themselves are held
against the plain versions bit for bit on the card (`chip_smoke.py`'s
`kernel_vs_plain` lines with `kernel` = `post_kernel`).

- Routing: CPU tensors take the plain version (no launch, no `post.kernel`
  count); inputs that autograd or forward-mode AD must see are recognised
  as such, and the frame's image stays differentiable in the G-buffer and
  in every SSAO uniform and the camera.
- The constants the wrapper passes are the f32 values the plain version's
  wrapped Python scalars take.
- The wrapper refuses a wrong dtype, a non-contiguous or mis-shaped plane,
  a block outside its target and a CPU tensor, before anything is built.
- A block of each pass equals the same rows and columns of the whole
  target's pass; the fused vertical blur and composite equal the vertical
  blur followed by the composite's shading; `postprocess` equals the chain
  of passes.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from sphereflake_tpu_torch import spans
from sphereflake_tpu_torch.config import RenderConfig, default_scene
from sphereflake_tpu_torch.ops import post
from sphereflake_tpu_torch.ops.noise import ssao_noise_texture
from sphereflake_tpu_torch.render import render_frame, render_gbuffer

import _torch_helpers  # noqa: F401  (one intra-op thread per worker)

W, H = 128, 64


def _cfg(**over):
    return RenderConfig(width=W, height=H, max_depth=2, tile_h=32, tile_w=32,
                        algorithm="binned", **over)


@pytest.fixture(scope="module")
def frame():
    """A rendered G-buffer, the noise texture and the scene (CPU)."""
    scene = default_scene("cpu")
    with torch.no_grad():
        gb = render_gbuffer(scene, _cfg(), device="cpu")
    noise = torch.from_numpy(ssao_noise_texture(64))
    return dict(scene=scene, gb=gb, noise=noise,
                radius=(scene.ssao.radius_multiplier,
                        gb.metrics.closest_distance))


def test_cpu_tensors_take_the_plain_version(frame, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel's wrapper")

    monkeypatch.setattr(post, "_launch_ssao", refuse)
    monkeypatch.setattr(post, "_launch_blur", refuse)
    gb, scene = frame["gb"], frame["scene"]
    before = post.post_kernel.launches
    with spans.unit("post_kernel_test"):
        img = post.postprocess(gb.position, gb.normal,
                               gb.metrics.closest_distance, scene, _cfg(),
                               frame["noise"])
    counts = spans.records("post_kernel_test")[-1]["counts"]
    assert post.post_kernel.launches == before
    assert "post.kernel" not in counts
    assert img.shape == (H, W, 3) and torch.isfinite(img).all()


def test_differentiable_inputs_are_recognised():
    x, y = torch.ones(3), torch.ones(3, requires_grad=True)
    assert not post._differentiable(x, x)
    assert post._differentiable(x, y)
    with torch.no_grad():
        assert not post._differentiable(x, y)
    with fwAD.dual_level():
        dual = fwAD.make_dual(torch.ones(3), torch.ones(3))
        assert post._differentiable(x, dual)
        with torch.no_grad():
            assert post._differentiable(dual)
    assert not post._on_kernel(x)  # a CPU tensor never runs the kernel


def test_frame_image_is_differentiable_in_every_ssao_uniform():
    """The eager path keeps `render_frame`'s promise: the image reaches
    the G-buffer's leaves, the SSAO uniforms the shaders weigh and the
    camera; the gates' thresholds and the radius only choose taps."""
    scene = default_scene("cpu")
    leaves = scene.leaves()
    for leaf in leaves:
        leaf.requires_grad_(True)
    image, _ = render_frame(scene, _cfg(), device="cpu")
    image.sum().backward()
    names = [f"{g.name}.{f.name}" for g in dataclasses.fields(scene)
             for f in dataclasses.fields(getattr(scene, g.name))]
    for name, leaf in zip(names, leaves):
        if name.split(".")[1] in ("normal_threshold", "depth_threshold",
                                  "radius_multiplier"):
            continue
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all(), name
        assert leaf.grad.abs().sum() > 0, name


def test_forward_mode_tangent_passes_the_post(frame):
    gb, scene = frame["gb"], frame["scene"]
    with fwAD.dual_level():
        pos = fwAD.make_dual(gb.position, torch.ones_like(gb.position))
        img = post.postprocess(pos, gb.normal, gb.metrics.closest_distance,
                               scene, _cfg(), frame["noise"])
        tangent = fwAD.unpack_dual(img).tangent
    assert tangent is not None and tangent.abs().sum() > 0


def test_ssao_constants_are_the_plain_versions_f32_scalars():
    one, zero = torch.ones(()), torch.zeros(())
    c0707, c01, eps, rmax = post.ssao_constants()
    assert c0707 == (one * 0.707).item()
    assert c01 == (one * 0.1).item()
    assert eps == torch.clamp_min(zero, 1e-20).item()
    assert rmax == torch.clamp_max(torch.full((), 3e38), 1e30).item()


@pytest.mark.parametrize("direction", [(1.0, 0.0), (0.0, 1.0)],
                         ids=["h", "v"])
@pytest.mark.parametrize("size", [(64, 128), (1080, 1920), (16384, 16384)],
                         ids=["small", "1080p", "16k"])
def test_blur_constants_are_the_plain_versions_f32_scalars(direction, size):
    out_h, out_w = size
    w0, w1, w2, o1x, o1y, o2x, o2y = post.blur_constants(direction, out_h,
                                                         out_w)
    zero = torch.zeros(())
    assert w0 == (zero + post._BLUR_WEIGHT[0]).item()
    assert w1 == torch.full_like(zero, post._BLUR_WEIGHT[1]).item()
    assert w2 == (torch.ones(()) * post._BLUR_WEIGHT[2]).item()
    dx, dy = direction
    for off, ox, oy in zip(post._BLUR_OFFSET, (o1x, o2x), (o1y, o2y)):
        for sign in (1.0, -1.0):
            # the plain version adds sign * (d * off / size) to the uv
            assert sign * ox == (zero + sign * (dx * off / out_w)).item()
            assert sign * oy == (zero + sign * (dy * off / out_h)).item()


def test_block_fragcoord_is_the_kernels_arithmetic():
    fx, fy = post.block_fragcoord(3, 5, 8192, 4096, "cpu")
    x = np.arange(5, dtype=np.float32)
    y = np.arange(3, dtype=np.float32)
    np.testing.assert_array_equal(
        fx[0].numpy(), (x + np.float32(0.5)) + np.float32(4096))
    np.testing.assert_array_equal(
        fy[:, 0].numpy(), (y + np.float32(0.5)) + np.float32(8192))


def _planes(h=8, w=16):
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.normal(size=(h, w, 3)).astype(np.float32))
    nrm = torch.from_numpy(rng.normal(size=(h, w, 3)).astype(np.float32))
    return pos, nrm


@pytest.mark.parametrize(
    "case, error, match",
    [
        ("dtype", TypeError, "position must be torch.float32"),
        ("non_contiguous", ValueError, "normal must be contiguous"),
        ("shape", ValueError, "normal must have shape"),
        ("noise_shape", ValueError, "noise must have shape"),
        ("radius", ValueError, "sample_radius.0. must have shape"),
        ("block", ValueError, "does not lie in"),
        ("cpu", ValueError, "runs on cuda"),
    ],
    ids=lambda v: v if isinstance(v, str) and " " not in v else "",
)
def test_ssao_wrapper_refuses(case, error, match):
    pos, nrm = _planes()
    noise = torch.zeros(4, 4, 4)
    params = default_scene("cpu").ssao
    radius = (params.radius_multiplier, torch.tensor(1.0))
    block = None
    if case == "dtype":
        pos = pos.double()
    elif case == "non_contiguous":
        nrm = nrm.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "shape":
        nrm = nrm[:4].contiguous()
    elif case == "noise_shape":
        noise = torch.zeros(4, 4, 3)
    elif case == "radius":
        radius = (torch.ones(1), torch.tensor(1.0))
    elif case == "block":
        block = (4, 8, 8, 8)  # rows 4..12 of an 8-row target
    with pytest.raises(error, match=match):
        post._launch_ssao(pos, nrm, noise, params, radius, 8, 16, block)


@pytest.mark.parametrize(
    "case, error, match",
    [
        ("dtype", TypeError, "source must be torch.float32"),
        ("source_dims", ValueError, "source must have shape"),
        ("shape", ValueError, "normal must have shape"),
        ("camera", ValueError, "camera_position must have shape"),
        ("block", ValueError, "does not lie in"),
        ("cpu", ValueError, "runs on cuda"),
    ],
    ids=lambda v: v if isinstance(v, str) and " " not in v else "",
)
def test_blur_wrapper_refuses(case, error, match):
    pos, nrm = _planes()
    source = torch.zeros(8, 16)
    cam = torch.zeros(3)
    params = default_scene("cpu").ssao
    block = None
    if case == "dtype":
        source = source.half()
    elif case == "source_dims":
        source = torch.zeros(8, 16, 1)
    elif case == "shape":
        pos = pos[:, :8].contiguous()
    elif case == "camera":
        cam = torch.zeros(4)
    elif case == "block":
        block = (0, 0, 0, 16)
    with pytest.raises(error, match=match):
        post._launch_blur(source, pos, nrm, params, (0.0, 1.0), 8, 16, block,
                          cam)


@pytest.mark.parametrize("downscale", [1, 2])
def test_a_block_of_each_pass_is_the_whole_targets_block(frame, downscale):
    """What a mesh cell evaluates: rows y0.. and columns x0.. of each
    pass equal those of the whole target's pass, bit for bit."""
    gb, p = frame["gb"], frame["scene"].ssao
    pos, nrm, noise, radius = gb.position, gb.normal, frame["noise"], \
        frame["radius"]
    cam = frame["scene"].camera.position
    sh, sw = H // downscale, W // downscale
    y0, x0, bh, bw = 32, 64, 32, 64
    sblock = tuple(v // downscale for v in (y0, x0, bh, bw))
    ao = post.ssao_pass(pos, nrm, noise, p, radius, sh, sw)
    got = post.ssao_pass(pos, nrm, noise, p, radius, sh, sw, block=sblock)
    sy, sx = sblock[0], sblock[1]
    assert torch.equal(got, ao[sy:sy + sblock[2], sx:sx + sblock[3]])
    aoh = post.blur_pass(ao, pos, nrm, p, (1.0, 0.0), H, W)
    got = post.blur_pass(ao, pos, nrm, p, (1.0, 0.0), H, W,
                         block=(y0, x0, bh, bw))
    assert torch.equal(got, aoh[y0:y0 + bh, x0:x0 + bw])
    img = post.blur_composite_pass(aoh, pos, nrm, p, cam, H, W)
    got = post.blur_composite_pass(aoh, pos, nrm, p, cam, H, W,
                                   block=(y0, x0, bh, bw))
    assert torch.equal(got, img[y0:y0 + bh, x0:x0 + bw])


@pytest.mark.parametrize("gate", ["shipped", "open"])
def test_fused_blur_composite_equals_the_two_passes(frame, gate):
    gb, scene = frame["gb"], frame["scene"]
    p = scene.ssao
    if gate == "open":  # a passable gate, so both branches run
        p = dataclasses.replace(p, normal_threshold=torch.tensor(-2.0),
                                depth_threshold=torch.tensor(0.05))
    src = torch.from_numpy(
        np.random.default_rng(4).random((H, W)).astype(np.float32))
    cam = scene.camera.position
    fused = post.blur_composite_pass(src, gb.position, gb.normal, p, cam, H, W)
    apart = post._shade(
        gb.position,
        post.blur_pass(src, gb.position, gb.normal, p, (0.0, 1.0), H, W),
        cam)
    assert torch.equal(fused, apart)


@pytest.mark.parametrize("downscale", [1, 2])
def test_postprocess_is_the_chain_of_passes(frame, downscale):
    gb, scene = frame["gb"], frame["scene"]
    cfg = _cfg(ssao_downscale=downscale)
    sh, sw = H // downscale, W // downscale
    p, pos, nrm = scene.ssao, gb.position, gb.normal
    ao = post.ssao_pass(pos, nrm, frame["noise"], p, frame["radius"], sh, sw)
    ao = post.blur_pass(ao, pos, nrm, p, (1.0, 0.0), H, W)
    ao = post.blur_pass(ao, pos, nrm, p, (0.0, 1.0), H, W)
    want = post._shade(pos, ao, scene.camera.position)
    got = post.postprocess(pos, nrm, gb.metrics.closest_distance, scene, cfg,
                           frame["noise"])
    assert torch.equal(got, want)


def test_channel_sums_run_in_channel_order():
    x = torch.tensor([[1e8, 1.0, -1e8]], dtype=torch.float32)
    # (1e8 + 1) + -1e8 = 0 in f32; another order would give 1
    assert post._csum(x).item() == 0.0
    assert post._csum(x[:, :2]).item() == np.float32(1e8) + np.float32(1.0)
