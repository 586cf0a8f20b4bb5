"""Post-processing: SSAO, edge-aware separable blur, final composite.

Plain-torch counterparts of the reference package's `ops/post.py`
(re-implementations of the C++ app's GLSL passes), orchestrated the
same way as `SSAO::Render()` (`SSAO.cpp:106-142`) and the final pass of
`main.cpp:301-335`:

    G-buffer -> SSAO (at size/downscale) -> horizontal blur -> vertical
    blur -> composite

Intermediates stay f32 (the C++ app quantizes AO to 8 bits in its FBO
textures); everything else follows the shaders tap for tap, including
the near-identity behavior of the blur gate with the shipped
normalThreshold=2.47 (`post_ssao_blur.glsl:46-55`: a unit normal dot
can never reach it — mechanism preserved, quirk documented).

Each pass has a hand-written CUDA kernel (`csrc/post_kernel.cu`) beside
its plain version (`_ssao_plain`, `_blur_plain`, `_blur_composite_plain`);
the vertical blur and the composite are one pass, `blur_composite_pass`.
Which runs is decided by the inputs alone:

- CUDA tensors that neither autograd (grad mode on and an input that
  requires grad) nor forward-mode AD (an input with a tangent) has to
  see: the kernel, one launch a pass, counted in `post_kernel.launches`
  and by the span counter `post.kernel`;
- anything else (CPU tensors, the differentiable frame that
  `render_frame` promises and `fit(loss="image")` uses): the plain
  version, differentiable in every input.

The kernel equals the plain version bit for bit: the plain version sums
channels in a fixed order, (x0 + x1) + x2, where `torch.sum` would take
its own on CUDA. Divisions by the target size use 0-d device tensors,
not Python numbers: torch turns `tensor / python_number` into a multiply
by the reciprocal on CUDA, which can move a NEAREST tap by one texel;
the kernel divides with IEEE division too.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd import forward_ad

from sphereflake_tpu_torch import kernels, spans
from sphereflake_tpu_torch.config import RenderConfig, SSAOParams, SceneParams
from sphereflake_tpu_torch.ops.texture import (
    sample_bilinear_clamp,
    sample_bilinear_repeat,
    sample_nearest_clamp,
)

# post_ssao.glsl:15 — the 4 kernel directions (a NumPy constant, turned
# into a tensor on the call's device; the kernel's `kDirX`, `kDirY`).
_KERNEL = np.asarray(
    [[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]], np.float32
)
# post_ssao_blur.glsl:9-10 — 5-tap gaussian as center + 2 mirrored taps
_BLUR_OFFSET = (1.3846153846, 3.2307692308)
_BLUR_WEIGHT = (0.2270270270, 0.3162162162, 0.0702702703)


def _f32(x: float) -> float:
    """A Python double rounded once to f32, as torch rounds a wrapped
    scalar operand of an f32 tensor."""
    return float(np.float32(x))


def _fragcoord(h: int, w: int, device):
    """gl_FragCoord.xy for every pixel of an h x w target: (x+0.5, y+0.5)."""
    y, x = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device) + 0.5,
        torch.arange(w, dtype=torch.float32, device=device) + 0.5,
        indexing="ij",
    )
    return x, y


def block_fragcoord(bh: int, bw: int, y0, x0, device):
    """Fragcoords of a [bh, bw] block whose top-left pixel sits at
    (x0, y0) of the full target — a post pass can evaluate one block of
    the same full-resolution shader."""
    fx, fy = _fragcoord(bh, bw, device)
    return fx + float(x0), fy + float(y0)


def _frag(out_h: int, out_w: int, block, device):
    """The fragcoords a pass evaluates: the whole target, or `block` =
    (y0, x0, bh, bw) of it."""
    if block is None:
        return _fragcoord(out_h, out_w, device)
    y0, x0, bh, bw = block
    return block_fragcoord(bh, bw, y0, x0, device)


def _csum(x):
    """Sum over the last (channel) dim in channel order, (x0 + x1) + x2:
    the kernel's order."""
    s = x[..., 0]
    for c in range(1, x.shape[-1]):
        s = s + x[..., c]
    return s


def _reflect(incident, normal):
    """GLSL reflect(I, N) = I - 2*dot(N, I)*N, batched over [..., 2]."""
    d = _csum(incident * normal)[..., None]
    return incident - 2.0 * d * normal


def _size(out_h: int, out_w: int, like):
    """(out_w, out_h) as 0-d f32 tensors on `like`'s device."""
    return like.new_tensor(float(out_w)), like.new_tensor(float(out_h))


def _differentiable(*tensors) -> bool:
    """Whether autograd (grad mode on and an input that requires grad) or
    forward-mode AD (an input with a tangent) has to see a pass."""
    grad = torch.is_grad_enabled()
    return any(
        (grad and t.requires_grad)
        or forward_ad.unpack_dual(t).tangent is not None
        for t in tensors
    )


def _on_kernel(*tensors) -> bool:
    """Whether a pass over `tensors` runs its kernel: they lie on a CUDA
    device and are not `_differentiable`."""
    return tensors[0].device.type == "cuda" and not _differentiable(*tensors)


def ssao_pass(
    position,
    normal,
    noise,
    params: SSAOParams,
    sample_radius,
    out_h: int,
    out_w: int,
    block=None,
):
    """`post_ssao.glsl` on the whole image -> AO [out_h, out_w].

    position/normal: [H, W, 3] G-buffer planes (full resolution; sampled
    NEAREST like the C++ app's G-buffer textures). The SSAO target may
    be smaller (downScale, `SSAO.cpp:58`). `sample_radius`: the pair of
    0-d tensors whose product is the radius (the radius law's multiplier
    and the closest distance, `SSAO.h:15-18`: the kernel multiplies them
    itself, so the frame needs no launch for it).

    `block` = (y0, x0, bh, bw) evaluates only that block of the
    (out_h, out_w) target -> AO [bh, bw]; out_h/out_w keep their
    full-target meaning for the uv normalization either way.
    """
    if _on_kernel(position, normal, noise, params.intensity, params.scale,
                  params.bias, *sample_radius):
        return _launch_ssao(position.contiguous(), normal.contiguous(),
                            noise.contiguous(), params, sample_radius, out_h,
                            out_w, block)
    return _ssao_plain(position, normal, noise, params, sample_radius, out_h,
                       out_w, block)


def _ssao_plain(position, normal, noise, params, radius, out_h, out_w,
                block):
    dev = position.device
    fx, fy = _frag(out_h, out_w, block, dev)
    fb_w, fb_h = _size(out_h, out_w, position)
    uv_x, uv_y = fx / fb_w, fy / fb_h
    multiplier, distance = radius
    sample_radius = multiplier * distance

    pos = sample_nearest_clamp(position, uv_x, uv_y)  # [h, w, 3]
    nrm = sample_nearest_clamp(normal, uv_x, uv_y)
    sky = _csum(pos * pos) == 0.0  # length(position)==0 (:33)

    # rad = SSAOSampleRadius / sqrt(|position.z|)  (:42), held finite: an
    # all-sky frame's radius law gives the multiplier times the 3e38 miss
    # sentinel, whose taps would be inf * 0 = NaN and index the G-buffer
    # out of bounds. Only sky pixels, written black below, ever reach the
    # bound.
    rad = torch.clamp_max(sample_radius / torch.sqrt(
        torch.clamp_min(torch.abs(pos[..., 2]), 1e-20)
    ), 1e30)

    # random reflection vector from the LINEAR+REPEAT noise texture (:44)
    nz = sample_bilinear_repeat(noise, uv_x * 0.1, uv_y * 0.1)[..., :2]
    nz = nz * 2.0 - 1.0
    nz = nz / torch.sqrt(torch.clamp_min(_csum(nz * nz)[..., None], 1e-20))

    def occlude(off_x, off_y):
        """`occlude()` (:19-25): offset in SSAO-target pixels."""
        su = (fx + off_x) / fb_w
        sv = (fy + off_y) / fb_h
        sample_pos = sample_nearest_clamp(position, su, sv)
        diff = sample_pos - pos
        dist2 = _csum(diff * diff)
        dist = torch.sqrt(torch.clamp_min(dist2, 1e-20))
        d = _csum(nrm * diff) / dist
        occ = torch.clamp_min(d - params.bias, 0.0)
        occ = occ * (1.0 / (1.0 + dist2 * params.scale)) * params.intensity
        return torch.where(dist2 > 0, occ, torch.zeros_like(occ))

    kernel = torch.from_numpy(_KERNEL).to(dev)
    ao = torch.zeros_like(fx)
    for i in range(4):
        coord1 = _reflect(kernel[i].expand(nz.shape), nz) * rad[..., None]
        c2x = coord1[..., 0] * 0.707 - coord1[..., 1] * 0.707
        c2y = coord1[..., 0] * 0.707 + coord1[..., 1] * 0.707
        ao = ao + occlude(coord1[..., 0] * 0.25, coord1[..., 1] * 0.25)
        ao = ao + occlude(coord1[..., 0] * 0.75, coord1[..., 1] * 0.75)
        ao = ao + occlude(c2x * 0.5, c2y * 0.5)
        ao = ao + occlude(c2x, c2y)

    ao = 1.0 - ao / 16.0  # (:58-59)
    return torch.where(sky, torch.zeros_like(ao), ao)  # sky writes black (:33-37)


def blur_pass(
    source,
    position,
    normal,
    params: SSAOParams,
    direction: tuple[float, float],
    out_h: int,
    out_w: int,
    block=None,
):
    """`post_ssao_blur.glsl`: depth/normal-gated separable gaussian.

    source: [h, w] AO plane (LINEAR-filtered like the FBO texture it
    replaces); position/normal: full-res G-buffer (NEAREST).
    `block` evaluates a block of the full target (see `ssao_pass`).
    """
    if _on_kernel(source, position, normal, params.normal_threshold,
                  params.depth_threshold):
        return _launch_blur(source.contiguous(), position.contiguous(),
                            normal.contiguous(), params, direction, out_h,
                            out_w, block)
    return _blur_plain(source, position, normal, params, direction, out_h,
                       out_w, block)


def _blur_plain(source, position, normal, params, direction, out_h, out_w,
                block):
    dev = position.device
    fx, fy = _frag(out_h, out_w, block, dev)
    fb_w, fb_h = _size(out_h, out_w, position)
    uv_x, uv_y = fx / fb_w, fy / fb_h

    pos = sample_nearest_clamp(position, uv_x, uv_y)
    nrm = sample_nearest_clamp(normal, uv_x, uv_y)

    dx, dy = direction
    color = torch.zeros_like(fx)
    leftover = torch.zeros_like(fx)

    for i in (1, 2):
        off = _BLUR_OFFSET[i - 1]
        wgt = _BLUR_WEIGHT[i]
        ox, oy = dx * off / out_w, dy * off / out_h  # normalized offsets
        for sign in (1.0, -1.0):
            su, sv = uv_x + sign * ox, uv_y + sign * oy
            s_pos = sample_nearest_clamp(position, su, sv)
            s_nrm = sample_nearest_clamp(normal, su, sv)
            gate = (_csum(nrm * s_nrm) >= params.normal_threshold) & (
                torch.abs(s_pos[..., 2] - pos[..., 2]) >= params.depth_threshold
            )
            tap = sample_bilinear_clamp(source, su, sv)
            color = color + torch.where(gate, tap * wgt, torch.zeros_like(tap))
            leftover = leftover + torch.where(
                gate, torch.zeros_like(tap), torch.full_like(tap, wgt)
            )

    center = sample_bilinear_clamp(source, uv_x, uv_y)
    return color + center * (_BLUR_WEIGHT[0] + leftover)


def _shade(pos, ao, camera_position):
    """`post_final.glsl` on sampled planes: sky -> black; else
    (0.5 + 0.5*(position + cameraPosition)) * ssao."""
    sky = _csum(pos * pos) == 0.0
    color = (0.5 + 0.5 * (pos + camera_position)) * ao[..., None]
    return torch.where(sky[..., None], torch.zeros_like(color), color)


def blur_composite_pass(
    source,
    position,
    normal,
    params: SSAOParams,
    camera_position,
    out_h: int,
    out_w: int,
    block=None,
):
    """The vertical blur and the composite in one pass -> the RGB image
    [out_h, out_w, 3] (or its `block`, see `ssao_pass`).

    The composite samples the blurred AO NEAREST at the pixel's own
    texel (the target is full resolution: floor(((x + 0.5) / W) * W) = x
    for every x < 2^22), so it reads the blur's value at the same pixel;
    the block needs no other pixel's blur."""
    if _on_kernel(source, position, normal, params.normal_threshold,
                  params.depth_threshold, camera_position):
        return _launch_blur(source.contiguous(), position.contiguous(),
                            normal.contiguous(), params, (0.0, 1.0), out_h,
                            out_w, block, camera_position.contiguous())
    return _blur_composite_plain(source, position, normal, params,
                                 camera_position, out_h, out_w, block)


def _blur_composite_plain(source, position, normal, params, camera_position,
                          out_h, out_w, block):
    ao = _blur_plain(source, position, normal, params, (0.0, 1.0), out_h,
                     out_w, block)
    fx, fy = _frag(out_h, out_w, block, position.device)
    fb_w, fb_h = _size(out_h, out_w, position)
    pos = sample_nearest_clamp(position, fx / fb_w, fy / fb_h)
    return _shade(pos, ao, camera_position)


# ---- the kernels' wrappers ---------------------------------------------


def ssao_constants() -> tuple:
    """The SSAO kernel's f32 arguments (0.707, 0.1, 1e-20, 1e30): each
    the value the plain version's wrapped scalar takes."""
    return tuple(_f32(x) for x in (0.707, 0.1, 1e-20, 1e30))


def blur_constants(direction, out_h: int, out_w: int) -> tuple:
    """The blur kernel's f32 arguments: the three weights, then the two
    tap pairs' uv offsets (x, y), each folded from the plain version's
    Python doubles and rounded once."""
    dx, dy = direction
    offsets = []
    for off in _BLUR_OFFSET:
        offsets += [_f32(dx * off / out_w), _f32(dy * off / out_h)]
    return (*(_f32(w) for w in _BLUR_WEIGHT), *offsets)


def _block_ints(block, out_h: int, out_w: int) -> list:
    """[out_h, out_w, y0, x0, bh, bw], checked."""
    y0, x0, bh, bw = (0, 0, out_h, out_w) if block is None else block
    if not (bh >= 1 and bw >= 1 and 0 <= y0 and 0 <= x0
            and y0 + bh <= out_h and x0 + bw <= out_w):
        raise ValueError(
            f"block (y0, x0, bh, bw) = {(y0, x0, bh, bw)} does not lie in "
            f"the {out_h}x{out_w} target"
        )
    return [out_h, out_w, y0, x0, bh, bw]


def _require_cuda(position):
    if position.device.type != "cuda":
        raise ValueError(
            f"the post kernel runs on cuda, position lies on "
            f"{position.device}"
        )


def _gbuffer_specs(position, normal) -> list:
    shape = (tuple(position.shape) if isinstance(position, torch.Tensor)
             and position.dim() == 3 else (None, None, 3))
    f32 = torch.float32
    return [("position", position, f32, (None, None, 3)),
            ("normal", normal, f32, shape)]


def post_kernel(entry: str, tensors, ints, floats, dev):
    """Launch `entry` of `csrc/post_kernel.cu` on the current stream of
    `dev` and count it."""
    fn = kernels.entry_point("post_kernel", entry, len(tensors), len(ints),
                             len(floats))
    kernels.enqueue(fn, entry, tensors, ints, dev, floats)
    post_kernel.launches += 1
    spans.count("post.kernel", 1)


post_kernel.launches = 0


def _launch_ssao(position, normal, noise, params, radius, out_h, out_w,
                 block):
    f32 = torch.float32
    kernels.check_tensors(_gbuffer_specs(position, normal) + [
        ("noise", noise, f32, (None, None, 4)),
        ("intensity", params.intensity, f32, ()),
        ("scale", params.scale, f32, ()),
        ("bias", params.bias, f32, ()),
    ] + [(f"sample_radius[{i}]", r, f32, ()) for i, r in enumerate(radius)],
        position, "position")
    ints = _block_ints(block, out_h, out_w)
    _require_cuda(position)
    h, w = position.shape[:2]
    out = torch.empty(ints[4], ints[5], dtype=f32, device=position.device)
    post_kernel(
        "sf_post_ssao",
        [position, normal, noise, params.intensity, params.scale,
         params.bias, *radius, out],
        [h, w, noise.shape[0], noise.shape[1], *ints],
        ssao_constants(), position.device,
    )
    return out


def _launch_blur(source, position, normal, params, direction, out_h, out_w,
                 block, camera_position=None):
    f32 = torch.float32
    specs = _gbuffer_specs(position, normal) + [
        ("source", source, f32, (None, None)),
        ("normal_threshold", params.normal_threshold, f32, ()),
        ("depth_threshold", params.depth_threshold, f32, ()),
    ]
    if camera_position is not None:
        specs.append(("camera_position", camera_position, f32, (3,)))
    kernels.check_tensors(specs, position, "position")
    ints = _block_ints(block, out_h, out_w)
    _require_cuda(position)
    h, w = position.shape[:2]
    shape = (ints[4], ints[5]) + (() if camera_position is None else (3,))
    out = torch.empty(shape, dtype=f32, device=position.device)
    ptrs = [source, position, normal, params.normal_threshold,
            params.depth_threshold]
    if camera_position is None:
        entry = "sf_post_blur"
    else:
        entry = "sf_post_blur_composite"
        ptrs.append(camera_position)
    post_kernel(
        entry, ptrs + [out], [*source.shape, h, w, *ints],
        blur_constants(direction, out_h, out_w), position.device,
    )
    return out


def postprocess(
    position,
    normal,
    closest_distance,
    scene: SceneParams,
    cfg: RenderConfig,
    noise,
):
    """The full post stage of the C++ app (`SSAO::Render` + final
    pass): returns the final RGB image [H, W, 3]. All tensors lie on
    one device (the G-buffer's)."""
    with spans.span("post"):
        h, w = cfg.height, cfg.width
        sh, sw = h // cfg.ssao_downscale, w // cfg.ssao_downscale
        radius = (scene.ssao.radius_multiplier, closest_distance)
        ao = ssao_pass(position, normal, noise, scene.ssao, radius, sh, sw)
        ao = blur_pass(ao, position, normal, scene.ssao, (1.0, 0.0), h, w)
        return blur_composite_pass(ao, position, normal, scene.ssao,
                                   scene.camera.position, h, w)
