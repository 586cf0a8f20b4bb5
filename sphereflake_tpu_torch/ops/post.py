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

Divisions by the target size use 0-d device tensors, not Python
numbers: torch turns `tensor / python_number` into a multiply by the
reciprocal on CUDA, which can move a NEAREST tap by one texel.
"""

from __future__ import annotations

import numpy as np
import torch

from sphereflake_tpu_torch import spans
from sphereflake_tpu_torch.config import RenderConfig, SSAOParams, SceneParams
from sphereflake_tpu_torch.ops.texture import (
    sample_bilinear_clamp,
    sample_bilinear_repeat,
    sample_nearest_clamp,
)

# post_ssao.glsl:15 — the 4 kernel directions (a NumPy constant, turned
# into a tensor on the call's device).
_KERNEL = np.asarray(
    [[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]], np.float32
)
# post_ssao_blur.glsl:9-10 — 5-tap gaussian as center + 2 mirrored taps
_BLUR_OFFSET = (1.3846153846, 3.2307692308)
_BLUR_WEIGHT = (0.2270270270, 0.3162162162, 0.0702702703)


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


def _reflect(incident, normal):
    """GLSL reflect(I, N) = I - 2*dot(N, I)*N, batched over [..., 2]."""
    d = torch.sum(incident * normal, dim=-1, keepdim=True)
    return incident - 2.0 * d * normal


def _size(out_h: int, out_w: int, like):
    """(out_w, out_h) as 0-d f32 tensors on `like`'s device."""
    return like.new_tensor(float(out_w)), like.new_tensor(float(out_h))


def ssao_pass(
    position,
    normal,
    noise,
    params: SSAOParams,
    sample_radius,
    out_h: int,
    out_w: int,
    frag=None,
):
    """`post_ssao.glsl` on the whole image -> AO [out_h, out_w].

    position/normal: [H, W, 3] G-buffer planes (full resolution; sampled
    NEAREST like the C++ app's G-buffer textures). The SSAO target may
    be smaller (downScale, `SSAO.cpp:58`).

    `frag` = (fx, fy) overrides the fragcoord grid to evaluate only a
    block of the (out_h, out_w) target (see `block_fragcoord`).
    out_h/out_w keep their full-target meaning for the uv normalization
    either way.
    """
    dev = position.device
    fx, fy = frag if frag is not None else _fragcoord(out_h, out_w, dev)
    fb_w, fb_h = _size(out_h, out_w, position)
    uv_x, uv_y = fx / fb_w, fy / fb_h

    pos = sample_nearest_clamp(position, uv_x, uv_y)  # [h, w, 3]
    nrm = sample_nearest_clamp(normal, uv_x, uv_y)
    sky = torch.sum(pos * pos, dim=-1) == 0.0  # length(position)==0 (:33)

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
    nz = nz / torch.sqrt(
        torch.clamp_min(torch.sum(nz * nz, dim=-1, keepdim=True), 1e-20)
    )

    def occlude(off_x, off_y):
        """`occlude()` (:19-25): offset in SSAO-target pixels."""
        su = (fx + off_x) / fb_w
        sv = (fy + off_y) / fb_h
        sample_pos = sample_nearest_clamp(position, su, sv)
        diff = sample_pos - pos
        dist2 = torch.sum(diff * diff, dim=-1)
        dist = torch.sqrt(torch.clamp_min(dist2, 1e-20))
        d = torch.sum(nrm * diff, dim=-1) / dist
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
    frag=None,
):
    """`post_ssao_blur.glsl`: depth/normal-gated separable gaussian.

    source: [h, w] AO plane (LINEAR-filtered like the FBO texture it
    replaces); position/normal: full-res G-buffer (NEAREST).
    `frag` evaluates a block of the full target (see `ssao_pass`).
    """
    dev = position.device
    fx, fy = frag if frag is not None else _fragcoord(out_h, out_w, dev)
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
            gate = (torch.sum(nrm * s_nrm, dim=-1) >= params.normal_threshold) & (
                torch.abs(s_pos[..., 2] - pos[..., 2]) >= params.depth_threshold
            )
            tap = sample_bilinear_clamp(source, su, sv)
            color = color + torch.where(gate, tap * wgt, torch.zeros_like(tap))
            leftover = leftover + torch.where(
                gate, torch.zeros_like(tap), torch.full_like(tap, wgt)
            )

    center = sample_bilinear_clamp(source, uv_x, uv_y)
    return color + center * (_BLUR_WEIGHT[0] + leftover)


def composite_pass(
    position,
    ssao,
    camera_position,
    out_h: int,
    out_w: int,
    frag=None,
):
    """`post_final.glsl`: sky -> black; else
    (0.5 + 0.5*(position + cameraPosition)) * ssao.
    `frag` evaluates a block of the full target (see `ssao_pass`)."""
    dev = position.device
    fx, fy = frag if frag is not None else _fragcoord(out_h, out_w, dev)
    fb_w, fb_h = _size(out_h, out_w, position)
    uv_x, uv_y = fx / fb_w, fy / fb_h
    pos = sample_nearest_clamp(position, uv_x, uv_y)
    sky = torch.sum(pos * pos, dim=-1) == 0.0
    ao = sample_nearest_clamp(ssao, uv_x, uv_y)
    color = (0.5 + 0.5 * (pos + camera_position)) * ao[..., None]
    return torch.where(sky[..., None], torch.zeros_like(color), color)


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
        # SSAO.h:15-18
        radius = scene.ssao.radius_multiplier * closest_distance
        ao = ssao_pass(position, normal, noise, scene.ssao, radius, sh, sw)
        ao = blur_pass(ao, position, normal, scene.ssao, (1.0, 0.0), h, w)
        ao = blur_pass(ao, position, normal, scene.ssao, (0.0, 1.0), h, w)
        return composite_pass(position, ao, scene.camera.position, h, w)
