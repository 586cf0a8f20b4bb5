"""Plain PyTorch reference of the post chain: SSAO, the two edge-gated
blur passes and the composite of the C++ app's shaders
(`post_ssao.glsl`, `post_ssao_blur.glsl`, `post_final.glsl`; orchestrated
as `SSAO::Render()` and `main.cpp:301-335`), vectorised over pixels and
computed in float64 by default (`dtype` lowers it, for the control).

GL texture conventions: texel centres at (i + 0.5) / size; NEAREST is
floor(u * size) clamped to the edge; LINEAR filters between the two
nearest texel centres (clamped, or wrapped for the noise texture). The
G-buffer is read NEAREST, the AO targets LINEAR. Sky (position 0) is
black. The SSAO sample radius is radius_multiplier times the frame's
closest hit distance (`SSAO.h:15-18`), and the per-pixel radius
SSAOSampleRadius / sqrt(|position.z|) is held finite (the all-sky
frame's sentinel would otherwise be infinite).
"""

from __future__ import annotations

import torch

_KERNEL = ((1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0))
_OFFSET = (1.3846153846, 3.2307692308)
_WEIGHT = (0.2270270270, 0.3162162162, 0.0702702703)


def _texel(x, n):
    return torch.clamp(torch.floor(x.double()), 0, n - 1).long()


def nearest(img, u, v):
    h, w = img.shape[0], img.shape[1]
    return img[_texel(v * h, h), _texel(u * w, w)]


def bilinear(img, u, v, repeat: bool):
    h, w = img.shape[0], img.shape[1]
    x, y = u * w - 0.5, v * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    if img.dim() == 3:
        fx, fy = fx[..., None], fy[..., None]
    if repeat:
        xa, xb = torch.remainder(x0.long(), w), torch.remainder(x0.long() + 1, w)
        ya, yb = torch.remainder(y0.long(), h), torch.remainder(y0.long() + 1, h)
    else:
        xa, xb = _texel(x0, w), _texel(x0 + 1, w)
        ya, yb = _texel(y0, h), _texel(y0 + 1, h)
    top = img[ya, xa] * (1 - fx) + img[ya, xb] * fx
    bot = img[yb, xa] * (1 - fx) + img[yb, xb] * fx
    return top * (1 - fy) + bot * fy


def _frag(h, w, like):
    """Fragment coordinates, in float64 whatever the values' precision:
    texture addressing stays exact in the control too."""
    y, x = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=like.device) + 0.5,
        torch.arange(w, dtype=torch.float64, device=like.device) + 0.5,
        indexing="ij",
    )
    return x, y


def ssao(position, normal, noise, p: dict, radius, h, w):
    fx, fy = _frag(h, w, position)
    u, v = fx / w, fy / h
    pos = nearest(position, u, v)
    nrm = nearest(normal, u, v)
    sky = torch.sum(pos * pos, -1) == 0.0
    rad = torch.clamp_max(
        radius / torch.sqrt(torch.clamp_min(torch.abs(pos[..., 2]), 1e-20)), 1e30
    )
    nz = bilinear(noise, u * 0.1, v * 0.1, repeat=True)[..., :2] * 2.0 - 1.0
    nz = nz / torch.sqrt(torch.clamp_min(torch.sum(nz * nz, -1, keepdim=True), 1e-20))

    def occlude(ox, oy):
        s = nearest(position, (fx + ox) / w, (fy + oy) / h)
        diff = s - pos
        dist2 = torch.sum(diff * diff, -1)
        dist = torch.sqrt(torch.clamp_min(dist2, 1e-20))
        d = torch.sum(nrm * diff, -1) / dist
        occ = torch.clamp_min(d - p["bias"], 0.0)
        occ = occ * (1.0 / (1.0 + dist2 * p["scale"])) * p["intensity"]
        return torch.where(dist2 > 0, occ, torch.zeros_like(occ))

    ao = torch.zeros_like(fx, dtype=position.dtype)
    for kx, ky in _KERNEL:
        dot = kx * nz[..., 0] + ky * nz[..., 1]
        c1x = (kx - 2.0 * dot * nz[..., 0]) * rad
        c1y = (ky - 2.0 * dot * nz[..., 1]) * rad
        c2x = c1x * 0.707 - c1y * 0.707
        c2y = c1x * 0.707 + c1y * 0.707
        ao = ao + occlude(c1x * 0.25, c1y * 0.25)
        ao = ao + occlude(c1x * 0.75, c1y * 0.75)
        ao = ao + occlude(c2x * 0.5, c2y * 0.5)
        ao = ao + occlude(c2x, c2y)
    ao = 1.0 - ao / 16.0
    return torch.where(sky, torch.zeros_like(ao), ao)


def blur(source, position, normal, p: dict, direction, h, w):
    fx, fy = _frag(h, w, position)
    u, v = fx / w, fy / h
    pos = nearest(position, u, v)
    nrm = nearest(normal, u, v)
    dx, dy = direction
    color = torch.zeros_like(fx, dtype=source.dtype)
    leftover = torch.zeros_like(fx, dtype=source.dtype)
    for i in (1, 2):
        off, wgt = _OFFSET[i - 1], _WEIGHT[i]
        ox, oy = dx * off / w, dy * off / h
        for sign in (1.0, -1.0):
            su, sv = u + sign * ox, v + sign * oy
            s_pos = nearest(position, su, sv)
            s_nrm = nearest(normal, su, sv)
            gate = (torch.sum(nrm * s_nrm, -1) >= p["normal_threshold"]) & (
                torch.abs(s_pos[..., 2] - pos[..., 2]) >= p["depth_threshold"])
            tap = bilinear(source, su, sv, repeat=False)
            color = color + torch.where(gate, tap * wgt, torch.zeros_like(tap))
            leftover = leftover + torch.where(gate, torch.zeros_like(tap),
                                              torch.full_like(tap, wgt))
    return color + bilinear(source, u, v, repeat=False) * (_WEIGHT[0] + leftover)


def composite(position, ao, cam_position, h, w):
    fx, fy = _frag(h, w, position)
    u, v = fx / w, fy / h
    pos = nearest(position, u, v)
    sky = torch.sum(pos * pos, -1) == 0.0
    a = nearest(ao, u, v)
    color = (0.5 + 0.5 * (pos + cam_position)) * a[..., None]
    return torch.where(sky[..., None], torch.zeros_like(color), color)


def postprocess(position, normal, min_t, scene: dict, noise, dtype=torch.float64):
    """The composited image [H, W, 3] of a G-buffer ([H, W, 3] planes and
    the [H, W] min_t plane, 3e38 at sky)."""
    h, w = min_t.shape
    position, normal = position.to(dtype), normal.to(dtype)
    noise = noise.to(dtype=dtype, device=position.device)
    p = {k: v.to(dtype) for k, v in scene["ssao"].items()}
    closest = torch.min(min_t).to(dtype)
    ao = ssao(position, normal, noise, p, p["radius_multiplier"] * closest, h, w)
    ao = blur(ao, position, normal, p, (1.0, 0.0), h, w)
    ao = blur(ao, position, normal, p, (0.0, 1.0), h, w)
    return composite(position, ao, scene["camera"]["position"].to(dtype), h, w)
