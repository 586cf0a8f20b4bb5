"""Golden NumPy transcriptions of the reference's GLSL post shaders.

The port's own copy of the reference package's `models/golden_post.py`:
direct, per-pixel-loop translations of `post_ssao.glsl`,
`post_ssao_blur.glsl` and `post_final.glsl`. Slow by design; a
reference for `sphereflake_tpu_torch.ops.post` on small frames.
"""

from __future__ import annotations

import numpy as np


def _tex_nearest_clamp(img, u, v):
    h, w = img.shape[:2]
    xi = min(max(int(np.floor(u * w)), 0), w - 1)
    yi = min(max(int(np.floor(v * h)), 0), h - 1)
    return img[yi, xi]


def _tex_bilinear(img, u, v, repeat):
    h, w = img.shape[:2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    fx, fy = x - x0, y - y0
    if repeat:
        xa, xb, ya, yb = x0 % w, (x0 + 1) % w, y0 % h, (y0 + 1) % h
    else:
        xa = min(max(x0, 0), w - 1)
        xb = min(max(x0 + 1, 0), w - 1)
        ya = min(max(y0, 0), h - 1)
        yb = min(max(y0 + 1, 0), h - 1)
    top = img[ya, xa] * (1 - fx) + img[ya, xb] * fx
    bot = img[yb, xa] * (1 - fx) + img[yb, xb] * fx
    return top * (1 - fy) + bot * fy


_KERNEL = [(1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0)]


def ssao_golden(position, normal, noise, intensity, scale, bias, sample_radius,
                out_h, out_w):
    """post_ssao.glsl, per pixel."""
    ao_img = np.zeros((out_h, out_w), np.float64)
    fb = np.array([out_w, out_h], np.float64)

    def occlude(frag, uv_off, pos, nrm):
        su, sv = (frag[0] + uv_off[0]) / fb[0], (frag[1] + uv_off[1]) / fb[1]
        sample_pos = _tex_nearest_clamp(position, su, sv)
        diff = sample_pos - pos
        dist = np.linalg.norm(diff)
        if dist == 0.0:
            return 0.0
        return (
            max(0.0, float(nrm @ (diff / dist)) - bias)
            * (1.0 / (1.0 + dist * dist * scale))
            * intensity
        )

    for py in range(out_h):
        for px in range(out_w):
            frag = (px + 0.5, py + 0.5)
            u, v = frag[0] / fb[0], frag[1] / fb[1]
            pos = _tex_nearest_clamp(position, u, v)
            if np.linalg.norm(pos) == 0.0:
                ao_img[py, px] = 0.0
                continue
            nrm = _tex_nearest_clamp(normal, u, v)
            rad = sample_radius / np.sqrt(abs(pos[2]))
            nz = _tex_bilinear(noise, u * 0.1, v * 0.1, repeat=True)[:2] * 2.0 - 1.0
            nz = nz / np.linalg.norm(nz)
            ao = 0.0
            for kx, ky in _KERNEL:
                k = np.array([kx, ky])
                c1 = (k - 2.0 * float(k @ nz) * nz) * rad  # reflect
                c2 = np.array(
                    [c1[0] * 0.707 - c1[1] * 0.707, c1[0] * 0.707 + c1[1] * 0.707]
                )
                ao += occlude(frag, c1 * 0.25, pos, nrm)
                ao += occlude(frag, c1 * 0.75, pos, nrm)
                ao += occlude(frag, c2 * 0.5, pos, nrm)
                ao += occlude(frag, c2, pos, nrm)
            ao_img[py, px] = 1.0 - ao / 16.0
    return ao_img


_OFFSET = [0.0, 1.3846153846, 3.2307692308]
_WEIGHT = [0.2270270270, 0.3162162162, 0.0702702703]


def blur_golden(source, position, normal, normal_threshold, depth_threshold,
                direction, out_h, out_w):
    """post_ssao_blur.glsl, per pixel."""
    out = np.zeros((out_h, out_w), np.float64)
    gh, gw = position.shape[:2]
    for py in range(out_h):
        for px in range(out_w):
            frag = np.array([px + 0.5, py + 0.5])
            pix = np.array([1.0 / out_w, 1.0 / out_h])
            pix_g = np.array([1.0 / gw, 1.0 / gh])
            uv = frag * pix
            uv_g = frag * pix_g
            pos = _tex_nearest_clamp(position, *uv_g)
            nrm = _tex_nearest_clamp(normal, *uv_g)
            color = 0.0
            leftover = 0.0
            for i in (1, 2):
                so = np.array(direction) * _OFFSET[i] * pix
                so_g = np.array(direction) * _OFFSET[i] * pix_g
                for sign in (1.0, -1.0):
                    sp = _tex_nearest_clamp(position, *(uv_g + sign * so_g))
                    sn = _tex_nearest_clamp(normal, *(uv_g + sign * so_g))
                    if (
                        float(nrm @ sn) >= normal_threshold
                        and abs(sp[2] - pos[2]) >= depth_threshold
                    ):
                        color += _tex_bilinear(source, *(uv + sign * so), False) * _WEIGHT[i]
                    else:
                        leftover += _WEIGHT[i]
            color += _tex_bilinear(source, *uv, False) * (_WEIGHT[0] + leftover)
            out[py, px] = color
    return out


def composite_golden(position, ssao, camera_position, out_h, out_w):
    """post_final.glsl, per pixel."""
    out = np.zeros((out_h, out_w, 3), np.float64)
    for py in range(out_h):
        for px in range(out_w):
            u, v = (px + 0.5) / out_w, (py + 0.5) / out_h
            pos = _tex_nearest_clamp(position, u, v)
            if np.linalg.norm(pos) == 0.0:
                continue
            ao = _tex_nearest_clamp(ssao, u, v)
            out[py, px] = (0.5 + 0.5 * (pos + camera_position)) * ao
    return out
