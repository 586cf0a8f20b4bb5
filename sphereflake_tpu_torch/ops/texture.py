"""Texture-sampling ops (torch): the GLSL `texture()` semantics the
C++ app's post shaders rely on, as gathers.

Conventions (GL): texel centers at (i + 0.5)/size; NEAREST is
floor(u·size) clamped; LINEAR filters between the two nearest texel
centers; CLAMP_TO_EDGE clamps indices, REPEAT wraps them.

Filter/wrap pairs used by the C++ app:
- G-buffer textures: NEAREST + CLAMP_TO_EDGE (`main.cpp:183-201`,
  `GLTexture2D.h:79-99`)
- FBO color targets (SSAO/blur sources): LINEAR + CLAMP_TO_EDGE
  (`GLFramebufferObject.cpp:42-45`)
- SSAO noise: LINEAR + REPEAT (`SSAO.cpp:170-174`)
"""

from __future__ import annotations

import torch


def _gather2d(img, yi, xi):
    """img [H, W, ...] gathered at integer index tensors (already valid)."""
    return img[yi, xi]


def _texel(x, n):
    """floor(x) clamped to [0, n-1], as an index tensor (clamped in
    float first, so huge or non-finite coordinates cannot overflow the
    integer cast)."""
    return torch.clamp(torch.floor(x), 0, n - 1).long()


def sample_nearest_clamp(img, u, v):
    """GLSL texture() with NEAREST + CLAMP_TO_EDGE. u, v in [0,1] texture
    coords (u → width axis); img [H, W, C] or [H, W]."""
    h, w = img.shape[0], img.shape[1]
    return _gather2d(img, _texel(v * h, h), _texel(u * w, w))


def _bilinear(img, x, y, wrap):
    """Shared LINEAR filter; x = u·W − 0.5 continuous texel coords."""
    h, w = img.shape[0], img.shape[1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None] if img.dim() == 3 else (x - x0)
    fy = (y - y0)[..., None] if img.dim() == 3 else (y - y0)
    if wrap == "repeat":
        x0 = x0.long()
        y0 = y0.long()
        xa, xb = torch.remainder(x0, w), torch.remainder(x0 + 1, w)
        ya, yb = torch.remainder(y0, h), torch.remainder(y0 + 1, h)
    else:
        xa, xb = _texel(x0, w), _texel(x0 + 1, w)
        ya, yb = _texel(y0, h), _texel(y0 + 1, h)
    p00 = _gather2d(img, ya, xa)
    p01 = _gather2d(img, ya, xb)
    p10 = _gather2d(img, yb, xa)
    p11 = _gather2d(img, yb, xb)
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    return top * (1 - fy) + bot * fy


def sample_bilinear_clamp(img, u, v):
    h, w = img.shape[0], img.shape[1]
    return _bilinear(img, u * w - 0.5, v * h - 0.5, "clamp")


def sample_bilinear_repeat(img, u, v):
    h, w = img.shape[0], img.shape[1]
    return _bilinear(img, u * w - 0.5, v * h - 0.5, "repeat")
