"""Image output.

The C++ app presents frames to a GLFW window (`main.cpp:301-335`); the
port is headless, so the display path becomes PNG/NPZ output. The
port's own copy of the reference package's `utils/image.py`: PNGs go
through the native C++ encoder (`runtime/native.py`, built at first
use) wherever a C++ compiler exists, else through the pure-Python zlib
encoder; tensors are brought to the host here.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a NumPy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def to_uint8(img) -> np.ndarray:
    """[H, W, 3] float image -> uint8 with the GL-style clamp to [0,1]."""
    arr = _host(img)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    chunk = tag + payload
    return struct.pack(">I", len(payload)) + chunk + struct.pack(
        ">I", zlib.crc32(chunk) & 0xFFFFFFFF
    )


def encode_png_python(rgb: np.ndarray) -> bytes:
    """Minimal RGB8 PNG encoder (filter 0, zlib)."""
    h, w, c = rgb.shape
    assert c == 3 and rgb.dtype == np.uint8
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1
    ).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return b"".join(
        [
            b"\x89PNG\r\n\x1a\n",
            _png_chunk(b"IHDR", ihdr),
            _png_chunk(b"IDAT", zlib.compress(raw, 6)),
            _png_chunk(b"IEND", b""),
        ]
    )


def write_png(path: str, img) -> None:
    """Write a float [H, W, 3] image (or uint8) as PNG."""
    from sphereflake_tpu_torch.runtime import native

    img = _host(img)
    rgb = img if img.dtype == np.uint8 else to_uint8(img)
    if native.available():
        data = native.encode_png_native(rgb)
    else:
        data = encode_png_python(rgb)
    with open(path, "wb") as f:
        f.write(data)


def write_gbuffer_npz(path: str, position, normal, min_t, image=None) -> None:
    """Save raw G-buffer planes (the C++ app's RGBA32F textures);
    `image` optionally adds the composited frame (float RGB) — the
    target surface for image-loss fitting."""
    planes = dict(
        position=_host(position),
        normal=_host(normal),
        min_t=_host(min_t),
    )
    if image is not None:
        planes["image"] = _host(image)
    np.savez_compressed(path, **planes)


def shade_normals(normal, hit=None, background=0.12) -> np.ndarray:
    """Debug shading: normals remapped to RGB (G-buffer visualization)."""
    n = _host(normal)
    img = n * 0.5 + 0.5
    if hit is not None:
        img = np.where(_host(hit)[..., None], img, background)
    return img
