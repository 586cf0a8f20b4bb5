"""The reference frame of `sphereflake.py` and `post.py` for a frame too
large for one device's memory, computed in horizontal bands spread over
several devices (float64 by default). It imports nothing of the program.

Band d of n holds a contiguous run of tile rows; its device traces the
band's rays (`sphereflake.trace_rays`, in chunks of `CHUNK_TILES` tiles),
one Python thread a device, since the tracer reads each level's candidate
count back to the host. The post reads the whole G-buffer from every
pixel (the SSAO radius is unbounded), so the position and normal planes
are assembled on every device, and each device evaluates its own rows of
each pass of `post.py`: the same per-pixel functions, with the fragment
grid cut to those rows (`_rows`). The AO target is assembled on every
device between passes. A band's numbers are the same as those of the
whole-frame `sphereflake.gbuffer` and `post.postprocess`: every pixel is
computed by the same operations from the same inputs.

`frame` returns the bands; `numbers` compares a frame's G-buffer and
image with them band by band and sums the counts into `check.py`'s
shares.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import torch

from benchmark import check
from benchmark.reference import post, sphereflake as ref

F64 = torch.float64
CHUNK_TILES = 1024  # tiles of rays traced together (1M rays)
CHUNK_PIXELS = 1 << 23  # pixels of one post evaluation


@dataclasses.dataclass
class Band:
    """Rows [y0, y1) of the cropped frame, on `device`: t [r, W] (BIG at
    sky), normal [r, W, 3] and the composited image [r, W, 3]."""

    y0: int
    y1: int
    device: torch.device
    t: torch.Tensor
    normal: torch.Tensor
    image: torch.Tensor = None


def _scene_on(scene: dict, device) -> dict:
    return {g: {k: v.to(device) for k, v in leaves.items()}
            for g, leaves in scene.items()}


def _layout(cfg: dict, n: int):
    """Tile-row runs [(r0, r1)] of up to `n` bands, each non-empty."""
    _, ty = ref.tile_grid(cfg)
    step = -(-ty // n)
    return [(r, min(r + step, ty)) for r in range(0, ty, step)]


def _trace(scene: dict, cfg: dict, device, rows, test_dtype):
    """(t, position, normal) [r, W(, 3)] of tile rows `rows`, cropped to
    the frame (the loop of `sphereflake.gbuffer` over the band's
    tiles)."""
    scene = _scene_on(scene, device)
    tree = ref.Tree(scene, cfg["max_depth"], cfg["lod_factor"])
    tx, _ = ref.tile_grid(cfg)
    th, tw = cfg["tile_h"], cfg["tile_w"]
    tiles = torch.arange(rows[0] * tx, rows[1] * tx, device=device)
    n = tiles.numel() * th * tw
    out = ref.Trace(n, device)
    pos = torch.empty((n, 3), dtype=F64, device=device)
    nrm = torch.empty((n, 3), dtype=F64, device=device)
    cam = scene["camera"]
    for b in range(0, tiles.numel(), CHUNK_TILES):
        xs, ys = ref.tile_pixels(cfg, tiles[b:b + CHUNK_TILES], device)
        dirs = ref.pixel_dirs(cam, cfg["width"], cfg["height"], xs, ys)
        lo, hi = b * th * tw, b * th * tw + dirs.shape[0]
        ref.trace_rays(tree, dirs, out, lo, test_dtype=test_dtype)
        pos[lo:hi], nrm[lo:hi] = ref.shade(dirs, out.t[lo:hi], out.center[lo:hi],
                                           dtype=test_dtype)
    del out.center, out.node

    def lay(x):
        rest = x.shape[1:]
        x = x.reshape(rows[1] - rows[0], tx, th, tw, *rest)
        x = torch.movedim(x, 2, 1).reshape((rows[1] - rows[0]) * th, tx * tw, *rest)
        return x[: cfg["height"] - rows[0] * th, : cfg["width"]]

    return lay(out.t), lay(pos), lay(nrm)


_whole_frag = post._frag


@contextlib.contextmanager
def _rows(y0: int, y1: int):
    """`post`'s passes evaluate only fragment rows [y0, y1) of the full
    target (texture coordinates keep their full-frame meaning)."""

    def frag(h, w, like):
        y, x = torch.meshgrid(
            torch.arange(y0, y1, dtype=F64, device=like.device) + 0.5,
            torch.arange(w, dtype=F64, device=like.device) + 0.5,
            indexing="ij",
        )
        return x, y

    post._frag = frag
    try:
        yield
    finally:
        post._frag = _whole_frag


def _chunks(y0: int, y1: int, w: int):
    step = max(1, CHUNK_PIXELS // w)
    return [(a, min(a + step, y1)) for a in range(y0, y1, step)]


def _everywhere(devices, parts, dtype=F64):
    """The whole frame of band rows `parts`, in `dtype`, on each device."""
    return [torch.cat([p.to(device=d, dtype=dtype) for p in parts])
            for d in devices]


def frame(scene: dict, cfg: dict, devices, noise, test_dtype=F64, dtype=F64):
    """The reference frame of `scene` (float64 leaves) under render
    config `cfg`, as bands over `devices` ([Band]); `noise` is the SSAO
    noise texture. `test_dtype` and `dtype` lower the ray tests and the
    post (the control)."""
    layout = _layout(cfg, len(devices))
    devs = [torch.device(d) for d in devices][:len(layout)]
    th, h, w = cfg["tile_h"], cfg["height"], cfg["width"]
    with ThreadPoolExecutor(len(devs)) as pool:
        traced = list(pool.map(
            lambda i: _trace(scene, cfg, devs[i], layout[i], test_dtype),
            range(len(devs))))
    bands = [Band(r0 * th, min(r1 * th, h), d, t, nrm)
             for d, (r0, r1), (t, _pos, nrm) in zip(devs, layout, traced)]
    closest = min(torch.min(b.t).cpu() for b in bands)
    pos = _everywhere(devs, [p for _t, p, _n in traced], dtype)
    nrm = _everywhere(devs, [b.normal for b in bands], dtype)
    del traced
    par = [{k: v.to(device=d, dtype=dtype) for k, v in scene["ssao"].items()}
           for d in devs]
    cam = [scene["camera"]["position"].to(device=d, dtype=dtype) for d in devs]
    nz = [noise.to(device=d, dtype=dtype) for d in devs]
    near = [closest.to(device=d, dtype=dtype) for d in devs]

    def rows(fn):
        """[fn(i) on band i's rows, evaluated chunk by chunk]."""
        out = []
        for i, b in enumerate(bands):
            parts = []
            for a, z in _chunks(b.y0, b.y1, w):
                with _rows(a, z):
                    parts.append(fn(i))
            out.append(torch.cat(parts))
        return out

    ao = rows(lambda i: post.ssao(pos[i], nrm[i], nz[i], par[i],
                                  par[i]["radius_multiplier"] * near[i], h, w))
    for direction in ((1.0, 0.0), (0.0, 1.0)):
        whole = _everywhere(devs, ao, dtype)
        ao = rows(lambda i: post.blur(whole[i], pos[i], nrm[i], par[i],
                                      direction, h, w))
    whole = _everywhere(devs, ao, dtype)
    images = rows(lambda i: post.composite(pos[i], whole[i], cam[i], h, w))
    for b, img in zip(bands, images):
        b.image = img
    return bands


def numbers(bands, rows_of) -> dict:
    """`check.py`'s shares of a frame against the reference `bands`:
    `rows_of(y0, y1, device)` gives the frame's (min_t [r, W], normal
    [r, W, 3], image [r, W, 3]) rows y0..y1 on `device`. Each share's
    counts are summed over the bands."""
    pix = mism = both = tbad = nbad = ibad = 0.0
    for b in bands:
        min_t, normal, image = rows_of(b.y0, b.y1, b.device)
        g = check.gbuffer_numbers(min_t, normal, b.t, b.normal)
        n = b.t.numel()
        n_both = float(((min_t.double() < check.BIG) & (b.t < check.BIG)).sum())
        pix += n
        both += n_both
        mism += g["hit_mismatch"] * n
        tbad += g["t_bad"] * max(n_both, 1.0)
        nbad += g["normal_bad"] * max(n_both, 1.0)
        ibad += check.image_numbers(image, b.image)["image_bad"] * n
    both = max(both, 1.0)
    return dict(hit_mismatch=mism / pix, t_bad=tbad / both,
                normal_bad=nbad / both, image_bad=ibad / pix)
