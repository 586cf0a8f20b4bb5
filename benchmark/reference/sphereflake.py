"""Plain PyTorch reference of the sphereflake G-buffer, independent of the
program under test: it imports nothing of the renderer and takes nothing
the renderer made. It computes in float64 by default.

What it computes (the binned renderer's semantics, written as a spec):

- The scene is the 9-ary sphere tree of `Sphereflake.cpp:216-249`: the
  root frame is translate(-camera) @ Rx(90 deg); a child's frame is its
  parent's frame composed with one of 9 template frames whose unit
  displacement is scaled by (1 + radius_ratio) * r_parent; a sphere at
  level L has radius root_radius * radius_ratio**L. Every level from 0
  to `max_depth` is geometry.
- A ray d (unit, from the camera) takes a sphere (centre c, radius r,
  bounding radius 2r) as a candidate when tca = d.c >= 0, the ray enters
  the bounding sphere before lod**2 * r (max(tca - lod**2 r, 0)**2 <
  tca**2 + 4r**2 - |c|**2), and it meets the sphere itself
  (tca**2 + r**2 - |c|**2 >= 0). Its distance is
  ts = tca - sqrt(tca**2 + r**2 - |c|**2); the nearest candidate wins.
- The G-buffer of a pixel is (min_t, position = d * min_t, normal =
  (position - c) / |position - c|) of its winner; sky is min_t = 3e38 and
  zeros.

The traversal walks the tree level by level with (ray, node) pairs. A
node's subtree lies inside the ball of radius max(2, (1 + q) / (1 - q)) r
around it (q = radius_ratio), and every candidate in the subtree is
entered before lod**2 * r, so a pair whose ray misses that ball, or
enters it later, is not expanded: the pruning drops nothing the spec
takes.

`test_dtype` computes each (ray, sphere) test and the shading in a lower
precision while the pruning stays in float64: the control of the
comparison (a renderer whose hot loop runs in bfloat16).
"""

from __future__ import annotations

import math

import torch

BIG = 3.0e38
F64 = torch.float64
BLOCK_TILES = 64  # tiles of rays traced together (bounds the pairs held)


# --------------------------------------------------------------------
# Geometry.
# --------------------------------------------------------------------


def _rot(axis: int, a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    if axis == 0:
        rows = [[o, z, z], [z, c, -s], [z, s, c]]
    elif axis == 1:
        rows = [[c, z, s], [z, o, z], [-s, z, c]]
    else:
        rows = [[c, -s, z], [s, c, z], [z, z, o]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def euler_xyz_deg(deg):
    """Rx @ Ry @ Rz of XYZ Euler angles in degrees (`Util.h:13-18`);
    deg [..., 3] -> [..., 3, 3]."""
    rad = deg * (math.pi / 180.0)
    return _rot(0, rad[..., 0]) @ _rot(1, rad[..., 1]) @ _rot(2, rad[..., 2])


def look_rotation(yaw, pitch, roll):
    """GLM quat(vec3(yaw, pitch, roll)) = Rz(roll) @ Ry(pitch) @ Rx(yaw)."""
    return _rot(2, roll) @ _rot(1, pitch) @ _rot(0, yaw)


def child_templates(rot_deg, longlat_deg):
    """(R [9, 3, 3], unit displacement [9, 3]) of the 9 child frames."""
    lon = longlat_deg[:, 0] * (math.pi / 180.0)
    lat = longlat_deg[:, 1] * (math.pi / 180.0)
    d = torch.stack([torch.cos(lat) * torch.sin(lon),
                     torch.sin(lat) * torch.sin(lon), torch.cos(lon)], -1)
    d = d / torch.sqrt(torch.sum(d * d, -1, keepdim=True))
    return euler_xyz_deg(rot_deg), d


def corners(cam: dict, aspect: float):
    """(origin, top_left, top_right, bottom_left) of `camera.h:37-53`,
    with the d = tan(fov / 2) / 3 quirk of `camera.h:111-114`."""
    rot = look_rotation(cam["yaw"], cam["pitch"], cam["roll"])
    d = torch.tan(cam["fov"] * (math.pi / 360.0)) / 3.0
    one = torch.ones_like(d)
    pos = cam["position"]
    tl = pos + rot @ torch.stack([-aspect * d, d, -one])
    tr = pos + rot @ torch.stack([aspect * d, d, -one])
    bl = pos + rot @ torch.stack([-aspect * d, -d, -one])
    return pos, tl, tr, bl


def pixel_dirs(cam: dict, width: int, height: int, xs, ys):
    """Unit ray directions [N, 3] of pixels (xs, ys) of a width x height
    frame (`Sphereflake.cpp:149-167`: target = TL + (TR - TL) x / W +
    (BL - TL) y / H)."""
    pos, tl, tr, bl = corners(cam, width / height)
    u = (xs.to(pos.dtype) / width)[:, None]
    v = (ys.to(pos.dtype) / height)[:, None]
    dirs = (tl + ((tr - tl) * u + (bl - tl) * v)) - pos
    return dirs / torch.sqrt(torch.sum(dirs * dirs, -1, keepdim=True))


def root_frame(cam_position):
    """(rotation, translation) of translate(-camera) @ Rx(90 deg)."""
    a = torch.full((), math.pi / 2.0, dtype=cam_position.dtype,
                   device=cam_position.device)
    return _rot(0, a), -cam_position


def subtree_factor(ratio: float) -> float:
    """Radius, in units of a node's r, of a ball holding its subtree."""
    return max(2.0, (1.0 + ratio) / (1.0 - ratio))


# --------------------------------------------------------------------
# The tree, culled only where the spec provably takes nothing.
# --------------------------------------------------------------------


class Tree:
    """Per level: the centres `c` [n, 3] of every node whose subtree can
    hold a candidate of some ray, the child table [n_parent, 9] (-1
    where a child was culled), and each kept child's parent and slot
    (`parent`, `slot`: [n] per level from level 1)."""

    def __init__(self, scene: dict, max_depth: int, lod: float):
        cam, fr = scene["camera"], scene["fractal"]
        with torch.no_grad():
            R9, D9 = child_templates(fr["child_rotations_deg"],
                                     fr["child_longlat_deg"])
            rot0, c0 = root_frame(cam["position"])
        self.ratio = float(fr["radius_ratio"])
        self.r0 = float(fr["root_radius"])
        self.lod_sq = float(lod) ** 2
        self.max_depth = max_depth
        k = subtree_factor(self.ratio) * (1.0 + 1e-9)
        self.radius = [self.r0 * self.ratio ** l for l in range(max_depth + 1)]

        def keep(c, r):
            return torch.sqrt(torch.sum(c * c, -1)) - k * r < self.lod_sq * r * (
                1.0 + 1e-9)

        c = c0[None]
        rot = rot0[None]
        m = keep(c, self.radius[0])
        self.c = [c[m]]
        rot = rot[m]
        self.child = []
        self.parent, self.slot = [], []
        for lvl in range(1, max_depth + 1):
            pc = self.c[-1]
            n = pc.shape[0]
            scale = (1.0 + self.ratio) * self.radius[lvl - 1]
            crot = rot[:, None] @ R9[None]  # [n, 9, 3, 3]
            cc = (rot[:, None] @ (D9 * scale)[None, :, :, None])[..., 0] + pc[:, None]
            m = keep(cc, self.radius[lvl])  # [n, 9]
            idx = torch.full((n, 9), -1, dtype=torch.long, device=pc.device)
            n_kept = int(m.sum())
            idx[m] = torch.arange(n_kept, device=pc.device)
            self.child.append(idx)
            kept = torch.nonzero(m)
            self.parent.append(kept[:, 0])
            self.slot.append(kept[:, 1])
            self.c.append(cc[m])
            rot = crot[m]
            if n_kept == 0:
                break
        self.levels = len(self.c)
        self.offsets = [0]
        for c in self.c:
            self.offsets.append(self.offsets[-1] + c.shape[0])


# --------------------------------------------------------------------
# Tracing.
# --------------------------------------------------------------------


class Trace:
    """Per ray: t (BIG at sky), the winner's centre and its node (an
    index into the tree's nodes of every level, in level order; -1 at
    sky); per tile, when asked, the number of distinct candidate nodes
    (the (tile, node) pairs of the kernels' counted work)."""

    def __init__(self, n: int, device, n_tiles: int = 0):
        self.t = torch.full((n,), BIG, dtype=F64, device=device)
        self.center = torch.zeros((n, 3), dtype=F64, device=device)
        self.node = torch.full((n,), -1, dtype=torch.long, device=device)
        self.pairs = torch.zeros((n_tiles,), dtype=torch.long, device=device)


def trace_rays(tree: Tree, dirs, trace: Trace, lo: int, tile_of=None,
               test_dtype=F64):
    """Trace dirs [N, 3] (float64) into trace[lo : lo + N]. `tile_of` [N]
    gives each ray's tile, to count distinct candidate (tile, node)
    pairs."""
    dev = dirs.device
    n = dirs.shape[0]
    t_best = torch.full((n,), BIG, dtype=F64, device=dev)
    c_best = torch.zeros((n, 3), dtype=F64, device=dev)
    n_best = torch.full((n,), -1, dtype=torch.long, device=dev)
    k = subtree_factor(tree.ratio) * (1.0 + 1e-9)
    ray = torch.arange(n, device=dev)
    node = torch.zeros((n,), dtype=torch.long, device=dev)
    if tree.c[0].shape[0] == 0:
        ray = ray[:0]
        node = node[:0]
    low = test_dtype != F64
    for lvl in range(tree.levels):
        if ray.numel() == 0:
            break
        r = tree.radius[lvl]
        lodr = tree.lod_sq * r
        c = tree.c[lvl][node]
        d = dirs[ray]
        tca = torch.sum(d * c, -1)
        t2 = tca * tca
        cc = torch.sum(c * c, -1)
        c1p = torch.clamp_min(tca - lodr, 0.0)
        # Candidates, in the test precision.
        if low:
            dl, cl = d.to(test_dtype), c.to(test_dtype)
            tca_l = torch.sum(dl * cl, -1)
            t2_l = tca_l * tca_l
            cc_l = torch.sum(cl * cl, -1)
            c1p_l = torch.clamp_min(tca_l - lodr, 0.0)
            disc = t2_l + (r * r - cc_l)
            ok = (tca_l >= 0) & (c1p_l * c1p_l < t2_l + (4 * r * r - cc_l)) & (disc >= 0)
            ts = (tca_l - torch.sqrt(torch.clamp_min(disc, 0.0))).to(F64)
        else:
            disc = t2 + (r * r - cc)
            ok = (tca >= 0) & (c1p * c1p < t2 + (4 * r * r - cc)) & (disc >= 0)
            ts = tca - torch.sqrt(torch.clamp_min(disc, 0.0))
        if ok.any():
            ro, ts_o = ray[ok], ts[ok]
            t_best.scatter_reduce_(0, ro, ts_o, reduce="amin")
            win = ts_o == t_best[ro]
            rw = ro[win]
            c_best[rw] = c[ok][win]
            n_best[rw] = tree.offsets[lvl] + node[ok][win]
            if tile_of is not None:
                n_all = tree.offsets[-1]
                key = torch.unique(tile_of[ro] * n_all + (tree.offsets[lvl] + node[ok]))
                trace.pairs.index_add_(0, key // n_all, torch.ones_like(key))
        if lvl + 1 >= tree.levels:
            break
        # Expand the pairs whose ray can reach a candidate in the subtree.
        R = k * r
        expand = c1p * c1p < t2 + (R * R - cc) * (1.0 + 1e-9) + 1e-300
        ch = tree.child[lvl][node[expand]]  # [m, 9]
        rr = ray[expand][:, None].expand_as(ch)
        live = ch >= 0
        ray, node = rr[live], ch[live]
    hit = t_best < BIG
    trace.t[lo:lo + n] = torch.where(hit, t_best, torch.full_like(t_best, BIG))
    trace.center[lo:lo + n] = c_best
    trace.node[lo:lo + n] = torch.where(hit, n_best, torch.full_like(n_best, -1))


def tile_pixels(cfg: dict, tiles, device):
    """(xs, ys) [len(tiles) * 1024] of the frame tiles `tiles`, tile by
    tile, rows of a tile in order (the padded tile grid)."""
    th, tw = cfg["tile_h"], cfg["tile_w"]
    tiles_x = -(-cfg["width"] // tw)
    flat = torch.arange(th * tw, device=device)
    tiles = tiles.to(device)
    xs = (tiles % tiles_x)[:, None] * tw + (flat % tw)[None]
    ys = (tiles // tiles_x)[:, None] * th + (flat // tw)[None]
    return xs.reshape(-1), ys.reshape(-1)


def tile_grid(cfg: dict):
    """(tiles_x, tiles_y) of the padded frame."""
    return (-(-cfg["width"] // cfg["tile_w"]), -(-cfg["height"] // cfg["tile_h"]))


def shade(dirs, t, center, dtype=F64):
    """(position, normal) of hits, zeros at sky (in `dtype`)."""
    hit = t < BIG
    d, c = dirs.to(dtype), center.to(dtype)
    t0 = torch.where(hit, t, torch.zeros_like(t)).to(dtype)
    pos = d * t0[:, None]
    w = pos - c
    nn = torch.sqrt(torch.clamp_min(torch.sum(w * w, -1, keepdim=True), 0.0))
    nn = torch.where(nn > 0, nn, torch.ones_like(nn))
    zero = torch.zeros_like(pos)
    return (torch.where(hit[:, None], pos, zero).to(F64),
            torch.where(hit[:, None], w / nn, zero).to(F64))


def gbuffer(scene: dict, cfg: dict, device, count=False, test_dtype=F64):
    """The reference G-buffer of `scene` under render config `cfg` (a
    dict of width, height, max_depth, lod_factor, tile_h, tile_w).

    Returns a dict of per-ray tensors in tile order over the padded tile
    grid: t, position, normal, node (the winner's, `Trace`); and `pairs` (per tile, its distinct
    candidate nodes, with `count`). `image()` lays the per-ray tensors
    out as [H, W] planes. Rays go in blocks of `BLOCK_TILES` tiles."""
    tree = Tree(scene, cfg["max_depth"], cfg["lod_factor"])
    tx, ty = tile_grid(cfg)
    tiles = torch.arange(tx * ty, device=device)
    rays = cfg["tile_h"] * cfg["tile_w"]
    n = tiles.numel() * rays
    out = Trace(n, device, tx * ty)
    pos = torch.empty((n, 3), dtype=F64, device=device)
    nrm = torch.empty((n, 3), dtype=F64, device=device)
    cam = scene["camera"]
    for b in range(0, tiles.numel(), BLOCK_TILES):
        tb = tiles[b:b + BLOCK_TILES]
        xs, ys = tile_pixels(cfg, tb, device)
        dirs = pixel_dirs(cam, cfg["width"], cfg["height"], xs, ys)
        lo = b * rays
        tile_of = tb.repeat_interleave(rays) if count else None
        trace_rays(tree, dirs, out, lo, tile_of=tile_of, test_dtype=test_dtype)
        p, q = shade(dirs, out.t[lo:lo + dirs.shape[0]],
                     out.center[lo:lo + dirs.shape[0]], dtype=test_dtype)
        pos[lo:lo + dirs.shape[0]] = p
        nrm[lo:lo + dirs.shape[0]] = q
    return dict(t=out.t, position=pos, normal=nrm, pairs=out.pairs, node=out.node)


def image(cfg: dict, per_ray):
    """Lay a per-ray tensor [T * 1024, ...] over the whole padded tile
    grid (tile order) out as the cropped [H, W, ...] image."""
    th, tw = cfg["tile_h"], cfg["tile_w"]
    tx, ty = tile_grid(cfg)
    rest = per_ray.shape[1:]
    x = per_ray.reshape(ty, tx, th, tw, *rest)
    x = torch.movedim(x, 2, 1).reshape(ty * th, tx * tw, *rest)
    return x[: cfg["height"], : cfg["width"]]
