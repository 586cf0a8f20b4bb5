"""Plain PyTorch reference of the fit: Adam steps on the G-buffer loss,
independent of the program (it imports nothing of the renderer).

The loss is the program's stated one: the sum over the frame of the
squared position and normal errors against a target G-buffer, over
width x height. Its gradient is the stated straight-through gradient:
each pixel's winning sphere is the discrete choice of the float64 trace
(`sphereflake.gbuffer`), and its distance t = tca - sqrt(r^2 - d^2),
position d t and normal (d t - c) / |d t - c| are differentiated in the
scene's leaves through the ray's direction (the camera), the winner's
centre (the camera's position and the tree's frames) and its radius. A
miss is a constant (zeros). Where r^2 - d^2 <= 0 the square root, as
the program's `safe_sqrt`, has no derivative.

Adam is optax's (and torch's): eps outside the square root, both
moments bias-corrected.
"""

from __future__ import annotations

import torch

from benchmark.reference import sphereflake as ref

F64 = torch.float64
GROUPS = (
    ("camera", ("position", "yaw", "pitch", "roll", "fov")),
    ("fractal", ("radius_ratio", "root_radius", "child_rotations_deg",
                 "child_longlat_deg")),
    ("ssao", ("intensity", "scale", "bias", "normal_threshold",
              "depth_threshold", "radius_multiplier")),
)


def leaves(scene: dict) -> list:
    """The scene's 15 leaves in the program's order."""
    return [scene[g][k] for g, keys in GROUPS for k in keys]


def from_leaves(xs) -> dict:
    it = iter(xs)
    return {g: {k: next(it) for k in keys} for g, keys in GROUPS}


def centres(tree: ref.Tree, scene: dict, dtype=F64):
    """([every kept node's centre, level order] [N, 3], [its radius] [N]),
    differentiable in the camera's position and the fractal's leaves."""
    cam, fr = scene["camera"], scene["fractal"]
    R9, D9 = ref.child_templates(fr["child_rotations_deg"].to(dtype),
                                 fr["child_longlat_deg"].to(dtype))
    rot0, c0 = ref.root_frame(cam["position"].to(dtype))
    ratio, r0 = fr["radius_ratio"].to(dtype), fr["root_radius"].to(dtype)
    n0 = tree.c[0].shape[0]
    rot = rot0[None].expand(n0, 3, 3)
    c = c0[None].expand(n0, 3)
    out_c, out_r = [c], [r0.expand(n0)]
    r = r0
    for lvl in range(1, tree.levels):
        p, s = tree.parent[lvl - 1], tree.slot[lvl - 1]
        scale = (1.0 + ratio) * r
        c = (rot[p] @ (D9[s] * scale)[..., None])[..., 0] + c[p]
        rot = rot[p] @ R9[s]
        r = r * ratio
        out_c.append(c)
        out_r.append(r.expand(c.shape[0]))
    return torch.cat(out_c), torch.cat(out_r)


def surface(dirs, c, r):
    """(t, position, normal) of rays dirs [N, 3] on their winners (c, r),
    straight through."""
    tca = torch.sum(dirs * c, -1)
    disc = r * r - (torch.sum(c * c, -1) - tca * tca)
    ok = disc > 0
    root = torch.where(ok, torch.sqrt(torch.where(ok, disc, torch.ones_like(disc))),
                       torch.zeros_like(disc))
    t = tca - root
    pos = dirs * t[:, None]
    w = pos - c
    nn = torch.sqrt(torch.sum(w * w, -1, keepdim=True))
    nn = torch.where(nn > 0, nn, torch.ones_like(nn))
    return t, pos, w / nn


def target(scene: dict, cfg: dict, device, dtype=F64):
    """The reference's target G-buffer of `scene`: (position, normal)
    per ray in tile order (traced and shaded in `dtype`)."""
    g = ref.gbuffer(scene, cfg, device, test_dtype=dtype)
    return g["position"], g["normal"]


def loss_and_grad(xs, tgt, cfg: dict, device, dtype=F64):
    """(loss, [gradient of each leaf]) of the G-buffer loss at leaves `xs`
    (float64) against `tgt` = (position, normal) per ray in tile order.
    `dtype` is the precision of the trace and the differentiated surface
    (the control computes them lower)."""
    leaves_g = [x.detach().clone().requires_grad_(True) for x in xs]
    scene = from_leaves(leaves_g)
    plain = from_leaves([x.detach() for x in xs])
    tree = ref.Tree(plain, cfg["max_depth"], cfg["lod_factor"])
    tx, ty = ref.tile_grid(cfg)
    rays = cfg["tile_h"] * cfg["tile_w"]
    tiles = torch.arange(tx * ty, device=device)
    t_pos, t_nrm = tgt
    cam = {k: v.to(dtype) for k, v in scene["camera"].items()}
    total = 0.0
    grads = [torch.zeros_like(x) for x in leaves_g]
    n_pix = cfg["width"] * cfg["height"]
    for b in range(0, tiles.numel(), ref.BLOCK_TILES):
        tb = tiles[b:b + ref.BLOCK_TILES]
        xs_, ys_ = ref.tile_pixels(cfg, tb, device)
        inside = (xs_ < cfg["width"]) & (ys_ < cfg["height"])
        lo, n = b * rays, xs_.numel()
        with torch.no_grad():
            d0 = ref.pixel_dirs(plain["camera"], cfg["width"], cfg["height"], xs_, ys_)
            tr = ref.Trace(n, device)
            ref.trace_rays(tree, d0, tr, 0, test_dtype=dtype)
        cc, rr = centres(tree, scene, dtype)
        hit = (tr.node >= 0) & inside
        dirs = ref.pixel_dirs(cam, cfg["width"], cfg["height"], xs_[hit], ys_[hit])
        _t, pos, nrm = surface(dirs, cc[tr.node[hit]], rr[tr.node[hit]])
        tp, tn = t_pos[lo:lo + n], t_nrm[lo:lo + n]
        err = (torch.sum((pos.to(F64) - tp[hit]) ** 2)
               + torch.sum((nrm.to(F64) - tn[hit]) ** 2))
        miss = inside & ~hit
        const = float(torch.sum(tp[miss] ** 2) + torch.sum(tn[miss] ** 2))
        got = torch.autograd.grad(err / n_pix, leaves_g, allow_unused=True)
        for i, g in enumerate(got):
            if g is not None:
                grads[i] += g
        total += (float(err.detach()) + const) / n_pix
    return total, grads


class Adam:
    """optax.adam(lr) over a list of float64 leaves."""

    def __init__(self, lr: float, xs, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(x) for x in xs]
        self.v = [torch.zeros_like(x) for x in xs]
        self.t = 0

    def step(self, xs, gs):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = []
        for i, (x, g) in enumerate(zip(xs, gs)):
            self.m[i] = self.b1 * self.m[i] + (1 - self.b1) * g
            self.v[i] = self.b2 * self.v[i] + (1 - self.b2) * g * g
            out.append(x - self.lr * (self.m[i] / c1)
                       / (torch.sqrt(self.v[i] / c2) + self.eps))
        return out


def fit(xs, tgt, cfg: dict, device, steps: int, lr: float, dtype=F64):
    """`steps` Adam steps from leaves `xs`: (losses, first gradients,
    [leaves after each step])."""
    opt = Adam(lr, xs)
    losses, first, after = [], None, []
    for _ in range(steps):
        loss, gs = loss_and_grad(xs, tgt, cfg, device, dtype)
        losses.append(loss)
        if first is None:
            first = gs
        xs = opt.step(xs, gs)
        after.append(xs)
    return losses, first, after

