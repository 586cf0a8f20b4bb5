"""The numbers that decide `correct`, each held against its limit.

A frame (or a refresh buffer) is compared with the reference pixel by
pixel; a share of pixels that differ is robust to the float32 renderer's
own fuzz at the silhouettes of the deepest spheres (its ray-sphere
discriminant cancels to ~1e-5 against r**2 ~ 1.7e-5 at level 5), and
far from what a renderer in a lower precision gives:

- `hit_mismatch`: pixels whose hit differs from the reference's;
- `t_bad`: common hits whose min_t is off by more than 1e-3 of it;
- `normal_bad`: common hits whose normal is off by more than 0.1;
- `image_bad`: pixels whose composited colour is off by more than 0.05
  in some channel.
"""

from __future__ import annotations

import math

import torch

BIG = 3.0e38


def gbuffer_numbers(min_t, normal, ref_t, ref_normal) -> dict:
    """The G-buffer shares of one frame; all [H, W(, 3)] tensors."""
    min_t, ref_t = min_t.double(), ref_t.double()
    hit, ref_hit = min_t < BIG, ref_t < BIG
    both = hit & ref_hit
    n_both = max(int(both.sum()), 1)
    dt = (min_t - ref_t).abs() > 1e-3 * ref_t.abs()
    dn = (normal.double() - ref_normal.double()).norm(dim=-1) > 0.1
    return dict(
        hit_mismatch=float((hit != ref_hit).double().mean()),
        t_bad=float((dt & both).sum()) / n_both,
        normal_bad=float((dn & both).sum()) / n_both,
    )


def image_numbers(image, ref_image) -> dict:
    d = (torch.as_tensor(image).double().to(ref_image.device)
         - ref_image.double()).abs().amax(-1)
    bad = ~(d <= 0.05)  # a NaN is bad
    return dict(image_bad=float(bad.double().mean()))


def worst(rows) -> dict:
    """The largest reading of each number over several frames."""
    out = {}
    for r in rows:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v) if math.isfinite(v) else math.inf
    return out


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): each number must be finite and
    at most its limit; a number without a limit, or a limit without its
    number, fails."""
    rows = []
    ok = True
    for name in sorted(set(numbers) | set(limits)):
        v, lim = numbers.get(name), limits.get(name)
        good = (v is not None and lim is not None and math.isfinite(v)
                and v <= lim)
        ok = ok and good
        rows.append((name, v, lim))
    return ok, rows
