"""Traffic kind `fit`: gradient-descent fitting of the scene to a target
G-buffer, Adam steps one after another.

Set-up renders the target, the truth scene at a seed-chosen angle on
the orbit, with the program (`render_gbuffer`, the `--gbuffer` user's
path), and offsets the start from the truth by each of `offsets`, its
sign drawn from the seed. Every step, in set-up and in the window, is
one call of the program's `fit.fit(..., steps=1, keep_best=False)`
resuming from the scene and the Adam state the call before returned
(the `--resume` path): one object, driven from the seed. End to end:
`fit_step_s`, the window over its steps.

The check follows the first `check_steps` steps (set-up's) with the
reference (`reference/fit.py`: float64, the stated straight-through
gradient, optax's Adam) from the same start and its own target:
- `loss_1`: the first step's loss, its gap to the reference's over the
  reference's;
- `change_1`: the first step's change of the leaves, by the worst leaf:
  the gap between the program's norm of a leaf's change and the
  reference's, over the reference's or the median leaf's, whichever is
  larger, among the leaves whose reference gradient is not nought to
  rounding (a thousandth of the median leaf's or more);
- `nonfinite`: steps whose loss was not finite.
The first gradient of each leaf, the later steps' losses and the change
after every checked step are printed on the earlier line and not
compared: the straight-through gradient is a sum of terms in
1/sqrt(r^2 - d^2) over grazing pixels that rounding sets, and Adam's
later steps follow its signs (see PERF.md).

Traffic parameters: `learning_rate`, `offsets` ({"group.leaf": size}),
`check_steps`, `spans`.
"""

from __future__ import annotations

import math
import statistics

from benchmark import drivers, scene as sc

TINY = {"check_steps": 3}


def offset_scene(truth: dict, offsets: dict, seed: int) -> dict:
    """`truth` with each leaf of `offsets` moved by its size, the sign
    drawn from the seed (float32 leaves)."""
    import numpy as np

    r = sc.rng(seed, "offsets")
    out = {g: dict(v) for g, v in truth.items()}
    for key in sorted(offsets):
        g, leaf = key.split(".")
        sign = 1.0 if r.random() < 0.5 else -1.0
        out[g][leaf] = np.float32(out[g][leaf] + sign * float(offsets[key]))
    return out


def norms(xs) -> list:
    return [float(x.double().pow(2).sum().sqrt()) for x in xs]


def compare(p_losses, p_grad1, p_after, r_losses, r_grad1, r_after, start) -> tuple:
    """(the compared numbers, the readings printed beside them) of a
    program's checked steps against the reference's. Losses are lists;
    `*_grad1` are the first gradients and `*_after` the leaves after each
    checked step (lists of lists of 15 leaves), `start` the leaves before
    them, all CPU float64."""
    g_ref, g_prog = norms(r_grad1), norms(p_grad1)
    floor = 1e-3 * statistics.median(g_ref)
    counted = [i for i, g in enumerate(g_ref) if g >= floor and g > 0]
    g_med = statistics.median(g_ref[i] for i in counted)

    def gap(a, b):
        return abs(a - b) / b if b > 0 else math.inf

    def worst_leaf(prog, ref):
        med = statistics.median(ref[i] for i in counted)
        return max(abs(prog[i] - ref[i]) / max(ref[i], med) for i in counted)

    d_prog = [norms([a - s for a, s in zip(after, start)]) for after in p_after]
    d_ref = [norms([a - s for a, s in zip(after, start)]) for after in r_after]
    numbers = dict(loss_1=gap(p_losses[0], r_losses[0]),
                   change_1=worst_leaf(d_prog[0], d_ref[0]))
    readings = dict(
        losses=p_losses, ref_losses=r_losses,
        loss_gaps=[gap(a, b) for a, b in zip(p_losses, r_losses)],
        counted=counted, grad=g_prog, ref_grad=g_ref,
        grad_worst_leaf=max(abs(g_prog[i] - g_ref[i]) / max(g_ref[i], g_med)
                            for i in counted),
        change=d_prog[-1], ref_change=d_ref[-1],
        change_worst_leaf=[worst_leaf(p, r) for p, r in zip(d_prog, d_ref)])
    return numbers, readings


def reference_steps(torch, cfg: dict, truth: dict, start: dict, steps: int,
                    lr: float, device, dtype=None):
    """The reference's (losses, first gradients, leaves after each of
    `steps`, start leaves), all CPU float64, traced in `dtype` (float64
    unless the control asks lower)."""
    from benchmark.reference import fit as rf

    dtype = dtype or torch.float64
    xs = rf.leaves(sc.to_reference(start, device))
    tgt = rf.target(sc.to_reference(truth, device), cfg, device, dtype)
    losses, g1, after = rf.fit(xs, tgt, cfg, device, steps, lr, dtype=dtype)
    cpu = lambda v: [x.detach().double().cpu() for x in v]
    return losses, cpu(g1), [cpu(a) for a in after], cpu(xs)


class Driver(drivers.Driver):
    def setup(self):
        from sphereflake_tpu_torch import fit as pf
        from sphereflake_tpu_torch.render import render_gbuffer

        torch = self.torch
        self.pf = pf
        self.lr = float(self.traffic["learning_rate"])
        self.truth = sc.posed(sc.base_scene(self.config), sc.seeded_angle(self.seed))
        self.start = offset_scene(self.truth, self.traffic["offsets"], self.seed)
        with torch.no_grad():
            gb = render_gbuffer(sc.to_program(self.truth, self.dev), self.cfg,
                                device=self.dev)
        self.target = (gb.position, gb.normal)
        self.notes["target_overflow"] = int(gb.metrics.overflow)
        del gb
        self.scene = sc.to_program(self.start, self.dev)
        self.opt = None
        self.nonfinite = 0
        self.losses, self.after = [], []
        for i in range(int(self.traffic["check_steps"])):
            self.losses.append(self._step())
            if i == 0:
                # Adam's first moment after one step is (1 - b1) g.
                self.grad1 = [m.detach().double().cpu() / 0.1 for m in self.opt.mu]
            self.after.append([x.detach().double().cpu() for x in self.scene.leaves()])
        self.attempted = 0

    def _step(self) -> float:
        res = self.pf.fit(self.scene, *self.target, self.cfg, steps=1,
                          learning_rate=self.lr, opt_state=self.opt,
                          keep_best=False, device=self.dev)
        self.scene, self.opt = res.scene, res.opt_state
        loss = float(res.losses[0])
        if not math.isfinite(loss):
            self.nonfinite += 1
        return loss

    def unit(self):
        self._step()
        self.attempted += 1

    def end_to_end(self, window_s, times):
        return {"fit_step_s": window_s / len(times)}

    def release(self):
        self.target = None
        self.scene = None
        self.opt = None

    def check(self):
        r = reference_steps(self.torch, self.ref_cfg, self.truth, self.start,
                            len(self.losses), self.lr, self.dev)
        numbers, readings = compare(self.losses, self.grad1, self.after, *r)
        numbers["nonfinite"] = float(self.nonfinite)
        self.notes["fit"] = readings
        return numbers


def control(torch, cell: dict, seed: int, device) -> dict:
    """The numbers of the control at `seed`: the reference traced,
    shaded and differentiated in bfloat16 (its Adam in float64), in the
    program's place."""
    cfg = drivers.ref_config(cell["config"])
    t = cell["traffic"]
    truth = sc.posed(sc.base_scene(cell["config"]), sc.seeded_angle(seed))
    start = offset_scene(truth, t["offsets"], seed)
    steps, lr = int(t["check_steps"]), float(t["learning_rate"])
    dev = torch.device(device)
    low = reference_steps(torch, cfg, truth, start, steps, lr, dev, torch.bfloat16)
    ref = reference_steps(torch, cfg, truth, start, steps, lr, dev)
    numbers, _ = compare(*low[:3], *ref)
    numbers["nonfinite"] = 0.0
    return numbers


def _state_unchanged(p):
    """Every step returns the scene it was given."""
    import dataclasses

    from sphereflake_tpu_torch import fit as pf

    orig = pf.fit
    p.setattr(pf, "fit", lambda scene, *a, **k: dataclasses.replace(
        orig(scene, *a, **k), scene=scene))


def _half_the_batch(p):
    """The loss leaves out the lower half of the frame's rows and takes
    its mean over the rest."""
    import torch

    from sphereflake_tpu_torch import fit as pf

    def half(scene, target_pos, target_nrm, cfg, device="cuda"):
        gb = pf.render_gbuffer(scene, cfg, device=device)
        h = cfg.height // 2
        err = (torch.sum((gb.position[:h] - target_pos[:h]) ** 2)
               + torch.sum((gb.normal[:h] - target_nrm[:h]) ** 2))
        return err / (cfg.width * h)

    p.setattr(pf, "gbuffer_loss", half)


def _answer_altered(p):
    """The fit's G-buffer altered where it is produced: the normals of
    the middle quarter of the rows turned round (the target, rendered
    without a graph, is left as it is)."""
    import dataclasses

    import torch

    from sphereflake_tpu_torch import fit as pf

    orig = pf.render_gbuffer

    def broken(*a, **k):
        gb = orig(*a, **k)
        if not torch.is_grad_enabled():
            return gb
        h = gb.normal.shape[0]
        lo, hi = 3 * h // 8, 5 * h // 8
        normal = torch.cat([gb.normal[:lo], -gb.normal[lo:hi], gb.normal[hi:]])
        return dataclasses.replace(gb, normal=normal)

    p.setattr(pf, "render_gbuffer", broken)


FAULTS = {"state_unchanged": _state_unchanged, "half_the_batch": _half_the_batch,
          "answer_altered": _answer_altered}
