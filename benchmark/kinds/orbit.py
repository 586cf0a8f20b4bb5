"""Traffic kind `orbit`: a camera path, one client in a closed loop.

The window drives the program's `runtime.animate.animate(mode="orbit",
composite=True)`, started again whenever a revolution of
`frames_per_revolution` frames ends; the seed sets the start angle.
Each frame's image reaches the host as `animate` yields it. End to end:
`frame_ms` (the window over its frames) and `frame_ms_p95` (the 95th
percentile of every frame's time). The check compares a sample of the
window's frames, drawn from the seed, G-buffer and composited image,
with the reference's.

Traffic parameters: `frames_per_revolution`, `warmup_frames`, `spans`.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark import check, drivers, scene as sc

TINY = {"frames_per_revolution": 6, "warmup_frames": 1}


def reference_orbit(scene0: dict, i: int, n: int, device):
    """The reference's own pose of orbit frame i of n from the start
    scene (float64, from the same float32 start leaves)."""
    import torch

    out = sc.to_reference(scene0, device)
    pos0 = scene0["camera"]["position"].astype(np.float64)
    pos = sc.orbit_position(pos0, 2.0 * math.pi * i / n, float(np.linalg.norm(pos0)))
    yaw, pitch = sc.look_at_origin(pos)
    cam = out["camera"]
    cam["position"] = torch.as_tensor(pos, dtype=torch.float64, device=device)
    cam["yaw"] = torch.tensor(yaw, dtype=torch.float64, device=device)
    cam["pitch"] = torch.tensor(pitch, dtype=torch.float64, device=device)
    return out


class Driver(drivers.Driver):
    def setup(self):
        from sphereflake_tpu_torch import render
        from sphereflake_tpu_torch.runtime.animate import animate

        self.animate = animate
        self.fpr = int(self.traffic["frames_per_revolution"])
        self.scene0 = sc.posed(sc.base_scene(self.config), sc.seeded_angle(self.seed))
        self.program_scene = sc.to_program(self.scene0, self.dev)
        # Count render_frame calls (an overflowing frame is rendered again
        # one capacity rung up) and keep the G-buffer of the latest.
        self._render_frame = render.render_frame
        self.calls = 0
        self.last_gb = None

        def counted(*a, **k):
            self.calls += 1
            image, gb = self._render_frame(*a, **k)
            self.last_gb = gb
            return image, gb

        render.render_frame = counted
        self._render_mod = render
        self.rand = sc.rng(self.seed, "sample")
        self.keep_n = int(self.work_spec["check_frames"])
        self.kept = []  # reservoir of (pose index, image, min_t, normal)
        self.gen = None
        self.k = 0
        for _ in range(int(self.traffic["warmup_frames"])):
            self._frame(keep=False)
        self.gen = None
        self.k = 0
        self.calls_at_window = self.calls

    def _frame(self, keep=True):
        if self.gen is None or self.k % self.fpr == 0:
            self.gen = self.animate(self.program_scene, self.cfg, self.fpr,
                                    mode="orbit", composite=True,
                                    device=self.dev)
        image, _scene = next(self.gen)
        i = self.k % self.fpr
        self.k += 1
        if keep:
            self.attempted += 1
            # Reservoir sampling: a uniform sample of the window's frames.
            n = self.attempted
            slot = n - 1 if n <= self.keep_n else self.rand.randrange(n)
            if slot < self.keep_n:
                gb = self.last_gb
                row = (i, image, gb.min_t, gb.normal)
                if slot < len(self.kept):
                    self.kept[slot] = row
                else:
                    self.kept.append(row)
        return i

    def unit(self):
        self._frame()

    def profile(self, n, profile_fn):
        """(profile of n frames, their pose indices)."""
        poses = []
        return profile_fn(lambda: poses.append(self._frame(keep=False)), n), poses

    def end_to_end(self, window_s, times):
        ms = np.asarray(times) * 1e3
        self.notes["re_renders"] = self.calls - self.calls_at_window - len(times)
        return {"frame_ms": window_s * 1e3 / len(times),
                "frame_ms_p95": float(np.quantile(ms, 0.95))}

    def release(self):
        self._render_mod.render_frame = self._render_frame
        self.gen = None
        self.last_gb = None
        self.program_scene = None

    def check(self):
        import torch

        from benchmark.reference import noise, post, sphereflake as ref

        rows = []
        tex = torch.from_numpy(noise.ssao_noise_texture(64))
        for i, image, min_t, normal in self.kept:
            s = reference_orbit(self.scene0, i, self.fpr, self.dev)
            g = ref.gbuffer(s, self.ref_cfg, self.dev)
            t = ref.image(self.ref_cfg, g["t"])
            r_pos = ref.image(self.ref_cfg, g["position"])
            r_nrm = ref.image(self.ref_cfg, g["normal"])
            num = check.gbuffer_numbers(min_t.to(self.dev), normal.to(self.dev), t, r_nrm)
            r_img = post.postprocess(r_pos, r_nrm, t, s, tex.to(self.dev))
            num.update(check.image_numbers(image, r_img))
            rows.append(num)
            del g, r_pos, r_nrm, r_img
        self.kept = []
        return check.worst(rows)

    def work(self, profiled_poses):
        """Per profiled frame: the reference's distinct candidate (tile,
        node) pairs over the whole padded tile grid."""
        from benchmark.reference import sphereflake as ref

        out = []
        for i in profiled_poses:
            s = reference_orbit(self.scene0, i, self.fpr, self.dev)
            g = ref.gbuffer(s, self.ref_cfg, self.dev, count=True)
            out.append(int(g["pairs"].sum()))
        tx, ty = ref.tile_grid(self.ref_cfg)
        band_rows = self.cfg.effective_band_rows
        bands = ty // band_rows if band_rows else 1
        return dict(pairs=out, tiles=tx * ty, deep=self.ref_cfg["max_depth"] >= 7,
                    calls=bands * len(out))


def control(torch, cell: dict, seed: int, device) -> dict:
    """The numbers of the control at `seed`: the reference with each
    ray-sphere test, the shading and the post chain in bfloat16, in the
    program's place, at a frame of the orbit drawn from the seed."""
    from benchmark.reference import noise, post, sphereflake as ref

    dev = torch.device(device)
    low = torch.bfloat16
    rc = drivers.ref_config(cell["config"])
    s0 = sc.posed(sc.base_scene(cell["config"]), sc.seeded_angle(seed))
    fpr = int(cell["traffic"]["frames_per_revolution"])
    s = reference_orbit(s0, sc.rng(seed, "control").randrange(fpr), fpr, dev)
    tex = torch.from_numpy(noise.ssao_noise_texture(64)).to(dev)
    g = ref.gbuffer(s, rc, dev)
    c = ref.gbuffer(s, rc, dev, test_dtype=low)
    t, ct = ref.image(rc, g["t"]), ref.image(rc, c["t"])
    num = check.gbuffer_numbers(ct, ref.image(rc, c["normal"]), t,
                                ref.image(rc, g["normal"]))
    img = post.postprocess(ref.image(rc, g["position"]),
                           ref.image(rc, g["normal"]), t, s, tex)
    cimg = post.postprocess(ref.image(rc, c["position"]),
                            ref.image(rc, c["normal"]), ct, s, tex, dtype=low)
    num.update(check.image_numbers(cimg, img))
    return num


def _band_dropped(p):
    """The G-buffer altered where it is produced: a band of pixels loses
    its hits."""
    import dataclasses

    from sphereflake_tpu_torch import render

    orig = render.render_gbuffer

    def broken(*a, **k):
        gb = orig(*a, **k)
        h = gb.min_t.shape[0] // 4
        min_t = gb.min_t.clone()
        min_t[:h] = 3.0e38
        normal, position = gb.normal.clone(), gb.position.clone()
        normal[:h] = 0.0
        position[:h] = 0.0
        return dataclasses.replace(gb, min_t=min_t, normal=normal,
                                   position=position, hit=min_t < 3.0e38)

    p.setattr(render, "render_gbuffer", broken)


def _stale(p):
    """Every frame yields the first frame's image and G-buffer (a step
    that returns its state unchanged)."""
    from sphereflake_tpu_torch import render

    orig, first = render.render_frame, []

    def stale(*a, **k):
        if not first:
            first.append(orig(*a, **k))
        return first[0]

    p.setattr(render, "render_frame", stale)


FAULTS = {"answer_altered": _band_dropped, "state_unchanged": _stale}
