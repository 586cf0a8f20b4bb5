"""Traffic kind `refresh`: sustained frameless refresh of a static view.

A static view at a seed-chosen angle on the orbit is prepared
(`progressive_prepare_trimmed`) and initialised
(`progressive_tiles_init(seed)`) in set-up; the window drives
`progressive_tiles_step(tiles_per_step)` with one host read at the end.
End to end: `refresh_rays_per_s`, every step's `tiles_per_step` x 1,024
rays over the whole window.

The check holds the rate's count of work and the buffer to the
reference:
- the buffer the window leaves, against the reference's G-buffer of the
  view (every tile has been refreshed many times over);
- a probe step through the window's own call, from the state where the
  window left it with every row set to NaN: the tiles it refreshes must
  be exactly the reference's Sobol tiles of that step (`tiles_off`, the
  tiles refreshed or left that should not have been, over
  `tiles_per_step`), so a step that traces fewer tiles, or others, than
  it counts is caught;
- the state's cursor must have advanced by exactly `tiles_per_step` for
  every step the harness drove (`cursor_off`);
- overflow 0, the configuration's guarantee.

Traffic parameters: `tiles_per_step`, `warmup_steps`, `spans`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark import check, drivers, scene as sc

TINY = {"tiles_per_step": 4, "warmup_steps": 1}


class Driver(drivers.Driver):
    def setup(self):
        from sphereflake_tpu_torch.runtime import progressive as pg

        self.pg = pg
        self.k = int(self.traffic["tiles_per_step"])
        self.scene0 = sc.posed(sc.base_scene(self.config), sc.seeded_angle(self.seed))
        self.program_scene = sc.to_program(self.scene0, self.dev)
        self.stream_seed = self.seed & 0xFFFFFFFF
        with self.torch.no_grad():
            self.prepared = pg.progressive_prepare_trimmed(
                self.program_scene, self.cfg, device=self.dev)
            self.state = pg.progressive_tiles_init(
                self.cfg, seed=self.stream_seed, device=self.dev)
        self.notes["prepare_overflow"] = int(self.prepared[3])
        self.steps = 0  # every step driven, set-up and profile included
        for _ in range(int(self.traffic["warmup_steps"])):
            self.unit()
        self.sync()
        self.attempted = 0

    def _step(self, state):
        return self.pg.progressive_tiles_step(
            state, self.program_scene, self.cfg, tiles_per_step=self.k,
            prepared=self.prepared)

    def unit(self):
        self.state = self._step(self.state)
        self.steps += 1
        self.attempted += 1

    def end_to_end(self, window_s, times):
        return {"refresh_rays_per_s": len(times) * self.k * 1024 / window_s}

    def release(self):
        """Runs the probe step while the program's state is held, then
        frees it."""
        torch = self.torch
        st = self.state
        self.cursor = (int(st.sample_hi) << 32) | int(st.sample_lo)
        probe = dataclasses.replace(st, rows=torch.full_like(st.rows, float("nan")))
        with torch.no_grad():
            out = self._step(probe)
        self.refreshed = (~torch.isnan(out.rows).flatten(1).any(1)).cpu().numpy()
        self.probe_overflow = int(out.overflow)
        del probe, out
        self.prepared = None
        self.program_scene = None

    def check(self):
        from benchmark.reference import sphereflake as ref, tiles

        rows = self.state.rows  # [T, 7, 8, 128]: min_t, position, normal
        per_ray = rows.reshape(rows.shape[0], 7, -1).movedim(1, 2).reshape(-1, 7)
        min_t = ref.image(self.ref_cfg, per_ray[:, 0])
        normal = ref.image(self.ref_cfg, per_ray[:, 4:7])
        overflow = int(self.state.overflow)
        n_tiles = rows.shape[0]
        self.state = None
        s = sc.to_reference(self.scene0, self.dev)
        g = ref.gbuffer(s, self.ref_cfg, self.dev)
        num = check.gbuffer_numbers(min_t, normal, ref.image(self.ref_cfg, g["t"]),
                                    ref.image(self.ref_cfg, g["normal"]))
        want = np.zeros(n_tiles, bool)
        want[tiles.step_tiles(self.stream_seed, self.steps, self.k, n_tiles)] = True
        num["tiles_off"] = float((want != self.refreshed).sum()) / self.k
        num["cursor_off"] = float(abs(self.cursor - self.steps * self.k))
        num["overflow"] = float(overflow + self.probe_overflow
                                + self.notes["prepare_overflow"])
        return num

    def profile(self, n, profile_fn):
        """(profile of n steps, the tile ids each of them traced)."""
        ids = []
        orig = self.pg.progressive_tile_ids

        def rec(*a, **k):
            out = orig(*a, **k)
            ids.append(out[0])
            return out

        self.pg.progressive_tile_ids = rec
        try:
            return profile_fn(self.unit, n), ids
        finally:
            self.pg.progressive_tile_ids = orig

    def work(self, ids):
        """The reference's distinct candidate pairs of the tiles the
        profiled steps traced (the untrimmed work: no occlusion trim)."""
        from benchmark.reference import sphereflake as ref

        s = sc.to_reference(self.scene0, self.dev)
        g = ref.gbuffer(s, self.ref_cfg, self.dev, count=True)
        per_tile = g["pairs"]
        pairs = [int(per_tile[i.to(per_tile.device).long()].sum()) for i in ids]
        return dict(pairs=pairs, ids=[int(i.numel()) for i in ids],
                    deep=self.ref_cfg["max_depth"] >= 7)


def control(torch, cell: dict, seed: int, device) -> dict:
    """The numbers of the control at `seed`: the reference with each
    ray-sphere test and the shading in bfloat16, in the program's place,
    refreshing every tile; its tiles are the reference's own."""
    from benchmark.reference import sphereflake as ref

    dev = torch.device(device)
    rc = drivers.ref_config(cell["config"])
    s = sc.to_reference(sc.posed(sc.base_scene(cell["config"]),
                                 sc.seeded_angle(seed)), dev)
    g = ref.gbuffer(s, rc, dev)
    c = ref.gbuffer(s, rc, dev, test_dtype=torch.bfloat16)
    num = check.gbuffer_numbers(ref.image(rc, c["t"]), ref.image(rc, c["normal"]),
                                ref.image(rc, g["t"]), ref.image(rc, g["normal"]))
    num.update(tiles_off=0.0, cursor_off=0.0, overflow=0.0)
    return num


def _state_unchanged(p):
    from sphereflake_tpu_torch.runtime import progressive

    p.setattr(progressive, "progressive_tiles_step", lambda state, *a, **k: state)


def _normals_altered(p):
    """Every refreshed tile's normals turned round where they are
    produced."""
    from sphereflake_tpu_torch.runtime import progressive

    orig = progressive.progressive_tiles_step

    def broken(*a, **k):
        st = orig(*a, **k)
        rows = st.rows.clone()
        rows[:, 4:7] = -rows[:, 4:7]
        return dataclasses.replace(st, rows=rows)

    p.setattr(progressive, "progressive_tiles_step", broken)


def _half_the_tiles(p):
    """Each step traces half of its tiles and counts (and advances its
    cursor by) all of them: the buffer still converges over a window."""
    from sphereflake_tpu_torch.runtime import progressive

    orig = progressive.progressive_tile_ids

    def half(state, cfg, k):
        ids, lo, hi = orig(state, cfg, k)
        return ids[: k // 2], lo, hi

    p.setattr(progressive, "progressive_tile_ids", half)


FAULTS = {"state_unchanged": _state_unchanged, "answer_altered": _normals_altered,
          "half_the_batch": _half_the_tiles}
