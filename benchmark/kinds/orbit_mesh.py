"""Traffic kind `orbit_mesh`: the camera path of `orbit` with every frame
sharded over a device mesh of the cell's cards, one client in a closed
loop.

The window drives the program's `runtime.animate.animate(mode="orbit",
composite=True, mesh=...)`, the mesh built from the run's cards in the
configuration's `mesh.shape` (row-major, the home card first). A CUDA
card is never used twice: given fewer cards than the mesh has cells, the
driver raises. A single CPU device fills the mesh (`[cpu] * n`, as the
program's CPU tests run it), so the harness's tests run the kind. The
rest is `orbit`'s driver: the start angle from the seed, each frame's
whole image on the host as `animate` yields it, the revolution restarted
after the warm-up frames, `frame_ms` (the window over its frames) end to
end. The check compares a sample of the window's frames, G-buffer and
composited image on the whole frame, with the reference computed in
bands over the cell's cards (`reference/blocked.py`).

Traffic parameters: `frames_per_revolution`, `warmup_frames`.
"""

from __future__ import annotations

import numpy as np

from benchmark import drivers, scene as sc, spec

TINY = {"warmup_frames": 1}


def mesh_devices(torch, devs, shape) -> list:
    """The mesh's devices, row-major: the first prod(shape) of `devs`, or
    a single CPU device repeated."""
    n = int(np.prod(shape))
    devs = [torch.device(d) for d in devs]
    if len(devs) == 1 and devs[0].type == "cpu":
        return devs * n
    if len(devs) < n or len(set(devs[:n])) < n:
        raise ValueError(f"a {shape[0]}x{shape[1]} mesh needs {n} distinct "
                         f"cards, the run was given {[str(d) for d in devs]}")
    return devs[:n]


def _cards(torch, device, chips: int) -> list:
    """The control's devices: the cell's cards, or one CPU device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i)
            for i in range(min(chips, torch.cuda.device_count()))]


class Driver(spec.kind("orbit").Driver):
    """The `orbit` driver with the mesh in its place: the render hook, the
    keyword `animate` takes, the G-buffer taken only of a drawn frame, no
    roofline work, and the check in bands."""

    def setup(self):
        from sphereflake_tpu_torch import parallel

        shape = tuple(self.config["mesh"]["shape"])
        self.mesh = parallel.make_mesh(
            mesh_devices(self.torch, self.devs, shape), shape=shape)
        # Count the frames rendered (an overflowing frame is rendered
        # again one capacity rung up) and keep the G-buffer of a frame
        # the sample has drawn before it is rendered.
        self._parallel = parallel
        self._render = parallel.render_frame_sharded
        self.want = False
        self.drawn = None

        def counted(*a, **k):
            self.calls += 1
            image, gb = self._render(*a, **k)
            if self.want:
                self.drawn = (gb.min_t, gb.normal)
            return image, gb

        parallel.render_frame_sharded = counted
        # `orbit`'s own hook on `render.render_frame` is set too, and never
        # called: the mesh path does not go through it.
        super().setup()

    def _frame(self, keep=True):
        slot = None
        if keep:
            self.attempted += 1
            # Reservoir sampling: a uniform sample of the window's frames,
            # drawn before the frame so that only a drawn frame's G-buffer
            # is held.
            n = self.attempted
            slot = n - 1 if n <= self.keep_n else self.rand.randrange(n)
            slot = slot if slot < self.keep_n else None
        if self.gen is None or self.k % self.fpr == 0:
            self.gen = self.animate(self.program_scene, self.cfg, self.fpr,
                                    mode="orbit", composite=True, mesh=self.mesh)
        self.want = slot is not None
        image, _scene = next(self.gen)
        self.want = False
        i = self.k % self.fpr
        self.k += 1
        if slot is not None:
            row = (i, image, *self.drawn)
            self.drawn = None
            if slot < len(self.kept):
                self.kept[slot] = row
            else:
                self.kept.append(row)
        return i

    def work(self, profiled_poses):
        return None

    def release(self):
        self._parallel.render_frame_sharded = self._render
        self.mesh = None
        super().release()

    def check(self):
        import torch

        from benchmark import check
        from benchmark.reference import blocked, noise

        tex = torch.from_numpy(noise.ssao_noise_texture(64))
        rows = []
        for i, image, min_t, normal in self.kept:
            s = spec.kind("orbit").reference_orbit(self.scene0, i, self.fpr, self.dev)
            bands = blocked.frame(s, self.ref_cfg, self.devs, tex)

            def rows_of(y0, y1, dev):
                return (min_t[y0:y1].to(dev), normal[y0:y1].to(dev),
                        image[y0:y1])

            rows.append(blocked.numbers(bands, rows_of))
            del bands
        self.kept = []
        return check.worst(rows)


def control(torch, cell: dict, seed: int, device) -> dict:
    """The numbers of the control at `seed`: the reference with each
    ray-sphere test, the shading and the post chain in bfloat16, in the
    program's place, at a frame of the orbit drawn from the seed, both
    computed in bands over the cell's cards."""
    from benchmark.reference import blocked, noise

    cards = _cards(torch, device, int(cell["entry"]["chips"]))
    rc = drivers.ref_config(cell["config"])
    s0 = sc.posed(sc.base_scene(cell["config"]), sc.seeded_angle(seed))
    fpr = int(cell["traffic"]["frames_per_revolution"])
    s = spec.kind("orbit").reference_orbit(
        s0, sc.rng(seed, "control").randrange(fpr), fpr, cards[0])
    tex = torch.from_numpy(noise.ssao_noise_texture(64))
    low = blocked.frame(s, rc, cards, tex, test_dtype=torch.bfloat16,
                        dtype=torch.bfloat16)
    parts = {(b.y0, b.y1): (b.t, b.normal, b.image) for b in low}
    del low
    bands = blocked.frame(s, rc, cards, tex)
    return blocked.numbers(bands, lambda y0, y1, dev: parts[(y0, y1)])


def _per_block(p):
    """Frames take the per-block path, as the cell's banded frames do (a
    small unbanded frame would take the shared bin)."""
    from sphereflake_tpu_torch.parallel import shared_bin

    p.setattr(shared_bin, "shared_bin_supported", lambda cfg, mesh: False)


def _block_sky(p):
    """One cell's block is left unrendered: all sky."""
    from sphereflake_tpu_torch.parallel import sharded

    orig = sharded._render_block

    def sky(scene, cfg, bcfg, iy, ix):
        pos, nrm, min_t, hit, metrics = orig(scene, cfg, bcfg, iy, ix)
        if (iy, ix) != (0, 0):
            return pos, nrm, min_t, hit, metrics
        return (pos.new_zeros(pos.shape), nrm.new_zeros(nrm.shape),
                min_t.new_full(min_t.shape, 3.0e38),
                hit.new_zeros(hit.shape), metrics)

    _per_block(p)
    p.setattr(sharded, "_render_block", sky)


def _blocks_swapped(p):
    """The first and the last block trade places in every assembly."""
    from sphereflake_tpu_torch.parallel import sharded

    orig = sharded.tile_blocks

    def swapped(mesh, cells):
        cells = list(cells)
        cells[0], cells[-1] = cells[-1], cells[0]
        return orig(mesh, cells)

    _per_block(p)
    p.setattr(sharded, "tile_blocks", swapped)


def _stale(p):
    """Every frame yields the first frame's image and G-buffer (a step
    that returns its state unchanged)."""
    from sphereflake_tpu_torch import parallel

    orig, first = parallel.render_frame_sharded, []

    def stale(*a, **k):
        if not first:
            first.append(orig(*a, **k))
        return first[0]

    p.setattr(parallel, "render_frame_sharded", stale)


FAULTS = {"block_unrendered": _block_sky, "blocks_swapped": _blocks_swapped,
          "state_unchanged": _stale}
