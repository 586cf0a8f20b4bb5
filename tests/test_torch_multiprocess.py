"""Two processes over gloo on the CPU (`sphereflake_tpu_torch.parallel.
worker`, the port's copy of `tools/multihost_worker.py`), in the config of
`tests/test_multihost.py` (128 wide, 16 rows per device, depth 2, 16x64
tiles, `fast`): each process renders its row-band of a global 2x1 mesh
and runs one sharded fit step. The stitched min_t must equal the port's
single-process render over a mesh of two CPU devices bit for bit; the
all-reduced loss and gradient fingerprint must be equal on both ranks
bit for bit, and match the single-process fit step (rtol 1e-6: the
gradients of the two blocks are summed in another order). The
processes import no JAX; they run under their own 120-s timeout."""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from sphereflake_tpu_torch.config import RenderConfig, default_scene
from sphereflake_tpu_torch.parallel import (
    fit_step_sharded,
    make_mesh,
    render_gbuffer_sharded,
)
from sphereflake_tpu_torch.parallel import distributed

import _torch_helpers  # noqa: F401  (one intra-op thread per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROCS = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cfg():
    return RenderConfig(width=128, height=16 * NPROCS, max_depth=2,
                        tile_h=16, tile_w=64, max_frontier=128)


@pytest.fixture(scope="module")
def worker_outputs(tmp_path_factory):
    out = tmp_path_factory.mktemp("workers")
    port = _free_port()
    env = {
        **os.environ,
        "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        "OMP_NUM_THREADS": "1",
    }
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "sphereflake_tpu_torch.parallel.worker",
             str(out), "--coordinator", f"127.0.0.1:{port}",
             "--nprocs", str(NPROCS), "--pid", str(pid), "--device", "cpu"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(NPROCS)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert all("jax" not in log.lower() for log in logs)
    return [dict(np.load(out / f"worker_{r}.npz")) for r in range(NPROCS)]


def test_two_processes_match_one(worker_outputs):
    a, b = worker_outputs
    assert float(a["loss"]) == float(b["loss"]) > 0.0
    np.testing.assert_array_equal(a["grad_fingerprint"], b["grad_fingerprint"])
    assert a["grad_fingerprint"].sum() > 0.0
    rows = {}
    for f in worker_outputs:
        for k, v in f.items():
            if k.startswith("minrow_"):
                rows[int(k.split("_")[1])] = v
    assert sorted(rows) == [0, 16]  # one row-band per process
    stitched = np.concatenate([rows[k] for k in sorted(rows)], axis=0)

    cfg = _cfg()
    scene = default_scene("cpu")
    mesh = make_mesh(["cpu"] * NPROCS, shape=(NPROCS, 1))
    gb = render_gbuffer_sharded(scene, cfg, mesh)
    np.testing.assert_array_equal(stitched, gb.min_t.numpy())
    cam = dataclasses.replace(scene.camera, yaw=scene.camera.yaw + 0.01)
    target = render_gbuffer_sharded(
        dataclasses.replace(scene, camera=cam), cfg, mesh)
    loss, grads = fit_step_sharded(scene, target.position, target.normal,
                                   cfg, mesh)
    np.testing.assert_allclose(float(a["loss"]), float(loss), rtol=1e-6)
    want = np.array([float(torch.sum(torch.abs(g))) for g in grads.leaves()])
    np.testing.assert_allclose(a["grad_fingerprint"], want, rtol=1e-6)


def test_single_process_needs_no_process_group(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize_distributed()  # nothing to do
    assert distributed.process_info() == (0, 1)
    mesh = distributed.global_mesh(local_devices=["cpu", "cpu"])
    assert mesh.shape == (2, 1) and not mesh.multi_process
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize_distributed(num_processes=2, process_id=0)
    assert distributed.choose_backend("cpu", 2) == "gloo"
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.process_device("cpu") == torch.device("cpu")
