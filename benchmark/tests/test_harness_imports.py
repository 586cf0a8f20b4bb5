"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole: the port's name starts with the JAX package's), and the reference
imports nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark import run, spec


def test_names_are_compared_whole():
    mods = ["sphereflake_tpu_torch", "sphereflake_tpu_torch.render", "jaxtyping",
            "flaxen", "benchmark.run"]
    assert run.forbidden_modules(mods) == []
    assert run.forbidden_modules(mods + ["sphereflake_tpu.render"]) == ["sphereflake_tpu"]
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


CHILD = r"""
import sys, tempfile, torch
sys.path.insert(0, {root!r})
from benchmark import run
from benchmark.tests import tiny
d = tiny.folder(tempfile.mkdtemp())
for name in {cells!r}:
    run.run(torch, tiny.cell(name, d), 5, 0.2, True, "cpu")
print("FORBIDDEN", run.forbidden_modules())
"""


def test_a_run_loads_no_jax():
    cells = [w["name"] for w in spec.benchmark()["workloads"]]
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", CHILD.format(root=spec.ROOT, cells=cells)],
                         capture_output=True, text=True, timeout=900, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(spec.HERE, "reference")
    for name in os.listdir(ref_dir):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref_dir, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            for top in tops:
                assert top not in ("sphereflake_tpu_torch", "sphereflake_tpu", "jax"), (name, top)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.sphereflake, benchmark.reference.post, "
            "benchmark.reference.noise\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'sphereflake_tpu_torch', 'sphereflake_tpu', 'jax'}))" % spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_a_card_no_result(tmp_path):
    """The command refuses to run without a card: exit 2, no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(spec.HERE, "run.py"),
                          "--workload", "frame_1080p_d6_orbit", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env=env,
                         cwd=str(tmp_path))
    assert out.returncode == 2
    assert out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files the command exits non-zero and prints no result."""
    import shutil

    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "frame_1080p_d6_orbit", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         env=env, cwd=str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
