"""The port's CLI fitting and checkpoint flags (`--fit`, `--fit-steps`,
`--fit-lr`, `--fit-params`, `--fit-loss`, `--checkpoint`, `--resume`)
on the CPU, held to the reference CLI's tests (`tests/test_cli.py`: the
fit reduces the loss and writes its checkpoint; a progressive run
resumed from its checkpoint continues the cursor) and to its errors,
and a reference `--fit --checkpoint` file resumed by the port."""

import numpy as np

from sphereflake_tpu_torch.cli import main

import _torch_helpers  # noqa: F401  (one intra-op thread)


def _common(*extra):
    return [
        "--device", "cpu", "--width", "96", "--height", "64", "--depth",
        "2", "--algorithm", "fast", "--tile", "32x32", *extra,
    ]


def _fit_line(out):
    line = [ln for ln in out.splitlines() if ln.startswith("fit: loss")][0]
    return float(line.split()[2]), float(line.split()[5])


def test_fit_subcommand_reduces_loss(tmp_path, capsys):
    gbuf = tmp_path / "g.npz"
    assert main(_common(
        "--output", str(tmp_path / "t.png"), "--gbuffer", str(gbuf)
    )) == 0
    rc = main(_common(
        "--yaw", "0.93",  # perturbed start (default pose is 0.921999)
        "--fit", str(gbuf), "--fit-steps", "8",
        "--output", str(tmp_path / "f.png"),
        "--checkpoint", str(tmp_path / "ck.npz"),
    ))
    assert rc == 0
    out = capsys.readouterr().out
    first, best = _fit_line(out)
    assert best < first
    assert "fit step 0: loss" in out
    ck = np.load(tmp_path / "ck.npz")
    # scene (15 leaves) + optax adam state with the cosine schedule (32)
    assert len(ck.files) == 15 + 32
    assert int(ck["opt_state/0"]) == 8 and ck["opt_state/0"].dtype == np.int32
    assert (tmp_path / "f.png").stat().st_size > 0


def test_fit_errors_exit_2(tmp_path, capsys):
    gbuf = tmp_path / "g.npz"
    assert main(_common(
        "--mode", "normals", "--output", str(tmp_path / "t.png"),
        "--gbuffer", str(gbuf),
    )) == 0
    capsys.readouterr()
    assert main(_common("--fit", str(gbuf), "--fit-loss", "image",
                        "-o", str(tmp_path / "x.png"))) == 2
    assert "no 'image' plane" in capsys.readouterr().err
    assert main(_common("--fit", str(gbuf), "--fit-params", "ssao",
                        "-o", str(tmp_path / "x.png"))) == 2
    assert "--fit-loss image" in capsys.readouterr().err


def test_progressive_checkpoint_resume(tmp_path, capsys):
    ck = tmp_path / "prog.npz"
    assert main(_common(
        "--progressive", "3", "--batch", "1024",
        "--output", str(tmp_path / "p.png"), "--checkpoint", str(ck),
    )) == 0
    assert main(_common(
        "--progressive", "2", "--batch", "1024", "--resume", str(ck),
        "--output", str(tmp_path / "p2.png"),
    )) == 0
    txt = capsys.readouterr().out
    counts = [
        int(ln.split()[1]) for ln in txt.splitlines()
        if ln.startswith("progressive:")
    ]
    assert counts == [3072, 5120]  # resumed run continues the cursor


def test_tile_progressive_checkpoint_resume(tmp_path, capsys):
    ck = tmp_path / "tiles.npz"
    tiles = ["--device", "cpu", "--width", "96", "--height", "64",
             "--depth", "2", "--batch", "2048"]
    assert main(tiles + ["--progressive", "2", "-o", str(tmp_path / "a.png"),
                         "--checkpoint", str(ck)]) == 0
    assert "progressive_tiles/0" in np.load(ck).files
    assert main(tiles + ["--progressive", "1", "--resume", str(ck),
                         "-o", str(tmp_path / "b.png")]) == 0
    counts = [
        int(ln.split()[1]) for ln in capsys.readouterr().out.splitlines()
        if ln.startswith("progressive[tile]:")
    ]
    assert counts == [4096, 6144]


def test_reference_fit_checkpoint_resumes_in_the_port(tmp_path, capsys):
    """A checkpoint the reference CLI's `--fit --checkpoint` wrote (scene +
    optax adam state with the cosine schedule) is taken by the port's
    `--resume`: the resumed fit starts from the reference's parameters."""
    from sphereflake_tpu.cli import main as ref_main

    gbuf = tmp_path / "g.npz"
    assert main(_common("-o", str(tmp_path / "t.png"),
                        "--gbuffer", str(gbuf))) == 0
    ref_ck = tmp_path / "ref.npz"
    ref_args = [a for a in _common() if a not in ("--device", "cpu")]
    assert ref_main(ref_args + [
        "--devices", "1", "--yaw", "0.93", "--fit", str(gbuf),
        "--fit-steps", "3", "-o", str(tmp_path / "r.png"),
        "--checkpoint", str(ref_ck),
    ]) == 0
    ref_first, _ = _fit_line(capsys.readouterr().out)
    assert main(_common(
        "--yaw", "0.93", "--fit", str(gbuf), "--fit-steps", "3",
        "--resume", str(ref_ck), "-o", str(tmp_path / "p.png"),
    )) == 0
    port_first, _ = _fit_line(capsys.readouterr().out)
    assert port_first < ref_first  # continued from the fitted parameters
