"""CPU rehearsals of every bench.py entry point.

bench.py measures the GPU, so a code path that only the GPU run reaches
would rot unseen. These tests run each entry point in-process at tiny
sizes with `--cpu-rehearsal` (conftest forces jax_platforms=cpu) and
assert that (a) it finishes, (b) it prints exactly one parseable JSON
line that names the CPU as its platform. Without the flag the harness
must refuse to run on the CPU.
"""

import json
import sys

import pytest


def _run_bench(monkeypatch, capsys, argv):
    import bench

    monkeypatch.setattr(
        sys, "argv", ["bench.py", "--cpu-rehearsal"] + argv
    )
    bench.main()
    out = capsys.readouterr().out
    lines = [l for l in out.strip().splitlines() if l.strip()]
    json_lines = [l for l in lines if l.lstrip().startswith("{")]
    assert len(json_lines) == 1, f"expected ONE JSON line, got: {out!r}"
    rec = json.loads(json_lines[0])
    for field in ("metric", "value", "unit", "platform", "device_kind",
                  "device_count", "card"):
        assert field in rec, f"missing {field}: {rec}"
    assert isinstance(rec["value"], (int, float))
    assert rec["platform"] == "cpu" and rec["device_count"] == 8
    return rec


def test_bench_refuses_cpu_without_rehearsal_flag(monkeypatch, capsys):
    import bench

    monkeypatch.setattr(sys, "argv", ["bench.py", "--cat", "--reps", "1"])
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code != 0
    captured = capsys.readouterr()
    assert "no GPU" in captured.err
    assert "{" not in captured.out


def test_bench_flagship_smoke(monkeypatch, capsys):
    rec = _run_bench(
        monkeypatch, capsys, ["--n", "4096", "--reps", "1", "--iters", "6"]
    )
    assert rec["metric"] == "registered_points_per_sec_per_chip"
    # quality gate must pass at this easy config (value 0 = diverged)
    assert rec["value"] > 0


def test_bench_batch_smoke(monkeypatch, capsys):
    rec = _run_bench(
        monkeypatch, capsys,
        ["--batch", "2", "--n", "40960", "--reps", "1", "--iters", "6"],
    )
    assert rec["metric"] == "batched_registered_points_per_sec_per_chip"
    assert rec["value"] > 0


def test_bench_cat_smoke(monkeypatch, capsys):
    rec = _run_bench(monkeypatch, capsys, ["--cat", "--reps", "1"])
    assert rec["metric"] == "cat_pair_registered_points_per_sec"
    assert rec["value"] > 0


def test_bench_odometry_smoke(monkeypatch, capsys):
    rec = _run_bench(
        monkeypatch,
        capsys,
        [
            "--odometry",
            "--frames",
            "4",
            "--scan-points",
            "1024",
            "--reps",
            "1",
            "--iters",
            "4",
        ],
    )
    assert rec["metric"] == "odometry_registered_points_per_sec"
    assert rec["value"] > 0


def test_bench_odometry_batch_smoke(monkeypatch, capsys):
    rec = _run_bench(
        monkeypatch,
        capsys,
        [
            "--odometry",
            "--odo-batch",
            "--frames",
            "4",
            "--scan-points",
            "1024",
            "--reps",
            "1",
            "--iters",
            "6",
        ],
    )
    assert rec["metric"] == "odometry_batched_points_per_sec_per_chip"
    assert rec["value"] > 0


def test_bench_odometry_batch_block_smoke(monkeypatch, capsys):
    # scan size above block_auto_threshold: the batch rides
    # register_batch_block (in-jit normals, per-pair KD indexes)
    rec = _run_bench(
        monkeypatch,
        capsys,
        [
            "--odometry",
            "--odo-batch",
            "--frames",
            "3",
            "--scan-points",
            "32768",
            "--reps",
            "1",
            "--iters",
            "6",
        ],
    )
    assert rec["metric"] == "odometry_batched_points_per_sec_per_chip"
    assert rec["value"] > 0
