"""chip_smoke.py's phase functions at tiny sizes on the CPU: each runs
its path through the user entry points and enforces its gate. (The
script itself refuses to run without a GPU; see test_portability.)"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def test_phase_cat():
    out = chip_smoke.phase_cat(reps=1)
    assert out["n"] == 3400 and out["rot_err"] < 1e-3


def test_phase_pair_block_gather():
    out = chip_smoke.phase_pair(16384, "b", reps=1)
    assert out["payload"] == "gather" and out["rot_err"] < 5e-3


def test_phase_pair_block_infold_large_tiles():
    # phase c's path (infold payload, Sq=128 query tiles) scaled down
    out = chip_smoke.phase_pair(
        16384, "c", reps=0, payload_infold_threshold=8192
    )
    assert out["payload"] == "infold" and out["t_err"] < 5e-3


def test_phase_odometry():
    out = chip_smoke.phase_odometry(n_frames=4, scan_points=2048, reps=0)
    assert out["ate_m"] < 0.5 and out["fps"] > 0


@pytest.mark.parametrize("n,q_tile", [(8192, 64), (16384, 128)])
def test_fold_agreement_interpreted(n, q_tile):
    out = chip_smoke.fold_agreement(
        n, q_tile=q_tile, n_check=2048, reps=0, interpret=True
    )
    assert out["exact_payload_copy"]
    assert out["miss_rate_kernel"] <= out["miss_rate_xla"] + 1e-4


def test_phase_gate_raises():
    with pytest.raises(chip_smoke.PhaseFailed):
        chip_smoke._check(False, "gate")
