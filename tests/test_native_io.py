"""Native C++ IO library: build, parse/format parity vs numpy, fallback."""

import os
import subprocess
from pathlib import Path

import numpy as np
import pytest

from icpx.io import native


@pytest.fixture(scope="module")
def lib():
    l = native.get_lib()
    if l is None:
        pytest.skip("native toolchain unavailable")
    return l


def test_parse_float_table(lib, rng):
    arr = rng.normal(size=(100, 5)).astype(np.float32)
    text = "\n".join(
        " ".join(f"{v:.8g}" for v in row) for row in arr
    ).encode()
    out = native.parse_float_table(text, 100, 5)
    assert out is not None
    assert np.allclose(out, arr, rtol=1e-6)


def test_parse_handles_nan_inf_comments(lib):
    text = b"# a comment\n1.0 nan inf\n-inf 2.5e-3 3\n"
    out = native.parse_float_table(text, 2, 3)
    assert out is not None
    assert np.isnan(out[0, 1]) and np.isinf(out[0, 2])
    assert out[1, 0] == -np.inf and abs(out[1, 1] - 2.5e-3) < 1e-9


def test_parse_truncated_returns_none(lib):
    assert native.parse_float_table(b"1 2 3", 2, 3) is None


def test_parse_float_columns(lib, rng):
    arr = rng.normal(size=(50, 6)).astype(np.float32)
    text = "\n".join(
        "\t".join(f"{v:.8g}" for v in row) for row in arr
    ).encode()
    out = native.parse_float_columns(text, 50, 6, 1, 3)
    assert out is not None
    assert np.allclose(out, arr[:, 1:4], rtol=1e-6)


def test_format_roundtrip(lib, rng):
    arr = rng.normal(size=(64, 3)).astype(np.float32) * 100
    payload = native.format_float_table(arr)
    assert payload is not None
    back = native.parse_float_table(payload, 64, 3)
    assert np.allclose(back, arr, rtol=1e-6)


def test_kitti_xyz(lib, rng):
    pts = rng.normal(size=(30, 4)).astype(np.float32)
    out = native.kitti_xyz(pts.tobytes())
    assert np.allclose(out, pts[:, :3])


def test_pcd_read_uses_native_and_matches(tmp_path, rng):
    """End parity: the PCD ascii reader produces identical clouds with and
    without the native parser."""
    from icpx.io.pcd import read_pcd, write_pcd

    xyz = (rng.normal(size=(500, 3)) * 50).astype(np.float32)
    p = tmp_path / "x.pcd"
    write_pcd(p, xyz)
    a = read_pcd(p)["xyz"]
    os.environ["ICPX_NO_NATIVE"] = "1"
    try:
        # force a fresh decision in a subprocess (module-level cache)
        code = (
            "import jax\n"
            # force CPU before any device touch: this subprocess must
            # not compete with the test process for an accelerator
            "jax.config.update('jax_platforms', 'cpu')\n"
            "import numpy as np\n"
            "from icpx.io.pcd import read_pcd\n"
            f"b = read_pcd({str(p)!r})['xyz']\n"
            f"np.save({str(tmp_path / 'b.npy')!r}, b)\n"
        )
        subprocess.run(
            ["python", "-c", code],
            check=True,
            env={**os.environ, "ICPX_NO_NATIVE": "1", "JAX_PLATFORMS": ""},
            capture_output=True,
            timeout=120,
        )
        b = np.load(tmp_path / "b.npy")
    finally:
        os.environ.pop("ICPX_NO_NATIVE", None)
    assert np.allclose(a, b, atol=1e-5)
    assert np.allclose(a, xyz, atol=1e-4)

def test_scan_prefetcher_order_and_overlap(tmp_path, rng):
    """ScanPrefetcher yields scans in order with `depth` loads in flight
    (loader invocation order is the submission order, ahead of use)."""
    import threading
    import time

    from icpx.cloud import PointCloud
    from icpx.io.prefetch import ScanPrefetcher

    calls = []
    lock = threading.Lock()

    def loader(p):
        with lock:
            calls.append(int(Path(p).stem))
        time.sleep(0.01)
        k = int(Path(p).stem)
        return PointCloud.create(
            np.full((4, 3), float(k), np.float32), capacity=128
        )

    paths = []
    for k in range(8):
        f = tmp_path / f"{k}.bin"
        f.write_bytes(b"")
        paths.append(f)
    pf = ScanPrefetcher(paths, capacity=128, depth=3, loader=loader)
    assert len(pf) == 8
    out = [float(c.xyz[0, 0]) for c in pf]
    assert out == [float(k) for k in range(8)]
    assert sorted(calls) == list(range(8))


def test_prefetch_kitti_reflectance(tmp_path, rng):
    from icpx.io.prefetch import prefetch_kitti

    for k in range(3):
        pts = rng.normal(size=(64, 4)).astype(np.float32)
        pts.tofile(tmp_path / f"{k:06d}.bin")
    scans = list(prefetch_kitti(tmp_path, capacity=128, with_intensity=True))
    assert len(scans) == 3
    assert scans[0].feat_names == ("reflectance",)
    assert int(scans[0].num_valid()) == 64
