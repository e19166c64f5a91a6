"""Extension-dispatching cloud load/save + reference-fixture locator.

`load_cloud` is the framework equivalent of `MyICP::LoadCloud`
(`myicp.cpp:20-31`) — with actual error handling, which the reference lacks
(SURVEY.md §5.3). Fixture helpers expose the reference demo data
(cat/cat_out/bunny) when available, else synthesize equivalent clouds so
tests and benches run hermetically.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from icpx.cloud import PointCloud
from icpx.io.pcd import read_pcd, write_pcd
from icpx.io.ply import read_ply, write_ply
from icpx.io.xyz import read_xyz_txt, write_xyz_txt


# Scalar PCD/PLY fields carried through to PointCloud.feats (in file
# order); geometry fields and padding are handled separately.
_PAYLOAD_FIELDS = (
    "intensity", "reflectance", "rgb", "rgba", "label", "curvature",
    "ring", "time", "t", "red", "green", "blue", "alpha",
)


def _collect_feats(rec):
    names, cols = [], []
    for name in rec:
        if name in ("xyz", "normals"):
            continue
        base = name.lower()
        if base in ("x", "y", "z", "normal_x", "normal_y", "normal_z",
                    "nx", "ny", "nz", "_", "padding"):
            continue
        col = np.asarray(rec[name])
        if col.ndim != 1 or base not in _PAYLOAD_FIELDS:
            continue
        if col.dtype.kind in "iu" and col.size and (
            np.abs(col.astype(np.float64)).max() > 2**24
        ):
            # feats are float32 on-device; wide integers (packed rgba,
            # large labels) would silently round — skip rather than
            # corrupt (pcd.py keeps them exact through its own round trip)
            continue
        names.append(base)
        cols.append(col.astype(np.float32))
    if not cols:
        return None, None
    return np.stack(cols, axis=1), tuple(names)


def load_cloud(path, *, capacity: Optional[int] = None) -> PointCloud:
    """Load a cloud from .pcd/.ply/.txt/.xyz/.bin (KITTI) by extension.

    Scalar payload fields (intensity / reflectance / rgb / label /
    curvature / ring / time) become `PointCloud.feats` columns; they ride
    through registration untouched and `save_cloud` writes them back.
    """
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"cloud file not found: {path}")
    ext = path.suffix.lower()
    normals = None
    feats = feat_names = None
    if ext == ".pcd":
        rec = read_pcd(path)
        xyz = rec["xyz"]
        normals = rec.get("normals")
        if normals is not None and not np.any(normals):
            normals = None  # all-zero normals (like cat_out.pcd) = none
        feats, feat_names = _collect_feats(rec)
    elif ext == ".ply":
        rec = read_ply(path)
        xyz = rec["xyz"]
        normals = rec.get("normals")
        feats, feat_names = _collect_feats(rec)
    elif ext in (".txt", ".xyz"):
        xyz = read_xyz_txt(path)
    elif ext == ".bin":  # KITTI velodyne: float32 x,y,z,reflectance
        raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
        xyz = raw[:, :3]
        feats, feat_names = raw[:, 3:4].copy(), ("reflectance",)
    else:
        raise ValueError(f"unsupported cloud extension: {ext}")
    return PointCloud.create(
        xyz, normals=normals, capacity=capacity, feats=feats,
        feat_names=feat_names,
    )


def save_cloud(path, cloud: PointCloud, *, binary: bool = False) -> None:
    """Save valid points of a cloud to .pcd/.ply/.txt by extension
    (payload feature columns included for .pcd)."""
    path = Path(path)
    xyz = cloud.to_numpy()
    normals = cloud.normals_to_numpy()
    feats = cloud.feats_to_numpy()
    extra = None
    if feats is not None and cloud.feat_names:
        extra = {
            name: feats[:, i] for i, name in enumerate(cloud.feat_names)
        }
    ext = path.suffix.lower()
    if ext == ".pcd":
        write_pcd(
            path, xyz, normals=normals, binary=binary, extra_fields=extra
        )
    elif ext == ".ply":
        write_ply(path, xyz, normals=normals, binary=binary)
    elif ext in (".txt", ".xyz"):
        write_xyz_txt(path, xyz)
    else:
        raise ValueError(f"unsupported cloud extension: {ext}")


# ---- reference fixtures ------------------------------------------------------

_VENDORED_DATA_DIR = Path(__file__).resolve().parent.parent.parent / "tests" / "data"


def reference_data_dir() -> Path:
    """Fixture search order: $ICPX_DATA_DIR > vendored tests/data > reference.

    The demo fixtures (cat.pcd / cat_out.pcd / txt2pcd_bunny1.pcd / za.txt,
    reference C9: /root/reference/ICP) are vendored into tests/data so the
    golden tests run on a bare checkout. Resolved at CALL time, so setting
    ICPX_DATA_DIR after import works (the old
    module-level constant froze the env var at first import).
    """
    env = os.environ.get("ICPX_DATA_DIR")
    if env:
        return Path(env)
    if (_VENDORED_DATA_DIR / "cat.pcd").exists():
        return _VENDORED_DATA_DIR
    return Path("/root/reference/ICP")


def __getattr__(name):
    # REFERENCE_DATA_DIR stays importable but resolves dynamically
    if name == "REFERENCE_DATA_DIR":
        return reference_data_dir()
    raise AttributeError(name)


def has_reference_data() -> bool:
    return (reference_data_dir() / "cat.pcd").exists()


def load_cat_pair(capacity: Optional[int] = None) -> Tuple[PointCloud, PointCloud]:
    """The reference demo pair: cat.pcd and cat_out.pcd (GT = Rz(pi/4)+(2.5,0,0)).

    Falls back to a synthetic cat-like cloud + the same GT transform when the
    reference data directory is unavailable.
    """
    if has_reference_data():
        d = reference_data_dir()
        src = load_cloud(d / "cat.pcd", capacity=capacity)
        tgt = load_cloud(d / "cat_out.pcd", capacity=capacity)
        return src, tgt
    xyz = synthetic_cat(3400)
    src = PointCloud.create(xyz, capacity=capacity)
    from icpx.geometry.transforms import make_rigid_perturbation, transform_cloud

    tgt = transform_cloud(src, make_rigid_perturbation())
    return src, tgt


def load_bunny(capacity: Optional[int] = None) -> PointCloud:
    """The 93-point bunny slice fixture (txt2pcd_bunny1.pcd / za.txt)."""
    if has_reference_data():
        p = reference_data_dir() / "txt2pcd_bunny1.pcd"
        if p.exists():
            return load_cloud(p, capacity=capacity)
        t = reference_data_dir() / "za.txt"
        if t.exists():
            return load_cloud(t, capacity=capacity)
    return PointCloud.create(synthetic_surface(93, seed=7) * 0.18, capacity=capacity)


def synthetic_cat(n: int = 3400, seed: int = 0) -> np.ndarray:
    """A cat-scale (extent ~200 units) curved synthetic surface, (n, 3) f32."""
    return synthetic_surface(n, seed=seed) * 100.0


def synthetic_surface(n: int, seed: int = 0) -> np.ndarray:
    """Random smooth 2.5D surface patch with unit-ish extent — a stand-in
    shape with well-defined normals for tests/benches without fixtures."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-1.0, 1.0, size=(n, 2))
    u, v = uv[:, 0], uv[:, 1]
    z = 0.35 * np.sin(2.1 * u) * np.cos(1.7 * v) + 0.15 * np.sin(4.3 * v)
    return np.stack([u, v, z], axis=-1).astype(np.float32)
