"""Background scan prefetching: overlap disk IO + native parsing with
device compute.

Sequential odometry alternates [load scan k+1] -> [register scan k+1];
on real sequences (KITTI velodyne ~2 MB/scan) the load is file IO plus
the native C parser (`native/icpx_io.cpp`), both of which release the
GIL — so a small thread pool keeps `depth` scans decoded ahead while the
device registers the current one. The reference has no data layer at all
(it reads two files at startup, `myicp.cpp:20-31`); this is the
streaming ingest tier a production odometry pipeline needs.
"""

from __future__ import annotations

import concurrent.futures as _fut
from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence

from icpx.cloud import PointCloud


class ScanPrefetcher:
    """Iterate PointClouds from `paths`, keeping `depth` loads in flight.

    `loader(path) -> PointCloud` defaults to `icpx.io.load_cloud` with a
    fixed capacity (required: one capacity = one compiled registration
    executable downstream). Supports len() and iteration; scans arrive
    in order.
    """

    def __init__(
        self,
        paths: Sequence,
        *,
        capacity: int,
        depth: int = 3,
        loader: Optional[Callable] = None,
    ):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.paths = [Path(p) for p in paths]
        self.capacity = capacity
        self.depth = depth
        if loader is None:
            from icpx.io.loaders import load_cloud

            loader = lambda p: load_cloud(p, capacity=capacity)  # noqa: E731
        self._loader = loader

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[PointCloud]:
        if not self.paths:
            return
        with _fut.ThreadPoolExecutor(max_workers=self.depth) as pool:
            pending = {}
            n = len(self.paths)
            head = 0
            for k in range(n):
                # top up the pipeline to `depth` in-flight loads
                while head < n and head - k < self.depth:
                    pending[head] = pool.submit(self._loader, self.paths[head])
                    head += 1
                yield pending.pop(k).result()


def prefetch_kitti(
    velodyne_dir,
    *,
    capacity: int,
    max_frames: Optional[int] = None,
    depth: int = 3,
    with_intensity: bool = False,
) -> ScanPrefetcher:
    """Streaming KITTI ingest: velodyne .bin files decoded ahead of use
    (native float parse; reflectance kept as a payload column when
    `with_intensity`)."""
    import numpy as np

    files = sorted(Path(velodyne_dir).glob("*.bin"))
    if max_frames is not None:
        files = files[:max_frames]

    def loader(p):
        from icpx.odometry.kitti import load_kitti_scan, load_kitti_scan_xyzi

        if with_intensity:
            arr = load_kitti_scan_xyzi(p)[:capacity]
            return PointCloud.create(
                arr[:, :3], capacity=capacity,
                feats=arr[:, 3:4], feat_names=("reflectance",),
            )
        xyz = load_kitti_scan(p)[:capacity]
        return PointCloud.create(
            np.asarray(xyz), capacity=capacity
        )

    return ScanPrefetcher(
        files, capacity=capacity, depth=depth, loader=loader
    )
