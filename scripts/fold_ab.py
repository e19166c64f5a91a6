#!/usr/bin/env python
"""End-to-end A/B of the NN fold paths on one GPU, in one process.

    python scripts/fold_ab.py [--sizes 1048576 8388608] [--reps 5]

For each size it registers the flagship pair (bench.py) under each
configuration below, compiling all first and then timing them in turns
(A, B, C, A, B, C, ...), and prints one JSON line per (size, config):
median wall, rmse and GT errors. Then it times, with the plain XLA
code, the stages that deleted kernels used to serve: the in-jit normals
moments fold at each size, and the brute NN on the cat pair.

Configurations: "xla" (payload delivery the non-GPU auto picks: row
gather below payload_infold_threshold, one-hot infold above), "fold"
(the fused GPU fold kernel on frozen-candidate phases) and "xla_bf16"
(the XLA path with bf16 score einsums).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _block(x):
    import jax

    return jax.block_until_ready(x)


def ab_register(n: int, reps: int) -> None:
    import jax

    from bench import flagship_config, flagship_pair
    from icpx.geometry.se3 import SE3
    from icpx.registration.icp import _register_jit

    src, tgt, gt = flagship_pair(n)
    base = flagship_config()
    xla_mode = "infold" if n >= base.payload_infold_threshold else "gather"
    configs = {
        "xla": flagship_config(payload_mode=xla_mode),
        "fold": flagship_config(payload_mode="fold"),
        "xla_bf16": flagship_config(payload_mode=xla_mode,
                                    score_precision="bf16"),
    }
    runs, compile_s = {}, {}
    for name, cfg in configs.items():
        runs[name] = jax.jit(
            lambda s, t, cfg=cfg: _register_jit(
                s, t, SE3.identity(), cfg, normals_for=("src", "tgt")
            )
        )
        t0 = time.perf_counter()
        _block(runs[name](src, tgt))
        compile_s[name] = time.perf_counter() - t0
    times = {k: [] for k in runs}
    out = {}
    for _ in range(reps):
        for name, run in runs.items():
            t0 = time.perf_counter()
            out[name] = _block(run(src, tgt))
            times[name].append(time.perf_counter() - t0)
    for name, res in out.items():
        rot, tr = (float(x) for x in res.transform.distance_to(gt))
        print(json.dumps(dict(
            n=n, config=name, wall_s=float(np.median(times[name])),
            walls_s=times[name], first_call_s=compile_s[name],
            rmse=float(res.final_rmse), iters=int(res.iters),
            rot_err=rot, t_err=tr,
        )), flush=True)


def stage_moments(n: int, reps: int) -> None:
    """The in-jit normals stage (KD build excluded): radius moments +
    eigensolver over the target index, as _register_jit runs it."""
    import jax

    from bench import flagship_pair
    from icpx.kernels.blocknn import _SUPER_G, build_kd_index, trim_index
    from icpx.registration.icp import _index_normals

    _, tgt, _ = flagship_pair(n)
    idx = trim_index(
        build_kd_index(tgt.xyz, tgt.mask, tile_size=128), n,
        multiple=_SUPER_G,
    )
    f = jax.jit(lambda i: _index_normals(i, 10, k_tiles=2))
    _block(f(idx))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _block(f(idx))
        ts.append(time.perf_counter() - t0)
    print(json.dumps(dict(stage="normals_moments_xla", n=n,
                          wall_s=float(np.median(ts)))), flush=True)


def stage_brute_nn(reps: int) -> None:
    """Share of the cat registration spent in its brute NN calls."""
    import jax

    from bench import cat_config, cat_pair
    from icpx.kernels.knn import nearest_neighbor
    from icpx.registration.icp import register

    src, tgt = cat_pair()
    cfg = cat_config()
    nn = jax.jit(lambda q, r, m: nearest_neighbor(
        q, r, ref_mask=m, tile_q=cfg.tile_q, tile_r=cfg.tile_r))
    _block(nn(src.xyz, tgt.xyz, tgt.mask))
    _block(register(src, tgt, cfg))
    t_nn, t_reg = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        _block(nn(src.xyz, tgt.xyz, tgt.mask))
        t_nn.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        res = _block(register(src, tgt, cfg))
        t_reg.append(time.perf_counter() - t0)
    print(json.dumps(dict(
        stage="cat_brute_nn", nn_call_s=float(np.median(t_nn)),
        register_s=float(np.median(t_reg)), iters=int(res.iters),
    )), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[1 << 20, 1 << 23])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    from icpx.cli import _enable_compile_cache
    from icpx.utils.device import gpu_name_and_power_limit, require_gpu

    dev = require_gpu()
    print(f"# {dev} card: {gpu_name_and_power_limit()}", flush=True)
    _enable_compile_cache()
    for n in args.sizes:
        ab_register(n, args.reps)
        stage_moments(n, args.reps)
    stage_brute_nn(args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
