#!/usr/bin/env python
"""Benchmark harness — prints ONE JSON line naming what it ran on.

Flagship config: single-pair symmetric ICP (in-jit normals off the
shared KD indexes, up to 10 Gauss-Newton iterations with fresh NN
correspondences each iteration) on synthetic surface clouds.

Metric: registered points per second = N / median wall time of a full
registration, quality-gated (a run that misses the ground truth reports
0). The JSON line carries platform, device kind, device count and the
card's name and power limit. Without a GPU the harness exits non-zero;
`--cpu-rehearsal` runs it on the CPU at tiny sizes to check the code
path, and its output says platform "cpu" (never a device number).
"""

import argparse
import json
import statistics
import sys
import time

import numpy as np

def _emit(args, metric: str, value: float) -> None:
    """The one JSON result line, naming the device it ran on."""
    print(json.dumps({"metric": metric, "value": value, "unit": "points/s",
                      **args.device}))


def _stall_timeouts(args):
    """(warmup, steady-state) watchdog timeouts from --stall-timeout."""
    from icpx.distributed.fault import default_stall_timeout

    if args.stall_timeout >= 0:
        return args.stall_timeout, args.stall_timeout
    return default_stall_timeout(warmup=True), default_stall_timeout()


def guarded_call(fn, timeout_s):
    from icpx.distributed.fault import guarded_call as _gc

    return _gc(fn, timeout_s)


def main():
    ap = argparse.ArgumentParser()
    # Flagship config: 1M-point pair (the scale this framework exists
    # for; smaller clouds are dominated by fixed index-build/dispatch
    # overheads — use --n 65536 for a small-pair point).
    ap.add_argument("--n", type=int, default=1048576,
                    help="points per cloud")
    ap.add_argument("--iters", type=int, default=10, help="ICP iterations")
    ap.add_argument("--reps", type=int, default=5, help="timed repetitions")
    ap.add_argument("--objective", default="symmetric")
    ap.add_argument("--k-normals", type=int, default=10)
    ap.add_argument("--cat", action="store_true",
                    help="reference-parity run on the cat fixture pair")
    ap.add_argument("--batch", type=int, default=0,
                    help="register B independent --n-point pairs in one "
                    "vmapped block-NN executable (the small-pair "
                    "aggregate operating point; default --n 65536)")
    ap.add_argument("--odometry", action="store_true",
                    help="scan-to-scan odometry throughput (synthetic LiDAR)")
    ap.add_argument("--odo-batch", action="store_true",
                    help="with --odometry: register all F-1 consecutive "
                    "pairs as ONE vmapped batch (identity init, no "
                    "keyframe gating — the offline-mapping throughput "
                    "operating point; odometry/parallel.py on one device)")
    ap.add_argument("--odo-seed", default="identity",
                    choices=["identity", "global"],
                    help="with --odo-batch: per-pair init. 'global' = "
                    "sector-profile yaw seed "
                    "(odometry/parallel.batched_pair_seed); 'identity' "
                    "= the default")
    ap.add_argument("--odo-anneal-iters", type=int, default=-1,
                    help="with --odo-batch: extra phase-1 iterations for "
                    "robust-scale annealing (-1 = auto: 10 for identity "
                    "init, 2 for the global seed)")
    ap.add_argument("--odo-q-tile", type=int, default=0,
                    help="with --odometry: source query-tile size for "
                    "the compiled loop (0 = auto: 256 from 65k-pt "
                    "scans, 128 from 8k)")
    ap.add_argument("--odo-freeze", default="auto",
                    choices=["auto", "on", "off"],
                    help="with --odometry: freeze per-frame candidate "
                    "tiles at the warm init (auto: on from 16k-pt "
                    "scans)")
    ap.add_argument("--odo-refine-stride", type=int, default=0,
                    help="with --odometry: within-tile row stride for "
                    "the bulk refine iterations of each per-frame "
                    "registration (multi-resolution refine; 1 = off, "
                    "0 = auto: 4 from 131k-pt scans, 2 from 65k, else 1)")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--scan-points", type=int, default=8192,
                    help="points per scan for --odometry")
    ap.add_argument("--profile", default=None,
                    help="jax.profiler trace directory")
    ap.add_argument("--score-precision", default="auto",
                    choices=["auto", "highest", "high", "bf16"],
                    help="block-NN score einsum precision (see ICPConfig)")
    ap.add_argument("--nn-method", default="auto",
                    choices=["auto", "brute", "block"],
                    help="NN kernel (auto: block above "
                    "block_auto_threshold target points)")
    ap.add_argument("--stall-timeout", type=float, default=-1.0,
                    help="seconds before a hung device fence raises "
                    "CollectiveStallError (-1 = auto: 600s steady-state "
                    "/ 1200s warmup in multi-process runs, off otherwise; "
                    "0 = off)")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run on the CPU to check the code path (tiny "
                    "sizes); without it the harness requires a GPU")
    args = ap.parse_args()

    from icpx.utils.device import (
        NoGPUError,
        gpu_name_and_power_limit,
        require_gpu,
    )

    try:
        rec = require_gpu(allow_cpu=args.cpu_rehearsal)
    except NoGPUError as e:
        print(f"bench.py: {e} (use --cpu-rehearsal to check the code "
              "path on the CPU)", file=sys.stderr)
        sys.exit(2)
    card = (
        gpu_name_and_power_limit() if rec["platform"] == "gpu"
        else "none (cpu rehearsal)"
    )
    print(f"# device: {rec['platform']} {rec['kind']} x{rec['count']}; "
          f"card: {card}", file=sys.stderr)
    args.device = dict(platform=rec["platform"], device_kind=rec["kind"],
                       device_count=rec["count"], card=card)

    from icpx.cli import _enable_compile_cache

    _enable_compile_cache()
    if args.cat:
        return bench_cat(args)
    if args.odometry:
        return bench_odometry(args)
    if args.batch:
        return bench_batch(args)

    import jax
    import jax.numpy as jnp

    from icpx.cloud import PointCloud
    from icpx.geometry.se3 import SE3
    from icpx.kernels.normals import estimate_normals
    from icpx.registration.icp import _register_jit

    n = args.n
    src, tgt, gt = flagship_pair(n)
    cfg = flagship_config(
        objective=args.objective,
        max_iters=args.iters,
        k_normals=args.k_normals,
        score_precision=args.score_precision,
        nn_method=args.nn_method,
    )

    # Normal estimation happens once per cloud in a real pipeline; include
    # it in the timed path (it is part of registering a fresh pair). In
    # block mode it runs in-jit off the shared KD indexes (one build per
    # cloud); the brute path estimates up front.
    block = cfg.resolve_nn(src.capacity) == "block"

    def run(src_xyz, src_mask, tgt_xyz, tgt_mask):
        s = PointCloud(xyz=src_xyz, mask=src_mask)
        t = PointCloud(xyz=tgt_xyz, mask=tgt_mask)
        if block:
            res = _register_jit(
                s, t, SE3.identity(), cfg, normals_for=("src", "tgt")
            )
        else:
            s = estimate_normals(s, k=cfg.k_normals)
            t = estimate_normals(t, k=cfg.k_normals)
            res = _register_jit(s, t, SE3.identity(), cfg)
        return res.transform.R, res.transform.t, res.final_rmse

    run_j = jax.jit(run)
    args_in = (src.xyz, src.mask, tgt.xyz, tgt.mask)
    warm_t, step_t = _stall_timeouts(args)
    out = run_j(*args_in)
    # completion fence under the stall watchdog (HeartbeatMonitor): a
    # stalled collective raises CollectiveStallError instead of hanging
    # the bench silently
    guarded_call(lambda: jax.block_until_ready(out), warm_t)
    profile_cm = None
    if args.profile:
        from icpx.utils.profiling import trace_context

        profile_cm = trace_context(args.profile)
        profile_cm.__enter__()
    times = []
    for rep in range(args.reps):
        t0 = time.perf_counter()
        out = run_j(*args_in)
        guarded_call(lambda o=out: jax.block_until_ready(o), step_t)
        times.append(time.perf_counter() - t0)
    if profile_cm is not None:
        profile_cm.__exit__(None, None, None)
    wall = statistics.median(times)
    rmse = float(out[2])

    est = SE3(R=out[0], t=out[1])
    rot_err, t_err = est.distance_to(gt)
    quality_ok = bool(float(rot_err) < 5e-3 and float(t_err) < 5e-3)

    # ENFORCED quality gate: a run that fails to recover the ground truth
    # reports zero throughput — early exits cannot inflate the metric.
    pts_per_sec = n / wall if quality_ok else 0.0
    _emit(args, "registered_points_per_sec_per_chip", pts_per_sec)
    # diagnostics on stderr only
    print(
        f"# n={n} iters={args.iters} wall={wall * 1e3:.1f}ms rmse={rmse:.2e} "
        f"rot_err={float(rot_err):.2e} t_err={float(t_err):.2e} "
        f"quality_ok={quality_ok} times_ms={[round(t * 1e3, 1) for t in times]}",
        file=sys.stderr,
    )


def flagship_pair(n: int, seed: int = 0):
    """(src, tgt, gt): an n-point synthetic surface and its rigidly moved,
    row-shuffled copy — the flagship registration pair (seed 0)."""
    from icpx.cloud import PointCloud
    from icpx.geometry.transforms import make_rigid_perturbation
    from icpx.io.loaders import synthetic_surface

    xyz = synthetic_surface(n, seed=seed)
    src = PointCloud.create(xyz, capacity=n if n % 128 == 0 else None)
    gt = make_rigid_perturbation(
        angle=0.2 - 0.01 * seed, translation=(0.12, -0.06, 0.03)
    )
    rng = np.random.default_rng(1 + seed)
    tgt_np = np.asarray(gt.apply(src.xyz))[: src.capacity]
    perm = rng.permutation(src.capacity)
    tgt = PointCloud.create(tgt_np[perm], capacity=src.capacity)
    return src, tgt.replace(mask=src.mask[perm]), gt


def flagship_config(**overrides):
    """The flagship ICPConfig. Converged-stopping: the while_loop exits
    when RMSE stops improving (what a real registration costs); max_iters
    caps it. The quality gate still requires GT recovery, so early exit
    cannot cheat."""
    from icpx.registration.icp import ICPConfig

    kw = dict(
        objective="symmetric",
        max_iters=10,
        diff_threshold=0.0,
        rmse_change_tol=1e-6,
        tile_q=2048,
        tile_r=8192,
    )
    kw.update(overrides)
    return ICPConfig(**kw)


def odometry_scans(n_frames: int, scan_points: int):
    """(frames, gt poses): simulated LiDAR scans of a structured world
    along a gentle trajectory. This config measures throughput at a fixed
    good ATE; robustness to aggressive motion and degenerate scenes is
    exercised in tests/."""
    from icpx.odometry.kitti import make_trajectory, make_world, simulate_scans

    world = make_world(
        n_points=300000, extent=50.0, seed=0, n_posts=300, ground_frac=0.5
    )
    gt = make_trajectory(n_frames, speed=0.6, turn=0.02)
    frames = simulate_scans(
        world, gt, max_range=25.0, points_per_scan=scan_points, noise=0.01,
        seed=1,
    )
    return frames, gt


def odometry_config(**overrides):
    from icpx.registration.icp import ICPConfig

    kw = dict(
        objective="symmetric",
        max_iters=10,
        diff_threshold=0.0,
        rmse_change_tol=1e-6,
        robust="huber",
        max_corr_dist=2.0,
    )
    kw.update(overrides)
    return ICPConfig(**kw)


def bench_batch(args):
    """Aggregate batched small-pair config:
    B independent n-point pairs in ONE vmapped block-NN executable —
    the operating point for fleets of small registrations (the
    reference's actual regime is a 3400-pt pair). Quality gate: EVERY
    pair must recover its ground truth or throughput reports zero."""
    import jax
    import jax.numpy as jnp

    from icpx.geometry.se3 import SE3
    from icpx.geometry.transforms import make_rigid_perturbation
    from icpx.io.loaders import synthetic_surface
    from icpx.registration.icp import ICPConfig, register_batch_block

    b = args.batch
    n = 65536 if args.n == 1048576 else args.n  # batch default: 65k pairs
    rng = np.random.default_rng(1)
    sxs, txs, gts = [], [], []
    for i in range(b):
        xyz = synthetic_surface(n, seed=i)
        gt = make_rigid_perturbation(
            angle=0.15 + 0.01 * (i % 7),
            translation=(0.12, -0.06 + 0.01 * (i % 5), 0.03),
        )
        txs.append(np.asarray(gt.apply(jnp.asarray(xyz)))[rng.permutation(n)])
        sxs.append(xyz)
        gts.append(gt)
    sx = jnp.stack([jnp.asarray(s) for s in sxs])
    tx = jnp.stack([jnp.asarray(t) for t in txs])
    sm = jnp.ones((b, n), bool)
    tm = jnp.ones((b, n), bool)
    cfg = ICPConfig(
        objective=args.objective,
        max_iters=args.iters,
        diff_threshold=0.0,
        rmse_change_tol=1e-6,
        k_normals=args.k_normals,
        nn_method="block" if args.nn_method == "auto" else args.nn_method,
        score_precision=args.score_precision,
    )

    def run(sxx):
        res = register_batch_block(sxx, sm, tx, tm, cfg)
        return res.transform.R, res.transform.t, res.final_rmse

    run_j = jax.jit(run)
    warm_t, step_t = _stall_timeouts(args)
    out = run_j(sx)
    guarded_call(lambda: jax.block_until_ready(out), warm_t)
    times = []
    for rep in range(args.reps):
        t0 = time.perf_counter()
        out = run_j(sx)
        guarded_call(lambda o=out: jax.block_until_ready(o), step_t)
        times.append(time.perf_counter() - t0)
    wall = statistics.median(times)

    Rb, tb, rmseb = jax.device_get(out)
    worst_rot, worst_t = 0.0, 0.0
    for i in range(b):
        est = SE3(R=jnp.asarray(Rb[i]), t=jnp.asarray(tb[i]))
        rot_err, t_err = est.distance_to(gts[i])
        worst_rot = max(worst_rot, float(rot_err))
        worst_t = max(worst_t, float(t_err))
    quality_ok = bool(worst_rot < 5e-3 and worst_t < 5e-3)
    pts_per_sec = b * n / wall if quality_ok else 0.0
    _emit(args, "batched_registered_points_per_sec_per_chip", pts_per_sec)
    print(
        f"# batch={b} n={n} wall={wall * 1e3:.1f}ms "
        f"({wall * 1e3 / b:.1f}ms/pair) worst rot_err={worst_rot:.2e} "
        f"t_err={worst_t:.2e} quality_ok={quality_ok} "
        f"times_ms={[round(t * 1e3, 1) for t in times]}",
        file=sys.stderr,
    )


def cat_pair():
    """The reference demo pair (cat.pcd -> cat_out.pcd, GT Rz(pi/4) +
    (2.5, 0, 0)) with the target rows shuffled: the reference itself can
    only register index-aligned rows."""
    from icpx.cloud import PointCloud
    from icpx.io.loaders import load_cat_pair

    src, tgt = load_cat_pair()
    rng = np.random.default_rng(0)
    tgt_np = tgt.to_numpy()
    return src, PointCloud.create(tgt_np[rng.permutation(len(tgt_np))])


def cat_config():
    from icpx.registration.icp import ICPConfig

    return ICPConfig(
        objective="symmetric",
        max_iters=20,
        diff_threshold=1.0,  # reference threshold, myicp.cpp:6
        max_corr_dist=50.0,
        robust="huber",
    )


def bench_cat(args):
    """Reference-parity config: the shuffled cat pair must converge to the
    fixture's noise floor (rmse ~1e-5) while the reference can't even run
    it (its correspondence step needs index alignment)."""
    import jax

    from icpx.geometry.transforms import make_rigid_perturbation
    from icpx.registration.icp import register

    src, tgt = cat_pair()
    cfg = cat_config()
    warm_t, step_t = _stall_timeouts(args)
    res = register(src, tgt, cfg)
    guarded_call(lambda: jax.block_until_ready(res), warm_t)
    times = []
    for rep in range(args.reps):
        t0 = time.perf_counter()
        res = register(src, tgt, cfg)
        guarded_call(lambda r=res: jax.block_until_ready(r), step_t)
        times.append(time.perf_counter() - t0)
    wall = statistics.median(times)
    rot_err, t_err = res.transform.distance_to(make_rigid_perturbation())
    n = int(jax.device_get(src.num_valid()))
    _emit(args, "cat_pair_registered_points_per_sec", n / wall)
    print(
        f"# cat: wall={wall * 1e3:.1f}ms iters={int(res.iters)} "
        f"rmse={float(res.final_rmse):.2e} rot_err={float(rot_err):.2e} "
        f"t_err={float(t_err):.2e} converged={bool(res.converged)}",
        file=sys.stderr,
    )


def bench_odometry(args):
    """Scan-to-scan odometry throughput: the whole sequence runs as ONE
    compiled XLA program (odometry/compiled.py) — the host-driven loop
    pays a dispatch round trip per frame. Registered points/s counts
    each frame's points once."""
    import jax
    import jax.numpy as jnp
    import numpy as np_

    from icpx.kernels.normals import estimate_normals
    from icpx.odometry.compiled import (
        resolve_odo_freeze,
        resolve_odo_q_tile,
        resolve_odo_refine_stride,
        run_odometry_compiled,
    )
    from icpx.odometry.evaluate import ate_rmse

    n_pts = args.scan_points
    frames, gt = odometry_scans(args.frames, n_pts)
    if args.odo_batch:
        return bench_odometry_batch(args, frames, gt)
    frames = [estimate_normals(f, k=args.k_normals) for f in frames]
    fx = jnp.stack([f.xyz for f in frames])
    fm = jnp.stack([f.mask for f in frames])
    fn = jnp.stack([f.normals for f in frames])
    cfg = odometry_config(
        objective=args.objective,
        max_iters=args.iters,
        nn_method=args.nn_method,
    )
    kwargs = dict(
        # velocity EMA on: this world's smooth ground has the slide mode
        # the knob exists for
        velocity_damping=0.7,
        freeze_candidates=(
            None if args.odo_freeze == "auto" else args.odo_freeze == "on"
        ),
        q_tile=args.odo_q_tile,
        refine_stride=args.odo_refine_stride,
    )
    warm_t, step_t = _stall_timeouts(args)
    out = run_odometry_compiled(fx, fm, fn, cfg, **kwargs)
    # compile + warm, under the stall watchdog
    guarded_call(lambda: jax.block_until_ready(out), warm_t)
    times = []
    for rep in range(args.reps):
        t0 = time.perf_counter()
        out = run_odometry_compiled(fx, fm, fn, cfg, **kwargs)
        guarded_call(lambda o=out: jax.block_until_ready(o), step_t)
        times.append(time.perf_counter() - t0)
    wall = statistics.median(times)
    poses = out.poses
    gt_rel = [gt[0].inverse() @ g for g in gt]
    plist = [
        jax.tree_util.tree_map(lambda x: x[i], poses)
        for i in range(len(frames))
    ]
    ate = ate_rmse(plist, gt_rel, align=False)
    # ENFORCED quality gate (mirrors the flagship config): a diverged run
    # reports zero throughput rather than full speed with a bad trajectory.
    ATE_BOUND_M = 0.5
    quality_ok = bool(ate < ATE_BOUND_M)
    pts_per_sec = len(frames) * n_pts / wall if quality_ok else 0.0
    _emit(args, "odometry_registered_points_per_sec", pts_per_sec)
    print(
        f"# odometry frames={len(frames)} pts/scan={n_pts} "
        f"nn={cfg.resolve_nn(n_pts)} "
        f"q_tile={resolve_odo_q_tile(cfg, n_pts, args.odo_q_tile)} "
        f"freeze={resolve_odo_freeze(n_pts, kwargs['freeze_candidates'])} "
        f"stride={resolve_odo_refine_stride(cfg, n_pts, args.odo_refine_stride)} "
        f"wall={wall * 1e3:.0f}ms fps={len(frames) / wall:.1f} "
        f"ATE={ate:.4f}m keyframes={int(np_.asarray(out.is_keyframe).sum())}",
        file=sys.stderr,
    )


def bench_odometry_batch(args, frames, gt):
    """Odometry THROUGHPUT operating point: all F-1 consecutive scan
    pairs register simultaneously in one vmapped executable
    (`register_batch` / `register_batch_block`, the single-device analogue
    of odometry/parallel.py), then relative poses compose host-side.

    This is the honest odometry counterpart of `--batch`: the sequential
    compiled loop (`--odometry` without this flag) is LATENCY-bound —
    frame k's motion-model init needs frame k-1's pose, so per-frame
    fixed costs (solve, small matmuls, scan-step overhead) cannot
    amortize and points/s is the wrong lens for it (fps is). When frames
    are already captured (offline mapping / bag processing), the
    dependency disappears and throughput is the number that matters.
    Identity init per pair, no keyframe
    gating; the same ATE quality gate as the sequential config."""
    import jax
    import jax.numpy as jnp
    import numpy as np_

    from icpx.geometry.se3 import SE3
    from icpx.kernels.normals import estimate_normals
    from icpx.odometry.evaluate import ate_rmse
    from icpx.registration.icp import (
        ICPConfig,
        register_batch,
        register_batch_block,
    )

    n_pts = args.scan_points
    f = len(frames)
    cfg = ICPConfig(
        objective=args.objective,
        max_iters=args.iters,
        diff_threshold=0.0,
        rmse_change_tol=1e-6,
        robust="huber",
        max_corr_dist=2.0,
        score_precision=args.score_precision,
        nn_method=args.nn_method,
    )
    block = cfg.resolve_nn(n_pts) == "block"
    srcs, tgts = frames[1:], frames[:-1]
    sx = jnp.stack([fr.xyz for fr in srcs])
    sm = jnp.stack([fr.mask for fr in srcs])
    tx = jnp.stack([fr.xyz for fr in tgts])
    tm = jnp.stack([fr.mask for fr in tgts])
    # Identity init needs an ANNEALED schedule: one 10-iteration pass
    # leaves every pair ~0.1 m short (the huber scale anneals slowly
    # from a 0.6 m start on cross-sampled scans), while sequential's
    # constant-velocity init starts ~0.01 m out and converges in 2-3.
    # Phase 1 burns the annealing iterations on a 4x row-subsampled
    # source (pose noise ~ 1/sqrt(N): statistics to spare at scan
    # sizes); phase 2 polishes full-res from the warm init with a
    # tightened gate. --odo-seed global replaces
    # the identity start with a sector-profile yaw + centroid-delta
    # seed, cutting the annealing budget (auto: 10 -> 2 extra iters).
    import dataclasses

    from icpx.odometry.parallel import batched_pair_seed

    seeded = args.odo_seed == "global"
    extra = args.odo_anneal_iters
    if extra < 0:
        extra = 2 if seeded else 10
    sub = 4
    cfg_c = dataclasses.replace(cfg, max_iters=args.iters + extra)
    cfg_f = dataclasses.replace(
        cfg, max_iters=5, max_corr_dist=cfg.max_corr_dist / 4.0
    )

    def seed_of(sxx):
        return batched_pair_seed(sxx, sm, tx, tm) if seeded else None

    if block:
        # block path estimates normals in-jit off the per-pair KD indexes
        def run(sxx):
            s0 = seed_of(sxx)
            r1 = register_batch_block(
                sxx[:, ::sub], sm[:, ::sub], tx, tm, cfg_c, init=s0,
            )
            res = register_batch_block(
                sxx, sm, tx, tm, cfg_f, init=r1.transform
            )
            return res.transform.R, res.transform.t, res.final_rmse

    else:
        srcs = [estimate_normals(fr, k=args.k_normals) for fr in srcs]
        tgts = [estimate_normals(fr, k=args.k_normals) for fr in tgts]
        sn = jnp.stack([fr.normals for fr in srcs])
        tn = jnp.stack([fr.normals for fr in tgts])

        def run(sxx):
            s0 = seed_of(sxx)
            r1 = register_batch(
                sxx[:, ::sub], sm[:, ::sub], sn[:, ::sub],
                tx, tm, tn, cfg_c, init=s0,
            )
            res = register_batch(
                sxx, sm, sn, tx, tm, tn, cfg_f, init=r1.transform
            )
            return res.transform.R, res.transform.t, res.final_rmse

    run_j = jax.jit(run)
    warm_t, step_t = _stall_timeouts(args)
    out = run_j(sx)
    guarded_call(lambda: jax.block_until_ready(out), warm_t)
    times = []
    for rep in range(args.reps):
        t0 = time.perf_counter()
        out = run_j(sx)
        guarded_call(lambda o=out: jax.block_until_ready(o), step_t)
        times.append(time.perf_counter() - t0)
    wall = statistics.median(times)

    Rb, tb, rmseb = jax.device_get(out)
    poses = [SE3.identity()]
    for k in range(f - 1):
        rel = SE3(R=jnp.asarray(Rb[k]), t=jnp.asarray(tb[k]))
        poses.append(poses[-1] @ rel)
    gt_rel = [gt[0].inverse() @ g for g in gt]
    ate = ate_rmse(poses, gt_rel, align=False)
    ATE_BOUND_M = 0.5
    quality_ok = bool(ate < ATE_BOUND_M)
    pts_per_sec = f * n_pts / wall if quality_ok else 0.0
    _emit(args, "odometry_batched_points_per_sec_per_chip", pts_per_sec)
    print(
        f"# odometry-batch frames={f} pts/scan={n_pts} nn="
        f"{'block' if block else 'brute'} seed={args.odo_seed} "
        f"extra_iters={extra} wall={wall * 1e3:.0f}ms "
        f"ATE={ate:.4f}m worst_rmse={float(np_.max(rmseb)):.2e} "
        f"times_ms={[round(t * 1e3, 1) for t in times]}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
