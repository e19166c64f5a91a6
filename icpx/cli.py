"""`icpx` command-line interface.

Replaces the reference's four alternate `main()`s, which are switched via
MSBuild ExcludedFromBuild flags (`ICP.vcxproj:133-145`), with subcommands:

  register  — the active demo (`main.cpp:5-68` / `MyICP::RegisterSymm`)
  horn      — closed-form fit with aligned rows (`register-test.cpp`)
  convert   — txt/pcd/ply conversion (`test.cpp`, C3a)
  perturb   — rigid-transform fixture generator (`matrix-transform.cpp`, C3b)
  odometry  — multi-scan extension (no reference analogue)
  info      — cloud stats
  bench     — throughput harness (bench.py)

Every hard-coded reference constant is a flag with the reference value as
its default (SURVEY §5.6).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path


def _add_icp_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--objective", default="symmetric",
                   choices=["symmetric", "p2plane", "p2p", "gicp", "ndt"])
    p.add_argument("--ndt-cell", type=int, default=64,
                   help="NDT cell size in points (objective=ndt)")
    p.add_argument("--weight-feat", default=None,
                   help="payload column used as per-point source weight "
                        "(e.g. a confidence channel)")
    p.add_argument("--feat-nn", default=None,
                   help="payload column for feature-augmented (4D-metric) "
                        "correspondence matching, e.g. intensity")
    p.add_argument("--feat-nn-weight", type=float, default=None,
                   help="feature weight w in ||p-q||^2 + w^2 (f_p-f_q)^2 "
                        "(requires --feat-nn; default 1.0)")
    p.add_argument("--max-iters", type=int, default=10,
                   help="outer iterations (reference: 10, myicp.cpp:6)")
    p.add_argument("--diff-threshold", type=float, default=1.0,
                   help="evalDiff sum threshold (reference: 1.0)")
    p.add_argument("--k-normals", type=int, default=10,
                   help="normal-estimation k (reference: 10)")
    p.add_argument("--max-corr-dist", type=float, default=float("inf"))
    p.add_argument("--robust", default="none",
                   choices=["none", "huber", "tukey", "welsch", "cauchy"])
    p.add_argument("--nn", default="auto", choices=["auto", "brute", "block"])
    p.add_argument("--score-precision", default="auto",
                   choices=["auto", "highest", "high", "bf16"],
                   help="matmul precision of the block-NN score einsum "
                        "(auto = highest, true fp32; high = TF32 on "
                        "NVIDIA GPUs; bf16 = one pass on tile-centered "
                        "coordinates)")
    p.add_argument("--payload-mode", default="auto",
                   choices=["auto", "gather", "infold", "fold"],
                   help="how matched target rows reach the solve: coherent "
                        "row gather, one-hot selection in the XLA fold, or "
                        "the fused GPU fold kernel (auto: fold on a GPU "
                        "from 1M target points, else infold from 2M, else "
                        "gather)")
    p.add_argument("--pyramid-levels", type=int, default=1)
    p.add_argument("--config", type=Path, default=None,
                   help="JSON file of ICPConfig overrides")


def _resolve_feat_weight(args) -> float:
    has_nn = bool(getattr(args, "feat_nn", None))
    w = getattr(args, "feat_nn_weight", None)
    if w is not None and not has_nn:
        raise SystemExit("--feat-nn-weight requires --feat-nn <channel>")
    if not has_nn:
        return 0.0
    return 1.0 if w is None else w


def _icp_config(args):
    from icpx.registration.icp import ICPConfig

    overrides = {}
    if args.config:
        overrides = json.loads(Path(args.config).read_text())
    cfg = ICPConfig(
        objective=args.objective,
        max_iters=args.max_iters,
        diff_threshold=args.diff_threshold,
        k_normals=args.k_normals,
        max_corr_dist=args.max_corr_dist,
        robust=args.robust,
        nn_method=args.nn,
        score_precision=getattr(args, "score_precision", "auto"),
        payload_mode=getattr(args, "payload_mode", "auto"),
        feat_nn=getattr(args, "feat_nn", None) or "",
        feat_nn_weight=_resolve_feat_weight(args),
    )
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def cmd_register(args) -> int:
    import jax

    from icpx.geometry.transforms import transform_cloud
    from icpx.io import load_cloud, save_cloud
    from icpx.registration.icp import format_trace, register
    from icpx.registration.pyramid import PyramidConfig, register_pyramid
    from icpx.utils.metrics import MetricsLogger, icp_iteration_records

    src = load_cloud(args.src)
    tgt = load_cloud(args.tgt)
    if args.objective == "ndt":
        if args.pyramid_levels > 1:
            raise SystemExit(
                "--objective ndt does not compose with --pyramid-levels "
                "(NDT's cell granularity IS its resolution control; use "
                "--ndt-cell)"
            )
        args.objective = "gicp"  # the solve NDT rides on (see ndt.py)
    else:
        args.ndt_cell = 0
    cfg = _icp_config(args)
    if getattr(args, "feat_nn", None) and args.ndt_cell:
        raise SystemExit(
            "--feat-nn does not compose with --objective ndt (cells carry "
            "no payload channels)"
        )
    src_weight = src.feat(args.weight_feat) if args.weight_feat else None
    if src_weight is not None and (args.ndt_cell or args.pyramid_levels > 1):
        raise SystemExit(
            "--weight-feat is only wired into the plain register path "
            "(not --objective ndt / --pyramid-levels)"
        )
    if args.ndt_cell:
        from icpx.registration.ndt import register_ndt

        res = register_ndt(src, tgt, cfg, cell_size=args.ndt_cell)
    elif args.pyramid_levels > 1:
        res, _ = register_pyramid(
            src, tgt, PyramidConfig(levels=args.pyramid_levels, base=cfg)
        )
    else:
        res = register(src, tgt, cfg, src_weight=src_weight)
    jax.block_until_ready(res)
    print(format_trace(res))
    m = res.transform.matrix()
    print("transform:")
    for row in jax.device_get(m):
        print("  " + " ".join(f"{v: .6f}" for v in row))
    if args.metrics:
        with MetricsLogger(args.metrics) as ml:
            for rec in icp_iteration_records(res):
                ml.log(event="icp_iter", **rec)
            ml.log(
                event="icp_done",
                converged=bool(res.converged),
                rmse=float(res.final_rmse),
                inliers=int(res.inlier_count),
            )
    aligned = None
    if args.out or args.render:
        aligned = transform_cloud(src, res.transform)
    if args.out:
        save_cloud(args.out, aligned)
        print(f"aligned cloud -> {args.out}")
    if args.render:
        from icpx.viz import render_clouds

        render_clouds(
            args.render,
            [aligned, tgt],
            ["aligned src", "tgt"],
            title=f"rmse={float(res.final_rmse):.4g}",
        )
        print(f"render -> {args.render}")
    return 0


def cmd_horn(args) -> int:
    import jax

    from icpx.io import load_cloud
    from icpx.registration.horn import horn_align

    src = load_cloud(args.src)
    tgt = load_cloud(args.tgt)
    cap = max(src.capacity, tgt.capacity)
    src, tgt = src.pad_to(cap), tgt.pad_to(cap)
    # only rows valid in BOTH clouds are index-aligned correspondences
    w = (src.mask & tgt.mask).astype("float32")
    est = horn_align(src.xyz, tgt.xyz, weights=w)
    print("R:")
    for row in jax.device_get(est.R):
        print("  " + " ".join(f"{v: .6f}" for v in row))
    print("t: " + " ".join(f"{v: .6f}" for v in jax.device_get(est.t)))
    return 0


def cmd_convert(args) -> int:
    from icpx.io import load_cloud, save_cloud

    cloud = load_cloud(args.input)
    save_cloud(args.output, cloud, binary=args.binary)
    print(f"{args.input} -> {args.output} ({int(cloud.num_valid())} points)")
    return 0


def cmd_perturb(args) -> int:
    import jax.numpy as jnp

    from icpx.geometry.transforms import make_rigid_perturbation, transform_cloud
    from icpx.io import load_cloud, save_cloud

    cloud = load_cloud(args.input)
    gt = make_rigid_perturbation(
        axis=tuple(args.axis),
        angle=args.angle,
        translation=tuple(args.translate),
    )
    out = transform_cloud(cloud, gt)
    if args.noise > 0:
        import numpy as np

        rng = np.random.default_rng(args.seed)
        noisy = np.asarray(out.xyz) + rng.normal(0, args.noise, out.xyz.shape)
        out = out.with_xyz(jnp.asarray(noisy, jnp.float32))
    save_cloud(args.output, out)
    print(f"perturbed ({args.angle} rad about {args.axis}, t={args.translate})"
          f" -> {args.output}")
    return 0


def cmd_odometry(args) -> int:
    from icpx.odometry.evaluate import ate_rmse, rpe
    from icpx.odometry.frontend import OdometryConfig, run_odometry
    from icpx.registration.icp import ICPConfig
    from icpx.utils.checkpoint import OdometryCheckpoint
    from icpx.utils.metrics import MetricsLogger

    if args.synthetic:
        from icpx.odometry.kitti import (
            make_trajectory,
            make_world,
            simulate_scans,
        )

        world = make_world(seed=args.seed)
        gt = make_trajectory(args.frames)
        frames = simulate_scans(
            world, gt, points_per_scan=args.points_per_scan, seed=args.seed
        )
    else:
        from icpx.odometry.kitti import load_kitti_poses, load_kitti_sequence

        frames = load_kitti_sequence(
            args.velodyne_dir,
            max_frames=args.frames,
            subsample=args.subsample,
        )
        gt = load_kitti_poses(args.poses) if args.poses else None

    icp_cfg = ICPConfig(
        objective=args.objective,
        max_iters=args.max_iters,
        diff_threshold=0.0,
        rmse_change_tol=1e-6,
        robust="huber",
        max_corr_dist=args.max_corr_dist,
    )
    cfg = OdometryConfig(
        icp=icp_cfg,
        keyframe_trans=args.keyframe_trans,
        keyframe_rot=args.keyframe_rot,
        mode=args.mode,
        map_cell=args.map_cell,
        map_capacity=args.map_capacity,
        backend=args.backend,
        window=args.window,
        dynamic_sigma=args.dynamic_sigma,
        stall_timeout_s=args.stall_timeout,
    )
    if args.compiled:
        # whole-sequence single-program path (fast; scan-to-keyframe only)
        incompatible = [
            name for name, v in [
                ("--resume", getattr(args, "resume", None)),
                ("--backend", args.backend != "none"),
                ("--dynamic-sigma", args.dynamic_sigma > 0),
                ("--mode scan_to_map", args.mode != "scan_to_keyframe"),
            ] if v
        ]
        if incompatible:
            raise SystemExit(
                f"--compiled does not support {', '.join(incompatible)} "
                "(host-path features); drop --compiled or those flags"
            )
        import jax
        import jax.numpy as jnp

        from icpx.geometry.se3 import SE3
        from icpx.kernels.normals import estimate_covariances, estimate_normals
        from icpx.odometry.compiled import run_odometry_compiled
        from icpx.odometry.frontend import OdometryResult

        if icp_cfg.objective == "gicp":
            frames = [
                f if f.covs is not None else estimate_covariances(f, k=15)
                for f in frames
            ]
            aux = jnp.stack(
                [f.covs.reshape(f.capacity, 9) for f in frames]
            )
        else:
            frames = [
                f if f.normals is not None else estimate_normals(f, k=10)
                for f in frames
            ]
            aux = jnp.stack([f.normals for f in frames])
        comp = run_odometry_compiled(
            jnp.stack([f.xyz for f in frames]),
            jnp.stack([f.mask for f in frames]),
            aux,
            icp_cfg,
            keyframe_trans=args.keyframe_trans,
            keyframe_rot=args.keyframe_rot,
            freeze_candidates=(
                None if args.odo_freeze == "auto"
                else args.odo_freeze == "on"
            ),
            q_tile=args.odo_q_tile,
            refine_stride=args.odo_refine_stride,
        )
        import numpy as np

        poses = [
            SE3(R=comp.poses.R[i], t=comp.poses.t[i])
            for i in range(len(frames))
        ]
        is_kf_np = np.asarray(comp.is_keyframe)
        kf_list = [i for i in range(len(frames)) if is_kf_np[i]]
        res = OdometryResult(
            poses=poses,
            is_keyframe=[bool(v) for v in is_kf_np],
            rmse=[float(v) for v in np.asarray(comp.rmse)],
            # MEASURED keyframe-to-keyframe constraints from the scan
            # carry (not pose-derived)
            edges=comp.edge_list(),
            keyframe_indices=kf_list,
        )
    else:
        resume_ck = None
        if getattr(args, "resume", None):
            from icpx.utils.checkpoint import OdometryCheckpoint as _OC

            resume_ck = _OC.load(args.resume)
            print(
                f"resuming from {args.resume} at frame "
                f"{resume_ck.frame_index + 1}/{len(frames)}"
            )
        res = run_odometry(frames, cfg, resume=resume_ck)
    print(f"{len(res.poses)} frames, {len(res.keyframe_indices)} keyframes, "
          f"{len(res.edges)} edges")
    if gt is not None:
        ate = ate_rmse(res.poses, gt[: len(res.poses)])
        t_rpe, r_rpe = rpe(res.poses, gt[: len(res.poses)])
        print(f"ATE {ate:.4f} m   RPE {t_rpe:.4f} m / {r_rpe:.5f} rad")
    if args.loop_closure:
        import jax.numpy as jnp

        from icpx.geometry.se3 import SE3
        from icpx.odometry.loopclosure import (
            LoopClosureConfig,
            detect_loop_closures,
        )
        from icpx.odometry.posegraph import PoseGraph, optimize_pose_graph

        kf = res.keyframe_indices
        kf_poses = [res.poses[i] for i in kf]
        closures = detect_loop_closures(
            kf_poses,
            [frames[i] for i in kf],
            LoopClosureConfig(
                icp=cfg.icp,
                max_candidates=args.lc_max_candidates,
                max_candidate_dist=args.lc_max_dist,
                max_descriptor_dist=args.lc_descriptor_dist,
            ),
        )
        print(f"loop closures: {len(closures)}")
        if closures:
            remap = {f: i for i, f in enumerate(kf)}
            edges = [
                (remap[i], remap[j], T)
                for (i, j, T) in res.edges
                if i in remap and j in remap
            ] + [(i, j, T) for (i, j, T, _) in closures]
            graph = PoseGraph.from_edge_list(
                SE3(
                    R=jnp.stack([p.R for p in kf_poses]),
                    t=jnp.stack([p.t for p in kf_poses]),
                ),
                edges,
            )
            opt, chi2 = optimize_pose_graph(graph, iters=10)
            print(
                f"pose graph: chi2 {float(chi2[0]):.3e} -> {float(chi2[-1]):.3e}"
            )
            # splice optimized keyframe poses back into the trajectory
            for idx, f_idx in enumerate(kf):
                res.poses[f_idx] = SE3(R=opt.R[idx], t=opt.t[idx])
            if gt is not None:
                ate2 = ate_rmse(res.poses, gt[: len(res.poses)])
                print(f"ATE after pose graph: {ate2:.4f} m")
    if args.metrics:
        with MetricsLogger(args.metrics) as ml:
            for k, (p, r) in enumerate(zip(res.poses, res.rmse)):
                ml.log(event="frame", frame=k, rmse=r,
                       keyframe=bool(res.is_keyframe[k]))
    if args.checkpoint:
        ck = OdometryCheckpoint.from_result(res)
        ck.save(args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}")
    if args.render:
        from icpx.viz import render_trajectory

        render_trajectory(args.render, res.poses, gt)
        print(f"render -> {args.render}")
    return 0


def cmd_info(args) -> int:
    import jax

    from icpx.io import load_cloud

    cloud = load_cloud(args.input)
    n = int(cloud.num_valid())
    ext = float(jax.device_get(cloud.extent()))
    c = jax.device_get(cloud.centroid())
    feats = (
        ",".join(cloud.feat_names) if cloud.feat_names else "none"
    )
    print(f"{args.input}: {n} points, capacity {cloud.capacity}, "
          f"extent {ext:.4g}, centroid ({c[0]:.4g}, {c[1]:.4g}, {c[2]:.4g}), "
          f"normals={'yes' if cloud.normals is not None else 'no'}, "
          f"payload={feats}")
    return 0


def cmd_bench(args) -> int:
    # the harness lives at the repo root next to the package (editable
    # install); import it by path so `icpx bench` works from any cwd
    import importlib.util

    bench_path = Path(__file__).resolve().parents[1] / "bench.py"
    if not bench_path.exists():
        raise FileNotFoundError(f"bench harness not found at {bench_path}")
    spec = importlib.util.spec_from_file_location("icpx_bench", bench_path)
    bench_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_mod)

    saved = sys.argv
    try:
        sys.argv = ["bench.py"] + (args.bench_args or [])
        bench_mod.main()
    finally:
        sys.argv = saved
    return 0


# Fixed in-checkout location of the persistent compile cache (listed in
# .gitignore). The path is part of the cache key, so it must not move.
COMPILE_CACHE_DIR = Path(__file__).resolve().parents[1] / ".jax_cache"


def _enable_compile_cache() -> None:
    """Persistent XLA compilation cache shared by every entry-point
    process, so a rerun skips compiles that a previous process already
    paid: in $JAX_COMPILATION_CACHE_DIR when set (JAX reads it itself),
    otherwise in COMPILE_CACHE_DIR. ICPX_NO_COMPILE_CACHE=1 disables."""
    import os

    if os.environ.get("ICPX_NO_COMPILE_CACHE"):
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        COMPILE_CACHE_DIR.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(COMPILE_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="icpx",
        description="Point-cloud registration & odometry engine (JAX)",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("register", help="pairwise ICP registration")
    p.add_argument("src")
    p.add_argument("tgt")
    p.add_argument("--out", default=None, help="save aligned source cloud")
    p.add_argument("--render", default=None, help="save PNG snapshot")
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    _add_icp_flags(p)
    p.set_defaults(fn=cmd_register)

    p = sub.add_parser("horn", help="closed-form fit (index-aligned rows)")
    p.add_argument("src")
    p.add_argument("tgt")
    p.set_defaults(fn=cmd_horn)

    p = sub.add_parser("convert", help="convert between pcd/ply/txt")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--binary", action="store_true")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("perturb", help="apply a known rigid perturbation")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--angle", type=float, default=0.7853981633974483,
                   help="radians (reference: pi/4)")
    p.add_argument("--axis", type=float, nargs=3, default=[0.0, 0.0, 1.0])
    p.add_argument("--translate", type=float, nargs=3, default=[2.5, 0.0, 0.0])
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_perturb)

    p = sub.add_parser("odometry", help="multi-scan odometry")
    p.add_argument("--velodyne-dir", default=None)
    p.add_argument("--poses", default=None, help="KITTI poses file (GT)")
    p.add_argument("--synthetic", action="store_true",
                   help="simulated LiDAR sequence instead of a dataset")
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--points-per-scan", type=int, default=8192)
    p.add_argument("--subsample", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--objective", default="symmetric",
                   choices=["symmetric", "p2plane", "p2p", "gicp"])
    p.add_argument("--max-iters", type=int, default=12)
    p.add_argument("--max-corr-dist", type=float, default=2.0)
    p.add_argument("--keyframe-trans", type=float, default=1.0)
    p.add_argument("--keyframe-rot", type=float, default=0.2)
    p.add_argument("--mode", default="scan_to_keyframe",
                   choices=("scan_to_keyframe", "scan_to_map"),
                   help="register against the latest keyframe (default) "
                        "or a maintained voxel map (drifts less)")
    p.add_argument("--map-cell", type=float, default=0.1,
                   help="voxel size for --mode scan_to_map")
    p.add_argument("--map-capacity", type=int, default=65536,
                   help="voxel-map point capacity for --mode scan_to_map")
    p.add_argument("--lc-max-candidates", type=int, default=10,
                   help="loop-closure verification budget per pass "
                        "(<= 0 verifies every candidate)")
    p.add_argument("--lc-max-dist", type=float, default=3.0,
                   help="believed-position candidate gate (m)")
    p.add_argument("--lc-descriptor-dist", type=float, default=0.12,
                   help="appearance-channel descriptor gate "
                        "(<= 0 disables appearance candidates)")
    p.add_argument("--backend", default="none",
                   choices=["none", "sliding_window"],
                   help="incremental pose-graph backend during the run")
    p.add_argument("--window", type=int, default=10,
                   help="sliding-window size (keyframes) for --backend")
    p.add_argument("--dynamic-sigma", type=float, default=0.0,
                   help="reject moving objects from keyframes: residual "
                        "> sigma x median (0 = off)")
    p.add_argument("--loop-closure", action="store_true",
                   help="detect loop closures and optimize the pose graph")
    p.add_argument("--compiled", action="store_true",
                   help="run the whole sequence as one compiled program "
                        "(fastest; scan-to-keyframe only, measured edges; "
                        "--resume/--backend/--dynamic-sigma need the host "
                        "path)")
    p.add_argument("--odo-q-tile", type=int, default=0,
                   help="with --compiled: source query-tile size (0 = "
                        "auto: 256 from 65k-pt scans, 128 from 8k)")
    p.add_argument("--odo-freeze", default="auto",
                   choices=("auto", "on", "off"),
                   help="with --compiled: freeze per-frame candidate "
                        "tiles at the warm init (auto: on from 16k-pt "
                        "scans)")
    p.add_argument("--odo-refine-stride", type=int, default=0,
                   help="with --compiled: within-tile row stride for "
                        "the bulk refine iterations of each per-frame "
                        "registration (0 = auto: 4 from 131k-pt scans, "
                        "2 from 65k, else off — the measured ladder)")
    p.add_argument("--stall-timeout", type=float, default=-1.0,
                   help="seconds before a hung per-frame device fence "
                        "raises CollectiveStallError (-1 = auto: 600s in "
                        "multi-process runs, off otherwise; 0 = off)")
    p.add_argument("--metrics", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--resume", default=None,
                   help="continue from a --checkpoint file (host path)")
    p.add_argument("--render", default=None)
    p.set_defaults(fn=cmd_odometry)

    p = sub.add_parser("info", help="cloud stats")
    p.add_argument("input")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("bench", help="run the benchmark harness; flags "
                       "after 'bench' pass through (e.g. icpx bench --n 1000)")
    p.add_argument("bench_args", nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_bench)

    # 'bench' forwards everything verbatim (argparse.REMAINDER does not
    # capture flags that directly follow a subcommand)
    raw = list(sys.argv[1:] if argv is None else argv)
    if raw and raw[0] == "bench":
        _enable_compile_cache()
        ns = argparse.Namespace(bench_args=raw[1:])
        return cmd_bench(ns)

    args = ap.parse_args(argv)
    if args.command == "odometry" and not args.synthetic and not args.velodyne_dir:
        ap.error("odometry needs --velodyne-dir or --synthetic")
    _enable_compile_cache()  # after parsing: --help stays jax-free
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
