#!/usr/bin/env python
"""End-to-end check that icpx runs on one NVIDIA GPU, at full size.

    python chip_smoke.py               # phases a-e on one card
    python chip_smoke.py --four-cards  # the multi-device paths, 4 cards

One process drives the card and runs every phase; no child process
opens JAX. Before the phases it prints the JAX device and the card's
name and power limit. Each phase prints one line of results and raises
if its gate fails, so any failing phase makes the script exit non-zero.
Without a GPU it exits non-zero before running anything.

Phases (one card):
  a  cat parity: `register` on the vendored cat pair, target rows
     shuffled (3,400 points, brute NN): recovers Rz(pi/4) + (2.5, 0, 0).
  b  flagship pair, 1,048,576 points (block NN, in-jit normals): GT gate.
  c  large pair, 8,388,608 points (Sq=128 query tiles, fold/infold
     payload paths): GT gate, plus peak device memory.
  d  compiled odometry, 20 simulated 65,536-point LiDAR scans: ATE gate.
  e  the NN fold at the widths of b and c: the GPU fold kernel against
     the XLA fold on the same candidates, and both against exact brute
     NN on a 65,536-query subset.

The last line is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

GT_GATE = 5e-3  # rot (rad) and translation gate of the flagship pairs
ATE_GATE_M = 0.5


class PhaseFailed(AssertionError):
    """A phase's gate did not hold."""


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseFailed(msg)


def _timed(fn, reps: int):
    """(first-call seconds, median steady-state seconds, last output)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return first, float(np.median(times)) if times else first, out


# ---- phases -------------------------------------------------------------


def phase_cat(reps: int = 3) -> dict:
    """a: the reference demo pair through `icpx.register`."""
    from bench import cat_config
    from icpx.cloud import PointCloud
    from icpx.geometry.transforms import make_rigid_perturbation
    from icpx.io.loaders import load_cloud
    from icpx.registration.icp import register

    data = ROOT / "tests" / "data"
    src = load_cloud(data / "cat.pcd")
    tgt_np = load_cloud(data / "cat_out.pcd").to_numpy()
    tgt = PointCloud.create(
        tgt_np[np.random.default_rng(0).permutation(len(tgt_np))]
    )
    cfg = cat_config()
    first, wall, res = _timed(lambda: register(src, tgt, cfg), reps)
    rot, tr = (float(x) for x in res.transform.distance_to(
        make_rigid_perturbation()
    ))
    out = dict(phase="a", n=int(src.num_valid()), wall_s=wall,
               first_call_s=first, rot_err=rot, t_err=tr,
               rmse=float(res.final_rmse), iters=int(res.iters))
    print(json.dumps(out), flush=True)
    _check(rot < 1e-3 and tr < 1e-2, f"cat parity failed: {out}")
    return out


def phase_pair(n: int, label: str, reps: int = 3, **overrides) -> dict:
    """b / c: the flagship synthetic pair at n points."""
    import jax

    from bench import flagship_config, flagship_pair
    from icpx.geometry.se3 import SE3
    from icpx.registration.icp import _register_jit

    src, tgt, gt = flagship_pair(n)
    cfg = flagship_config(**overrides)
    run = jax.jit(
        lambda s, t: _register_jit(
            s, t, SE3.identity(), cfg, normals_for=("src", "tgt")
        )
    )
    first, wall, res = _timed(lambda: run(src, tgt), reps)
    rot, tr = (float(x) for x in res.transform.distance_to(gt))
    stats = jax.devices()[0].memory_stats() or {}
    out = dict(
        phase=label, n=n, payload=cfg.resolve_payload(n),
        wall_s=wall, first_call_s=first, pts_per_s=n / wall,
        rot_err=rot, t_err=tr, rmse=float(res.final_rmse),
        iters=int(res.iters),
        peak_bytes_in_use=stats.get("peak_bytes_in_use"),
    )
    print(json.dumps(out), flush=True)
    _check(rot < GT_GATE and tr < GT_GATE, f"pair {label} failed GT: {out}")
    return out


def phase_odometry(n_frames: int = 20, scan_points: int = 65536,
                   reps: int = 2) -> dict:
    """d: the whole-sequence compiled odometry loop."""
    import jax
    import jax.numpy as jnp

    from bench import odometry_config, odometry_scans
    from icpx.kernels.normals import estimate_normals
    from icpx.odometry.compiled import run_odometry_compiled
    from icpx.odometry.evaluate import ate_rmse

    frames, gt = odometry_scans(n_frames, scan_points)
    frames = [estimate_normals(f, k=10) for f in frames]
    fx = jnp.stack([f.xyz for f in frames])
    fm = jnp.stack([f.mask for f in frames])
    fn = jnp.stack([f.normals for f in frames])
    cfg = odometry_config()
    first, wall, res = _timed(
        lambda: run_odometry_compiled(
            fx, fm, fn, cfg, velocity_damping=0.7
        ),
        reps,
    )
    poses = [jax.tree_util.tree_map(lambda x: x[i], res.poses)
             for i in range(n_frames)]
    gt_rel = [gt[0].inverse() @ g for g in gt]
    ate = float(ate_rmse(poses, gt_rel, align=False))
    out = dict(phase="d", frames=n_frames, scan_points=scan_points,
               wall_s=wall, first_call_s=first, fps=n_frames / wall,
               ate_m=ate,
               keyframes=int(np.asarray(res.is_keyframe).sum()))
    print(json.dumps(out), flush=True)
    _check(ate < ATE_GATE_M, f"odometry ATE gate failed: {out}")
    return out


def fold_agreement(n: int, q_tile: int, n_check: int = 65536,
                   reps: int = 5, interpret: bool = False) -> dict:
    """e: the GPU fold kernel on frozen candidates (refine-regime
    queries: the source moved by the ground truth, as after the coarse
    phase) against its plain-jnp reference (`fold_nn_reference`, the
    same exact-difference distances) and the production XLA fold
    (`block_nn_payload`, norm-expansion scores at "highest"), and both
    folds against exact brute NN on an `n_check`-query subset.

    Gates: against the reference, rows whose selected target row
    differs are at most 1e-4 of all rows, and only where the two
    distances differ by <= 1e-6 * extent^2 (near-ties: the GPU may
    contract the distance sum into FMAs); the kernel's payload is the
    table row bit for bit; kernel and XLA fold miss the same rows; the
    kernel's miss rate against exact NN is no worse than the XLA
    fold's. Rows where kernel and XLA fold pick different rows are
    reported: at dense sizes the expansion's rounding exceeds the gap
    between the nearest candidates."""
    import jax
    import jax.numpy as jnp

    from bench import flagship_pair
    from icpx.kernels import fold_triton
    from icpx.kernels.blocknn import (
        _SUPER_G,
        _candidate_tiles,
        block_nn_payload,
        build_kd_index,
        tile_payload,
        trim_index,
    )
    from icpx.kernels.knn import nearest_neighbor

    src, tgt, gt = flagship_pair(n)
    center = tgt.centroid()
    q_xyz = gt.apply(src.xyz) - center
    t_xyz = tgt.xyz - center
    q_idx = trim_index(
        build_kd_index(q_xyz, src.mask, tile_size=q_tile), n, multiple=4
    )
    t_idx = trim_index(
        build_kd_index(t_xyz, tgt.mask, tile_size=128), n,
        multiple=_SUPER_G,
    )
    # payload = [xyz || original row id || 2 noise lanes]: the id lane
    # names the selected row, the noise lanes check exact copying
    rid = jnp.arange(n, dtype=jnp.float32)[:, None]
    noise = jax.random.normal(jax.random.PRNGKey(0), (n, 2), jnp.float32)
    aux = tile_payload(t_idx, jnp.concatenate([rid, noise], axis=1))
    pl_tiles = jnp.concatenate([t_idx.tiles, aux], axis=2)  # (T, S, 6)
    q_tiles = q_idx.tiles
    cand, _ = jax.jit(_candidate_tiles, static_argnums=2)(q_tiles, t_idx, 6)
    tabs = jax.jit(fold_triton.fold_tables)(t_idx, pl_tiles)

    # the index and tables are arguments, not closed-over constants
    xla = jax.jit(lambda q, c, idx, pl_t: block_nn_payload(
        q, idx, pl_t, k_tiles=6, cand_tiles=c,
        score_prec="highest", payload_prec="highest",
    ))
    _, t_xla, (d_x, p_x) = _timed(
        lambda: xla(q_tiles, cand, t_idx, pl_tiles), reps
    )
    _, t_ker, (d_k, p_k) = _timed(
        lambda: fold_triton.fold_nn(q_tiles, cand, tabs, interpret=interpret),
        reps,
    )
    d_r, p_r = fold_triton.fold_nn_reference(q_tiles, cand, tabs)

    qv = np.asarray(q_idx.order) >= 0
    d_x, p_x, d_k, p_k, d_r, p_r = (
        np.asarray(a)[qv] for a in (d_x, p_x, d_k, p_k, d_r, p_r)
    )
    lo = np.asarray(jnp.min(t_xyz, axis=0))
    hi = np.asarray(jnp.max(t_xyz, axis=0))
    ext2 = float(np.sum((hi - lo) ** 2))
    tie = 1e-6 * ext2
    rows = len(d_k)
    differ = np.isfinite(d_k) & (p_k[:, 3] != p_r[:, 3])
    differ_x = np.isfinite(d_k) & (p_k[:, 3] != p_x[:, 3])
    ids = np.where(np.isfinite(d_k), p_k[:, 3], 0).astype(np.int64)
    table = np.concatenate(
        [np.asarray(tgt.xyz - center), np.asarray(rid), np.asarray(noise)],
        axis=1,
    )
    exact_copy = bool(np.all(
        (p_k[np.isfinite(d_k)] == table[ids[np.isfinite(d_k)]]).all(1)
    ))
    # exact brute NN on an evenly spaced query subset
    take = np.linspace(0, rows - 1, min(n_check, rows)).astype(np.int64)
    qs = np.asarray(q_tiles).reshape(-1, 3)[qv][take]
    d_e, _ = nearest_neighbor(jnp.asarray(qs), t_xyz, ref_mask=tgt.mask)
    d_e = np.asarray(d_e)
    slack = 1e-6 * ext2
    miss_k = float(np.mean(d_k[take] > d_e + slack))
    miss_x = float(np.mean(d_x[take] > d_e + slack))
    out = dict(
        phase="e", n=n, q_tile=q_tile, fold_xla_s=t_xla, fold_kernel_s=t_ker,
        rows=rows, rows_differ_ref=int(differ.sum()),
        max_tie_gap_ref=float(np.max(np.abs(d_k - d_r)[differ]))
        if differ.any() else 0.0,
        tie_limit=tie,
        rows_differ_xla=int(differ_x.sum()),
        max_gap_xla=float(np.max(np.abs(d_k - d_x)[differ_x]))
        if differ_x.any() else 0.0,
        miss_sets_differ=int(
            (np.isfinite(d_k) != np.isfinite(d_x)).sum()
            + (np.isfinite(d_k) != np.isfinite(d_r)).sum()),
        exact_payload_copy=exact_copy,
        miss_rate_kernel=miss_k, miss_rate_xla=miss_x,
    )
    print(json.dumps(out), flush=True)
    _check(out["miss_sets_differ"] == 0, f"miss sets differ: {out}")
    _check(differ.sum() <= 1e-4 * rows, f"too many rows differ: {out}")
    _check(out["max_tie_gap_ref"] <= tie,
           f"a differing row is no tie: {out}")
    _check(exact_copy, f"payload rows are not exact copies: {out}")
    _check(miss_k <= miss_x + 1e-4, f"kernel misses more than XLA: {out}")
    return out


# ---- four cards ---------------------------------------------------------


def four_card_phases(n_per_card: int = 1 << 20,
                     n_brute: int = 1 << 16) -> None:
    """DP over pairs, points-axis TP, ring block NN and EP scan-to-map,
    each compared with the same work on one card. `n_brute` sizes the
    pairs of the brute-NN DP path (sharded_register_pairs)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from bench import flagship_config, flagship_pair
    from icpx.distributed.map_ep import partition_map, sharded_map_register
    from icpx.distributed.mesh import make_mesh
    from icpx.distributed.sharded_icp import (
        sharded_register,
        sharded_register_pairs,
    )
    from icpx.kernels.normals import estimate_normals
    from icpx.registration.icp import register, register_batch

    devs = jax.devices()
    nd = len(devs)
    _check(nd == 4, f"--four-cards needs 4 devices, found {nd}")

    def report(name, one, many, gt, t_one, t_many, tol=1e-3):
        rot1, tr1 = (float(x) for x in one.distance_to(gt))
        rot4, tr4 = (float(x) for x in many.distance_to(gt))
        agree_r, agree_t = (float(x) for x in one.distance_to(many))
        out = dict(phase=name, one_card_s=t_one, four_cards_s=t_many,
                   rot_err_1=rot1, t_err_1=tr1, rot_err_4=rot4,
                   t_err_4=tr4, rot_1v4=agree_r, t_1v4=agree_t)
        print(json.dumps(out), flush=True)
        _check(max(rot1, tr1, rot4, tr4) < GT_GATE, f"{name} GT: {out}")
        _check(max(agree_r, agree_t) < tol, f"{name} 1 vs 4: {out}")

    def on_all(res):
        """Every result leaf must live on all four cards, not device 0."""
        for leaf in jax.tree_util.tree_leaves(res):
            _check(len(leaf.sharding.device_set) == nd,
                   f"result on {leaf.sharding.device_set}")

    n = n_per_card * nd
    src, tgt, gt = flagship_pair(n)
    cfg = flagship_config(nn_method="block")

    # points-axis TP (psum'd 6x6 system), replicated target
    src_n = estimate_normals(src, k=cfg.k_normals)
    tgt_n = estimate_normals(tgt, k=cfg.k_normals)
    mesh = make_mesh(axis_names=("points",), devices=devs)
    _, t_one, r1 = _timed(lambda: register(src_n, tgt_n, cfg), 1)
    _, t_tp, r4 = _timed(lambda: sharded_register(src_n, tgt_n, cfg, mesh), 1)
    on_all(r4)
    report("tp", r1.transform, r4.transform, gt, t_one, t_tp)
    # ring block NN: the target sharded too, index shards rotating
    _, t_ring, r4 = _timed(
        lambda: sharded_register(src_n, tgt_n, cfg, mesh, ring=True), 0
    )
    on_all(r4)
    report("ring", r1.transform, r4.transform, gt, t_one, t_ring)

    # EP scan-to-map: map blocks expert-parallel, scan sharded
    mb = partition_map(tgt_n.xyz, tgt_n.normals, tgt_n.mask, n_blocks=nd)
    ep_mesh = make_mesh(axis_names=("blocks",), devices=devs)
    _, t_ep, r4 = _timed(
        lambda: sharded_map_register(src_n, mb, cfg, ep_mesh, nn="block"), 0
    )
    on_all(r4)
    report("ep", r1.transform, r4.transform, gt, t_one, t_ep)

    # DP over pairs, block path: four 1M pairs, the batch axis sharded
    # one pair per card, vs the same batch on one card
    from jax.sharding import NamedSharding, PartitionSpec as P

    from icpx.registration.icp import register_batch_block

    pairs = [flagship_pair(n_per_card, seed=i) for i in range(nd)]
    xs = [jnp.stack([p[0].xyz for p in pairs]),
          jnp.stack([p[0].mask for p in pairs]),
          jnp.stack([p[1].xyz for p in pairs]),
          jnp.stack([p[1].mask for p in pairs])]
    run_b = jax.jit(lambda a, b, c, d: register_batch_block(a, b, c, d, cfg))
    _, t_one, r1 = _timed(lambda: run_b(*xs), 1)
    dp_mesh = make_mesh(axis_names=("pairs",), devices=devs)
    xs4 = [jax.device_put(x, NamedSharding(dp_mesh, P("pairs")))
           for x in xs]
    _, t_dp, r4 = _timed(lambda: run_b(*xs4), 1)
    on_all(r4)
    for i in range(nd):
        report(f"dp_block[{i}]",
               jax.tree_util.tree_map(lambda x: x[i], r1.transform),
               jax.tree_util.tree_map(lambda x: x[i], r4.transform),
               pairs[i][2], t_one, t_dp)

    # DP x TP over pairs with sharded_register_pairs: its NN is the
    # brute scan (scan-scale pairs), so pairs are n_brute points here
    pairs = [flagship_pair(n_brute, seed=i) for i in range(nd)]
    ns = [(estimate_normals(s, k=cfg.k_normals),
           estimate_normals(t, k=cfg.k_normals)) for s, t, _ in pairs]
    args = (
        jnp.stack([s.xyz for s, _ in ns]), jnp.stack([s.mask for s, _ in ns]),
        jnp.stack([s.normals for s, _ in ns]),
        jnp.stack([t.xyz for _, t in ns]), jnp.stack([t.mask for _, t in ns]),
        jnp.stack([t.normals for _, t in ns]),
    )
    cfg_dp = dataclasses.replace(cfg, nn_method="brute")
    dp_mesh = make_mesh((nd, 1), ("pairs", "points"), devices=devs)
    _, t_one, r1 = _timed(lambda: register_batch(*args, cfg_dp), 1)
    _, t_dp, r4 = _timed(
        lambda: sharded_register_pairs(*args, cfg_dp, dp_mesh), 0
    )
    on_all(r4)
    for i in range(nd):
        report(f"dp_pairs[{i}]",
               jax.tree_util.tree_map(lambda x: x[i], r1.transform),
               jax.tree_util.tree_map(lambda x: x[i], r4.transform),
               pairs[i][2], t_one, t_dp)


# ---- entry --------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on 4 cards")
    args = ap.parse_args(argv)

    from icpx.utils.device import (
        NoGPUError,
        gpu_name_and_power_limit,
        require_gpu,
    )

    try:
        dev = require_gpu()
    except NoGPUError as e:
        print(f"chip_smoke.py: {e}", file=sys.stderr)
        return 2
    print(f"platform: {dev['platform']}", flush=True)
    print(f"device_kind: {dev['kind']}", flush=True)
    print(f"device_count: {dev['count']}", flush=True)
    print(f"card: {gpu_name_and_power_limit()}", flush=True)

    from icpx.cli import _enable_compile_cache

    _enable_compile_cache()
    if args.four_cards:
        four_card_phases()
    else:
        _check(dev["count"] >= 1, "no device")
        phase_cat()
        phase_pair(1 << 20, "b")
        phase_pair(1 << 23, "c")
        phase_odometry()
        fold_agreement(1 << 20, q_tile=64)
        fold_agreement(1 << 23, q_tile=128)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"],
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
