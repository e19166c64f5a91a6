"""Whole-sequence odometry as ONE compiled XLA program.

The host-driven frontend (`frontend.run_odometry`) dispatches one
registration per frame — flexible, but every frame pays a host round
trip. This version runs the ENTIRE sequence inside a single `lax.scan`:

  * frames arrive stacked (F, N, 3) with normals precomputed in one
    vmapped pass;
  * the carried state holds the current keyframe cloud, its pose, and
    the constant-velocity model; each scan step runs the full ICP
    while_loop against the carried keyframe;
  * keyframe spawning, the motion sanity gate, and dead-reckoning are
    `jnp.where` selects on the carry — no host involvement until the
    final trajectory comes back.

Trade-offs vs the host loop: fixed per-frame iteration budget, no map
mode / loop closures (run those host-side on the returned keyframes).
NN against the keyframe follows `ICPConfig.nn_method` ("auto"): the
tiled brute scan at small scan sizes, and per-step KD tile-index
builds inside the scan body above `block_auto_threshold` points — both
static-shape, both inside the one compiled program.

Parity with the host frontend: the program
returns the MEASURED keyframe-to-frame registration per step (`edge_rel`)
plus the final-segment carry, so `CompiledOdometry.edge_list()`
reconstructs exactly the edge list `frontend.run_odometry` builds —
measured constraints, not pose-derived ones. `objective="gicp"` is
supported by passing flattened (F, N, 9) covariances as the aux channel.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
from icpx import struct

from icpx.geometry.se3 import SE3
from icpx.kernels.knn import nearest_neighbor
from icpx.odometry.frontend import blend_velocity
from icpx.registration.icp import ICPConfig, _icp_scan, gicp_cov_rot


def resolve_odo_freeze(n_pts: int, freeze: Optional[bool] = None) -> bool:
    """Per-frame frozen-candidate default: on from 16384-pt scans (see
    run_odometry_compiled docstring)."""
    return n_pts >= 16384 if freeze is None else freeze


def resolve_odo_refine_stride(
    config: ICPConfig, n_pts: int, stride: int = 0
) -> int:
    """Within-tile refine stride for each per-frame registration of the
    compiled scan loop (multi-resolution refine: bulk iterations on every
    stride-th row of each query tile, `refine_full_iters` at full
    resolution).

    Explicit `stride` wins; an explicitly set `config.refine_stride`
    (non-auto) wins next; otherwise the scan-regime ladder — 4 from
    131072-pt scans, 2 from 65536, else 1 (tuned before the port to the
    H100; not yet re-chosen on it). The subsampled phase pays off only where the
    per-iteration fold dominates the frame; at small scans it costs ATE.
    This inverts the single-pair auto (stride 1: cold-start
    registrations pay extra iterations for the noisier solve
    statistics); the odometry frames are WARM-started, so the stride
    mostly thins already-converging iterations instead of adding new
    ones."""
    if stride:
        return stride
    if config.refine_stride:
        return config.refine_stride
    return 4 if n_pts >= 131072 else 2 if n_pts >= 65536 else 1


def resolve_odo_q_tile(config: ICPConfig, n_pts: int, q_tile: int = 0) -> int:
    """Source query-tile size for the compiled scan loop.

    Explicit `q_tile` wins; an explicitly tuned `config.block_q_tile`
    (anything but the class default) wins next — the ladder must not
    silently override a user's tiling; otherwise the scan-regime
    ladder: 256 from 65536-pt scans, 128 from 8192, else the config
    resolution (tuned before the port to the H100; not yet re-chosen on
    it)."""
    if q_tile:
        return q_tile
    if config.block_q_tile != ICPConfig.block_q_tile:
        return config.resolve_q_tile(n_pts)
    return (
        256 if n_pts >= 65536
        else 128 if n_pts >= 8192
        else config.resolve_q_tile(n_pts)
    )


@struct.dataclass
class CompiledOdometry:
    """Whole-sequence compiled odometry output (device arrays)."""

    poses: SE3  # (F,) world_T_frame
    is_keyframe: jax.Array  # (F,) bool
    rmse: jax.Array  # (F,)
    edge_src: jax.Array  # (F,) int32 keyframe index each step measured from
    edge_rel: SE3  # (F,) measured kf_T_frame (identity at index 0)
    final_kf: jax.Array  # scalar int32: keyframe index after the last frame
    final_rel: SE3  # prev_rel carry after the last frame

    def edge_list(self) -> List[Tuple[int, int, SE3]]:
        """Measured pose-graph edges, identical in structure to
        `frontend.run_odometry().edges`: one edge per keyframe spawn
        (src keyframe -> new keyframe, measured transform) plus the
        closing edge for the final open segment."""
        import numpy as np

        is_kf = np.asarray(self.is_keyframe)
        src = np.asarray(self.edge_src)
        f = int(is_kf.shape[0])
        edges: List[Tuple[int, int, SE3]] = []
        for k in range(1, f):
            if is_kf[k]:
                edges.append(
                    (
                        int(src[k]),
                        k,
                        SE3(R=self.edge_rel.R[k], t=self.edge_rel.t[k]),
                    )
                )
        fk = int(self.final_kf)
        if fk != f - 1:
            edges.append((fk, f - 1, self.final_rel))
        return edges


@partial(jax.jit, static_argnames=("config", "keyframe_trans", "keyframe_rot",
                                   "max_correction_trans",
                                   "max_correction_rot", "velocity_damping",
                                   "adaptive_velocity", "innovation_scale",
                                   "velocity_damping_min",
                                   "freeze_candidates", "q_tile",
                                   "refine_stride"))
def run_odometry_compiled(
    frames_xyz: jax.Array,  # (F, N, 3) sensor-frame scans
    frames_mask: jax.Array,  # (F, N)
    frames_normals: jax.Array,  # (F, N, 3)
    config: ICPConfig = ICPConfig(
        objective="symmetric",
        max_iters=12,
        diff_threshold=0.0,
        rmse_change_tol=1e-6,
        robust="huber",
        max_corr_dist=2.0,
    ),
    *,
    keyframe_trans: float = 1.0,
    keyframe_rot: float = 0.2,
    max_correction_trans: float = 1.0,
    max_correction_rot: float = 0.5,
    velocity_damping: float = 1.0,
    adaptive_velocity: bool = True,
    innovation_scale: float = 0.5,
    velocity_damping_min: float = 0.25,
    freeze_candidates: Optional[bool] = None,
    q_tile: int = 0,
    refine_stride: int = 0,
) -> CompiledOdometry:
    """Returns a `CompiledOdometry` (poses[0] = identity; world = first
    sensor frame).

    For `config.objective == "gicp"`, pass flattened per-point
    covariances (F, N, 9) as `frames_normals` (the aux channel).

    `freeze_candidates` (block path): rank each frame's candidate tiles
    ONCE at the warm-started init position and reuse them across the
    frame's ICP iterations — the constant-velocity init leaves residual
    motion well under a tile extent, the same precondition the
    single-pair path's frozen refine candidates rely on after coarse
    alignment. Misses follow block-NN semantics (genuine-but-larger
    distances, robust-gated). None = auto: on from 16384-pt scans up
    (below that the per-frame ranking overhead loses to per-iteration
    ranking; tuned before the port to the H100, not yet re-chosen on
    it).

    `q_tile` overrides the source query-tile size; 0 = auto: 256 from
    65536-pt scans, 128 from 8192, else `config.resolve_q_tile`. The
    SCAN-regime crossover differs from the single-pair tuning (Sq=64
    at <=2M registration points): simulated-LiDAR scan density favors
    wider tiles at the same ATE.

    `refine_stride` (block path): within-tile row stride for the bulk of
    each per-frame registration's iterations, full resolution for the
    last `config.refine_full_iters` — see `resolve_odo_refine_stride`
    for the ladder (0 = auto: 4 from 131k-pt scans, 2 from 65k).
    """
    f = frames_xyz.shape[0]
    n_pts = frames_xyz.shape[1]
    freeze_candidates = resolve_odo_freeze(n_pts, freeze_candidates)
    q_tile = resolve_odo_q_tile(config, n_pts, q_tile)
    refine_stride = resolve_odo_refine_stride(config, n_pts, refine_stride)
    gicp = config.objective == "gicp"
    aux_rot = gicp_cov_rot if gicp else None
    # Brute NN serves small scans (below block_auto_threshold there are
    # too few tiles to rank); above it the O(N^2)-per-frame cost would
    # dominate, so large scans use KD tile indexes — the SOURCE index
    # built per step inside the scan body, the KEYFRAME index built once
    # per keyframe SPAWN and loop-carried (the keyframe cloud only
    # changes on spawn). Everything stays one compiled XLA program.
    use_block = config.resolve_nn(n_pts) == "block"

    def nn_factory(t_xyz, t_mask, t_n):
        def nn_fn(p):
            d2, idx = nearest_neighbor(
                p, t_xyz, ref_mask=t_mask,
                tile_q=config.tile_q, tile_r=config.tile_r,
            )
            return t_xyz[idx], t_n[idx], jnp.sqrt(d2)

        return nn_fn

    def build_target(fx, fm, fn):
        """Keyframe-side state, computed ONCE per keyframe spawn: the
        centroid shift, the trimmed tile index over the centered cloud,
        and the fused (N, 3+D) sorted payload table."""
        from icpx.kernels.blocknn import (
            _SUPER_G,
            fused_payload_table,
            trim_index,
        )

        denom = jnp.maximum(fm.sum(), 1).astype(jnp.float32)
        center = jnp.where(fm[:, None], fx, 0.0).sum(0) / denom
        fx_c = jnp.where(fm[:, None], fx - center[None, :], fx)
        builder = config.tile_builder()
        t_idx = trim_index(
            builder(fx_c, fm, tile_size=config.block_tile),
            n_pts,
            multiple=_SUPER_G,
        )
        return t_idx, fused_payload_table(t_idx, fn), center

    def block_register(fx_c, fm, fn, t_idx, tgt_pl, init_c):
        """One frame-to-keyframe registration via tile-index NN (both
        clouds already in keyframe-centroid coordinates; the keyframe
        index/payload arrive prebuilt from the carry). Mirrors the
        single-pair block path (registration/icp.py) minus the coarse
        phase: scan-to-scan motion is small, refine-only converges."""
        from icpx.kernels.blocknn import (
            _candidate_tiles,
            block_nn,
            trim_index,
        )

        builder = config.tile_builder()
        s_idx = trim_index(
            builder(fx_c, fm, tile_size=q_tile),
            n_pts,
        )
        order = s_idx.order
        valid = order >= 0
        safe = jnp.maximum(order, 0)
        s_xyz = s_idx.tiles.reshape(-1, 3)
        s_n = jnp.where(valid[:, None], fn[safe], 0.0)
        sq = q_tile
        tq = s_xyz.shape[0] // sq

        cand = None
        if freeze_candidates:
            # candidate ranking paid once per FRAME (at the warm init's
            # aligned positions) instead of once per ICP iteration
            p0 = init_c.apply(s_xyz).reshape(tq, sq, 3)
            cand = _candidate_tiles(p0, t_idx, config.block_k)[0]

        def make_nn(sq_n):
            def nn_fn(p):
                d2, pos = block_nn(
                    p.reshape(tq, sq_n, 3), t_idx,
                    k_tiles=config.block_k, return_pos=True,
                    cand_tiles=cand,
                    score_prec=config.resolve_score_prec(),
                )
                pl = tgt_pl[pos]
                return pl[:, :3], pl[:, 3:], jnp.sqrt(d2)

            return nn_fn

        # Multi-resolution refine (the single-pair "mid" phase,
        # registration/icp.py): bulk iterations on every refine_stride-th
        # row WITHIN each query tile (tile boxes and the per-frame frozen
        # candidate list stay valid), full resolution only for the last
        # `refine_full_iters`. Resolution + measured scan ladder:
        # resolve_odo_refine_stride (A/B via
        # `bench.py --odometry --odo-refine-stride N`).
        stride_r = refine_stride
        mid = (
            stride_r > 1
            and sq % stride_r == 0
            and sq // stride_r >= 8
            and config.max_iters > config.refine_full_iters
        )
        prev_rmse0 = None
        init_m = init_c
        cfg_f = config
        if mid:
            sq_m = sq // stride_r
            dn = s_n.shape[1]

            def substride(arr, d=None):
                a = arr.reshape(tq, sq, d) if d else arr.reshape(tq, sq)
                return (
                    a[:, ::stride_r].reshape(-1, d)
                    if d
                    else a[:, ::stride_r].reshape(-1)
                )

            cfg_m = dataclasses.replace(
                config,
                max_iters=config.max_iters - config.refine_full_iters,
                diff_threshold=config.diff_threshold / stride_r,
            )
            res_m = _icp_scan(
                cfg_m,
                substride(s_xyz, 3),
                substride(valid),
                substride(s_n, dn),
                init_c,
                make_nn(sq_m),
                aux_rot=aux_rot,
            )
            init_m = res_m.transform
            prev_rmse0 = res_m.final_rmse
            cfg_f = dataclasses.replace(
                config, max_iters=config.refine_full_iters
            )

        return _icp_scan(
            cfg_f, s_xyz, valid, s_n, init_m, make_nn(sq),
            aux_rot=aux_rot, prev_rmse0=prev_rmse0,
        )

    def step(carry, frame):
        (kf_xyz, kf_mask, kf_n, kf_R, kf_t, kf_idx, prev_rel, velocity,
         model_warm, rejects, kf_cache) = carry
        fx, fm, fn, k = frame
        kf_pose = SE3(R=kf_R, t=kf_t)

        init = prev_rel @ velocity
        # Solve in keyframe-centroid coordinates (same conjugation as
        # register()/register_batch): sensor scans are near the origin,
        # but a world-frame or large-offset sequence would otherwise lose
        # fp32 precision in the squared-distance expansions.
        # Block path: the centroid is part of the spawn-time cache (it is
        # a pure function of the keyframe, fixed per segment).
        if use_block:
            t_idx, tgt_pl, center = kf_cache
        else:
            denom = jnp.maximum(kf_mask.sum(), 1).astype(jnp.float32)
            center = (
                jnp.where(kf_mask[:, None], kf_xyz, 0.0).sum(0) / denom
            )
        shift = SE3.identity().replace(t=-center)
        unshift = SE3.identity().replace(t=center)
        fx_c = jnp.where(fm[:, None], fx - center[None, :], fx)
        init_c = shift @ init @ unshift
        if use_block:
            res = block_register(fx_c, fm, fn, t_idx, tgt_pl, init_c)
        else:
            kf_c = jnp.where(
                kf_mask[:, None], kf_xyz - center[None, :], kf_xyz
            )
            res = _icp_scan(
                config,
                fx_c,
                fm,
                fn,
                init_c,
                nn_factory(kf_c, kf_mask, kf_n),
                aux_rot=aux_rot,
            )
        rel = unshift @ res.transform @ shift

        # motion sanity gate (see frontend.py: warm-up + 2-strike valve)
        corr = init.inverse() @ rel
        corr_t = jnp.linalg.norm(corr.t)
        corr_r = corr.rotation_angle()
        finite = jnp.isfinite(corr_t) & jnp.all(jnp.isfinite(rel.t))
        gate_on = (
            (max_correction_trans > 0) & model_warm & (rejects < 2)
        )
        rejected = (~finite) | (
            gate_on
            & (
                (corr_t > max_correction_trans)
                | (corr_r > max_correction_rot)
            )
        )
        rel = jax.tree_util.tree_map(
            lambda a, b: jnp.where(rejected, a, b), init, rel
        )
        pose = kf_pose @ rel
        rmse = jnp.where(rejected, jnp.float32(jnp.inf), res.final_rmse)
        vel_raw = prev_rel.inverse() @ rel
        velocity = blend_velocity(
            velocity,
            vel_raw,
            damping=velocity_damping,
            adaptive=adaptive_velocity,
            innovation_scale=innovation_scale,
            damping_min=velocity_damping_min,
        )
        model_warm = model_warm | ~rejected
        rejects = jnp.where(rejected, rejects + 1, 0)

        # keyframe decision
        spawn = (~rejected) & (
            (jnp.linalg.norm(rel.t) > keyframe_trans)
            | (rel.rotation_angle() > keyframe_rot)
        )
        # the measured edge this step: kf_idx (at entry) -> frame k, rel
        out = (pose.R, pose.t, spawn, rmse, kf_idx, rel.R, rel.t)
        kf_xyz = jnp.where(spawn, fx, kf_xyz)
        kf_mask = jnp.where(spawn, fm, kf_mask)
        kf_n = jnp.where(spawn, fn, kf_n)
        kf_R = jnp.where(spawn, pose.R, kf_R)
        kf_t = jnp.where(spawn, pose.t, kf_t)
        kf_idx = jnp.where(spawn, k, kf_idx)
        prev_rel = jax.tree_util.tree_map(
            lambda eye, r: jnp.where(spawn, eye, r), SE3.identity(), rel
        )
        if use_block:
            # rebuild the keyframe index ONLY on spawn steps (lax.cond:
            # non-spawn frames skip the build + payload sort entirely)
            old_cache = kf_cache
            kf_cache = jax.lax.cond(
                spawn,
                lambda: build_target(fx, fm, fn),
                lambda: old_cache,
            )

        return (
            (kf_xyz, kf_mask, kf_n, kf_R, kf_t, kf_idx, prev_rel, velocity,
             model_warm, rejects, kf_cache),
            out,
        )

    eye = SE3.identity()
    kf_cache0 = (
        build_target(frames_xyz[0], frames_mask[0], frames_normals[0])
        if use_block
        else jnp.zeros((), jnp.float32)  # placeholder carry leaf
    )
    carry0 = (
        frames_xyz[0],
        frames_mask[0],
        frames_normals[0],
        eye.R,
        eye.t,
        jnp.int32(0),
        eye,
        eye,
        jnp.array(False),
        jnp.int32(0),
        kf_cache0,
    )
    carry_f, (Rs, ts, spawns, rmses, srcs, relR, relt) = jax.lax.scan(
        step,
        carry0,
        (
            frames_xyz[1:],
            frames_mask[1:],
            frames_normals[1:],
            jnp.arange(1, f, dtype=jnp.int32),
        ),
    )
    poses = SE3(
        R=jnp.concatenate([eye.R[None], Rs]),
        t=jnp.concatenate([eye.t[None], ts]),
    )
    is_kf = jnp.concatenate([jnp.ones((1,), bool), spawns])
    rmse = jnp.concatenate([jnp.zeros((1,), jnp.float32), rmses])
    return CompiledOdometry(
        poses=poses,
        is_keyframe=is_kf,
        rmse=rmse,
        edge_src=jnp.concatenate([jnp.zeros((1,), jnp.int32), srcs]),
        edge_rel=SE3(
            R=jnp.concatenate([eye.R[None], relR]),
            t=jnp.concatenate([eye.t[None], relt]),
        ),
        final_kf=carry_f[5],
        final_rel=carry_f[6],
    )
