"""Iterate-to-convergence ICP: the JAX rebuild of `MyICP::RegisterSymm`
(`myicp.cpp:100-150`) plus the point-to-point mode the reference declared
but never finished (`myicp.h:18`, stub at `myicp.cpp:43-59`).

Differences from the reference, by design (SURVEY.md §7):
  * real nearest-neighbor correspondences each iteration — the reference
    skips this entirely (TODO at `myicp.cpp:128-131`) and only works on
    index-aligned fixtures;
  * joint 6-DoF Gauss-Newton with Levenberg damping instead of alternating
    3-variable solves (`func.cpp:85-88`);
  * robust weights + max-correspondence-distance gating (absent upstream);
  * the whole loop is one `lax.scan` under `jit`: static shapes, no host
    round-trips, per-iteration diagnostics returned as arrays.

Convergence bookkeeping matches the reference observably: `diff` is the
plain sum of corresponded point distances (`evalDiff`, `func.cpp:19-32`)
with default threshold 1.0 and max 10 iterations (`myicp.cpp:6`).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from icpx import struct

from icpx.cloud import PointCloud
from icpx.geometry.se3 import SE3
from icpx.kernels.knn import nearest_neighbor
from icpx.kernels.normals import estimate_normals
from icpx.registration.step import (
    correspondence_weights,
    estimate_increment,
    identity_reduce,
    step_stats,
)

OBJECTIVES = ("symmetric", "p2plane", "p2p", "gicp")
PAYLOAD_MODES = ("auto", "gather", "infold", "fold")


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Static hyperparameters. Reference hard-codings become named fields
    with the reference values as defaults (SURVEY.md §5.6).

    Size thresholds, tile sizes and phase schedules below were tuned
    before the port to the H100 and have not yet been re-chosen on it;
    each comment keeps the design reason only."""

    objective: str = "symmetric"
    max_iters: int = 10  # myicp.cpp:6
    diff_threshold: float = 1.0  # myicp.cpp:6 (evalDiff sum)
    rmse_change_tol: float = 0.0  # extra stop: |delta RMSE| below this
    # extra stop (PCL transformation_epsilon analogue): stop once an
    # iteration's increment moves by less than this, measured as
    # rotation angle (rad) + translation norm (cloud units). 0 = off.
    transform_tol: float = 0.0
    k_normals: int = 10  # myicp.cpp:160
    max_corr_dist: float = float("inf")
    robust: str = "none"  # none|huber|tukey|welsch|cauchy
    robust_scale: float = 0.0  # <= 0 -> auto via MAD each iteration
    # Trimmed ICP: keep only the closest fraction of correspondences
    # (1.0 = keep all). Robust to partial overlap.
    trim_fraction: float = 1.0
    damping: float = 1e-6
    # LOAM-style degeneracy handling: zero the update along 6x6-JtJ
    # eigendirections with eigenvalue < clamp * max eigenvalue. In scenes
    # with a flat objective direction (corridors, smooth ground) ICP
    # otherwise WANDERS along it, chasing its init + IRLS bias. 0 = off.
    degeneracy_clamp: float = 0.0
    # NN search: "brute" = tiled O(N^2) XLA scan, "block" = spatially-
    # tiled IVF-style O(N*K*S) (the large-cloud path), "auto" picks block
    # at or above `block_auto_threshold` target points (below it clouds
    # have too few tiles to rank).
    nn_method: str = "auto"
    # Reference tile size S: smaller tiles give the same recall from
    # fewer candidate points per query.
    block_tile: int = 128
    block_q_tile: int = 64  # query tile size Sq (smaller = tighter boxes)
    # Query tile size for LARGE clouds (>= payload_infold_threshold
    # points): recall depends on a tile's SPATIAL extent, which shrinks
    # with density, so dense clouds afford more points per query tile.
    # 0 = always use block_q_tile.
    block_q_tile_large: int = 128
    block_k: int = 8
    # Candidate-tile count for refine-phase iterations (after the coarse
    # phase has aligned the clouds, correspondences are near and a
    # smaller candidate set keeps recall; 0 = use block_k throughout).
    block_k_refine: int = 6
    # Coarse phase: the first `coarse_iters` iterations run on a
    # stride-`coarse_stride` row subsample with 4 sibling KD tiles merged
    # per query tile (the parent box), reusing full-resolution normals —
    # ~4x cheaper NN while the motion is still large. 0 disables.
    coarse_iters: int = 2
    coarse_stride: int = 4
    # Feature-augmented correspondence (block NN only): match in the 4D
    # metric ||p-q||^2 + feat_nn_weight^2 (f_p - f_q)^2 using the named
    # payload column of BOTH clouds (e.g. "intensity"). Disambiguates
    # geometrically degenerate scenes (planes, corridors) where pure
    # point-to-surface ICP is rank-deficient. Scale the weight so
    # feat_nn_weight * (typical feature contrast) ~ the spatial scale
    # you want it to pin. "" disables. NOTE: correspondence distances
    # (max_corr_dist gating, trim_fraction, robust scaling, reported
    # diff/rmse) are then in the AUGMENTED metric — widen max_corr_dist
    # by the expected feature term if it was tuned spatially.
    feat_nn: str = ""
    feat_nn_weight: float = 0.0
    # Rank refine-phase candidate tiles ONCE at the coarse-aligned
    # positions instead of every iteration (safe: post-coarse motion is
    # well under a tile extent).
    freeze_refine_candidates: bool = True
    # Multi-resolution refine (the classic pyramid schedule, cf.
    # Rusinkiewicz & Levoy 2001 "Efficient ICP variants"): run the bulk
    # of the refine iterations on a within-tile row subsample of the
    # source (every refine_stride-th row of each query tile — the tile
    # boxes and frozen candidate lists stay valid), then at most
    # `refine_full_iters` at full resolution. `diff` is a SUM over
    # points, so the mid phase gates on diff_threshold / stride;
    # rmse-based stops are scale-invariant. refine_stride: 1 = off,
    # 0 = auto, which resolves to 1: on cold-start pairs the subsampled
    # mid phase needed more iterations than it saved.
    refine_stride: int = 0
    refine_full_iters: int = 2
    # retired auto-gate size (auto now always resolves to stride 1);
    # kept so existing configs stay constructible
    refine_stride_threshold: int = 2 * 1024 * 1024
    # Precision of the block-NN score einsum. "highest" = true fp32 (the
    # package default); "bf16" = one bf16 pass with f32 accumulation on
    # query-tile-CENTERED coordinates, where the expansion's terms scale
    # with the local tile extent, so rounding stays a small fraction of
    # a point spacing and misses remain genuine near-ties; "high" = the
    # backend's reduced-precision f32 (TF32 on NVIDIA GPUs). "auto" =
    # "highest" on every backend. Applies to correspondence scoring only
    # (solve/normals stay fp32).
    score_precision: str = "auto"
    # How matched target rows (coords + normals/covs) reach the solve:
    # "gather" = one coherent (N, 3+D) sorted-table row gather per
    # iteration; "infold" = one-hot selection inside the XLA NN fold,
    # independent of table size; "fold" = the fused GPU kernel
    # (kernels/fold_triton.py) on frozen-candidate phases. "auto" = fold
    # on a GPU from `fold_threshold` target points, else infold from
    # `payload_infold_threshold`, else gather.
    payload_mode: str = "auto"
    payload_infold_threshold: int = 2 * 1024 * 1024
    fold_threshold: int = 1024 * 1024
    # Precision of the infold one-hot payload-selection matmul:
    # "highest" (true fp32, so payload values are exact copies) or
    # "bf16" (one bf16 pass; matched coords are query-tile-centered
    # before selection so quantization is tile-local). "auto" = highest.
    payload_prec: str = "auto"
    block_auto_threshold: int = 8192
    # Tile partitioner: "kd" (median-cut, compact boxes — 0.01% NN miss
    # at the defaults vs ~5% for Morton ranges on uniform volumes) or
    # "morton" (cheaper build).
    tile_index: str = "kd"
    # Partitioner for the SOURCE (query) tiling only; "" = tile_index.
    # A Morton source build is one global sort instead of ~7, but its
    # sprawling query boxes dilute the shared top-k tile list and cost
    # recall (GT still recovered, rmse inflated by miss distances).
    src_tile_index: str = ""
    tile_q: int = 2048
    tile_r: int = 4096

    def __post_init__(self):
        if self.objective not in OBJECTIVES:
            raise ValueError(f"objective must be one of {OBJECTIVES}")
        if self.nn_method not in ("auto", "brute", "block"):
            raise ValueError("nn_method must be auto|brute|block")
        if self.tile_index not in ("kd", "morton"):
            raise ValueError("tile_index must be kd|morton")
        if self.src_tile_index not in ("", "kd", "morton"):
            raise ValueError("src_tile_index must be ''|kd|morton")
        if self.payload_mode not in PAYLOAD_MODES:
            raise ValueError(
                "payload_mode must be " + "|".join(PAYLOAD_MODES)
            )
        if self.payload_prec not in ("auto", "highest", "bf16"):
            raise ValueError("payload_prec must be auto|highest|bf16")
        if self.score_precision not in ("auto", "highest", "high", "bf16"):
            raise ValueError(
                "score_precision must be auto|highest|high|bf16"
            )
        if self.refine_stride < 0:
            raise ValueError("refine_stride must be >= 0 (0 = auto)")
        if self.refine_full_iters < 1:
            raise ValueError("refine_full_iters must be >= 1")
        if bool(self.feat_nn) != (self.feat_nn_weight > 0):
            raise ValueError(
                "feature matching needs BOTH feat_nn (channel name) and "
                "feat_nn_weight > 0 — setting one without the other is "
                "almost certainly a mistake"
            )

    def tile_builder(self, kind: str = ""):
        from icpx.kernels.blocknn import build_kd_index, build_tile_index

        k = kind or self.tile_index
        return build_kd_index if k == "kd" else build_tile_index

    def resolve_nn(self, tgt_capacity: int) -> str:
        if self.nn_method != "auto":
            return self.nn_method
        return (
            "block" if tgt_capacity >= self.block_auto_threshold else "brute"
        )

    def resolve_score_prec(self) -> str:
        if self.score_precision != "auto":
            return self.score_precision
        return "highest"

    def resolve_q_tile(self, capacity: int) -> int:
        if (
            self.block_q_tile_large > 0
            and capacity >= self.payload_infold_threshold
        ):
            return self.block_q_tile_large
        return self.block_q_tile

    def resolve_payload(self, tgt_capacity: int) -> str:
        # The fused fold kernel compiles only for NVIDIA GPUs; elsewhere
        # (the CPU test backend) auto keeps the XLA paths.
        if self.payload_mode != "auto":
            return self.payload_mode
        import jax

        if (
            jax.default_backend() == "gpu"
            and tgt_capacity >= self.fold_threshold
        ):
            return "fold"
        if tgt_capacity >= self.payload_infold_threshold:
            return "infold"
        return "gather"

    def resolve_refine_stride(
        self, src_capacity: int, tgt_capacity: int
    ) -> int:
        # Auto = 1 (off) at every size; explicit strides are honored.
        if self.refine_stride:
            return self.refine_stride
        return 1

    def resolve_payload_prec(self) -> str:
        if self.payload_prec != "auto":
            return self.payload_prec
        return "highest"


def result_struct() -> "ICPResult":
    """Shape-only ICPResult skeleton (for shard_map out_specs trees)."""
    return ICPResult(
        transform=SE3(R=0, t=0),
        iters=0,
        converged=0,
        diff_history=0,
        rmse_history=0,
        final_rmse=0,
        inlier_count=0,
    )


@struct.dataclass
class ICPResult:
    transform: SE3  # accumulated src -> tgt
    iters: jax.Array  # number of iterations actually applied
    converged: jax.Array  # bool
    diff_history: jax.Array  # (max_iters,) evalDiff-style sums (post-update)
    rmse_history: jax.Array  # (max_iters,) inlier euclidean RMSE
    final_rmse: jax.Array
    inlier_count: jax.Array


def register(
    src: PointCloud,
    tgt: PointCloud,
    config: ICPConfig = ICPConfig(),
    init: Optional[SE3] = None,
    *,
    src_weight: Optional[jax.Array] = None,
) -> ICPResult:
    """Register src onto tgt (returns transform with tgt ~= T(src)).

    Estimates normals (k = config.k_normals) for either cloud that lacks
    them when the objective needs normals.

    `src_weight` (N,) optionally scales each source point's vote in the
    solve (sensor confidence / reflectance-derived priors, e.g. a
    payload column via `src.feat("weight")`).

    Both clouds are internally shifted by the target centroid before
    solving and the shift is composed back into the returned transform:
    fp32 squared-distance expansions lose ~half their digits at
    coordinate magnitudes like UTM eastings (1e5-1e7), and the block-NN
    validity heuristics assume post-centering extents << 1e6.
    """
    if init is None:
        init = SE3.identity()

    # Auto-centering FIRST: normal/covariance estimation and NN scoring
    # use ||a||^2+||b||^2-2ab expansions whose fp32 error scales with the
    # squared coordinate magnitude — at offsets ~1e3+ it drowns real
    # point spacings. Solve in target-centroid coordinates, compose back.
    center = tgt.centroid()
    shift = SE3.identity().replace(t=-center)
    unshift = SE3.identity().replace(t=center)
    src = src.with_xyz(src.xyz - center[None, :])
    tgt = tgt.with_xyz(tgt.xyz - center[None, :])
    init_c = shift @ init @ unshift

    needs_normals = config.objective in ("symmetric", "p2plane")
    block = config.resolve_nn(tgt.capacity) == "block"
    if config.feat_nn and config.feat_nn_weight > 0 and not block:
        raise ValueError(
            "feature-augmented matching (feat_nn) needs the block NN "
            "path; set nn_method='block'"
        )
    normals_for = []
    if needs_normals and config.objective == "symmetric" and src.normals is None:
        if block:
            normals_for.append("src")  # estimated in-jit off the shared index
        else:
            src = estimate_normals(src, k=config.k_normals)
    if needs_normals and tgt.normals is None:
        if block:
            normals_for.append("tgt")
        else:
            tgt = estimate_normals(tgt, k=config.k_normals)
    if config.objective == "gicp":
        from icpx.kernels.normals import estimate_covariances

        if src.covs is None:
            src = estimate_covariances(src, k=max(config.k_normals, 15))
        if tgt.covs is None:
            tgt = estimate_covariances(tgt, k=max(config.k_normals, 15))

    res = _register_jit(
        src, tgt, init_c, config, normals_for=tuple(normals_for),
        src_w=src_weight,
    )
    return res.replace(transform=unshift @ res.transform @ shift)


def _icp_scan(
    config: ICPConfig,
    src_xyz: jax.Array,
    src_mask: jax.Array,
    src_n: jax.Array,
    init: SE3,
    nn_fn,
    reduce=identity_reduce,
    aux_rot=None,
    prev_rmse0=None,
    src_w=None,
) -> ICPResult:
    """The ICP iteration core shared by every execution mode.

    `nn_fn(p) -> (q, aux_q, dist)` produces matched target rows for the
    transformed source; `src_n`/`aux_q` are the per-objective auxiliary
    channel (normals (N,3), or flattened covariances (N,9) for GICP).
    `aux_rot(T, aux)` moves the source aux into the current frame
    (default: vector rotation). `reduce` sums pytrees across a points
    partition (identity on a single device, psum when sharded).
    `src_w` (N,) optionally scales each source point's vote in the solve
    (sensor confidence, user priors) on top of the validity/robust
    weights; it does not affect the convergence statistics.

    A `lax.while_loop` so convergence ACTUALLY stops the work (the
    reference's `while diff > threshold` loop, `myicp.cpp:123`) — the
    convergence predicate is reduce()'d, so every shard exits together.
    """
    if aux_rot is None:
        aux_rot = lambda T, aux: T.rotate(aux)

    def cond(state):
        it, _, _, stop, _, *_ = state
        return (it < config.max_iters) & ~stop

    def body(state):
        it, transform, prev_rmse, stop, failed, diffs, rmses, counts = state

        p = transform.apply(src_xyz)
        n_p = aux_rot(transform, src_n)
        q, n_q, dist = nn_fn(p)

        w = correspondence_weights(
            config, p, n_p, q, n_q, dist, src_mask, reduce
        )
        if src_w is not None:
            w = w * src_w
        incre = estimate_increment(config, p, q, n_p, n_q, w, reduce)
        new_transform = incre @ transform

        # Post-update diagnostics against the same correspondences.
        stats = step_stats(
            config, new_transform.apply(src_xyz), q, dist, src_mask, reduce
        )
        # Degraded-mode guard (SURVEY §5.3): a non-finite or correspondence-
        # starved update is rejected, keeping the previous transform. The
        # loop stops AND reports failure (converged stays False).
        from icpx.distributed.fault import degenerate_solve_guard

        new_transform, ok = degenerate_solve_guard(
            new_transform, stats, transform
        )
        diff, rmse, count = stats.diff, stats.rmse, stats.inlier_count
        diff = jnp.where(ok, diff, jnp.float32(jnp.inf))
        rmse = jnp.where(ok, rmse, prev_rmse)

        now_stop = (~ok) | (diff < config.diff_threshold) | (
            (config.rmse_change_tol > 0)
            & (jnp.abs(prev_rmse - rmse) < config.rmse_change_tol)
        )
        if config.transform_tol > 0:
            cos_a = jnp.clip(
                (jnp.trace(incre.R) - 1.0) * 0.5, -1.0, 1.0
            )
            inc_mag = jnp.arccos(cos_a) + jnp.linalg.norm(incre.t)
            now_stop = now_stop | (inc_mag < config.transform_tol)
        return (
            it + 1,
            new_transform,
            rmse,
            now_stop,
            failed | ~ok,
            diffs.at[it].set(diff),
            rmses.at[it].set(rmse),
            counts.at[it].set(count),
        )

    nan_hist = jnp.full((config.max_iters,), jnp.nan, jnp.float32)
    # prev_rmse0 seeds the convergence state (e.g. with the coarse
    # phase's final RMSE, so an already-converged refine phase can stop
    # after ONE iteration instead of needing two to see a stable RMSE).
    state0 = (
        jnp.int32(0),
        init,
        jnp.float32(jnp.inf) if prev_rmse0 is None else prev_rmse0,
        jnp.array(False),
        jnp.array(False),
        nan_hist,
        nan_hist,
        jnp.zeros((config.max_iters,), jnp.float32),
    )
    (it, transform, rmse, stop, failed, diffs, rmses, counts) = (
        jax.lax.while_loop(cond, body, state0)
    )
    last = jnp.maximum(it - 1, 0)
    return ICPResult(
        transform=transform,
        iters=it,
        converged=stop & ~failed,
        diff_history=diffs,
        rmse_history=rmses,
        final_rmse=rmse,
        inlier_count=counts[last].astype(jnp.int32),
    )


def gicp_cov_rot(T, aux):
    """Rotate flattened (N, 9) GICP covariances into T's frame: R C R^T.
    The GICP auxiliary-channel rotator shared by every execution mode."""
    C = aux.reshape(-1, 3, 3)
    return jnp.einsum("ij,njk,lk->nil", T.R, C, T.R).reshape(-1, 9)


def _index_normals(index, k_normals, k_tiles=4, prec="highest"):
    """PCA normals for an index's own tiles (self-query radius moments):
    (normals, valid_count) in SORTED tile order. The shared-index fast
    path — one KD build serves NN search and normal estimation
    (`pcl::NormalEstimation` equivalent, `myicp.cpp:152-172`)."""
    import numpy as np

    from icpx.kernels.blocknn import block_radius_moments
    from icpx.kernels.eigh3 import smallest_eigenvector_3x3
    from icpx.kernels.voxel import auto_cell_size

    flat = index.tiles.reshape(-1, 3)
    valid = index.order >= 0
    scale = 3.0 * float(np.sqrt(max(k_normals, 1) / 10.0))
    radius = auto_cell_size(flat, valid, scale=scale)
    cnt, _, cov = block_radius_moments(
        index.tiles, index, radius, k_tiles=k_tiles, prec=prec
    )
    normal, _ = smallest_eigenvector_3x3(cov)
    # orient toward the (centered-frame) viewpoint at the origin
    flip = jnp.sum(normal * (-flat), axis=-1) < 0.0
    normal = jnp.where(flip[:, None], -normal, normal)
    ok = (cnt >= 3.0) & valid
    return jnp.where(ok[:, None], normal, 0.0)


def _effective_payload_mode(
    config: "ICPConfig",
    tgt_capacity: int,
    *,
    use_feat: bool,
    will_freeze: bool,
) -> str:
    """The payload-delivery mode a block registration will ACTUALLY run.

    The fused fold kernel scores 3D coordinates only and needs a frozen
    candidate list; feature-augmented and no-frozen-candidate
    registrations resolve to the table-size-independent infold path at
    large sizes (the gather otherwise) instead."""
    pmode = config.resolve_payload(tgt_capacity)
    if pmode == "fold" and (use_feat or not will_freeze):
        pmode = (
            "infold"
            if tgt_capacity >= config.payload_infold_threshold
            else "gather"
        )
    return pmode


@partial(jax.jit, static_argnames=("config", "normals_for"))
def _register_jit(
    src: PointCloud,
    tgt: PointCloud,
    init: SE3,
    config: ICPConfig,
    normals_for: tuple = (),
    src_w: Optional[jax.Array] = None,
) -> ICPResult:
    if config.objective == "gicp":
        if src.covs is None or tgt.covs is None:
            raise ValueError(
                "gicp needs covariances (estimate_covariances first)"
            )
        n = src.capacity
        src_n = src.covs.reshape(n, 9)
        tgt_n = tgt.covs.reshape(tgt.capacity, 9)
        aux_rot = gicp_cov_rot
    else:
        src_n = (
            src.normals
            if src.normals is not None
            else jnp.zeros_like(src.xyz)
        )
        tgt_n = (
            tgt.normals
            if tgt.normals is not None
            else jnp.zeros_like(tgt.xyz)
        )
        aux_rot = None

    method = config.resolve_nn(tgt.capacity)
    if normals_for and method != "block":
        raise ValueError(
            "normals_for requires the block NN path (estimate normals "
            "up front for brute-force registration)"
        )
    if method == "block":
        from icpx.cloud import PAD_COORD
        from icpx.kernels.blocknn import block_nn

        # Sort the source spatially once (rigid motion preserves coherence;
        # point order is irrelevant to the solve). Sentinel-fill invalid.
        builder = config.tile_builder()
        from icpx.kernels.blocknn import _SUPER_G, trim_index

        q_tile = config.resolve_q_tile(src.capacity)
        src_order_idx = trim_index(
            config.tile_builder(config.src_tile_index)(
                src.xyz, src.mask, tile_size=q_tile
            ),
            src.capacity,
            multiple=4,  # coarse phase needs tq % 4 == 0
        )
        order = src_order_idx.order
        valid = order >= 0
        safe = jnp.maximum(order, 0)
        # the builder already produced the sorted, sentinel-filled coords
        # (masked-out rows got PAD_COORD and order -1 in the build) — no
        # 1M-row re-gather needed
        src_xyz = src_order_idx.tiles.reshape(-1, 3)
        src_mask = valid
        if src_w is not None:
            src_w = jnp.where(valid, src_w[safe], 0.0)
        use_feat = bool(config.feat_nn) and config.feat_nn_weight > 0
        if use_feat:
            from icpx.kernels.blocknn import tile_payload as _tp

            src_f = jnp.where(valid, src.feat(config.feat_nn)[safe], 0.0)
            tgt_f_tiles = None  # built after tgt_index below
        tgt_index = trim_index(
            builder(tgt.xyz, tgt.mask, tile_size=config.block_tile),
            tgt.capacity,
            multiple=_SUPER_G,  # hierarchical ranking needs T % 64 == 0
        )
        if use_feat:
            tgt_f_tiles = _tp(
                tgt_index, tgt.feat(config.feat_nn)[:, None]
            )[..., 0]

        # In-jit normal estimation off the SAME indexes (one KD build per
        # cloud total instead of a separate estimate_normals build).
        if "src" in normals_for:
            # self-query at the FINE tiling costs a (T, T) candidate
            # ranking; coarsen to parent tiles first (same flat point
            # order, so the result aligns with src_xyz)
            from icpx.kernels.blocknn import coarsen_index

            s_idx = src_order_idx
            f = config.block_tile // q_tile
            if f > 1 and s_idx.n_tiles % f == 0:
                s_idx = coarsen_index(s_idx, f)
            # normals stay at full score precision: normal noise biases
            # the symmetric solve SYSTEMATICALLY, unlike NN near-tie swaps
            src_n_s = _index_normals(s_idx, config.k_normals, k_tiles=2)
        else:
            src_n_s = jnp.where(valid[:, None], src_n[safe], 0.0)
        # Target payload in SORTED tile layout: NN returns sorted flat
        # positions (return_pos=True) and the q / n_q gathers become
        # spatially COHERENT (queries are in KD order, their NNs are in
        # target KD order — neighbors hit neighboring rows), instead of
        # random-row gathers through the original (arbitrary) point
        # order. In-jit target normals come out of _index_normals already
        # sorted, with no unsort scatter.
        tgt_sorted = tgt_index.tiles.reshape(-1, 3)
        if "tgt" in normals_for:
            tgt_n_sorted = _index_normals(
                tgt_index, config.k_normals, k_tiles=2
            )
        else:
            from icpx.kernels.blocknn import tile_payload

            tgt_n_sorted = tile_payload(tgt_index, tgt_n).reshape(
                -1, tgt_n.shape[1]
            )
        # one fused (N, 3+D) payload table: a single row gather per
        # iteration instead of two (q then n_q)
        tgt_pl = jnp.concatenate([tgt_sorted, tgt_n_sorted], axis=1)

        sq = q_tile
        tq = src_xyz.shape[0] // sq
        # Will the refine phases have a FROZEN candidate list? The fused
        # fold kernel only engages with one (see _effective_payload_mode).
        coarse = (
            config.coarse_iters > 0
            and config.coarse_stride > 1
            and tq % 4 == 0
            and tq >= 8
            and (4 * sq) % config.coarse_stride == 0
        )
        will_freeze = coarse and config.freeze_refine_candidates
        pmode = _effective_payload_mode(
            config, tgt.capacity, use_feat=use_feat, will_freeze=will_freeze
        )
        if pmode in ("infold", "fold"):
            from icpx.kernels.blocknn import block_nn_payload

            tgt_pl_tiles = tgt_pl.reshape(
                tgt_index.n_tiles, tgt_index.tile_size, tgt_pl.shape[1]
            )
        if pmode == "fold":
            from icpx.kernels import fold_triton

            # built once, outside the ICP while loop
            fold_tabs = fold_triton.fold_tables(tgt_index, tgt_pl_tiles)

        def make_nn(n_tiles, tile_rows, k_tiles, cand=None, qfeat=None):
            if pmode == "fold" and cand is not None:

                def nn_fn_fold(p):
                    d2, pl = fold_triton.fold_nn(
                        p.reshape(n_tiles, tile_rows, 3), cand, fold_tabs
                    )
                    return pl[:, :3], pl[:, 3:], jnp.sqrt(d2)

                return nn_fn_fold

            def nn_fn(p):
                ptiles = p.reshape(n_tiles, tile_rows, 3)
                qf = (
                    qfeat.reshape(n_tiles, tile_rows)
                    if qfeat is not None
                    else None
                )
                if pmode != "gather":
                    # phases without frozen candidates under "fold" also
                    # take the XLA infold path
                    d2, pl = block_nn_payload(
                        ptiles, tgt_index, tgt_pl_tiles,
                        k_tiles=k_tiles, cand_tiles=cand,
                        query_feat=qf,
                        feat_tiles=tgt_f_tiles if qf is not None else None,
                        feat_weight=config.feat_nn_weight,
                        score_prec=config.resolve_score_prec(),
                        payload_prec=config.resolve_payload_prec(),
                        payload_xyz=3,
                    )
                    # miss/pad rows: d2=inf with zero payload — finite
                    # coords, zero weight downstream, no NaNs
                    return pl[:, :3], pl[:, 3:], jnp.sqrt(d2)
                d2, pos = block_nn(
                    ptiles, tgt_index, k_tiles=k_tiles,
                    return_pos=True, cand_tiles=cand,
                    query_feat=qf,
                    feat_tiles=tgt_f_tiles if qf is not None else None,
                    feat_weight=config.feat_nn_weight,
                    score_prec=config.resolve_score_prec(),
                )
                # pad/miss rows carry d2=inf (gated by the validity mask
                # downstream); their PAD_COORD coords are finite, so
                # zero-weight rows cannot produce NaNs in the solve.
                pl = tgt_pl[pos]
                return pl[:, :3], pl[:, 3:], jnp.sqrt(d2)

            return nn_fn

        # Coarse phase: stride-subsampled rows of 4 merged sibling KD
        # tiles (the parent node's compact box) — a spatially uniform
        # ~1/stride subsample reusing full-res normals; NN cost drops
        # ~4x while the motion is still large.
        stride = config.coarse_stride
        # `coarse` was decided above (it feeds the payload-mode carve-out)
        if coarse:
            cs = 4 * sq // stride
            xyz_c = src_xyz.reshape(tq // 4, 4 * sq, 3)[:, ::stride]
            dn = src_n_s.shape[1]  # 3 (normals) or 9 (gicp covariances)
            n_c = src_n_s.reshape(tq // 4, 4 * sq, dn)[:, ::stride]
            m_c = src_mask.reshape(tq // 4, 4 * sq)[:, ::stride]
            f_c = (
                src_f.reshape(tq // 4, 4 * sq)[:, ::stride].reshape(-1)
                if use_feat
                else None
            )
            w_c = (
                src_w.reshape(tq // 4, 4 * sq)[:, ::stride].reshape(-1)
                if src_w is not None
                else None
            )
            cfg_c = dataclasses.replace(
                config, max_iters=config.coarse_iters, diff_threshold=0.0
            )
            res_c = _icp_scan(
                cfg_c,
                xyz_c.reshape(-1, 3),
                m_c.reshape(-1),
                n_c.reshape(-1, dn),
                init,
                make_nn(tq // 4, cs, config.block_k, qfeat=f_c),
                aux_rot=aux_rot,
                src_w=w_c,
            )
            init = res_c.transform
            k_ref = (
                config.block_k_refine
                if config.block_k_refine > 0
                else config.block_k
            )
            prev_rmse0 = res_c.final_rmse
        else:
            k_ref = config.block_k
            prev_rmse0 = None

        # Freeze refine-phase candidate tiles at the coarse-aligned
        # positions: after the coarse phase the residual motion is well
        # under a tile extent, so the per-iteration candidate ranking is
        # paid once instead of per iteration. Only safe when a coarse phase ran (refine starts
        # near-aligned).
        cand_ref = None
        if will_freeze:
            from icpx.kernels.blocknn import _candidate_tiles

            p0 = init.apply(src_xyz).reshape(tq, sq, 3)
            cand_ref, _ = _candidate_tiles(p0, tgt_index, k_ref)

        # Multi-resolution refine: bulk iterations on every
        # refine_stride-th row WITHIN each query tile (same tiles, same
        # boxes — the frozen candidate list is reused verbatim), full
        # resolution only for the last `refine_full_iters`. The pose from
        # a 1/stride spatially-uniform subsample is statistically within
        # noise of the full solve; the full-res tail polishes it and
        # produces full-res convergence statistics (config docstring).
        stride_r = config.resolve_refine_stride(src.capacity, tgt.capacity)
        mid = (
            stride_r > 1
            and sq % stride_r == 0
            and sq // stride_r >= 8
            and config.max_iters > config.refine_full_iters
        )
        mid_iters = jnp.int32(0)
        orig_config = config
        if mid:
            sq_m = sq // stride_r
            dn = src_n_s.shape[1]

            def substride(arr, d=None):
                a = arr.reshape(tq, sq, d) if d else arr.reshape(tq, sq)
                return a[:, ::stride_r].reshape(-1, d) if d else (
                    a[:, ::stride_r].reshape(-1)
                )

            # The mid phase gets max_iters - refine_full_iters so the
            # documented max_iters cap bounds TOTAL refine work (mid +
            # full-res tail), not each phase separately.
            cfg_m = dataclasses.replace(
                config,
                max_iters=config.max_iters - config.refine_full_iters,
                diff_threshold=config.diff_threshold / stride_r,
            )
            res_m = _icp_scan(
                cfg_m,
                substride(src_xyz, 3),
                substride(src_mask),
                substride(src_n_s, dn),
                init,
                make_nn(
                    tq, sq_m, k_ref, cand=cand_ref,
                    qfeat=substride(src_f) if use_feat else None,
                ),
                aux_rot=aux_rot,
                prev_rmse0=prev_rmse0,
                src_w=substride(src_w) if src_w is not None else None,
            )
            init = res_m.transform
            prev_rmse0 = res_m.final_rmse
            mid_iters = res_m.iters
            config = dataclasses.replace(
                config, max_iters=config.refine_full_iters
            )

        res = _icp_scan(
            config, src_xyz, src_mask, src_n_s, init,
            make_nn(
                tq, sq, k_ref, cand=cand_ref,
                qfeat=src_f if use_feat else None,
            ),
            aux_rot=aux_rot,
            prev_rmse0=prev_rmse0,
            src_w=src_w,
        )
        if mid:
            # Merge the mid-phase histories ahead of the full-res tail's so
            # diff_history/rmse_history cover ALL refine iterations (sized
            # orig max_iters; entries past the work done stay NaN). The
            # coarse phase's history stays excluded by design: it runs on a
            # different (strided-parent-tile) resolution whose diff sums
            # are not comparable. A mid phase that already met its stop is
            # carried into `converged` — the fixed-budget tail is a polish
            # and may legitimately not re-trigger its own stop.
            m_total = orig_config.max_iters
            i_all = jnp.arange(m_total)
            from_mid = i_all < mid_iters
            mid_idx = jnp.clip(i_all, 0, cfg_m.max_iters - 1)
            tail_idx = jnp.clip(
                i_all - mid_iters, 0, orig_config.refine_full_iters - 1
            )
            in_range = i_all < (mid_iters + res.iters)

            def merge(mid_h, tail_h, fill):
                out = jnp.where(
                    from_mid, mid_h[mid_idx], tail_h[tail_idx]
                )
                return jnp.where(in_range, out, fill)

            res = res.replace(
                iters=res.iters + mid_iters,
                converged=res.converged | res_m.converged,
                diff_history=merge(
                    res_m.diff_history, res.diff_history, jnp.nan
                ),
                rmse_history=merge(
                    res_m.rmse_history, res.rmse_history, jnp.nan
                ),
            )
        if coarse:
            res = res.replace(iters=res.iters + res_c.iters)
        return res

    def nn_fn(p):
        d2, idx = nearest_neighbor(
            p,
            tgt.xyz,
            ref_mask=tgt.mask,
            tile_q=config.tile_q,
            tile_r=config.tile_r,
        )
        return tgt.xyz[idx], tgt_n[idx], jnp.sqrt(d2)

    return _icp_scan(
        config, src.xyz, src.mask, src_n, init, nn_fn, aux_rot=aux_rot,
        src_w=src_w,
    )


@partial(jax.jit, static_argnames=("config",))
def register_batch(
    src_xyz: jax.Array,  # (B, N, 3)
    src_mask: jax.Array,  # (B, N)
    src_normals: jax.Array,  # (B, N, 3)
    tgt_xyz: jax.Array,
    tgt_mask: jax.Array,
    tgt_normals: jax.Array,
    config: ICPConfig = ICPConfig(),
    init: Optional[SE3] = None,  # batched (B,) initial guesses
) -> ICPResult:
    """Register B independent pairs in one vmapped executable.

    The single-chip DP-over-pairs throughput path (SURVEY P1): batching
    keeps the device fed when individual pairs are small (odometry-scale
    scans). Brute-force NN per pair; normals must be precomputed. For
    multi-device DP use `distributed.sharded_register_pairs`.

    Like `register`, each pair is solved in target-centroid coordinates
    (fp32 squared-distance expansions lose precision at large coordinate
    magnitudes) and the shift is composed back into the returned transform.
    """

    if init is None:
        b = src_xyz.shape[0]
        eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (b, 3, 3))
        init = SE3(R=eye, t=jnp.zeros((b, 3), jnp.float32))

    def one(sx, sm, sn, tx, tm, tn, iR, it):
        denom = jnp.maximum(tm.sum(), 1).astype(jnp.float32)
        center = jnp.where(tm[:, None], tx, 0.0).sum(0) / denom
        sx = jnp.where(sm[:, None], sx - center[None, :], sx)
        tx = jnp.where(tm[:, None], tx - center[None, :], tx)
        shift = SE3.identity().replace(t=-center)
        unshift = SE3.identity().replace(t=center)
        init_c = shift @ SE3(R=iR, t=it) @ unshift

        def nn_fn(p):
            d2, idx = nearest_neighbor(
                p, tx, ref_mask=tm, tile_q=config.tile_q, tile_r=config.tile_r
            )
            return tx[idx], tn[idx], jnp.sqrt(d2)

        res = _icp_scan(config, sx, sm, sn, init_c, nn_fn)
        return res.replace(transform=unshift @ res.transform @ shift)

    return jax.vmap(one)(
        src_xyz, src_mask, src_normals, tgt_xyz, tgt_mask, tgt_normals,
        init.R, init.t,
    )


@partial(jax.jit, static_argnames=("config",))
def register_batch_block(
    src_xyz: jax.Array,  # (B, N, 3)
    src_mask: jax.Array,  # (B, N)
    tgt_xyz: jax.Array,  # (B, N, 3)
    tgt_mask: jax.Array,  # (B, N)
    config: ICPConfig = ICPConfig(),
    init: Optional[SE3] = None,  # batched (B,) initial guesses
) -> ICPResult:
    """Register B independent pairs through the FULL block-NN pipeline in
    one vmapped executable (the small-pair throughput path).

    Where `register_batch` vmaps the brute O(N^2) loop (right for
    odometry-scale scans), this vmaps the complete large-cloud machinery
    — per-pair KD index builds, in-jit normals off the shared indexes,
    coarse/refine phases, frozen candidates — so a batch of B x 65k
    pairs costs what one (B*65k)-point registration costs instead of B
    fixed overheads: the batch dimension rides every sort/einsum/gather
    as a leading axis and the device sees large ops + ONE dispatch.
    Normals are always estimated in-jit (pass clouds, not normals).

    Solves in per-pair target-centroid coordinates like `register`
    (composed back into the returned transforms).
    """
    b = src_xyz.shape[0]
    if config.resolve_nn(tgt_xyz.shape[1]) != "block":
        raise ValueError(
            "register_batch_block needs the block NN path (clouds above "
            "block_auto_threshold or nn_method='block'); use "
            "register_batch for brute-NN scan-scale pairs"
        )
    if init is None:
        eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (b, 3, 3))
        init = SE3(R=eye, t=jnp.zeros((b, 3), jnp.float32))

    def one(sx, sm, tx, tm, iR, it):
        denom = jnp.maximum(tm.sum(), 1).astype(jnp.float32)
        center = jnp.where(tm[:, None], tx, 0.0).sum(0) / denom
        sx = jnp.where(sm[:, None], sx - center[None, :], sx)
        tx = jnp.where(tm[:, None], tx - center[None, :], tx)
        shift = SE3.identity().replace(t=-center)
        unshift = SE3.identity().replace(t=center)
        init_c = shift @ SE3(R=iR, t=it) @ unshift
        res = _register_jit(
            PointCloud(xyz=sx, mask=sm),
            PointCloud(xyz=tx, mask=tm),
            init_c,
            config,
            normals_for=("src", "tgt"),
        )
        return res.replace(transform=unshift @ res.transform @ shift)

    return jax.vmap(one)(
        src_xyz, src_mask, tgt_xyz, tgt_mask, init.R, init.t
    )


def register_xyz(
    src_xyz,
    tgt_xyz,
    config: ICPConfig = ICPConfig(),
    init: Optional[SE3] = None,
) -> ICPResult:
    """Convenience: register raw (N, 3) arrays (padding handled here)."""
    return register(
        PointCloud.create(src_xyz), PointCloud.create(tgt_xyz), config, init
    )


def format_trace(result: ICPResult) -> str:
    """Reference-style per-iteration trace (`myicp.cpp:125-126`)."""
    import numpy as np

    lines = []
    diffs = np.asarray(result.diff_history)
    for i, d in enumerate(diffs):
        if np.isnan(d):
            break
        lines.append(f"iters#{i + 1} / diff: {d:.6g}")
    lines.append(
        f"converged={bool(result.converged)} iters={int(result.iters)} "
        f"rmse={float(result.final_rmse):.6g}"
    )
    return "\n".join(lines)
