"""Sharded ICP over a device mesh (SURVEY §2.3 P1/P2/P4).

Execution modes, all one `shard_map` around the full jitted ICP scan (no
host round-trips between iterations):

  * `sharded_register` — one pair, source points sharded over the
    ``points`` axis. Target replicated (default: fastest when it fits per
    device) or sharded with ring NN passes (`ring=True`: target shards
    rotate over `ppermute`, ring-attention style). Per-iteration
    cross-device traffic: the 6x6 normal equations + centroid/convergence
    scalars (psum), plus the ring rotation when enabled.
  * `sharded_register_pairs` — a batch of pairs sharded over ``pairs``
    (DP) with each pair's points optionally sharded over ``points``.

The serial analogue in the reference is the whole of `RegisterSymm`
(`myicp.cpp:100-150`), which holds every point in one Eigen matrix.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from icpx.cloud import PointCloud
from icpx.geometry.se3 import SE3
from icpx.kernels.knn import nearest_neighbor
from icpx.kernels.normals import estimate_normals
from icpx.registration.icp import ICPConfig, ICPResult, _icp_scan, result_struct
from icpx.distributed.ring import ring_block_nn, ring_nearest_neighbor


def sharded_register(
    src: PointCloud,
    tgt: PointCloud,
    config: ICPConfig,
    mesh: Mesh,
    init: Optional[SE3] = None,
    *,
    points_axis: str = "points",
    ring: bool = False,
) -> ICPResult:
    """Single-pair ICP with the source points sharded across `mesh`.

    Capacities must be divisible by the points-axis size (pad clouds with
    `PointCloud.pad_to`). Normals (or GICP covariances) are estimated up
    front (replicated) when missing. With `ring=True` the target is
    sharded too and NN runs as ring passes — use when the target cloud
    cannot be replicated per device.

    `config.nn_method` applies per shard: "block" sorts each local source
    shard through the tile builder once and answers NN via the tile index
    (per-shard index over the local target shard when `ring=True`, one
    replicated index otherwise) — the O(N*K*S) scalable path, usable at
    1M+ points/device where brute O(N^2/shard) is not.
    """
    use_feat = bool(config.feat_nn) and config.feat_nn_weight > 0
    if use_feat and config.resolve_nn(tgt.capacity) != "block":
        raise ValueError(
            "feature-augmented matching (feat_nn) needs the block NN "
            "path (same constraint as single-device register)"
        )
    n_shards = mesh.shape[points_axis]
    if src.capacity % n_shards or tgt.capacity % n_shards:
        raise ValueError(
            f"cloud capacities ({src.capacity}, {tgt.capacity}) must be "
            f"divisible by the '{points_axis}' axis size {n_shards}"
        )
    # Target-centroid auto-centering, conjugated back into the returned
    # transform — same precision discipline as register() (fp32
    # squared-distance expansions lose ~half their digits at UTM-scale
    # coordinate magnitudes).
    center = tgt.centroid()
    shift = SE3.identity().replace(t=-center)
    unshift = SE3.identity().replace(t=center)
    src = src.with_xyz(src.xyz - center[None, :])
    tgt = tgt.with_xyz(tgt.xyz - center[None, :])
    if init is not None:
        init = shift @ init @ unshift
    if config.objective == "gicp":
        from icpx.kernels.normals import estimate_covariances

        if src.covs is None:
            src = estimate_covariances(src, k=max(config.k_normals, 15))
        if tgt.covs is None:
            tgt = estimate_covariances(tgt, k=max(config.k_normals, 15))
        src_n = src.covs.reshape(src.capacity, 9)
        tgt_n = tgt.covs.reshape(tgt.capacity, 9)

        def aux_rot(T, aux):
            C = aux.reshape(-1, 3, 3)
            return jnp.einsum(
                "ij,njk,lk->nil", T.R, C, T.R
            ).reshape(-1, 9)

    else:
        needs_normals = config.objective in ("symmetric", "p2plane")
        if (
            needs_normals
            and config.objective == "symmetric"
            and src.normals is None
        ):
            src = estimate_normals(src, k=config.k_normals)
        if needs_normals and tgt.normals is None:
            tgt = estimate_normals(tgt, k=config.k_normals)
        src_n = (
            src.normals if src.normals is not None else jnp.zeros_like(src.xyz)
        )
        tgt_n = (
            tgt.normals if tgt.normals is not None else jnp.zeros_like(tgt.xyz)
        )
        aux_rot = None
    if init is None:
        init = SE3.identity()
    nn_method = config.resolve_nn(tgt.capacity)
    if use_feat:
        src_f = src.feat(config.feat_nn)
        tgt_f = tgt.feat(config.feat_nn)
    else:  # dummy lanes keep the shard_map signature static
        src_f = jnp.zeros((src.capacity,), jnp.float32)
        tgt_f = jnp.zeros((tgt.capacity,), jnp.float32)

    shard1 = P(points_axis)
    shard2 = P(points_axis, None)
    repl1, repl2 = P(), P(None, None)
    reduce = partial(lax.psum, axis_name=points_axis)

    if ring:
        tgt_spec1, tgt_spec2 = shard1, shard2
    else:
        tgt_spec1, tgt_spec2 = repl1, repl2

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            shard2,  # src xyz
            shard1,  # src mask
            shard2,  # src normals
            shard1,  # src feature channel (dummy when feat_nn off)
            tgt_spec2,  # tgt xyz
            tgt_spec1,  # tgt mask
            tgt_spec2,  # tgt normals
            tgt_spec1,  # tgt feature channel
            P(),  # init R  (replicated; SE3 leaves passed separately)
            P(),  # init t
        ),
        out_specs=jax.tree_util.tree_map(lambda _: P(), result_struct()),
        check_vma=False,
    )
    def run(s_xyz, s_mask, s_n, s_f, t_xyz, t_mask, t_n, t_f, init_R, init_t):
        if nn_method == "block":
            # Per-shard spatial sort of the local source (point order is
            # irrelevant to the psum'd normal equations) + tile-index NN:
            # O(N*K*S) per shard instead of brute O(N * N_tgt/shard).
            from icpx.kernels.blocknn import (
                _SUPER_G,
                block_nn,
                tile_payload,
                trim_index,
            )

            builder = config.tile_builder()
            local_cap = s_xyz.shape[0]
            s_idx = trim_index(
                builder(
                    s_xyz, s_mask,
                    tile_size=config.resolve_q_tile(local_cap),
                ),
                local_cap,
            )
            sorder = s_idx.order
            svalid = sorder >= 0
            ssafe = jnp.maximum(sorder, 0)
            s_xyz = s_idx.tiles.reshape(-1, 3)
            s_mask = svalid
            s_n = jnp.where(svalid[:, None], s_n[ssafe], 0.0)
            sq = config.resolve_q_tile(local_cap)
            local_tq = s_xyz.shape[0] // sq
            qf = (
                jnp.where(svalid, s_f[ssafe], 0.0).reshape(local_tq, sq)
                if use_feat
                else None
            )

            # same static trim on every shard (shared local capacity), so
            # ring ppermutes stay shape-uniform
            t_idx = trim_index(
                builder(t_xyz, t_mask, tile_size=config.block_tile),
                t_xyz.shape[0],
                multiple=_SUPER_G,
            )
            ft = (
                tile_payload(t_idx, t_f[:, None])[..., 0]
                if use_feat
                else None
            )
            if ring:
                pl_tiles = tile_payload(
                    t_idx, jnp.concatenate([t_xyz, t_n], axis=1)
                )

                def nn_fn(p):
                    d2, pl = ring_block_nn(
                        p.reshape(local_tq, sq, 3),
                        t_idx,
                        pl_tiles,
                        points_axis,
                        k_tiles=config.block_k,
                        query_feat=qf,
                        feat_tiles=ft,
                        feat_weight=config.feat_nn_weight,
                        score_prec=config.resolve_score_prec(),
                        payload_prec=config.resolve_payload_prec(),
                        payload_xyz=3,
                    )
                    return pl[:, :3], pl[:, 3:], jnp.sqrt(d2)

            else:

                def nn_fn(p):
                    d2, idx = block_nn(
                        p.reshape(local_tq, sq, 3),
                        t_idx,
                        k_tiles=config.block_k,
                        query_feat=qf,
                        feat_tiles=ft,
                        feat_weight=config.feat_nn_weight,
                        score_prec=config.resolve_score_prec(),
                    )
                    return t_xyz[idx], t_n[idx], jnp.sqrt(d2)

        elif ring:
            payload = jnp.concatenate([t_xyz, t_n], axis=1)

            def nn_fn(p):
                d2, _, pl = ring_nearest_neighbor(
                    p,
                    t_xyz,
                    t_mask,
                    points_axis,
                    payload_shard=payload,
                    tile_q=config.tile_q,
                    tile_r=config.tile_r,
                )
                return pl[:, :3], pl[:, 3:], jnp.sqrt(d2)

        else:

            def nn_fn(p):
                d2, idx = nearest_neighbor(
                    p,
                    t_xyz,
                    ref_mask=t_mask,
                    tile_q=config.tile_q,
                    tile_r=config.tile_r,
                )
                return t_xyz[idx], t_n[idx], jnp.sqrt(d2)

        return _icp_scan(
            config,
            s_xyz,
            s_mask,
            s_n,
            SE3(R=init_R, t=init_t),
            nn_fn,
            reduce,
            aux_rot=aux_rot,
        )

    res = run(
        src.xyz, src.mask, src_n, src_f,
        tgt.xyz, tgt.mask, tgt_n, tgt_f,
        init.R, init.t,
    )
    return res.replace(transform=unshift @ res.transform @ shift)


def sharded_register_pairs(
    src_xyz: jax.Array,  # (B, N, 3)
    src_mask: jax.Array,  # (B, N)
    src_normals: jax.Array,  # (B, N, 3)
    tgt_xyz: jax.Array,
    tgt_mask: jax.Array,
    tgt_normals: jax.Array,
    config: ICPConfig,
    mesh: Mesh,
    *,
    pairs_axis: str = "pairs",
    points_axis: str = "points",
) -> ICPResult:
    """DP over pairs x TP/SP over points: the full training-step analogue.

    Each (pairs, points) device tile holds a slice of a sub-batch of
    pairs; within a pair the 6x6 systems psum over `points_axis` (batched
    collective under vmap), while independent pairs proceed in parallel
    along `pairs_axis` with no cross-talk. Target is replicated along
    `points_axis` here (scan-to-scan odometry shapes).

    The `*_normals` arguments are the per-point auxiliary channel and are
    width-agnostic: (B, N, 3) normals for symmetric/p2plane, (B, N, 9)
    row-flattened covariances for objective="gicp" (pass
    `cloud.covs.reshape(n, 9)` per frame; `estimate_covariances` first).
    """
    aux_w = src_normals.shape[2]
    if config.objective == "gicp":
        if aux_w != 9 or tgt_normals.shape[2] != 9:
            raise ValueError(
                "gicp pairs need (B, N, 9) flattened covariances in the "
                f"aux channel, got widths {aux_w}/{tgt_normals.shape[2]}"
            )
        from icpx.registration.icp import gicp_cov_rot as aux_rot
    else:
        if aux_w != 3:
            raise ValueError(
                f"aux channel width {aux_w} != 3 (normals) for "
                f"objective={config.objective!r}"
            )
        aux_rot = None
    b, n = src_xyz.shape[0], src_xyz.shape[1]
    dp = mesh.shape[pairs_axis]
    sp = mesh.shape[points_axis]
    if b % dp or n % sp:
        raise ValueError(f"batch {b} / points {n} not divisible by mesh {mesh.shape}")
    reduce = partial(lax.psum, axis_name=points_axis)

    spec3 = P(pairs_axis, points_axis, None)
    spec2 = P(pairs_axis, points_axis)
    repl3 = P(pairs_axis, None, None)
    repl2 = P(pairs_axis, None)
    out_struct = result_struct()
    out_specs = jax.tree_util.tree_map(lambda _: P(pairs_axis), out_struct)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec3, spec2, spec3, repl3, repl2, repl3),
        out_specs=out_specs,
        check_vma=False,
    )
    def run(s_xyz, s_mask, s_n, t_xyz, t_mask, t_n):
        def one_pair(sx, sm, sn, tx, tm, tn):
            # per-pair target-centroid centering (see register_batch);
            # the target is replicated along the points axis, so the
            # local masked centroid already IS the global one
            denom = jnp.maximum(tm.sum(), 1).astype(jnp.float32)
            center = jnp.where(tm[:, None], tx, 0.0).sum(0) / denom
            sx = jnp.where(sm[:, None], sx - center[None, :], sx)
            tx = jnp.where(tm[:, None], tx - center[None, :], tx)
            shift = SE3.identity().replace(t=-center)
            unshift = SE3.identity().replace(t=center)

            def nn_fn(p):
                d2, idx = nearest_neighbor(
                    p,
                    tx,
                    ref_mask=tm,
                    tile_q=config.tile_q,
                    tile_r=config.tile_r,
                )
                return tx[idx], tn[idx], jnp.sqrt(d2)

            res = _icp_scan(
                config, sx, sm, sn, SE3.identity(), nn_fn, reduce,
                aux_rot=aux_rot,
            )
            return res.replace(transform=unshift @ res.transform @ shift)

        return jax.vmap(one_pair)(s_xyz, s_mask, s_n, t_xyz, t_mask, t_n)

    return run(src_xyz, src_mask, src_normals, tgt_xyz, tgt_mask, tgt_normals)
