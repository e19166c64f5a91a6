"""Pipeline parallelism over pyramid levels (SURVEY §2.3 P6).

Coarse-to-fine ICP has a sequential chain per pair (level l seeds level
l+1), but a STREAM of pairs pipelines: stage/device l refines pairs at
pyramid level l, so while stage L-1 polishes pair b, stage 0 is already
coarse-aligning pair b+L-1 — classic GPipe-style filling/draining with
the inter-stage handoff (the accumulated transform, an SE3) moving along
the ``stages`` mesh axis via `ppermute` each tick.

SPMD constraint: every stage runs the same program on same-shape data, so
levels subsample by MASK stride (identical array shapes, fewer valid
points) rather than by slicing — coarse stages do full-shape compute and
save NOTHING per tick. This is a VALIDATED-MAPPING DEMO, not a
throughput mode (README parallelism table says the same): B pairs finish in B+L-1 ticks where every tick costs a
full-resolution level, so the win over a sequential pyramid is bounded
by stage overlap, never by per-level work reduction. True per-stage
work reduction needs per-stage shapes (MPMD), which single-program
`shard_map` cannot express. For real multi-pair throughput use the DP
`pairs` axis (`sharded_register_pairs` / `register_batch`); the
single-chip pyramid (`register_pyramid`) remains the latency-optimal
path when only one pair is in flight.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from icpx.geometry.se3 import SE3
from icpx.registration.icp import ICPConfig
from icpx.registration.step import (
    correspondence_weights,
    estimate_increment,
)
from icpx.kernels.knn import _nearest_neighbor_jnp


def pipelined_pyramid_register(
    src_xyz: jax.Array,  # (B, N, 3)
    src_mask: jax.Array,  # (B, N)
    src_normals: jax.Array,
    tgt_xyz: jax.Array,
    tgt_mask: jax.Array,
    tgt_normals: jax.Array,
    config: ICPConfig,
    mesh,
    *,
    stages_axis: str = "stages",
    iters_per_level: int = 4,
    subsample: int = 4,
) -> SE3:
    """Register B pairs through an L-stage coarse-to-fine pipeline
    (L = mesh axis size). Returns batched SE3 (B,).

    Precondition (unlike register()/register_batch/sharded_register, which
    auto-center): clouds must be in near-origin coordinates — at UTM-scale
    offsets (1e5+) the fp32 squared-distance expansion loses precision.
    Center inputs beforehand (subtract the target centroid) if needed;
    stage handoffs make an internal conjugation intrusive here.
    """
    b, n, _ = src_xyz.shape
    L = mesh.shape[stages_axis]
    n_ticks = b + L - 1

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, None, None),) * 4 + (P(None, None),) * 2,
        out_specs=(P(), P()),
        check_vma=False,
    )
    def run(sx, sn, tx, tn, sm, tm):
        stage = lax.axis_index(stages_axis)
        stride = subsample ** (L - 1 - stage)
        lane = jnp.arange(n, dtype=jnp.int32)
        level_keep = (lane % stride) == 0  # this stage's subsample mask

        perm_fwd = [(i, i + 1) for i in range(L - 1)]

        def refine(pair_idx, transform):
            """iters_per_level ICP iterations on this stage's level."""
            psx = lax.dynamic_index_in_dim(sx, pair_idx, 0, keepdims=False)
            psn = lax.dynamic_index_in_dim(sn, pair_idx, 0, keepdims=False)
            ptx = lax.dynamic_index_in_dim(tx, pair_idx, 0, keepdims=False)
            ptn = lax.dynamic_index_in_dim(tn, pair_idx, 0, keepdims=False)
            psm = lax.dynamic_index_in_dim(sm, pair_idx, 0, keepdims=False)
            ptm = lax.dynamic_index_in_dim(tm, pair_idx, 0, keepdims=False)
            s_mask = psm & level_keep
            t_mask = ptm & level_keep

            def one_iter(k, T):
                p = T.apply(psx)
                n_p = T.rotate(psn)
                d2, idx = _nearest_neighbor_jnp(
                    p, ptx, ref_mask=t_mask,
                    tile_q=config.tile_q, tile_r=config.tile_r,
                )
                q = ptx[idx]
                n_q = ptn[idx]
                dist = jnp.sqrt(d2)
                w = correspondence_weights(
                    config, p, n_p, q, n_q, dist, s_mask
                )
                incre = estimate_increment(config, p, q, n_p, n_q, w)
                return incre @ T

            return lax.fori_loop(0, iters_per_level, one_iter, transform)

        def tick(carry, s):
            in_transform, out_R, out_t = carry
            pair_idx = s - stage  # which pair this stage works on now
            active = (pair_idx >= 0) & (pair_idx < b)

            refined = refine(jnp.clip(pair_idx, 0, b - 1), in_transform)
            refined = jax.tree_util.tree_map(
                lambda r, i: jnp.where(active, r, i), refined, in_transform
            )

            # the last stage emits a finished pair
            done = active & (stage == L - 1)
            out_R = jnp.where(
                done,
                out_R.at[jnp.clip(pair_idx, 0, b - 1)].set(refined.R),
                out_R,
            )
            out_t = jnp.where(
                done,
                out_t.at[jnp.clip(pair_idx, 0, b - 1)].set(refined.t),
                out_t,
            )

            # hand the transform to the next stage; stage 0 restarts with
            # identity for the next incoming pair
            nxt_R = lax.ppermute(refined.R, stages_axis, perm_fwd)
            nxt_t = lax.ppermute(refined.t, stages_axis, perm_fwd)
            eye = SE3.identity()
            nxt = SE3(
                R=jnp.where(stage == 0, eye.R, nxt_R),
                t=jnp.where(stage == 0, eye.t, nxt_t),
            )
            return (nxt, out_R, out_t), None

        init = (
            SE3.identity(),
            jnp.zeros((b, 3, 3), jnp.float32),
            jnp.zeros((b, 3), jnp.float32),
        )
        (_, out_R, out_t), _ = lax.scan(
            tick, init, jnp.arange(n_ticks, dtype=jnp.int32)
        )
        # outputs live on the last stage; broadcast via psum of one-hot
        is_last = (stage == L - 1).astype(jnp.float32)
        out_R = lax.psum(out_R * is_last, stages_axis)
        out_t = lax.psum(out_t * is_last, stages_axis)
        return out_R, out_t

    R, t = run(src_xyz, src_normals, tgt_xyz, tgt_normals, src_mask, tgt_mask)
    return SE3(R=R, t=t)
