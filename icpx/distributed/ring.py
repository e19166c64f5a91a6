"""Ring nearest-neighbor pass — the ring-attention analogue (SURVEY §2.3 P4).

When the target cloud is itself sharded over the ``points`` axis (too large
to replicate per device), each device keeps its resident query shard and
the target shards rotate around the ring via `lax.ppermute` (XLA maps this
onto ICI neighbor links). Each step folds one visiting target shard into a
running (min-distance, global-index) accumulator — exactly blockwise/ring
attention with min instead of softmax accumulation. n_steps == ring size.

Comm/compute overlap: the compiled loop body keeps every `ppermute`
schedule-independent of the fold compute — 0 compute ancestors, 0
descendants, with the full per-shard fold available to hide it behind
(verified structurally on the compiled HLO by
tests/test_hlo_overlap.py; `scripts/hlo_dump.py ring` prints the
report). That is the precondition for XLA's latency-hiding scheduler to
turn the collective into an async collective-permute-start/done pair;
actual wall-clock overlap on multi-device hardware is not measured yet.

Use inside `shard_map` with a named mesh axis.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from icpx.kernels.knn import nearest_neighbor


def ring_nearest_neighbor(
    query: jax.Array,
    ref_shard: jax.Array,
    ref_mask_shard: jax.Array,
    axis_name: str,
    *,
    payload_shard: jax.Array | None = None,
    tile_q: int = 2048,
    tile_r: int = 4096,
) -> Tuple[jax.Array, jax.Array, jax.Array | None]:
    """NN of local `query` (Nq,3) against the UNION of all devices'
    `ref_shard` (Ns,3).

    LEGACY PATH for small shards: each fold is a brute O(Nq*Ns) pass and
    the payload gather at line ~`pl_cur[li]` is a per-query random row
    gather — the pattern that scales super-linearly at large tables. For 1M+/device shards use `ring_block_nn` (tile
    index + payload tiles riding the ring), which this module keeps as
    the scalable variant.

    Returns (sqdist (Nq,), global index (Nq,), gathered payload or None).
    Global indices are `owner_device * Ns + local_index`, matching a
    row-major concatenation of shards along the ring axis.

    `payload_shard` (Ns, D) rides the ring alongside the coordinates and is
    gathered at fold time — so callers get the matched rows (e.g. target
    xyz+normals) without a second cross-shard gather pass.
    """
    n_dev = lax.axis_size(axis_name)
    me = lax.axis_index(axis_name)
    nq = query.shape[0]
    shard_n = ref_shard.shape[0]
    perm = [(j, (j - 1) % n_dev) for j in range(n_dev)]  # send left
    has_payload = payload_shard is not None
    payload = (
        payload_shard
        if has_payload
        else jnp.zeros((shard_n, 1), jnp.float32)
    )

    def fold(carry, _):
        best_d, best_i, best_pl, r_cur, m_cur, pl_cur, owner = carry
        d, li = nearest_neighbor(
            query, r_cur, ref_mask=m_cur, tile_q=tile_q, tile_r=tile_r
        )
        gi = owner * shard_n + li
        better = d < best_d
        best_d = jnp.where(better, d, best_d)
        best_i = jnp.where(better, gi, best_i)
        best_pl = jnp.where(better[:, None], pl_cur[li], best_pl)
        r_next = lax.ppermute(r_cur, axis_name, perm)
        m_next = lax.ppermute(m_cur, axis_name, perm)
        pl_next = lax.ppermute(pl_cur, axis_name, perm)
        owner_next = (owner + 1) % n_dev
        return (
            best_d,
            best_i,
            best_pl,
            r_next,
            m_next,
            pl_next,
            owner_next,
        ), None

    init = (
        jnp.full((nq,), jnp.inf, jnp.float32),
        jnp.zeros((nq,), jnp.int32),
        jnp.zeros((nq, payload.shape[1]), payload.dtype),
        ref_shard,
        ref_mask_shard,
        payload,
        me,
    )
    (best_d, best_i, best_pl, *_), _ = lax.scan(fold, init, None, length=n_dev)
    return best_d, best_i, (best_pl if has_payload else None)


def ring_block_nn(
    query_tiles: jax.Array,
    index,
    payload_tiles: jax.Array,
    axis_name: str,
    *,
    k_tiles: int = 8,
    query_feat: jax.Array | None = None,
    feat_tiles: jax.Array | None = None,
    feat_weight: float = 1.0,
    score_prec: str = "highest",
    payload_prec: str = "highest",
    payload_xyz: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """Block (tile-index) NN of local query tiles against the UNION of all
    devices' target shards — the scalable-cloud ring pass (SURVEY §2.3
    P3+P4; serial analogue `myicp.cpp:109-111`).

    Each device holds a `TileIndex` over its resident target shard plus
    the matching `(T, S, D)` payload tiles (`blocknn.tile_payload`); both
    rotate around the ring via `ppermute` while each step folds a
    `block_nn_payload` answer into a running (min-dist, payload) pair.
    Per-step comm = the shard's tile arrays (~the points themselves), the
    same traffic as `ring_nearest_neighbor`, but each fold costs
    O(Nq_local * K * S) instead of O(Nq_local * Ns) — the brute ring's
    quadratic term is what made 1M+/device shards unusable.

    Feature-augmented matching (`query_feat` (Tq, Sq) local scalar
    channel, `feat_tiles` (T, S) per-shard target channel) runs the 4D
    metric exactly as `block_nn`; the target feature tiles rotate around
    the ring alongside the index and payload.

    Returns (sqdist (Nq,), payload rows (Nq, D)); inf distance where no
    shard held a valid candidate (payload zeros).
    """
    from icpx.kernels.blocknn import block_nn_payload

    n_dev = lax.axis_size(axis_name)
    perm = [(j, (j - 1) % n_dev) for j in range(n_dev)]
    nq = query_tiles.shape[0] * query_tiles.shape[1]
    d_pl = payload_tiles.shape[2]
    has_feat = query_feat is not None
    ft0 = feat_tiles if has_feat else jnp.zeros((1, 1), jnp.float32)

    def fold(carry, _):
        best_d, best_pl, idx_cur, pl_cur, ft_cur = carry
        d, pl = block_nn_payload(
            query_tiles, idx_cur, pl_cur, k_tiles=k_tiles,
            query_feat=query_feat if has_feat else None,
            feat_tiles=ft_cur if has_feat else None,
            feat_weight=feat_weight,
            score_prec=score_prec,
            payload_prec=payload_prec,
            payload_xyz=payload_xyz,
        )
        better = d < best_d
        best_d = jnp.where(better, d, best_d)
        best_pl = jnp.where(better[:, None], pl, best_pl)
        idx_next = jax.tree_util.tree_map(
            lambda x: lax.ppermute(x, axis_name, perm), idx_cur
        )
        pl_next = lax.ppermute(pl_cur, axis_name, perm)
        ft_next = (
            lax.ppermute(ft_cur, axis_name, perm) if has_feat else ft_cur
        )
        return (best_d, best_pl, idx_next, pl_next, ft_next), None

    init = (
        jnp.full((nq,), jnp.inf, jnp.float32),
        jnp.zeros((nq, d_pl), payload_tiles.dtype),
        index,
        payload_tiles,
        ft0,
    )
    (best_d, best_pl, *_), _ = lax.scan(fold, init, None, length=n_dev)
    return best_d, best_pl
