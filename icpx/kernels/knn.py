"""Tiled brute-force nearest-neighbor search — the accelerator replacement
for the reference's KD-tree (`pcl::search::KdTree`, `myicp.cpp:158`) and for the
correspondence step the reference left as a TODO (`myicp.cpp:128-131`).

Design: a KD-tree is pointer-chasing and branch-heavy — hostile to matrix
units and to XLA's static-shape model. Instead the (query x ref) squared-distance
matrix is computed tile-by-tile as a matmul (the `-2 q @ r^T` term is a
GEMM; norms are rank-1 updates fused by XLA), keeping a running top-k per
query row. Everything is `lax.scan` over static tiles: no dynamic shapes,
no data-dependent control flow. Cost O(Nq * Nr); for multi-million-point
clouds use the block (tile-index) path in `icpx.kernels.blocknn`.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

_INF = jnp.float32(jnp.inf)


def pairwise_sqdist(q: jax.Array, r: jax.Array) -> jax.Array:
    """(Nq, 3) x (Nr, 3) -> (Nq, Nr) squared euclidean distances.

    ||q - r||^2 = ||q||^2 + ||r||^2 - 2 q.r ; the cross term is a matmul
    (a GEMM), the norms broadcast. Clamped at 0 against fp cancellation.
    """
    qq = jnp.sum(q * q, axis=-1, keepdims=True)  # (Nq, 1)
    rr = jnp.sum(r * r, axis=-1, keepdims=True).T  # (1, Nr)
    cross = jnp.dot(q, r.T, preferred_element_type=jnp.float32)
    return jnp.maximum(qq + rr - 2.0 * cross, 0.0)


def _pad_rows(x: jax.Array, multiple: int, value) -> jax.Array:
    n = x.shape[0]
    m = (-n) % multiple
    if m == 0:
        return x
    pad_width = ((0, m),) + ((0, 0),) * (x.ndim - 1)
    return jnp.pad(x, pad_width, constant_values=value)


@partial(jax.jit, static_argnames=("k", "tile_q", "tile_r"))
def knn(
    query: jax.Array,
    ref: jax.Array,
    k: int,
    *,
    ref_mask: Optional[jax.Array] = None,
    tile_q: int = 1024,
    tile_r: int = 4096,
) -> Tuple[jax.Array, jax.Array]:
    """k nearest neighbors of each query point among ref points.

    Args:
      query: (Nq, 3) float32.
      ref: (Nr, 3) float32.
      k: number of neighbors (static).
      ref_mask: optional (Nr,) bool; False rows are never returned.
      tile_q / tile_r: scan tile sizes (static).

    Returns:
      (sqdists (Nq, k) ascending, indices (Nq, k) into ref).
    """
    nq, nr = query.shape[0], ref.shape[0]
    if k > nr:
        raise ValueError(f"k={k} > number of reference points {nr}")
    tile_q = min(tile_q, _round_up(nq, 8))
    tile_r = min(tile_r, _round_up(nr, 128))

    qp = _pad_rows(query, tile_q, 0.0)
    rp = _pad_rows(ref, tile_r, 0.0)
    mask = jnp.ones((nr,), bool) if ref_mask is None else ref_mask
    mp = _pad_rows(mask, tile_r, False)

    n_qt = qp.shape[0] // tile_q
    n_rt = rp.shape[0] // tile_r
    r_tiles = rp.reshape(n_rt, tile_r, 3)
    m_tiles = mp.reshape(n_rt, tile_r)
    q_tiles = qp.reshape(n_qt, tile_q, 3)

    def query_tile_body(_, q_tile):
        def ref_tile_body(carry, inp):
            best_d, best_i = carry
            r_tile, m_tile, t_idx = inp
            d = pairwise_sqdist(q_tile, r_tile)
            d = jnp.where(m_tile[None, :], d, _INF)
            cd, cloc = lax.top_k(-d, k)  # (tile_q, k), ascending dists
            cand_d = -cd
            cand_i = t_idx * tile_r + cloc
            all_d = jnp.concatenate([best_d, cand_d], axis=1)
            all_i = jnp.concatenate([best_i, cand_i], axis=1)
            nd, sel = lax.top_k(-all_d, k)
            return (
                -nd,
                jnp.take_along_axis(all_i, sel, axis=1),
            ), None

        init = (
            jnp.full((tile_q, k), _INF),
            jnp.zeros((tile_q, k), jnp.int32),
        )
        (best_d, best_i), _ = lax.scan(
            ref_tile_body,
            init,
            (r_tiles, m_tiles, jnp.arange(n_rt, dtype=jnp.int32)),
        )
        return None, (best_d, best_i)

    _, (d_out, i_out) = lax.scan(query_tile_body, None, q_tiles)
    d_out = d_out.reshape(n_qt * tile_q, k)[:nq]
    i_out = i_out.reshape(n_qt * tile_q, k)[:nq]
    return d_out, i_out


def nearest_neighbor(
    query: jax.Array,
    ref: jax.Array,
    *,
    ref_mask: Optional[jax.Array] = None,
    tile_q: int = 2048,
    tile_r: int = 4096,
) -> Tuple[jax.Array, jax.Array]:
    """Single nearest neighbor (k=1 fast path): the jnp tiled scan.
    Returns (sqdist (Nq,), index (Nq,))."""
    return _nearest_neighbor_jnp(
        query, ref, ref_mask=ref_mask, tile_q=tile_q, tile_r=tile_r
    )


@partial(jax.jit, static_argnames=("tile_q", "tile_r"))
def _nearest_neighbor_jnp(
    query: jax.Array,
    ref: jax.Array,
    *,
    ref_mask: Optional[jax.Array] = None,
    tile_q: int = 2048,
    tile_r: int = 4096,
) -> Tuple[jax.Array, jax.Array]:
    """jnp tiled-scan NN: a running (min, argmin) over reference tiles."""
    nq, nr = query.shape[0], ref.shape[0]
    tile_q = min(tile_q, _round_up(nq, 8))
    tile_r = min(tile_r, _round_up(nr, 128))

    qp = _pad_rows(query, tile_q, 0.0)
    rp = _pad_rows(ref, tile_r, 0.0)
    mask = jnp.ones((nr,), bool) if ref_mask is None else ref_mask
    mp = _pad_rows(mask, tile_r, False)

    n_qt = qp.shape[0] // tile_q
    n_rt = rp.shape[0] // tile_r
    r_tiles = rp.reshape(n_rt, tile_r, 3)
    m_tiles = mp.reshape(n_rt, tile_r)
    q_tiles = qp.reshape(n_qt, tile_q, 3)

    def query_tile_body(_, q_tile):
        def ref_tile_body(carry, inp):
            best_d, best_i = carry
            r_tile, m_tile, t_idx = inp
            d = pairwise_sqdist(q_tile, r_tile)
            d = jnp.where(m_tile[None, :], d, _INF)
            dmin = jnp.min(d, axis=1)
            darg = jnp.argmin(d, axis=1).astype(jnp.int32) + t_idx * tile_r
            better = dmin < best_d
            return (
                jnp.where(better, dmin, best_d),
                jnp.where(better, darg, best_i),
            ), None

        init = (jnp.full((tile_q,), _INF), jnp.zeros((tile_q,), jnp.int32))
        (best_d, best_i), _ = lax.scan(
            ref_tile_body,
            init,
            (r_tiles, m_tiles, jnp.arange(n_rt, dtype=jnp.int32)),
        )
        return None, (best_d, best_i)

    _, (d_out, i_out) = lax.scan(query_tile_body, None, q_tiles)
    return (
        d_out.reshape(-1)[:nq],
        i_out.reshape(-1)[:nq],
    )


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
