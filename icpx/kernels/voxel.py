"""Voxel-hash nearest-neighbor — the O(N) replacement for the KD-tree at
1M-10M points (SURVEY §2.2, §7 hard-part #1).

A KD-tree's pointer-chasing traversal cannot map onto XLA's static-
shape, vector-parallel model. Instead:

  build (once per target cloud; the target is fixed across ICP iterations):
    1. integer cell coords  c = floor((x - origin) / h)
    2. spatial hash         k = (c . primes) mod H   (H = 2 * capacity,
       power of two, static)
    3. stable sort points by k; rank-within-bucket via a cummax scan
       (no atomics needed); scatter the first B ranks into a dense
       (H, B) index table (B static; overflow beyond B is dropped —
       choose h so mean occupancy ~1-2, see `auto_cell_size`)

  query (every iteration):
    for each of the 27 neighbor cells: hash, gather its B candidate
    indices + coordinates, fold squared distances into a running
    (min, argmin). 27*B candidates/query, elementwise math + gathers — no N^2.

Semantics: returns the exact NN whenever it lies within the 3x3x3 cell
neighborhood and within the first B entries of its bucket; with the
default auto cell size this is >99.9% of points (validated in tests), and
ICP's robust gating absorbs the remainder. Misses return inf distance
(never a wrong silent match... the fold only ever sees real candidates).

Hash collisions are benign: they merge buckets, adding spurious
candidates (extra distance checks), never removing true ones — except via
the shared capacity B, which the 2N-sized table makes rare.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from icpx import struct

from icpx.cloud import PAD_COORD

# Large primes for the 3D spatial hash (Teschner et al. 2003 constants).
_P1, _P2, _P3 = 73856093, 19349663, 83492791

_OFFSETS = [
    (dx, dy, dz)
    for dx in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dz in (-1, 0, 1)
]


@struct.dataclass
class VoxelGrid:
    """Hashed voxel index over a fixed reference cloud."""

    ref_xyz: jax.Array  # (N, 3) original reference coordinates
    table: jax.Array  # (H, B) int32 point indices, -1 = empty
    origin: jax.Array  # (3,)
    inv_cell: jax.Array  # scalar 1/h

    @property
    def n_buckets(self) -> int:
        return self.table.shape[0]

    @property
    def bucket_size(self) -> int:
        return self.table.shape[1]


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _hash_cells(cells: jax.Array, n_buckets: int) -> jax.Array:
    """(N, 3) int32 cell coords -> (N,) bucket ids in [0, n_buckets)."""
    h = (
        cells[..., 0] * _P1
        ^ cells[..., 1] * _P2
        ^ cells[..., 2] * _P3
    )
    return (h & (n_buckets - 1)).astype(jnp.int32)


@partial(jax.jit, static_argnames=("bucket_size", "table_factor"))
def build_voxel_grid(
    xyz: jax.Array,
    cell_size: jax.Array,
    mask: Optional[jax.Array] = None,
    *,
    bucket_size: int = 16,
    table_factor: int = 2,
) -> VoxelGrid:
    """Build the hash grid over (N, 3) reference points.

    `cell_size` may be traced (e.g. from `auto_cell_size`). `bucket_size`
    and the table size (table_factor * N rounded up to a power of two)
    are static.
    """
    n = xyz.shape[0]
    mask = jnp.ones((n,), bool) if mask is None else mask
    H = _next_pow2(max(table_factor * n, 16))
    inv_h = 1.0 / cell_size
    origin = jnp.min(jnp.where(mask[:, None], xyz, PAD_COORD), axis=0)

    cells = jnp.floor((xyz - origin) * inv_h).astype(jnp.int32)
    keys = _hash_cells(cells, H)
    # Masked points get the out-of-range key H: they sort to the end and
    # their scatter below lands out of bounds -> dropped.
    keys = jnp.where(mask, keys, H)

    order = jnp.argsort(keys, stable=True)
    sk = keys[order]
    # rank within equal-key run: i - (first index of this run), where the
    # first index comes from a cumulative max over run starts.
    idx = jnp.arange(n, dtype=jnp.int32)
    is_first = jnp.concatenate(
        [jnp.ones((1,), bool), sk[1:] != sk[:-1]]
    )
    first_pos = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_first, idx, 0)
    )
    rank = idx - first_pos

    flat = jnp.where(
        (rank < bucket_size) & (sk < H),
        sk * bucket_size + rank,
        H * bucket_size,  # out-of-range -> dropped by mode="drop"
    )
    table = (
        jnp.full((H * bucket_size,), -1, jnp.int32)
        .at[flat]
        .set(order.astype(jnp.int32), mode="drop")
        .reshape(H, bucket_size)
    )
    return VoxelGrid(
        ref_xyz=xyz,
        table=table,
        origin=origin,
        inv_cell=jnp.float32(inv_h),
    )


@jax.jit
def voxel_nn(
    query: jax.Array, grid: VoxelGrid
) -> Tuple[jax.Array, jax.Array]:
    """NN of (Nq, 3) queries among the grid's reference points.

    Returns (sqdist (Nq,), index (Nq,)); inf/0 when no candidate found in
    the 27-cell neighborhood (callers gate on finite distance).
    """
    nq = query.shape[0]
    H = grid.n_buckets
    qcells = jnp.floor((query - grid.origin) * grid.inv_cell).astype(jnp.int32)

    best_d = jnp.full((nq,), jnp.inf, jnp.float32)
    best_i = jnp.zeros((nq,), jnp.int32)
    for off in _OFFSETS:
        nb = qcells + jnp.asarray(off, jnp.int32)
        keys = _hash_cells(nb, H)  # (Nq,)
        cand = grid.table[keys]  # (Nq, B)
        valid = cand >= 0
        cxyz = grid.ref_xyz[jnp.maximum(cand, 0)]  # (Nq, B, 3)
        d = jnp.sum((query[:, None, :] - cxyz) ** 2, axis=-1)
        d = jnp.where(valid, d, jnp.inf)
        dmin = jnp.min(d, axis=1)
        darg = jnp.take_along_axis(
            cand, jnp.argmin(d, axis=1)[:, None], axis=1
        )[:, 0]
        better = dmin < best_d
        best_d = jnp.where(better, dmin, best_d)
        best_i = jnp.where(better, darg, best_i)
    return best_d, best_i


@partial(jax.jit, static_argnames=("sample",))
def auto_cell_size(
    xyz: jax.Array,
    mask: Optional[jax.Array] = None,
    *,
    sample: int = 1024,
    scale: float = 3.0,
) -> jax.Array:
    """Heuristic cell size: `scale` x the median NN spacing of a sample.

    A cell a few NN-spacings wide keeps bucket occupancy ~1-2 while making
    the 27-cell neighborhood all but certain to contain the true NN.
    """
    from icpx.kernels.knn import knn

    n = xyz.shape[0]
    mask = jnp.ones((n,), bool) if mask is None else mask
    stride = max(n // sample, 1)
    sub = xyz[::stride][:sample]
    sub_mask = mask[::stride][:sample]
    sub = jnp.where(sub_mask[:, None], sub, PAD_COORD)
    # 2-NN within the sample = nearest non-self neighbor. The sample is
    # sparser than the full cloud: for surface-like data its spacing is
    # ~sqrt(stride) x the full-cloud spacing — correct for that.
    d2, _ = knn(sub, sub, 2, ref_mask=sub_mask, tile_q=1024, tile_r=1024)
    d = jnp.sqrt(jnp.maximum(d2[:, 1], 0.0))
    med = jnp.nanmedian(jnp.where(sub_mask, d, jnp.nan))
    corr = jnp.sqrt(jnp.float32(max(stride, 1)))
    spacing = med / jnp.maximum(corr, 1.0)
    return jnp.maximum(scale * spacing, 1e-6)
