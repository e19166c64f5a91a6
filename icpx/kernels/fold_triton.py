"""Fused frozen-candidate NN fold for NVIDIA GPUs (Pallas, Triton route).

The XLA fold (`blocknn.block_nn_payload`) scores every candidate tile as
a `(Tq, Sq, S)` f32 tensor that is written to device memory and read
back for the min, the argmin and the one-hot payload selection. Its
contraction depth is 4, so the tensor cores have nothing to do and the
fold is bound by that round trip (about 26 GB each way per iteration
at 8M points, K=6, Sq=S=128).

This kernel keeps the score in registers. A program takes a block of
query rows; for each query tile in it, it walks that tile's K frozen
candidate tiles in order, loading each candidate tile by id straight
from the index's coordinate columns (no dense candidate pre-gather),
scores it with f32 subtract/FMA on the exact differences `q - r` (no
norm expansion, so no cancellation and no need to centre), and keeps an
elementwise running min over candidates; one row reduction at the end
picks the winner. The winning payload row is read once and written
once: payload values are copied, never computed, so they are
bit-identical to the table.

Contract (same as the XLA infold path): a query whose candidates are all
sentinel padding gets d2 = inf and a zero payload row. Ties keep the
earliest candidate tile and, within a tile, the lowest lane.

The kernel runs compiled for the GPU, or in the Pallas interpreter when
`interpret=True` is passed (tests). It never falls back by itself.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from icpx import struct
from icpx.cloud import PAD_COORD
from icpx.kernels.blocknn import TileIndex

# squared distances at or above this come from sentinel (PAD_COORD) rows
_MISS_D2 = 1.0e15


@struct.dataclass
class FoldTables:
    """Per-index operands of `fold_nn`, built once per registration phase
    (outside the ICP loop) by `fold_tables`."""

    rx: jax.Array  # (T*S,) sorted x coordinates, PAD_COORD padding
    ry: jax.Array
    rz: jax.Array
    payload: jax.Array  # (T*S, Dp) f32, Dp = next power of two >= d
    tile_size: int = struct.field(pytree_node=False, default=128)
    d: int = struct.field(pytree_node=False, default=0)


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def fold_tables(index: TileIndex, payload_tiles: jax.Array) -> FoldTables:
    """Coordinate columns and the lane-padded payload table of an index.

    `payload_tiles` is (T, S, D) in the index's sorted tile order."""
    t, s, d = payload_tiles.shape
    if s != index.tile_size or t != index.n_tiles:
        raise ValueError("payload_tiles must match the index's (T, S)")
    flat = index.tiles.reshape(-1, 3)
    dp = _pow2(d)
    pl_tab = payload_tiles.reshape(t * s, d).astype(jnp.float32)
    if dp != d:
        pl_tab = jnp.pad(pl_tab, ((0, 0), (0, dp - d)))
    return FoldTables(
        rx=flat[:, 0], ry=flat[:, 1], rz=flat[:, 2], payload=pl_tab,
        tile_size=s, d=d,
    )


def _fold_kernel(cand_ref, qx_ref, qy_ref, qz_ref, rx_ref, ry_ref, rz_ref,
                 pl_ref, d_out, pl_out, *, rows, sub, k, sq, s, dp):
    # `rows` query rows per program, in `rows // sub` sub-blocks of `sub`
    # rows that each lie inside one query tile. Per sub-block: an
    # elementwise running (min, candidate) over the K candidate tiles in
    # registers, then ONE row reduction to the winning (candidate, lane)
    # — earliest candidate, then lowest lane, on ties (the XLA fold's
    # order).
    pid = pl.program_id(0)
    lane = jnp.arange(s, dtype=jnp.int32)[None, :]
    cols = jnp.arange(dp, dtype=jnp.int32)[None, :]
    for j in range(rows // sub):
        row0 = pid * rows + j * sub
        t = row0 // sq
        qx = qx_ref[pl.ds(row0, sub)][:, None]
        qy = qy_ref[pl.ds(row0, sub)][:, None]
        qz = qz_ref[pl.ds(row0, sub)][:, None]
        best = jnp.full((sub, s), jnp.inf, jnp.float32)
        best_c = jnp.zeros((sub, s), jnp.int32)
        for c in range(k):
            tid = cand_ref[t * k + c]
            dx = qx - rx_ref[pl.ds(tid * s, s)][None, :]
            dy = qy - ry_ref[pl.ds(tid * s, s)][None, :]
            dz = qz - rz_ref[pl.ds(tid * s, s)][None, :]
            d2 = dx * dx + dy * dy + dz * dz  # (sub, S)
            better = d2 < best
            best = jnp.where(better, d2, best)
            best_c = jnp.where(better, c, best_c)
        dmin = jnp.min(best, axis=1)
        key = jnp.where(best == dmin[:, None], best_c * s + lane, k * s)
        kmin = jnp.min(key, axis=1)
        win = jnp.minimum(kmin // s, k - 1)
        pos = cand_ref[t * k + win] * s + kmin % s
        hit = dmin < _MISS_D2
        payload = pl_ref[pos[:, None] * dp + cols]  # (sub, Dp) row copy
        d_out[pl.ds(j * sub, sub)] = jnp.where(hit, dmin, jnp.inf)
        pl_out[pl.ds(j * sub, sub), :] = jnp.where(hit[:, None], payload, 0.0)


def _check_pow2(**named):
    for name, v in named.items():
        if v < 1 or v & (v - 1):
            raise ValueError(f"{name}={v} must be a power of two")


@functools.partial(
    jax.jit,
    static_argnames=("rows", "num_warps", "interpret"),
)
def fold_nn(
    query_tiles: jax.Array,
    cand_tiles: jax.Array,
    tables: FoldTables,
    *,
    rows: int = 16,
    num_warps: int = 2,
    interpret: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """NN of (Tq, Sq, 3) query tiles over their frozen (Tq, K) candidate
    tiles: (sqdist (Tq*Sq,), payload rows (Tq*Sq, d)).

    `rows` query rows per program: below Sq a program takes a slice of
    one query tile; above it, a group of rows // Sq whole tiles (the
    tile count is then padded to a multiple of the group). The defaults
    (16 rows, 2 warps) were the fastest of rows 16-256 x warps 2-8 on an
    H100 at 1M and 8M points (PERF.md).

    Matches `fold_nn_reference` up to near-tie argmin swaps (the GPU may
    contract the squared-distance sum into FMAs). Against the XLA fold
    (`blocknn.block_nn_payload`, norm-expansion scoring) it additionally
    differs wherever the expansion's rounding exceeds the gap between
    the two nearest candidates."""
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "fold_nn is compiled for NVIDIA GPUs only; pass "
            "interpret=True to run it in the Pallas interpreter"
        )
    tq, sq, _ = query_tiles.shape
    k = cand_tiles.shape[1]
    s = tables.tile_size
    dp = tables.payload.shape[1]
    _check_pow2(query_tile=sq, index_tile=s, rows=rows)
    sub = min(rows, sq)
    group = max(rows // sq, 1)
    pad_t = (-tq) % group
    if pad_t:
        query_tiles = jnp.concatenate(
            [query_tiles, jnp.full((pad_t, sq, 3), PAD_COORD, jnp.float32)]
        )
        cand_tiles = jnp.concatenate(
            [cand_tiles, jnp.zeros((pad_t, k), cand_tiles.dtype)]
        )
    n_pad = (tq + pad_t) * sq
    q = query_tiles.reshape(n_pad, 3)
    d2, pl_rows = pl.pallas_call(
        functools.partial(
            _fold_kernel, rows=rows, sub=sub, k=k, sq=sq, s=s, dp=dp
        ),
        grid=(n_pad // rows,),
        in_specs=[pl.no_block_spec] * 8,
        out_specs=[
            pl.BlockSpec((rows,), lambda i: (i,)),
            pl.BlockSpec((rows, dp), lambda i: (i, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
            jax.ShapeDtypeStruct((n_pad, dp), jnp.float32),
        ],
        backend="triton",
        # num_stages=1: the candidate loop is unrolled, nothing to pipeline
        compiler_params=plt.CompilerParams(
            num_warps=num_warps, num_stages=1
        ),
        interpret=interpret,
        name="icpx_fold_nn",
    )(
        cand_tiles.reshape(-1).astype(jnp.int32),
        q[:, 0], q[:, 1], q[:, 2],
        tables.rx, tables.ry, tables.rz,
        tables.payload.reshape(-1),
    )
    n = tq * sq
    return d2[:n], pl_rows[:n, : tables.d]


@functools.partial(jax.jit, static_argnames=("chunk",))
def fold_nn_reference(
    query_tiles: jax.Array,
    cand_tiles: jax.Array,
    tables: FoldTables,
    *,
    chunk: int = 1024,
) -> Tuple[jax.Array, jax.Array]:
    """Plain-jnp reference of `fold_nn`: the same exact-difference
    distances over the same candidates, the same tie order (flattened
    candidate-major index) and the same miss contract. Query tiles are
    processed `chunk` at a time to bound the (chunk, Sq, K*S) tensor."""
    tq, sq, _ = query_tiles.shape
    k = cand_tiles.shape[1]
    s = tables.tile_size
    chunk = min(chunk, tq)
    pad_t = (-tq) % chunk
    if pad_t:
        query_tiles = jnp.concatenate(
            [query_tiles, jnp.full((pad_t, sq, 3), PAD_COORD, jnp.float32)]
        )
        cand_tiles = jnp.concatenate(
            [cand_tiles, jnp.zeros((pad_t, k), cand_tiles.dtype)]
        )

    def one(args):
        qt, ct = args  # (chunk, Sq, 3), (chunk, K)
        pos = (ct[:, :, None] * s + jnp.arange(s)).reshape(ct.shape[0], -1)
        dx = qt[..., 0:1] - tables.rx[pos][:, None, :]
        dy = qt[..., 1:2] - tables.ry[pos][:, None, :]
        dz = qt[..., 2:3] - tables.rz[pos][:, None, :]
        d2 = dx * dx + dy * dy + dz * dz  # (chunk, Sq, K*S)
        j = jnp.argmin(d2, axis=2)
        dmin = jnp.min(d2, axis=2)
        p = jnp.take_along_axis(pos, j, axis=1)  # (chunk, Sq)
        hit = dmin < _MISS_D2
        rows = jnp.where(hit[..., None], tables.payload[p], 0.0)
        return jnp.where(hit, dmin, jnp.inf), rows

    n_c = (tq + pad_t) // chunk
    d2, rows = jax.lax.map(
        one,
        (
            query_tiles.reshape(n_c, chunk, sq, 3),
            cand_tiles.reshape(n_c, chunk, k),
        ),
    )
    n = tq * sq
    return (
        d2.reshape(-1)[:n],
        rows.reshape(-1, rows.shape[-1])[:n, : tables.d],
    )
