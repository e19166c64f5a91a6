"""Block-sparse (IVF-style) nearest neighbor — the scalable NN.

Why not a KD-tree, and why not hash-probe gathers: traversal is pointer
chasing, and per-query random multi-probe gathers are slow under XLA.
Accelerators want big contiguous blocks and dense tile math, so:

  build (once per reference cloud):
    1. Morton-order the points (30-bit interleaved key of 10-bit/axis
       quantized coords) — a spatial sort;
    2. cut the sorted order into T fixed tiles of S points (sentinel
       padding), keep per-tile centroids.

  query (per ICP iteration):
    1. queries arrive spatially sorted in tiles of Sq (rigid motion
       preserves locality, so ICP sorts the source ONCE);
    2. per query tile: top-K nearest reference tiles by centroid distance
       (a (Tq, T) matmul + top_k — tiny);
    3. scan over k = 1..K: slice the k-th candidate tile for every query
       tile ((Tq, S, 3) contiguous-row gather), compute the (Sq, S)
       squared-distance block via a batched matmul with the
       augmented-coordinate trick, fold a running (min, argmin).

  Cost: Nq * K * S candidate pairs (vs Nq * Nr brute force) with zero
  per-point gathers. The GPU fold kernel (kernels/fold_triton.py) runs
  step 3 on frozen candidates without materializing the score blocks.

Recall semantics: a query's true NN is found iff its tile's K candidate
tiles include the NN's tile. With Morton-compact tiles and default K this
is >99.9% (tests); misses surface as a larger (but genuine) distance to a
point in a candidate tile, which ICP's robust gating absorbs.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from icpx import struct

from icpx.cloud import PAD_COORD


@struct.dataclass
class TileIndex:
    """Morton-sorted, fixed-tile partition of a reference cloud."""

    tiles: jax.Array  # (T, S, 3) sorted coords, PAD_COORD padding
    box_lo: jax.Array  # (T, 3) per-tile AABB (sentinel-free)
    box_hi: jax.Array  # (T, 3)
    centroids: jax.Array  # (T, 3) masked tile centroids
    order: jax.Array  # (T*S,) sorted position -> original index, -1 pad

    @property
    def n_tiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def tile_size(self) -> int:
        return self.tiles.shape[1]


# Morton pre-sort hands segments of at most this many points to the
# median-cut phase of build_kd_index (segment-local sorts are ~10x
# cheaper than global ones; 16k keeps every in-node sort in that regime).
_KD_SEG = 65536

# Keep 4-way fanout while a node still has at least this many tiles
# below it; the last levels go 2-way (alternating axes) where box
# compactness matters most for recall. For LARGE builds (>= _FAN4_DEEP
# tiles) 8 = one fewer sort per build than 16 at recall-identical
# quality. Small builds keep 16: their sorts are cheap and the extra
# 2-way level measurably helps compactness (40k-pt refine-regime miss
# 0.21% vs 0.19%, CPU test scale). Shrinking the Morton segments
# instead (_KD_SEG=16384) is cheaper still but costs real recall.
_FAN4_MIN = 8
_FAN4_DEEP = 8192


def _part1by2(x: jax.Array) -> jax.Array:
    """Spread 10 bits to every 3rd bit (Morton interleave helper)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_keys(
    xyz: jax.Array, lo: jax.Array, inv_extent: jax.Array
) -> jax.Array:
    """(N, 3) -> (N,) 30-bit Morton codes over the given bounding box."""
    u = jnp.clip((xyz - lo) * inv_extent, 0.0, 1.0 - 1e-7)
    q = (u * 1024.0).astype(jnp.int32)
    return (
        _part1by2(q[..., 0])
        | (_part1by2(q[..., 1]) << 1)
        | (_part1by2(q[..., 2]) << 2)
    )


@partial(jax.jit, static_argnames=("tile_size",))
def build_tile_index(
    xyz: jax.Array,
    mask: Optional[jax.Array] = None,
    *,
    tile_size: int = 256,
) -> TileIndex:
    """Morton-sort (N, 3) points into (T, S, 3) tiles (built once)."""
    n = xyz.shape[0]
    mask = jnp.ones((n,), bool) if mask is None else mask
    s = tile_size
    t = -(-n // s)
    pad = t * s - n

    lo = jnp.min(jnp.where(mask[:, None], xyz, PAD_COORD), axis=0)
    hi = jnp.max(jnp.where(mask[:, None], xyz, -PAD_COORD), axis=0)
    inv_extent = 1.0 / jnp.maximum(hi - lo, 1e-6)

    keys = morton_keys(xyz, lo, inv_extent)
    keys = jnp.where(mask, keys, jnp.int32(2**30))  # pads sort last
    order = jnp.argsort(keys, stable=True).astype(jnp.int32)
    sorted_xyz = jnp.where(
        mask[order][:, None], xyz[order], PAD_COORD
    )
    order = jnp.where(mask[order], order, -1)
    if pad:
        sorted_xyz = jnp.concatenate(
            [sorted_xyz, jnp.full((pad, 3), PAD_COORD, jnp.float32)]
        )
        order = jnp.concatenate([order, jnp.full((pad,), -1, jnp.int32)])

    tiles = sorted_xyz.reshape(t, s, 3)
    valid = order.reshape(t, s) >= 0
    box_lo = jnp.min(
        jnp.where(valid[..., None], tiles, PAD_COORD), axis=1
    )
    box_hi = jnp.max(
        jnp.where(valid[..., None], tiles, -PAD_COORD), axis=1
    )
    n_valid = valid.sum(axis=1, keepdims=True)
    centroids = jnp.where(valid[..., None], tiles, 0.0).sum(axis=1) / (
        jnp.maximum(n_valid, 1)
    )
    # empty (all-padding) tiles: sentinel centroid so they never rank as
    # candidates even if the box-gap term is ever removed
    centroids = jnp.where(n_valid > 0, centroids, PAD_COORD)
    return TileIndex(
        tiles=tiles,
        box_lo=box_lo,
        box_hi=box_hi,
        centroids=centroids,
        order=order,
    )


@partial(jax.jit, static_argnames=("tile_size",))
def build_kd_index(
    xyz: jax.Array,
    mask: Optional[jax.Array] = None,
    *,
    tile_size: int = 256,
) -> TileIndex:
    """Median-cut (KD-split) partition into compact, balanced tiles.

    Alternative builder to `build_tile_index` producing the same TileIndex
    structure (every query path works unchanged). Morton-range tiles
    sprawl at octant boundaries of the space-filling curve, which loosens
    the AABB candidate bound and costs recall (measured 1.4-7%% misses on
    uniform volumes even at K=12); median cuts along each node's widest
    axis give tight non-overlapping boxes, so fewer candidate tiles
    recover >=99.9%% recall.

    Build: one global Morton pre-sort segments the cloud into
    <=`_KD_SEG`-point nodes, then log2(T/c0) batched median-cut levels
    refine each node (segment-local sorts are far cheaper than global
    ones; a pure top-down median build pays its global levels in full).
    The Morton phase cuts at count-balanced (not space-balanced)
    boundaries, and the in-node cuts immediately separate any
    Morton-seam sprawl, so leaf compactness — the thing recall depends
    on — survives (tests/test_blocknn keeps the >=99.9% recall
    property).
    Every level moves data with ONE multi-operand `lax.sort` (key plus
    x/y/z/orig sorted together): no argsort + per-array random gathers,
    which dominated the old build's cost.

    Invalid points carry +inf keys and sink to each node's tail, ending
    as tile padding exactly like the Morton builder.
    """
    n = xyz.shape[0]
    mask = jnp.ones((n,), bool) if mask is None else mask
    s = tile_size
    t = max(1, -(-n // s))
    # The split levels only need t2 / c0 to be a power of two — c0 (the
    # segment count the Morton phase hands over) can carry any leading
    # factor q. Rounding t up to q * 2^k with 64 <= q <= 127 caps tile
    # padding at ~1.6% for large builds, where the old power-of-two
    # rounding cost up to 2x sort rows (a 10M-point cloud = 81920 tiles
    # padded to 131072: every build sort ran over 16.8M rows). q is a
    # multiple-of-64 guarantee for the trimmed index's hierarchical
    # ranking (k >= 6). Small builds keep plain power-of-two: their
    # padding is cheap and q-form would starve the median levels.
    if t >= 4096:
        k = t.bit_length() - 7
        q0 = -(-t // (1 << k))
        t2 = q0 << k
    else:
        q0 = 1
        t2 = 1 << (t - 1).bit_length()
    total = t2 * s
    pad = total - n

    pts = xyz.astype(jnp.float32)
    valid = mask
    orig = jnp.arange(n, dtype=jnp.int32)
    if pad:
        pts = jnp.concatenate(
            [pts, jnp.full((pad, 3), PAD_COORD, jnp.float32)]
        )
        valid = jnp.concatenate([valid, jnp.zeros((pad,), bool)])
        orig = jnp.concatenate([orig, jnp.full((pad,), -1, jnp.int32)])

    def sort_by(key, c):
        """Reorder (pts, valid, orig) within each of c segments by key;
        one fused multi-operand sort, no gathers. valid rides in orig's
        sign (orig < 0 == invalid)."""
        nonlocal pts, valid, orig
        o = jnp.where(valid, orig, -1)
        _, x0, x1, x2, og = jax.lax.sort(
            (
                key.reshape(c, -1),
                pts[:, 0].reshape(c, -1),
                pts[:, 1].reshape(c, -1),
                pts[:, 2].reshape(c, -1),
                o.reshape(c, -1),
            ),
            dimension=1,
            num_keys=1,
            is_stable=True,
        )
        pts = jnp.stack([x0, x1, x2], axis=-1).reshape(total, 3)
        orig = og.reshape(total)
        valid = orig >= 0

    # choose the segment size the Morton phase hands to the median phase
    # (c0 carries t2's odd-ish leading factor so t2/c0 stays a power of 2)
    c0 = q0
    while total // c0 > _KD_SEG and c0 < t2:
        c0 *= 2

    if c0 > 1:
        lo = jnp.min(jnp.where(valid[:, None], pts, PAD_COORD), axis=0)
        hi = jnp.max(jnp.where(valid[:, None], pts, -PAD_COORD), axis=0)
        inv_extent = 1.0 / jnp.maximum(hi - lo, 1e-6)
        mkeys = morton_keys(pts, lo, inv_extent)
        mkeys = jnp.where(valid, mkeys, jnp.int32(2**30))
        sort_by(mkeys, 1)

    c = c0
    while c < t2:
        # 4-way fanout early, 2-way for the last three levels: after
        # sorting a segment by its widest axis, ANY equal-count cut is a
        # valid partition, so one sort yields two levels' worth of
        # splits. The fine tail stays 2-way (alternating axes) where box
        # compactness matters most — measured recall matches the
        # all-2-way build (0.13% vs 0.10% aligned-volume miss) at 7
        # sorts instead of 10 per 1M-point build.
        min4 = _FAN4_MIN if t2 >= _FAN4_DEEP else 16
        fan = 4 if t2 // c >= min4 else 2
        m = total // c
        seg = pts.reshape(c, m, 3)
        v = valid.reshape(c, m)
        lo = jnp.min(jnp.where(v[..., None], seg, PAD_COORD), axis=1)
        hi = jnp.max(jnp.where(v[..., None], seg, -PAD_COORD), axis=1)
        widest = jnp.argmax(hi - lo, axis=1)  # (c,)
        vals = jnp.take_along_axis(
            seg, widest[:, None, None], axis=2
        )[..., 0]  # (c, m)
        key = jnp.where(v, vals, PAD_COORD)
        # 4-operand level sort (round 4): the key IS the widest-axis
        # column, so carrying it as a payload too is pure waste — sort
        # (key, other-axis-1, other-axis-2, orig) and reconstruct the
        # widest column from the sorted key. Identical permutation
        # (stable sort on the same key), bit-identical coordinates
        # (carried values + the key's own exact values), ~1/5 less
        # operand traffic per level sort. `sort_by` (5-op) remains for
        # the Morton phase, whose key is not a coordinate.
        oth1 = jnp.take_along_axis(
            seg, (((widest + 1) % 3))[:, None, None], axis=2
        )[..., 0]
        oth2 = jnp.take_along_axis(
            seg, (((widest + 2) % 3))[:, None, None], axis=2
        )[..., 0]
        o = jnp.where(valid, orig, -1)
        key_s, a_s, b_s, og = jax.lax.sort(
            (key, oth1, oth2, o.reshape(c, m)),
            dimension=1,
            num_keys=1,
            is_stable=True,
        )
        cols = []
        for x in range(3):
            sel = (x - widest) % 3  # (c,)
            cols.append(
                jnp.where(
                    (sel == 0)[:, None], key_s,
                    jnp.where((sel == 1)[:, None], a_s, b_s),
                )
            )
        pts = jnp.stack(cols, axis=-1).reshape(total, 3)
        orig = og.reshape(total)
        valid = orig >= 0
        c *= fan

    sorted_xyz = jnp.where(valid[:, None], pts, PAD_COORD)
    order = jnp.where(valid, orig, -1)
    tiles = sorted_xyz.reshape(t2, s, 3)
    tvalid = valid.reshape(t2, s)
    box_lo = jnp.min(jnp.where(tvalid[..., None], tiles, PAD_COORD), axis=1)
    box_hi = jnp.max(
        jnp.where(tvalid[..., None], tiles, -PAD_COORD), axis=1
    )
    n_valid = tvalid.sum(axis=1, keepdims=True)
    centroids = jnp.where(tvalid[..., None], tiles, 0.0).sum(axis=1) / (
        jnp.maximum(n_valid, 1)
    )
    centroids = jnp.where(n_valid > 0, centroids, PAD_COORD)
    return TileIndex(
        tiles=tiles,
        box_lo=box_lo,
        box_hi=box_hi,
        centroids=centroids,
        order=order,
    )


def trim_index(
    index: TileIndex, capacity: int, multiple: int = 1
) -> TileIndex:
    """View of the leading tiles that can contain valid rows.

    Both builders keep valid rows in a GLOBAL PREFIX of the sorted
    layout: every sort keys invalid/pad rows with +inf-like sentinels
    (Morton key 2^30, coordinate PAD_COORD), the first sort is global,
    and each median-cut level splits contiguous segments — so once
    valids occupy [0, n_valid), every later within-segment sort
    preserves it. Tiles beyond ceil(capacity / S) are therefore
    guaranteed pure padding, and slicing them off makes all downstream
    per-iteration work scale with the actual cloud size instead of the
    power-of-two padded tile count of `build_kd_index` (a 10M-point
    cloud otherwise pays 16.8M slots).

    `multiple` rounds the kept tile count up: hierarchical candidate
    ranking wants T % 64 == 0, the coarse phase Tq % 4 == 0.
    """
    t, s, _ = index.tiles.shape
    keep = min(t, -(-capacity // s))
    keep = min(t, -(-keep // multiple) * multiple)
    if keep == t:
        return index
    return TileIndex(
        tiles=index.tiles[:keep],
        box_lo=index.box_lo[:keep],
        box_hi=index.box_hi[:keep],
        centroids=index.centroids[:keep],
        order=index.order[: keep * s],
    )


def coarsen_index(index: TileIndex, factor: int) -> TileIndex:
    """Merge `factor` adjacent tiles into one (T/factor, S*factor, 3)
    index over the SAME flat point order.

    For KD indexes with power-of-two tile counts, adjacent tiles are
    siblings, so merged tiles are exactly the parent nodes' compact
    boxes — one fine build serves every coarser granularity (this is a
    reshape plus per-tile reductions, far cheaper than a build).
    """
    t, s, _ = index.tiles.shape
    if t % factor:
        raise ValueError(f"tile count {t} not divisible by {factor}")
    tiles = index.tiles.reshape(t // factor, s * factor, 3)
    valid = (index.order >= 0).reshape(t // factor, s * factor)
    box_lo = jnp.min(jnp.where(valid[..., None], tiles, PAD_COORD), axis=1)
    box_hi = jnp.max(
        jnp.where(valid[..., None], tiles, -PAD_COORD), axis=1
    )
    n_valid = valid.sum(axis=1, keepdims=True)
    centroids = jnp.where(valid[..., None], tiles, 0.0).sum(axis=1) / (
        jnp.maximum(n_valid, 1)
    )
    centroids = jnp.where(n_valid > 0, centroids, PAD_COORD)
    return TileIndex(
        tiles=tiles,
        box_lo=box_lo,
        box_hi=box_hi,
        centroids=centroids,
        order=index.order,
    )


def _tile_center(query_tiles: jax.Array) -> jax.Array:
    """(Tq, Sq, 3) -> (Tq, 3) masked per-tile centroid (bf16 scoring)."""
    qv = jnp.max(jnp.abs(query_tiles), axis=2) < 1.0e6
    nv = jnp.maximum(qv.sum(axis=1, keepdims=True).astype(jnp.float32), 1.0)
    return jnp.where(qv[..., None], query_tiles, 0.0).sum(axis=1) / nv


def _score_einsum(q4: jax.Array, r4: jax.Array, score_prec: str) -> jax.Array:
    """The fold's (Tq, Sq, C) x (Tq, S, C) -> (Tq, Sq, S) score matmul.

    The package pins jax_default_matmul_precision=highest (true fp32)
    because coordinate-scale distance expansions cancel catastrophically
    in bf16. That reasoning is about GLOBAL coordinates; the fold can
    afford cheaper passes when both operands are centered on the query
    tile (see callers): "high" = the backend's reduced f32 (TF32 on
    NVIDIA GPUs), "bf16" = 1 pass on tile-local magnitudes.
    """
    if score_prec == "bf16":
        return jnp.einsum(
            "tqc,tsc->tqs",
            q4.astype(jnp.bfloat16),
            r4.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
    return jnp.einsum("tqc,tsc->tqs", q4, r4, precision=score_prec)


def _box_sqdist(
    lo_a: jax.Array, hi_a: jax.Array, lo_b: jax.Array, hi_b: jax.Array
) -> jax.Array:
    """Pairwise squared distance between AABBs (..., A, 3) x (..., B, 3)
    -> (..., A, B); zero when boxes overlap."""
    gap = jnp.maximum(
        lo_b[..., None, :, :] - hi_a[..., :, None, :],
        lo_a[..., :, None, :] - hi_b[..., None, :, :],
    )
    gap = jnp.maximum(gap, 0.0)
    return jnp.sum(gap * gap, axis=-1)


@partial(
    jax.jit,
    static_argnames=("k_tiles", "max_chunk", "return_pos", "score_prec"),
)
def block_nn(
    query_tiles: jax.Array,
    index: TileIndex,
    *,
    k_tiles: int = 8,
    max_chunk: int = 32768,
    return_pos: bool = False,
    cand_tiles: Optional[jax.Array] = None,
    query_feat: Optional[jax.Array] = None,
    feat_tiles: Optional[jax.Array] = None,
    feat_weight: float = 1.0,
    score_prec: str = "highest",
) -> Tuple[jax.Array, jax.Array]:
    """NN of spatially-coherent query tiles (Tq, Sq, 3) into the index.

    Returns (sqdist (Tq*Sq,), original ref index (Tq*Sq,), flattened in
    query-tile order). Queries in a tile share candidate tiles — callers
    must present spatially sorted tiles (see module docstring).

    With `return_pos` the second output is the SORTED flat position into
    `index.tiles.reshape(-1, 3)` instead of the original index — callers
    holding sorted-layout payloads skip the `order` indirection gather,
    and pad matches are detected by score magnitude (sentinel coords put
    them >= ~1e16) rather than an order lookup.

    `cand_tiles` (Tq, K) overrides candidate selection — callers whose
    queries barely move between calls (ICP refine iterations after the
    coarse phase) can rank once and amortize the selection cost.

    Feature-augmented matching: with `query_feat` (Tq, Sq) and
    `feat_tiles` (T, S) scalar channels (intensity/reflectance), the NN
    runs in the 4D metric ||p-q||^2 + feat_weight^2 (f_p - f_q)^2 — the
    feature rides the SAME einsum (one extra contraction lane), while
    candidate-tile selection stays purely spatial (the feature term only
    reorders within spatial candidates). Returned sqdists are in the
    augmented metric.

    Above `max_chunk` query tiles, processing runs in chunks (lax.map) so
    the per-fold score tensor stays bounded (~chunk*Sq*S*4 bytes): 10M-pt
    clouds would otherwise need a >10 GB intermediate.
    """
    tq, sq, _ = query_tiles.shape
    if tq > max_chunk:
        qt, n_chunks, chunk = _pad_chunks(query_tiles, max_chunk)
        parts = [qt]

        def pad2(arr, fill):
            pad_c = qt.shape[0] * qt.shape[1] - tq
            if pad_c:
                arr = jnp.concatenate(
                    [arr, jnp.full((pad_c,) + arr.shape[1:], fill,
                                   arr.dtype)]
                )
            return arr.reshape(qt.shape[0], qt.shape[1], *arr.shape[1:])

        have_cand = cand_tiles is not None
        have_feat = query_feat is not None
        if have_cand:
            parts.append(pad2(cand_tiles, 0))
        if have_feat:
            parts.append(pad2(query_feat, 0.0))
        d, i = jax.lax.map(
            lambda xs: block_nn(
                xs[0], index, k_tiles=k_tiles, max_chunk=max_chunk,
                return_pos=return_pos,
                cand_tiles=xs[1] if have_cand else None,
                query_feat=xs[1 + have_cand] if have_feat else None,
                feat_tiles=feat_tiles,
                feat_weight=feat_weight,
                score_prec=score_prec,
            ),
            tuple(parts),
        )
        return d.reshape(-1)[: tq * sq], i.reshape(-1)[: tq * sq]
    s = index.tile_size
    if cand_tiles is None:
        cand_tiles, _ = _candidate_tiles(query_tiles, index, k_tiles)

    # bf16 scoring works on query-tile-centered coordinates: the
    # expansion's terms then scale with the LOCAL tile extent, not the
    # cloud extent, so 8 mantissa bits keep the cancellation error a
    # small fraction of a point spacing (distances stay genuine;
    # near-tie argmin swaps pick an almost-equidistant real neighbor).
    qc = _tile_center(query_tiles) if score_prec == "bf16" else None
    q_cen = query_tiles - qc[:, None, :] if qc is not None else query_tiles

    # Augmented query: [-2x, -2y, -2z, 1] so the matmul emits the biased
    # score ||r||^2 - 2 q.r. A feature channel adds
    # one contraction lane: [..., -2 w^2 f_q] against [..., f_r] with
    # w^2 f_r^2 folded into the bias row.
    lam2 = jnp.float32(feat_weight) ** 2
    q_ops = [-2.0 * q_cen, jnp.ones((tq, sq, 1), jnp.float32)]
    if query_feat is not None:
        q_ops.append((-2.0 * lam2 * query_feat)[..., None])
    q4 = jnp.concatenate(q_ops, axis=2)

    def fold(carry, k):
        best_s, best_p = carry
        tid = cand_tiles[:, k]  # (Tq,)
        r = index.tiles[tid]  # (Tq, S, 3) contiguous-row gather
        if qc is not None:
            r = r - qc[:, None, :]
        rr = jnp.sum(r * r, axis=2)  # (Tq, S)
        if query_feat is not None:
            f_r = feat_tiles[tid]  # (Tq, S)
            rr = rr + lam2 * f_r * f_r
            r4 = jnp.concatenate(
                [r, rr[..., None], f_r[..., None]], axis=2
            )
        else:
            r4 = jnp.concatenate([r, rr[..., None]], axis=2)
        score = _score_einsum(q4, r4, score_prec)  # (Tq, Sq, S)
        smin = jnp.min(score, axis=2)
        sarg = jnp.argmin(score, axis=2).astype(jnp.int32)
        pos = tid[:, None] * s + sarg  # global sorted position
        better = smin < best_s
        return (
            jnp.where(better, smin, best_s),
            jnp.where(better, pos, best_p),
        ), None

    init = (
        jnp.full((tq, sq), jnp.inf, jnp.float32),
        jnp.zeros((tq, sq), jnp.int32),
    )
    (best_s, best_p), _ = jax.lax.scan(
        fold, init, jnp.arange(cand_tiles.shape[1]), unroll=True
    )

    qq = jnp.sum(q_cen**2, axis=2)
    if query_feat is not None:
        qq = qq + lam2 * query_feat * query_feat
    d = jnp.maximum(best_s + qq, 0.0).reshape(-1)
    if return_pos:
        return jnp.where(d < 1e15, d, jnp.inf), best_p.reshape(-1)
    ridx = index.order[best_p.reshape(-1)]  # (Tq*Sq,) original ids (-1 pad)
    d = jnp.where(ridx >= 0, d, jnp.inf)
    return d, jnp.maximum(ridx, 0)


def _pad_chunks(query_tiles: jax.Array, max_chunk: int):
    """Split the query-tile axis into (n_chunks, chunk, Sq, 3).

    Prefers an exact divisor of tq in [max_chunk/2, max_chunk] — "one
    extra padded chunk at most" sounds cheap but is 20% pure-sentinel
    fold work at the 10M operating point (Tq=81920 pads to 3x32768;
    the divisor 16384 gives 5 clean chunks instead). Prime-ish tile
    counts where no such divisor exists fall back to sentinel padding
    as before."""
    tq, sq, _ = query_tiles.shape
    chunk = min(max_chunk, tq)
    if tq > max_chunk and tq % chunk:
        for c in range(max_chunk, max_chunk // 2 - 1, -1):
            if tq % c == 0:
                chunk = c
                break
    pad = (-tq) % chunk
    if pad:
        query_tiles = jnp.concatenate(
            [query_tiles, jnp.full((pad, sq, 3), PAD_COORD, jnp.float32)]
        )
    return query_tiles.reshape(-1, chunk, sq, 3), (tq + pad) // chunk, chunk


# Above this many reference tiles, candidate selection goes hierarchical:
# rank super-tiles (groups of _SUPER_G adjacent tiles — KD subtrees, so
# their merged boxes are compact parents) first, then rank only the
# children of the top _SUPER_K super-tiles. Flat ranking is O(Tq * T)
# and dominated 8M-point registrations; two levels cost O(Tq * (T/G + K_s*G)).
_SUPER_G = 64
_SUPER_K = 4  # top supers expanded; recall-neutral vs 8 (tests), half the pool
_HIER_MIN_TILES = 8192


def _query_boxes(query_tiles: jax.Array):
    qc_valid = jnp.max(jnp.abs(query_tiles), axis=2) < 1.0e6  # (Tq, Sq)
    q_lo = jnp.min(
        jnp.where(qc_valid[..., None], query_tiles, PAD_COORD), axis=1
    )
    q_hi = jnp.max(
        jnp.where(qc_valid[..., None], query_tiles, -PAD_COORD), axis=1
    )
    nvalid = jnp.maximum(
        qc_valid.sum(axis=1, keepdims=True).astype(jnp.float32), 1.0
    )
    q_cent = (
        jnp.where(qc_valid[..., None], query_tiles, 0.0).sum(axis=1) / nvalid
    )
    return q_lo, q_hi, q_cent


def _rank_boxes(q_lo, q_hi, q_cent, box_lo, box_hi, cent, k):
    """Top-k reference boxes per query box by gap distance (+ centroid
    tiebreak). box_lo/hi/cent are (T, 3) shared or (Tq, P, 3) per-query."""
    box_d = _box_sqdist(q_lo, q_hi, box_lo, box_hi)
    cent_d = (
        jnp.sum(q_cent**2, axis=1, keepdims=True)
        + jnp.sum(cent**2, axis=1)[None, :]
        - 2.0 * q_cent @ cent.T
    )
    cd = 100.0 * box_d + jnp.maximum(cent_d, 0.0)
    return jax.lax.top_k(-cd, k)[1]


def _rank_pool(q_lo, q_hi, q_cent, index: TileIndex, sup, g, k):
    """Top-k child tiles from each query's selected super-tiles.

    Children of super-tile s are the contiguous id block [s*g, (s+1)*g),
    so per-axis (ts, g) views are row-gathered by `sup` (Tq, K_s) into
    (Tq, K_s, g) — contiguous rows; element gathers (T,)[child] would
    run as scalar gathers."""
    tq, k_s = sup.shape
    ts = index.n_tiles // g
    box_d = jnp.zeros((tq, k_s, g), jnp.float32)
    cent_d = jnp.zeros((tq, k_s, g), jnp.float32)
    for a in range(3):
        lo_a = jnp.take(index.box_lo[:, a].reshape(ts, g), sup, axis=0)
        hi_a = jnp.take(index.box_hi[:, a].reshape(ts, g), sup, axis=0)
        ct_a = jnp.take(index.centroids[:, a].reshape(ts, g), sup, axis=0)
        qa_lo = q_lo[:, a][:, None, None]
        qa_hi = q_hi[:, a][:, None, None]
        gap = jnp.maximum(jnp.maximum(lo_a - qa_hi, qa_lo - hi_a), 0.0)
        box_d = box_d + gap * gap
        dc = ct_a - q_cent[:, a][:, None, None]
        cent_d = cent_d + dc * dc
    cd = (100.0 * box_d + cent_d).reshape(tq, k_s * g)
    child = (
        sup[:, :, None] * g + jnp.arange(g, dtype=jnp.int32)
    ).reshape(tq, k_s * g)
    sel = jax.lax.top_k(-cd, k)[1]
    return jnp.take_along_axis(child, sel, axis=1)


def _candidate_tiles(query_tiles: jax.Array, index: TileIndex, k_tiles: int):
    """Shared candidate-tile selection: (Tq, K) ref tile ids.

    k_tiles is statically clamped to the number of reference tiles (tiny
    clouds may have fewer tiles than the configured K).

    AABB gap distance dominates (lower-bounds true point distance, robust
    to sprawling Morton tiles); centroid distance breaks the zero-gap ties
    of overlapping boxes. Large indexes are ranked hierarchically (see
    _SUPER_G above): recall survives because KD super-tiles are compact
    parent boxes and _SUPER_K * _SUPER_G = 512 children reach the final
    ranking — misses remain genuine-but-larger distances.
    """
    q_lo, q_hi, q_cent = _query_boxes(query_tiles)
    t = index.n_tiles
    g = _SUPER_G
    if t >= _HIER_MIN_TILES and t % g == 0:
        ts = t // g
        s_lo = jnp.min(index.box_lo.reshape(ts, g, 3), axis=1)
        s_hi = jnp.max(index.box_hi.reshape(ts, g, 3), axis=1)
        # super centroid: mean of non-empty child centroids (empty tiles
        # carry sentinel centroids; an all-empty super-tile gets centroid
        # 0 but its inverted box keeps it unselectable via the gap term)
        cg = index.centroids.reshape(ts, g, 3)
        c_ok = (jnp.max(jnp.abs(cg), axis=2) < 1.0e6)[..., None]
        s_cent = jnp.where(c_ok, cg, 0.0).sum(axis=1) / jnp.maximum(
            c_ok.sum(axis=1), 1.0
        )
        k_s = min(_SUPER_K, ts)
        sup = _rank_boxes(q_lo, q_hi, q_cent, s_lo, s_hi, s_cent, k_s)
        cand = _rank_pool(
            q_lo, q_hi, q_cent, index, sup, g, min(k_tiles, k_s * g)
        )
        return cand, q_cent
    cand = _rank_boxes(
        q_lo, q_hi, q_cent, index.box_lo, index.box_hi, index.centroids,
        min(k_tiles, t),
    )
    return cand, q_cent


def tile_payload(index: TileIndex, payload: jax.Array) -> jax.Array:
    """Arrange per-point payload (N, D), original order, into the index's
    (T, S, D) sorted-tile layout (zeros on padding). Built once so NN
    queries can return matched payload rows without global gathers."""
    t, s = index.n_tiles, index.tile_size
    order = index.order
    safe = jnp.maximum(order, 0)
    flat = jnp.where((order >= 0)[:, None], payload[safe], 0.0)
    return flat.reshape(t, s, payload.shape[1])


def fused_payload_table(index: TileIndex, aux: jax.Array) -> jax.Array:
    """The fused (T*S, 3+D) `[xyz || aux]` table in SORTED tile order —
    exactly the rows `block_nn(..., return_pos=True)` positions index
    into. One shared constructor (review r5: the concat invariant was
    re-spelled at every call site); one row gather per iteration
    delivers coordinates AND payload together."""
    return jnp.concatenate(
        [
            index.tiles.reshape(-1, 3),
            tile_payload(index, aux).reshape(-1, aux.shape[1]),
        ],
        axis=1,
    )


@partial(
    jax.jit,
    static_argnames=(
        "k_tiles", "max_chunk", "score_prec", "payload_prec", "payload_xyz"
    ),
)
def block_nn_payload(
    query_tiles: jax.Array,
    index: TileIndex,
    payload_tiles: jax.Array,
    *,
    k_tiles: int = 8,
    max_chunk: int = 32768,
    cand_tiles: Optional[jax.Array] = None,
    query_feat: Optional[jax.Array] = None,
    feat_tiles: Optional[jax.Array] = None,
    feat_weight: float = 1.0,
    score_prec: str = "highest",
    payload_prec: str = "highest",
    payload_xyz: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """Like `block_nn` but returns the matched payload row per query
    instead of an index — the row is selected in-tile by a one-hot
    matmul (a global (N, D) gather would need the index round-trip).

    Used by shard-local paths that cannot gather from a remote array, AND
    by single-device ICP on large clouds, where in-fold selection only
    touches candidate tiles instead of the whole (N, D) table — see
    ICPConfig.payload_mode.

    `cand_tiles`, `query_feat`/`feat_tiles`/`feat_weight` behave exactly
    as in `block_nn` (frozen refine candidates; 4D augmented metric).

    `payload_prec="bf16"` runs the one-hot selection matmul as ONE bf16
    pass (f32 accumulate) instead of true fp32 ("highest", the
    default: payload values are exact copies). The one-hot operand is
    exactly representable; the payload VALUES quantize to 8 mantissa
    bits, so the first `payload_xyz` channels — global coordinates,
    whose absolute quantization would be cloud-extent-scale — are
    centered on the query-tile centroid before selection and
    un-centered in f32 after (requires bf16 scoring, which provides the
    centroid).

    Returns (sqdist (Tq*Sq,), payload (Tq*Sq, D)); inf distance on pad
    or miss (payload zeros).
    """
    tq, sq, _ = query_tiles.shape
    d_pl = payload_tiles.shape[2]
    if tq > max_chunk:
        qt, n_chunks, chunk = _pad_chunks(query_tiles, max_chunk)
        parts = [qt]

        def pad2(arr, fill):
            pad_c = qt.shape[0] * qt.shape[1] - tq
            if pad_c:
                arr = jnp.concatenate(
                    [arr, jnp.full((pad_c,) + arr.shape[1:], fill,
                                   arr.dtype)]
                )
            return arr.reshape(qt.shape[0], qt.shape[1], *arr.shape[1:])

        have_cand = cand_tiles is not None
        have_feat = query_feat is not None
        if have_cand:
            parts.append(pad2(cand_tiles, 0))
        if have_feat:
            parts.append(pad2(query_feat, 0.0))
        d, pl = jax.lax.map(
            lambda xs: block_nn_payload(
                xs[0], index, payload_tiles, k_tiles=k_tiles,
                max_chunk=max_chunk,
                cand_tiles=xs[1] if have_cand else None,
                query_feat=xs[1 + have_cand] if have_feat else None,
                feat_tiles=feat_tiles,
                feat_weight=feat_weight,
                score_prec=score_prec,
                payload_prec=payload_prec,
                payload_xyz=payload_xyz,
            ),
            tuple(parts),
        )
        n = tq * sq
        return d.reshape(-1)[:n], pl.reshape(-1, d_pl)[:n]
    if cand_tiles is None:
        cand_tiles, _ = _candidate_tiles(query_tiles, index, k_tiles)

    qc = _tile_center(query_tiles) if score_prec == "bf16" else None
    q_cen = query_tiles - qc[:, None, :] if qc is not None else query_tiles
    pl_bf16 = payload_prec == "bf16"
    center_pl = pl_bf16 and payload_xyz > 0
    if center_pl and qc is None:
        raise ValueError(
            "payload_prec='bf16' with payload_xyz needs bf16 scoring "
            "(the query-tile centroid that makes centering available)"
        )

    lam2 = jnp.float32(feat_weight) ** 2
    q_ops = [-2.0 * q_cen, jnp.ones((tq, sq, 1), jnp.float32)]
    if query_feat is not None:
        q_ops.append((-2.0 * lam2 * query_feat)[..., None])
    q4 = jnp.concatenate(q_ops, axis=2)

    def fold(carry, kk):
        best_s, best_pl, best_valid = carry
        tid = cand_tiles[:, kk]
        r = index.tiles[tid]  # (Tq, S, 3)
        pl = payload_tiles[tid]  # (Tq, S, D)
        if center_pl:
            pl = jnp.concatenate(
                [pl[..., :payload_xyz] - qc[:, None, :payload_xyz],
                 pl[..., payload_xyz:]], axis=2
            )
        rvalid = jnp.max(jnp.abs(r), axis=2) < 1.0e6  # (Tq, S)
        if qc is not None:
            r = r - qc[:, None, :]
        rr = jnp.sum(r * r, axis=2)
        if query_feat is not None:
            f_r = feat_tiles[tid]  # (Tq, S)
            rr = rr + lam2 * f_r * f_r
            r4 = jnp.concatenate(
                [r, rr[..., None], f_r[..., None]], axis=2
            )
        else:
            r4 = jnp.concatenate([r, rr[..., None]], axis=2)
        score = _score_einsum(q4, r4, score_prec)
        score = jnp.where(rvalid[:, None, :], score, jnp.inf)
        smin = jnp.min(score, axis=2)  # (Tq, Sq)
        # one-hot selection with lowest-lane tiebreak: the payload is
        # always an actual row, never an average of tied rows
        lane = jax.lax.broadcasted_iota(jnp.int32, score.shape, 2)
        s_dim = score.shape[2]
        win = jnp.min(
            jnp.where(score <= smin[..., None], lane, s_dim), axis=2
        )
        if pl_bf16:
            cand_pl = jnp.einsum(
                "tqs,tsd->tqd",
                (lane == win[..., None]).astype(jnp.bfloat16),
                pl.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            )
        else:
            # true fp32 ("highest"): a one-hot row copy must not round
            # the payload (a reduced-precision f32 pass, TF32 on NVIDIA
            # GPUs, would keep ~10 mantissa bits)
            onehot = (lane == win[..., None]).astype(jnp.float32)
            cand_pl = jnp.einsum(
                "tqs,tsd->tqd", onehot, pl, precision="highest"
            )
        cand_ok = jnp.isfinite(smin)
        better = smin < best_s
        return (
            jnp.where(better, smin, best_s),
            jnp.where(better[..., None], cand_pl, best_pl),
            jnp.where(better, cand_ok, best_valid),
        ), None

    init = (
        jnp.full((tq, sq), jnp.inf, jnp.float32),
        jnp.zeros((tq, sq, d_pl), jnp.float32),
        jnp.zeros((tq, sq), bool),
    )
    (best_s, best_pl, best_valid), _ = jax.lax.scan(
        fold, init, jnp.arange(cand_tiles.shape[1]), unroll=True
    )
    if center_pl:
        # un-center in f32; misses keep their zero payload
        best_pl = jnp.concatenate(
            [jnp.where(
                best_valid[..., None],
                best_pl[..., :payload_xyz] + qc[:, None, :payload_xyz],
                0.0,
            ), best_pl[..., payload_xyz:]], axis=2
        )
    qq = jnp.sum(q_cen**2, axis=2)
    if query_feat is not None:
        qq = qq + lam2 * query_feat * query_feat
    d = jnp.maximum(best_s + qq, 0.0)
    d = jnp.where(best_valid, d, jnp.inf)
    return d.reshape(-1), best_pl.reshape(tq * sq, d_pl)


@partial(jax.jit, static_argnames=("k_tiles", "max_chunk", "prec"))
def block_radius_moments(
    query_tiles: jax.Array,
    index: TileIndex,
    radius: jax.Array,
    *,
    k_tiles: int = 8,
    max_chunk: int = 8192,
    prec: str = "highest",
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Neighborhood moments within `radius` of each query — the gather-free
    normal-estimation primitive.

    For every query point, accumulates over all candidate-tile points
    within `radius`:  count, sum(x), sum(x x^T)  — one weighted matmul
    per candidate tile against a 10-feature expansion (coordinates are
    tile-centered first, so the E[xx]-E[x]E[x] covariance subtraction is
    numerically safe in fp32).

    Returns (count (N,), mean (N,3), cov (N,3,3)) with N = Tq*Sq, in
    sorted-query order; zero count where no neighbors. Chunks query tiles
    above `max_chunk` (see block_nn).
    """
    tq, sq, _ = query_tiles.shape
    if tq > max_chunk:
        qt, n_chunks, chunk = _pad_chunks(query_tiles, max_chunk)
        cnt, mean, cov = jax.lax.map(
            lambda q: block_radius_moments(
                q, index, radius, k_tiles=k_tiles, max_chunk=max_chunk,
                prec=prec,
            ),
            qt,
        )
        n = tq * sq
        return (
            cnt.reshape(-1)[:n],
            mean.reshape(-1, 3)[:n],
            cov.reshape(-1, 3, 3)[:n],
        )
    cand_tiles, q_cent = _candidate_tiles(query_tiles, index, k_tiles)
    r2 = radius * radius

    # Center everything on the query-tile centroid for conditioning.
    qc = query_tiles - q_cent[:, None, :]  # (Tq, Sq, 3)
    q4 = jnp.concatenate(
        [-2.0 * qc, jnp.ones((tq, sq, 1), jnp.float32)], axis=2
    )
    qq = jnp.sum(qc * qc, axis=2)  # (Tq, Sq)

    def fold(carry, kk):
        moments = carry  # (Tq, Sq, 10)
        tid = cand_tiles[:, kk]
        r = index.tiles[tid] - q_cent[:, None, :]  # (Tq, S, 3) centered
        rvalid = jnp.max(jnp.abs(r), axis=2) < 1.0e6
        rr = jnp.sum(r * r, axis=2)
        r4 = jnp.concatenate([r, rr[..., None]], axis=2)
        # everything here is already query-tile-centered, so the bf16
        # single-pass score is safe exactly as in block_nn (the radius
        # TEST tolerates border-neighbor flips; normals average k~10+
        # neighbors). The moments einsum below stays true fp32: its
        # outputs are covariance entries, not a ranking.
        score = _score_einsum(q4, r4, prec)  # ||r||^2 - 2 q.r
        d = score + qq[..., None]  # true squared distance
        w = ((d <= r2) & rvalid[:, None, :]).astype(jnp.float32)
        x, y, z = r[..., 0], r[..., 1], r[..., 2]
        feat = jnp.stack(
            [
                jnp.ones_like(x), x, y, z,
                x * x, y * y, z * z,
                x * y, x * z, y * z,
            ],
            axis=2,
        )  # (Tq, S, 10)
        moments = moments + jnp.einsum(
            "tqs,tsf->tqf", w, feat, precision="highest"
        )
        return moments, None

    init = jnp.zeros((tq, sq, 10), jnp.float32)
    moments, _ = jax.lax.scan(
        fold, init, jnp.arange(cand_tiles.shape[1]), unroll=True
    )

    m = moments.reshape(tq * sq, 10)
    cnt = m[:, 0]
    safe = jnp.maximum(cnt, 1.0)[:, None]
    mean_c = m[:, 1:4] / safe  # tile-centered mean
    exx = jnp.stack(
        [
            jnp.stack([m[:, 4], m[:, 7], m[:, 8]], axis=1),
            jnp.stack([m[:, 7], m[:, 5], m[:, 9]], axis=1),
            jnp.stack([m[:, 8], m[:, 9], m[:, 6]], axis=1),
        ],
        axis=1,
    ) / safe[..., None]
    cov = exx - mean_c[:, :, None] * mean_c[:, None, :]
    mean = mean_c + jnp.repeat(q_cent, sq, axis=0)
    return cnt, mean, cov


@partial(jax.jit, static_argnames=("k", "k_tiles"))
def block_knn(
    query_tiles: jax.Array,
    index: TileIndex,
    k: int,
    *,
    k_tiles: int = 8,
) -> Tuple[jax.Array, jax.Array]:
    """k nearest neighbors via the tile index (normal-estimation path).

    Returns (sqdists (Tq*Sq, k) ascending, original ref indices). Same
    candidate-tile semantics as `block_nn`.
    """
    tq, sq, _ = query_tiles.shape
    s = index.tile_size
    cand_tiles, _ = _candidate_tiles(query_tiles, index, k_tiles)

    q4 = jnp.concatenate(
        [-2.0 * query_tiles, jnp.ones((tq, sq, 1), jnp.float32)], axis=2
    )

    def fold(carry, kk):
        best_s, best_p = carry  # (Tq, Sq, k)
        tid = cand_tiles[:, kk]
        r = index.tiles[tid]
        rr = jnp.sum(r * r, axis=2)
        r4 = jnp.concatenate([r, rr[..., None]], axis=2)
        score = jnp.einsum("tqc,tsc->tqs", q4, r4)  # (Tq, Sq, S)
        cs, cloc = jax.lax.top_k(-score, k)  # (Tq, Sq, k)
        cpos = tid[:, None, None] * s + cloc
        all_s = jnp.concatenate([best_s, -cs], axis=2)
        all_p = jnp.concatenate([best_p, cpos], axis=2)
        ns, sel = jax.lax.top_k(-all_s, k)
        return (
            -ns,
            jnp.take_along_axis(all_p, sel, axis=2),
        ), None

    init = (
        jnp.full((tq, sq, k), jnp.inf, jnp.float32),
        jnp.zeros((tq, sq, k), jnp.int32),
    )
    (best_s, best_p), _ = jax.lax.scan(
        fold, init, jnp.arange(cand_tiles.shape[1])
    )

    qq = jnp.sum(query_tiles**2, axis=2)[..., None]
    d = jnp.maximum(best_s + qq, 0.0).reshape(tq * sq, k)
    ridx = index.order[best_p.reshape(tq * sq, k)]
    d = jnp.where(ridx >= 0, d, jnp.inf)
    return d, jnp.maximum(ridx, 0)


def sort_queries(
    xyz: jax.Array, mask: Optional[jax.Array] = None, *, tile_size: int = 256
) -> Tuple[jax.Array, jax.Array]:
    """Morton-sort queries once; returns (query_tiles (Tq,S,3), perm).

    perm maps sorted position -> original row (use to unsort results).
    Rigid motion preserves the sort's spatial coherence, so ICP calls this
    once and transforms the sorted copy every iteration.
    """
    idx = build_tile_index(xyz, mask, tile_size=tile_size)
    t, s = idx.n_tiles, idx.tile_size
    return idx.tiles, idx.order.reshape(-1)
