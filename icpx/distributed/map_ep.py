"""Expert-parallel map blocks + all-to-all scan routing (SURVEY §2.3
P5/P7): the distributed scan-to-map correspondence engine.

The global map is partitioned into contiguous Morton-key ranges ("map
blocks" = experts), one block per device along the ``blocks`` mesh axis.
A scan (sharded by points) is matched against the map by ROUTING each
point to the device owning its Morton range — the MoE dispatch pattern:

  1. per-point destination = its Morton key's block (searchsorted against
     the static block boundaries);
  2. points pack into fixed-capacity per-destination send buffers
     (capacity factor x fair share; overflow drops like MoE token
     dropping — dropped points return inf and are absorbed by the robust
     gate);
  3. `lax.all_to_all` ships buffers over ICI;
  4. each device answers NN queries against its local block
     (brute/tiled — blocks are small);
  5. a second all-to-all returns (distance, matched xyz+normal payload)
     to the owners, which unpack into original point order.

Boundary effect: a query near a block edge only sees its own block's
points. Extra routing hops (`n_route` > 1) send each point to its
SPATIAL neighbor blocks: the point is perturbed by +-`route_radius`
along each axis, the perturbed Morton keys map to blocks, and the first
distinct non-primary blocks get the remaining hops. (Round-1 used
Morton-ADJACENT ranges, which are not spatially adjacent across octant
seams of the space-filling curve; the Morton mode
remains as `route_mode="morton"`.) Residual misses are genuine-but-worse
matches, handled like block-NN misses.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from icpx import struct

from icpx.cloud import PAD_COORD
from icpx.kernels.blocknn import morton_keys
from icpx.kernels.knn import _nearest_neighbor_jnp


@struct.dataclass
class MapBlocks:
    """A Morton-partitioned map, sharded one block per device.

    Built host-side (or replicated) with `partition_map`; the per-device
    view inside `shard_map` is one row of each array.
    """

    block_xyz: jax.Array  # (B, S, 3) sentinel-padded block points
    block_normals: jax.Array  # (B, S, 3)
    block_mask: jax.Array  # (B, S)
    boundaries: jax.Array  # (B + 1,) morton key range edges
    lo: jax.Array  # (3,) bbox used for morton keys
    inv_extent: jax.Array  # (3,)

    @property
    def n_blocks(self) -> int:
        return self.block_xyz.shape[0]

    @property
    def block_size(self) -> int:
        return self.block_xyz.shape[1]


@partial(jax.jit, static_argnames=("n_blocks",))
def partition_map(
    xyz: jax.Array,
    normals: jax.Array,
    mask: jax.Array,
    *,
    n_blocks: int,
) -> MapBlocks:
    """Split a map cloud into `n_blocks` equal-count Morton-range blocks."""
    n = xyz.shape[0]
    if n % n_blocks:
        raise ValueError(f"map capacity {n} not divisible by {n_blocks}")
    s = n // n_blocks
    lo = jnp.min(jnp.where(mask[:, None], xyz, PAD_COORD), axis=0)
    hi = jnp.max(jnp.where(mask[:, None], xyz, -PAD_COORD), axis=0)
    inv_extent = 1.0 / jnp.maximum(hi - lo, 1e-6)
    keys = morton_keys(xyz, lo, inv_extent)
    keys = jnp.where(mask, keys, jnp.int32(2**30))
    order = jnp.argsort(keys, stable=True)
    sk = keys[order]
    sorted_xyz = jnp.where(mask[order][:, None], xyz[order], PAD_COORD)
    sorted_nrm = jnp.where(mask[order][:, None], normals[order], 0.0)
    sorted_mask = mask[order]
    # Equal-count boundaries: key at each block's first sorted row.
    first = sk[:: s]
    boundaries = jnp.concatenate(
        [jnp.asarray([-(2**30)], jnp.int32), first[1:], jnp.asarray([2**30], jnp.int32)]
    )
    return MapBlocks(
        block_xyz=sorted_xyz.reshape(n_blocks, s, 3),
        block_normals=sorted_nrm.reshape(n_blocks, s, 3),
        block_mask=sorted_mask.reshape(n_blocks, s),
        boundaries=boundaries,
        lo=lo,
        inv_extent=inv_extent,
    )


def routed_map_nn(
    query: jax.Array,  # (Nq_local, 3) this device's scan shard
    my_block_xyz: jax.Array,  # (S, 3) this device's map block
    my_block_normals: jax.Array,  # (S, 3)
    my_block_mask: jax.Array,  # (S,)
    boundaries: jax.Array,  # (B+1,) replicated
    lo: jax.Array,
    inv_extent: jax.Array,
    axis_name: str,
    *,
    capacity_factor: float = 2.0,
    n_route: int = 2,
    tile_q: int = 512,
    tile_r: int = 2048,
    route_mode: str = "spatial",
    route_radius: Optional[float] = None,
    block_index=None,
    block_payload: Optional[jax.Array] = None,
    block_k_tiles: int = 8,
    block_q_tile: int = 1,
    score_prec: str = "highest",
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """All-to-all routed NN (call inside `shard_map` over `axis_name`).

    Returns (sqdist (Nq_local,), matched xyz (Nq_local, 3), matched
    normals (Nq_local, 3)); inf distance for dropped/missed points.

    `route_mode="spatial"` (default) sends extra hops to the blocks the
    point's +-`route_radius` axis perturbations land in (true spatial
    neighbors); "morton" uses Morton-adjacent ranges (round-1 behavior).
    `route_radius` defaults to 4% of the map's mean extent.

    Large blocks: pass `block_index` (a `TileIndex` over this device's
    block, built ONCE per registration — blocks are fixed across ICP
    iterations) plus `block_payload` (the matching flat (S, 6) xyz+normal
    table in sorted tile order) and received queries are answered by
    `block_nn` at O(Nq·K·tile) per hop instead of the brute O(Nq·S)
    (replaces `pcl::search::KdTree`,
    `/root/reference/ICP/myicp.cpp:158`, at map scale). Misses follow
    block-NN semantics: genuine-but-larger distances (robust-gated
    downstream), never wrong values at small distance.

    `block_q_tile=1` (default) ranks candidate tiles PER QUERY: routed
    queries are SPARSE relative to the block (a scan shard against a
    map block), so the single-pair path's per-tile candidate sharing
    collapses — a 64-query Morton tile of scattered queries spans many
    target tiles and k candidates miss ~90% of true NNs (measured on a
    64k block: sq=64/k=16 exact rate 0.10-0.50 by density, sq=1/k=4
    exact 1.0 at every density). Per-query ranking costs k·tile
    candidate rows per query instead of per 64 — the right trade until
    query density approaches block density; raise `block_q_tile` for
    dense-query regimes."""
    n_dev = lax.axis_size(axis_name)
    nq = query.shape[0]
    cap = int(capacity_factor * nq * n_route / n_dev)
    cap = max(64, ((cap + 7) // 8) * 8)

    keys = morton_keys(query, lo, inv_extent)  # (Nq,)
    # block of each point: count of boundaries[1..B-1] <= key
    inner = boundaries[1:-1]  # (B-1,)

    def block_of(k):
        return jnp.sum(
            (k[:, None] >= inner[None, :]).astype(jnp.int32), axis=1
        )  # in [0, B)

    primary = block_of(keys)

    dests = [primary]
    if route_mode == "spatial" and n_route > 1:
        if route_radius is None:
            r = 0.04 * jnp.mean(1.0 / inv_extent)
        else:
            r = jnp.float32(route_radius)
        # blocks of the 6 axis-perturbed positions, in fixed order
        nbr = []
        for a in range(3):
            for sgn in (1.0, -1.0):
                qp = query.at[:, a].add(sgn * r)
                nbr.append(block_of(morton_keys(qp, lo, inv_extent)))
        nbr = jnp.stack(nbr, axis=1)  # (Nq, 6)
        for _ in range(n_route - 1):
            taken = jnp.stack(dests, axis=1)  # (Nq, H)
            is_new = jnp.all(
                nbr[:, :, None] != taken[:, None, :], axis=2
            )  # (Nq, 6)
            first = jnp.argmax(is_new, axis=1)
            any_new = jnp.any(is_new, axis=1)
            pick = jnp.take_along_axis(
                nbr, first[:, None], axis=1
            )[:, 0]
            # no distinct spatial neighbor -> resend to primary (harmless
            # duplicate answer; keeps shapes static)
            dests.append(jnp.where(any_new, pick, primary))
    else:
        for hop in (1, -1, 2, -2)[: max(n_route - 1, 0)]:
            dests.append(jnp.clip(primary + hop, 0, n_dev - 1))

    d_best = jnp.full((nq,), jnp.inf, jnp.float32)
    pl_best = jnp.zeros((nq, 6), jnp.float32)

    for dest in dests:
        # pack: sort by dest, rank within dest, scatter into (B, cap, 3)
        order = jnp.argsort(dest, stable=True)
        sd = dest[order]
        idxs = jnp.arange(nq, dtype=jnp.int32)
        is_first = jnp.concatenate(
            [jnp.ones((1,), bool), sd[1:] != sd[:-1]]
        )
        first_pos = jax.lax.associative_scan(
            jnp.maximum, jnp.where(is_first, idxs, 0)
        )
        rank = idxs - first_pos
        keep = rank < cap
        slot = jnp.where(keep, sd * cap + rank, n_dev * cap)
        send = (
            jnp.full((n_dev * cap, 3), PAD_COORD, jnp.float32)
            .at[slot]
            .set(query[order], mode="drop")
            .reshape(n_dev, cap, 3)
        )
        # remember where each original point went (slot or -1)
        sent_slot = (
            jnp.full((n_dev * cap + 1,), -1, jnp.int32)
            .at[jnp.where(keep, slot, n_dev * cap)]
            .set(order.astype(jnp.int32), mode="drop")
        )[:-1]

        # ship queries to owners; answer; ship answers back
        recv = lax.all_to_all(send, axis_name, 0, 0, tiled=False)
        flat_q = recv.reshape(n_dev * cap, 3)
        nqf = n_dev * cap
        if block_index is not None:
            from icpx.kernels.blocknn import block_nn, sort_queries

            # received queries arrive in destination-packed order (not
            # spatially coherent): Morton-sort them (tile_size=1 default
            # -> per-query candidate ranking, see docstring), answer,
            # unsort. Dropped-slot sentinel rows are masked OUT of the
            # sort (a PAD_COORD row inside the bbox would stretch the
            # Morton extent and collapse all real queries into one cell).
            qmask = jnp.all(jnp.abs(flat_q) < 0.5 * PAD_COORD, axis=1)
            q_tiles, qperm = sort_queries(
                flat_q, qmask, tile_size=block_q_tile
            )
            d2_s, qpos = block_nn(
                q_tiles, block_index,
                k_tiles=block_k_tiles, return_pos=True,
                score_prec=score_prec,
            )
            pl_s = block_payload[qpos]  # coherent sorted-order row gather
            safe_q = jnp.where(qperm >= 0, qperm, nqf)
            d2 = (
                jnp.full((nqf + 1,), jnp.inf, jnp.float32)
                .at[safe_q].set(d2_s, mode="drop")[:nqf]
            )
            matched = (
                jnp.zeros((nqf + 1, 6), jnp.float32)
                .at[safe_q].set(pl_s, mode="drop")[:nqf]
            )
        else:
            d2, li = _nearest_neighbor_jnp(
                flat_q, my_block_xyz, ref_mask=my_block_mask,
                tile_q=tile_q, tile_r=tile_r,
            )
            matched = jnp.concatenate(
                [my_block_xyz[li], my_block_normals[li]], axis=1
            )  # (n_dev*cap, 6)
        ans_d = d2.reshape(n_dev, cap)
        ans_pl = matched.reshape(n_dev, cap, 6)
        back_d = lax.all_to_all(ans_d, axis_name, 0, 0, tiled=False)
        back_pl = lax.all_to_all(ans_pl, axis_name, 0, 0, tiled=False)

        # unpack: slot -> original index
        flat_d = back_d.reshape(n_dev * cap)
        flat_pl = back_pl.reshape(n_dev * cap, 6)
        oi = sent_slot  # (n_dev*cap,) original index or -1
        safe = jnp.where(oi >= 0, oi, nq)
        d_back = (
            jnp.full((nq + 1,), jnp.inf, jnp.float32)
            .at[safe]
            .min(flat_d, mode="drop")[:nq]
        )
        pl_back = (
            jnp.zeros((nq + 1, 6), jnp.float32)
            .at[safe]
            .set(flat_pl, mode="drop")[:nq]
        )
        better = d_back < d_best
        d_best = jnp.where(better, d_back, d_best)
        pl_best = jnp.where(better[:, None], pl_back, pl_best)

    return d_best, pl_best[:, :3], pl_best[:, 3:]


def sharded_map_register(
    scan,
    map_blocks: MapBlocks,
    config,
    mesh,
    init=None,
    *,
    axis: str = "blocks",
    capacity_factor: float = 2.0,
    n_route: int = 2,
    nn: str = "auto",
):
    """Scan-to-map ICP: scan points sharded, map blocks expert-parallel.

    The scan cloud must carry normals (estimate first); its capacity and
    the map's block count must match the mesh axis size. Returns the same
    `ICPResult` as `register`.

    `nn`: "brute" answers routed queries against the whole local block
    per hop (fine for small blocks); "block" builds a per-device
    `TileIndex` ONCE per registration (blocks are fixed across
    iterations) and answers via `block_nn`; "auto" picks block when the
    block size reaches `config.block_auto_threshold` (the same crossover
    the single-pair path uses).
    """
    from jax.sharding import PartitionSpec as P

    from icpx.geometry.se3 import SE3
    from icpx.registration.icp import _icp_scan, result_struct

    n_dev = mesh.shape[axis]
    if map_blocks.n_blocks != n_dev:
        raise ValueError(
            f"map has {map_blocks.n_blocks} blocks but mesh axis '{axis}' "
            f"has {n_dev} devices"
        )
    if scan.capacity % n_dev:
        raise ValueError(
            f"scan capacity {scan.capacity} not divisible by {n_dev}"
        )
    if scan.normals is None:
        raise ValueError("scan must carry normals (estimate_normals first)")
    if init is None:
        init = SE3.identity()
    reduce = partial(lax.psum, axis_name=axis)
    if nn not in ("auto", "brute", "block"):
        raise ValueError(f"nn must be auto|brute|block, got {nn!r}")
    use_block = nn == "block" or (
        nn == "auto"
        and map_blocks.block_size >= config.block_auto_threshold
    )

    out_specs = jax.tree_util.tree_map(
        lambda _: P(),
        result_struct(),
    )

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(axis, None),  # scan xyz (sharded by points)
            P(axis),  # scan mask
            P(axis, None),  # scan normals
            P(axis, None, None),  # block xyz (one block per device)
            P(axis, None, None),  # block normals
            P(axis, None),  # block mask
            P(None),  # boundaries (replicated)
            P(None),
            P(None),
            P(),  # init R
            P(),  # init t
        ),
        out_specs=out_specs,
        check_vma=False,
    )
    def run(s_xyz, s_mask, s_n, b_xyz, b_n, b_mask, bounds, lo, inv_e, iR, it):
        if use_block:
            from icpx.kernels.blocknn import fused_payload_table

            # built ONCE per registration (outside the ICP while_loop):
            # the map block never moves, only the scan does
            b_idx = config.tile_builder()(
                b_xyz[0], b_mask[0], tile_size=config.block_tile
            )
            b_pl = fused_payload_table(b_idx, b_n[0])
        else:
            b_idx = b_pl = None

        def nn_fn(p):
            d2, q, n_q = routed_map_nn(
                p,
                b_xyz[0],
                b_n[0],
                b_mask[0],
                bounds,
                lo,
                inv_e,
                axis,
                capacity_factor=capacity_factor,
                n_route=n_route,
                block_index=b_idx,
                block_payload=b_pl,
                block_k_tiles=config.block_k,
                score_prec=config.resolve_score_prec(),
            )
            return q, n_q, jnp.sqrt(d2)

        return _icp_scan(
            config, s_xyz, s_mask, s_n, SE3(R=iR, t=it), nn_fn, reduce
        )

    return run(
        scan.xyz,
        scan.mask,
        scan.normals,
        map_blocks.block_xyz,
        map_blocks.block_normals,
        map_blocks.block_mask,
        map_blocks.boundaries,
        map_blocks.lo,
        map_blocks.inv_extent,
        init.R,
        init.t,
    )
