"""Expert-parallel map blocks + all-to-all routed NN (P5/P7) on the faked
8-device mesh: routing recall vs brute force, and scan-to-map ICP."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from icpx.cloud import PointCloud
from icpx.distributed.map_ep import (
    MapBlocks,
    partition_map,
    routed_map_nn,
    sharded_map_register,
)
from icpx.distributed.mesh import make_mesh
from icpx.geometry.se3 import SE3
from icpx.io.loaders import synthetic_surface
from icpx.kernels.knn import _nearest_neighbor_jnp
from icpx.kernels.normals import estimate_normals
from icpx.registration.icp import ICPConfig


def _map_cloud(n=8192, seed=0):
    xyz = synthetic_surface(n, seed=seed)
    pc = estimate_normals(PointCloud.create(xyz, capacity=n), k=8)
    return pc


def test_partition_map_blocks():
    pc = _map_cloud(4096)
    mb = partition_map(pc.xyz, pc.normals, pc.mask, n_blocks=8)
    assert mb.block_xyz.shape == (8, 512, 3)
    assert int(mb.block_mask.sum()) == 4096
    # boundaries are monotonically non-decreasing
    b = np.asarray(mb.boundaries)
    assert (np.diff(b) >= 0).all()


def test_routed_nn_recall():
    mesh = make_mesh(axis_names=("blocks",))
    pc = _map_cloud(8192, seed=0)
    mb = partition_map(pc.xyz, pc.normals, pc.mask, n_blocks=8)
    q = synthetic_surface(2048, seed=1)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P("blocks", None),
            P("blocks", None, None),
            P("blocks", None, None),
            P("blocks", None),
            P(None),
            P(None),
            P(None),
        ),
        out_specs=(P("blocks"), P("blocks", None)),
        check_vma=False,
    )
    def run(qs, bx, bn, bm, bounds, lo, inv_e):
        d, mx, mn = routed_map_nn(
            qs, bx[0], bn[0], bm[0], bounds, lo, inv_e, "blocks",
            n_route=2, tile_q=256, tile_r=512,
        )
        return d, mx

    d, mx = run(
        jnp.asarray(q), mb.block_xyz, mb.block_normals, mb.block_mask,
        mb.boundaries, mb.lo, mb.inv_extent,
    )
    d_ref, _ = _nearest_neighbor_jnp(jnp.asarray(q), pc.xyz, ref_mask=pc.mask)
    d, d_ref = np.asarray(d), np.asarray(d_ref)
    found = np.isfinite(d)
    assert found.mean() > 0.98
    exact = (d[found] <= d_ref[found] + 1e-6).mean()
    assert exact > 0.95, f"routed exact-NN rate {exact}"
    # matched coordinates are consistent with reported distances
    dd = ((q[found] - np.asarray(mx)[found]) ** 2).sum(1)
    assert np.allclose(dd, d[found], rtol=1e-3, atol=1e-5)


def test_sharded_map_register_converges():
    mesh = make_mesh(axis_names=("blocks",))
    world = _map_cloud(8192, seed=3)
    mb = partition_map(world.xyz, world.normals, world.mask, n_blocks=8)
    # scan = subsample of the world, perturbed by a small rigid motion
    scan_xyz = world.to_numpy()[::4][:2048]
    gt = SE3.from_axis_angle(
        jnp.asarray([0.0, 0.0, 1.0]), 0.06, jnp.asarray([0.03, -0.02, 0.01])
    )
    scan = PointCloud.create(
        np.asarray(gt.inverse().apply(jnp.asarray(scan_xyz))), capacity=2048
    )
    scan = estimate_normals(scan, k=8)
    cfg = ICPConfig(
        objective="p2plane",
        max_iters=10,
        diff_threshold=1e-5,
        max_corr_dist=0.3,
        tile_q=256,
        tile_r=512,
    )
    res = sharded_map_register(scan, mb, cfg, mesh)
    rot_err, t_err = res.transform.distance_to(gt)
    assert float(rot_err) < 5e-3, float(rot_err)
    assert float(t_err) < 5e-3, float(t_err)


def test_mismatched_blocks_raises():
    mesh = make_mesh(axis_names=("blocks",))
    pc = _map_cloud(1024)
    mb = partition_map(pc.xyz, pc.normals, pc.mask, n_blocks=4)
    scan = estimate_normals(PointCloud.create(synthetic_surface(256)), k=8)
    with pytest.raises(ValueError):
        sharded_map_register(scan, mb, ICPConfig(), mesh)

def test_spatial_routing_beats_morton_at_seams():
    """Morton-adjacent blocks are not spatially
    adjacent across octant seams; spatial routing (axis-perturbed keys)
    must recover strictly more exact NNs on a uniform-volume map where
    seams cut through dense geometry."""
    rng = np.random.default_rng(7)
    xyz = rng.uniform(-1, 1, (8192, 3)).astype(np.float32)
    pc = estimate_normals(PointCloud.create(xyz, capacity=8192), k=8)
    mb = partition_map(pc.xyz, pc.normals, pc.mask, n_blocks=8)
    q = rng.uniform(-1, 1, (2048, 3)).astype(np.float32)
    mesh = make_mesh(axis_names=("blocks",))

    def run_mode(mode):
        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(
                P("blocks", None),
                P("blocks", None, None),
                P("blocks", None, None),
                P("blocks", None),
                P(None),
                P(None),
                P(None),
            ),
            out_specs=P("blocks"),
            check_vma=False,
        )
        def run(qs, bx, bn, bm, bounds, lo, inv_e):
            d, _, _ = routed_map_nn(
                qs, bx[0], bn[0], bm[0], bounds, lo, inv_e, "blocks",
                n_route=2, tile_q=256, tile_r=512, route_mode=mode,
            )
            return d

        return np.asarray(
            run(jnp.asarray(q), mb.block_xyz, mb.block_normals,
                mb.block_mask, mb.boundaries, mb.lo, mb.inv_extent)
        )

    d_ref, _ = _nearest_neighbor_jnp(jnp.asarray(q), pc.xyz, ref_mask=pc.mask)
    d_ref = np.asarray(d_ref)

    def exact_rate(d):
        found = np.isfinite(d)
        return ((d <= d_ref + 1e-6) & found).mean()

    r_spatial = exact_rate(run_mode("spatial"))
    r_morton = exact_rate(run_mode("morton"))
    assert r_spatial >= r_morton, (r_spatial, r_morton)
    assert r_spatial > 0.97, f"spatial exact-NN rate {r_spatial}"


def test_block_answering_matches_brute_at_64k_blocks():
    """Routed NN with per-block TileIndex answering
    agrees with brute block answering to the documented block-NN miss
    semantics: almost all answers exact, misses strictly larger distances
    (never wrong values at small distance)."""
    mesh = make_mesh(axis_names=("blocks",))
    n_map = 8 * 65536
    world = PointCloud.create(
        synthetic_surface(n_map, seed=5), capacity=n_map
    )
    world = estimate_normals(world, k=8)
    mb = partition_map(world.xyz, world.normals, world.mask, n_blocks=8)
    assert mb.block_size == 65536
    q = synthetic_surface(2048, seed=6)
    cfg = ICPConfig()  # block_tile / block_k defaults

    def run_nn(use_block):
        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(
                P("blocks", None),
                P("blocks", None, None),
                P("blocks", None, None),
                P("blocks", None),
                P(None),
                P(None),
                P(None),
            ),
            out_specs=(P("blocks"), P("blocks", None)),
            check_vma=False,
        )
        def run(qs, bx, bn, bm, bounds, lo, inv_e):
            if use_block:
                from icpx.kernels.blocknn import fused_payload_table

                b_idx = cfg.tile_builder()(
                    bx[0], bm[0], tile_size=cfg.block_tile
                )
                b_pl = fused_payload_table(b_idx, bn[0])
            else:
                b_idx = b_pl = None
            d, mx, mn = routed_map_nn(
                qs, bx[0], bn[0], bm[0], bounds, lo, inv_e, "blocks",
                n_route=2, tile_q=512, tile_r=4096,
                block_index=b_idx, block_payload=b_pl,
                block_k_tiles=cfg.block_k,
            )
            return d, mx

        d, mx = run(
            jnp.asarray(q), mb.block_xyz, mb.block_normals, mb.block_mask,
            mb.boundaries, mb.lo, mb.inv_extent,
        )
        return np.asarray(d), np.asarray(mx)

    d_blk, mx_blk = run_nn(True)
    d_brt, _ = run_nn(False)
    found = np.isfinite(d_blk) & np.isfinite(d_brt)
    assert found.mean() > 0.98
    # miss semantics: block answers are >= brute (larger genuine
    # distance on a candidate miss), and exact almost everywhere (the
    # per-query candidate ranking, block_q_tile=1, measured exact 1.0
    # at every query density — see routed_map_nn docstring)
    assert (d_blk[found] >= d_brt[found] - 1e-5).all()
    exact = (d_blk[found] <= d_brt[found] + 1e-6).mean()
    assert exact > 0.99, f"block-vs-brute exact rate {exact}"
    # matched coordinates consistent with reported distances
    dd = ((q[found] - mx_blk[found]) ** 2).sum(1)
    np.testing.assert_allclose(dd, d_blk[found], rtol=1e-3, atol=1e-5)


def test_sharded_map_register_block_nn_converges():
    """sharded_map_register(nn="block") — the large-block operating point
    — recovers the pose like the brute path."""
    mesh = make_mesh(axis_names=("blocks",))
    world = _map_cloud(8192, seed=3)
    mb = partition_map(world.xyz, world.normals, world.mask, n_blocks=8)
    scan_xyz = world.to_numpy()[::4][:2048]
    gt = SE3.from_axis_angle(
        jnp.asarray([0.0, 0.0, 1.0]), 0.06, jnp.asarray([0.03, -0.02, 0.01])
    )
    scan = PointCloud.create(
        np.asarray(gt.inverse().apply(jnp.asarray(scan_xyz))), capacity=2048
    )
    scan = estimate_normals(scan, k=8)
    cfg = ICPConfig(
        objective="p2plane",
        max_iters=10,
        diff_threshold=1e-5,
        max_corr_dist=0.3,
        tile_q=256,
        tile_r=512,
    )
    res = sharded_map_register(scan, mb, cfg, mesh, nn="block")
    rot_err, t_err = res.transform.distance_to(gt)
    assert float(rot_err) < 5e-3, float(rot_err)
    assert float(t_err) < 5e-3, float(t_err)
