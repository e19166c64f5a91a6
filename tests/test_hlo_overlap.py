"""Hardware-independent proof of the ring/EP comm-overlap story.

XLA's latency-hiding scheduler can only convert a collective into an
async start/done pair bracketing independent compute when the def-use
graph permits it. The CPU virtual-mesh compiler emits the SAME loop body
with a synchronous collective (verified: 0 start/done pairs on CPU), so
the graph property — collectives neither feed nor are fed by the fold's
heavy compute within an iteration — is checkable here and is exactly the
precondition for overlap on real chips. These tests fail if a refactor
ever serializes the ring (e.g. threads a fold result into the permuted
carry).
"""

import dataclasses

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from icpx.cloud import PointCloud
from icpx.distributed.mesh import make_mesh
from icpx.geometry.se3 import SE3
from icpx.io.loaders import synthetic_surface
from icpx.kernels.normals import estimate_normals
from icpx.registration.icp import ICPConfig
from icpx.utils.hlo import (
    assert_overlappable,
    overlap_reports,
    parse_computations,
)

SYNTH_HLO = """
HloModule test

%body (p: (f32[8], f32[8])) -> (f32[8], f32[8]) {
  %p = (f32[8]{0}, f32[8]{0}) parameter(0)
  %gte.0 = f32[8]{0} get-tuple-element(%p), index=0
  %gte.1 = f32[8]{0} get-tuple-element(%p), index=1
  %dot.0 = f32[8]{0} dot(%gte.0, %gte.0), lhs_contracting_dims={}, rhs_contracting_dims={}
  %cp.0 = f32[8]{0} collective-permute(%gte.1), source_target_pairs={{0,1},{1,0}}
  ROOT %tup = (f32[8]{0}, f32[8]{0}) tuple(%dot.0, %cp.0)
}

%bad_body (q: (f32[8], f32[8])) -> (f32[8], f32[8]) {
  %q = (f32[8]{0}, f32[8]{0}) parameter(0)
  %gte.2 = f32[8]{0} get-tuple-element(%q), index=0
  %dot.1 = f32[8]{0} dot(%gte.2, %gte.2), lhs_contracting_dims={}, rhs_contracting_dims={}
  %cp.1 = f32[8]{0} collective-permute(%dot.1), source_target_pairs={{0,1},{1,0}}
  ROOT %tup.1 = (f32[8]{0}, f32[8]{0}) tuple(%dot.1, %cp.1)
}
"""


def test_parser_and_verdicts_on_synthetic_hlo():
    comps = parse_computations(SYNTH_HLO)
    assert set(comps) == {"body", "bad_body"}
    reports = {r.computation: r for r in overlap_reports(SYNTH_HLO)}
    # body: permute independent of the dot -> overlappable
    assert reports["body"].overlappable
    assert reports["body"].n_independent == 1
    # bad_body: permute consumes the dot -> serialized, caught
    assert not reports["bad_body"].overlappable
    assert reports["bad_body"].compute_ancestors == 1
    with pytest.raises(AssertionError, match="serialized"):
        assert_overlappable(SYNTH_HLO, ["collective-permute"])


def _ring_pair(n=1024):
    xyz = synthetic_surface(n, seed=0)
    src = estimate_normals(PointCloud.create(xyz), k=8)
    tgt = estimate_normals(
        PointCloud.create(np.asarray(xyz)[::-1].copy()), k=8
    )
    return src, tgt


def test_ring_block_nn_permutes_overlap_fold():
    """Every ppermute in the compiled ring-block registration loop body
    (index tiles + boxes + centroids + payload) is schedule-independent
    of the fold compute: 0 compute ancestors, 0 descendants, with the
    whole per-shard fold available to hide it behind."""
    from icpx.distributed.sharded_icp import sharded_register

    src, tgt = _ring_pair()
    cfg = ICPConfig(
        objective="symmetric", max_iters=3, diff_threshold=1e-6,
        nn_method="block", block_tile=32, block_q_tile=16, block_k=4,
    )
    mesh = make_mesh(axis_names=("points",))

    def run(s, t):
        r = sharded_register(s, t, cfg, mesh, ring=True)
        return r.transform.R, r.transform.t

    txt = jax.jit(run).lower(src, tgt).compile().as_text()
    reports = assert_overlappable(txt, ["collective-permute"])
    assert len(reports) >= 4  # tiles, box_lo, box_hi, centroids, payload
    assert all(r.compute_descendants == 0 for r in reports)
    assert min(r.n_independent for r in reports) >= 10


def test_brute_ring_permutes_overlap_fold():
    """Same property for the brute ring (`ring_nearest_neighbor`)."""
    from icpx.distributed.sharded_icp import sharded_register

    src, tgt = _ring_pair()
    cfg = ICPConfig(
        objective="symmetric", max_iters=3, diff_threshold=1e-6,
        nn_method="brute", tile_q=128, tile_r=128,
    )
    mesh = make_mesh(axis_names=("points",))

    def run(s, t):
        r = sharded_register(s, t, cfg, mesh, ring=True)
        return r.transform.R, r.transform.t

    txt = jax.jit(run).lower(src, tgt).compile().as_text()
    reports = assert_overlappable(txt, ["collective-permute"])
    assert len(reports) >= 2  # shard coords + mask (+ payload)


def test_ep_all_to_all_overlap_structure():
    """EP routing's all-to-all ops must not wait on heavy compute inside
    their computation (routing tables are cheap iota/sort products kept
    off the COMPUTE_OPCODES critical path would be too strict — here we
    pin the weaker but still load-bearing property that at least one
    all-to-all coexists with independent compute it could hide behind)."""
    from icpx.distributed.map_ep import partition_map, sharded_map_register

    rng = np.random.default_rng(0)
    world_xyz = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
    world = estimate_normals(PointCloud.create(world_xyz), k=8)
    mb = partition_map(world.xyz, world.normals, world.mask, n_blocks=8)
    scan = estimate_normals(
        PointCloud.create(world_xyz[::4][:1024].copy(), capacity=1024), k=8
    )
    cfg = ICPConfig(
        objective="p2plane", max_iters=3, diff_threshold=1e-6,
        max_corr_dist=0.3, tile_q=128, tile_r=256,
    )
    mesh = make_mesh(axis_names=("blocks",))

    def run(s, blocks):
        r = sharded_map_register(s, blocks, cfg, mesh)
        return r.transform.R, r.transform.t

    txt = jax.jit(run).lower(scan, mb).compile().as_text()
    reports = overlap_reports(txt, ["all-to-all"])
    assert reports, "no all-to-all in compiled EP module"
    assert any(r.n_independent > 0 for r in reports)
