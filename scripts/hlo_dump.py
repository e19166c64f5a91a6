"""HLO inspection harness: dump compiled HLO + cost/memory analysis for the hot programs,
and print the collective-overlap report for the sharded paths.

Usage:
  python scripts/hlo_dump.py fold [--n 8388608] [--out /tmp/fold.hlo]
      the 8M-regime refine fold step (cost + temp-memory analysis)
  python scripts/hlo_dump.py ring [--out /tmp/ring.hlo]
      ring-block registration on the 8-device virtual mesh + overlap report
  python scripts/hlo_dump.py ep [--out /tmp/ep.hlo]
      EP all-to-all map registration + overlap report

The overlap analysis itself lives in icpx.utils.hlo and is enforced by
tests/test_hlo_overlap.py; this script is for eyeballing the artifacts.
"""

import argparse


def dump_fold(n: int, out: str):
    import jax
    import jax.numpy as jnp

    import icpx  # noqa: F401  (precision discipline)
    from icpx.kernels.blocknn import TileIndex, block_nn_payload

    S, SQ = 128, 128
    T = n // S
    tq = n // SQ

    def fold(q, cand, tiles, box_lo, box_hi, cent, order, pl_tiles):
        idx = TileIndex(tiles=tiles, box_lo=box_lo, box_hi=box_hi,
                        centroids=cent, order=order)
        return block_nn_payload(q, idx, pl_tiles, k_tiles=6,
                                max_chunk=32768, cand_tiles=cand,
                                score_prec="bf16", payload_prec="highest")

    sh = jax.ShapeDtypeStruct
    args = (sh((tq, SQ, 3), jnp.float32), sh((tq, 6), jnp.int32),
            sh((T, S, 3), jnp.float32), sh((T, 3), jnp.float32),
            sh((T, 3), jnp.float32), sh((T, 3), jnp.float32),
            sh((T * S,), jnp.int32), sh((T, S, 6), jnp.float32))
    comp = jax.jit(fold).lower(*args).compile()
    txt = comp.as_text()
    with open(out, "w") as fh:
        fh.write(txt)
    ca = comp.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    print("flops %.3g" % ca.get("flops", -1),
          "bytes %.3g" % ca.get("bytes accessed", -1))
    mem = comp.memory_analysis()
    print("temp GB", getattr(mem, "temp_size_in_bytes", 0) / 1e9)
    print("hlo ->", out)


def _force_cpu_mesh():
    import os

    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")


def dump_ring(out: str):
    _force_cpu_mesh()
    import jax
    import numpy as np

    from icpx.cloud import PointCloud
    from icpx.distributed.mesh import make_mesh
    from icpx.distributed.sharded_icp import sharded_register
    from icpx.io.loaders import synthetic_surface
    from icpx.kernels.normals import estimate_normals
    from icpx.registration.icp import ICPConfig
    from icpx.utils.hlo import overlap_reports

    xyz = synthetic_surface(1024, seed=0)
    src = estimate_normals(PointCloud.create(xyz), k=8)
    tgt = estimate_normals(
        PointCloud.create(np.asarray(xyz)[::-1].copy()), k=8
    )
    cfg = ICPConfig(objective="symmetric", max_iters=3, diff_threshold=1e-6,
                    nn_method="block", block_tile=32, block_q_tile=16,
                    block_k=4)
    mesh = make_mesh(axis_names=("points",))

    def run(s, t):
        r = sharded_register(s, t, cfg, mesh, ring=True)
        return r.transform.R, r.transform.t

    txt = jax.jit(run).lower(src, tgt).compile().as_text()
    with open(out, "w") as fh:
        fh.write(txt)
    for r in overlap_reports(txt, ["collective-permute"]):
        print(f"{r.computation}: {r.opcode} indep={r.n_independent}/"
              f"{r.n_compute_ops} anc={r.compute_ancestors} "
              f"desc={r.compute_descendants} overlappable={r.overlappable}")
    print("hlo ->", out)


def dump_ep(out: str):
    _force_cpu_mesh()
    import jax
    import numpy as np

    from icpx.cloud import PointCloud
    from icpx.distributed.map_ep import partition_map, sharded_map_register
    from icpx.distributed.mesh import make_mesh
    from icpx.kernels.normals import estimate_normals
    from icpx.registration.icp import ICPConfig
    from icpx.utils.hlo import overlap_reports

    rng = np.random.default_rng(0)
    world_xyz = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
    world = estimate_normals(PointCloud.create(world_xyz), k=8)
    mb = partition_map(world.xyz, world.normals, world.mask, n_blocks=8)
    scan = estimate_normals(
        PointCloud.create(world_xyz[::4][:1024].copy(), capacity=1024), k=8
    )
    cfg = ICPConfig(objective="p2plane", max_iters=3, diff_threshold=1e-6,
                    max_corr_dist=0.3, tile_q=128, tile_r=256)
    mesh = make_mesh(axis_names=("blocks",))

    def run(s, blocks):
        r = sharded_map_register(s, blocks, cfg, mesh)
        return r.transform.R, r.transform.t

    txt = jax.jit(run).lower(scan, mb).compile().as_text()
    with open(out, "w") as fh:
        fh.write(txt)
    for r in overlap_reports(txt, ["all-to-all"]):
        print(f"{r.computation}: {r.opcode} indep={r.n_independent}/"
              f"{r.n_compute_ops} anc={r.compute_ancestors} "
              f"desc={r.compute_descendants}")
    print("hlo ->", out)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["fold", "ring", "ep"])
    ap.add_argument("--n", type=int, default=8 * 1024 * 1024)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    out = a.out or f"/tmp/{a.what}.hlo"
    if a.what == "fold":
        dump_fold(a.n, out)
    elif a.what == "ring":
        dump_ring(out)
    else:
        dump_ep(out)
