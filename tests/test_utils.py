"""Metrics sink, checkpoint round-trips, profiling helpers, viz smoke."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icpx.geometry.se3 import SE3
from icpx.utils.checkpoint import (
    OdometryCheckpoint,
    load_checkpoint,
    save_checkpoint,
)
from icpx.utils.metrics import MetricsLogger, icp_iteration_records
from icpx.utils.profiling import kernel_speed_of_light, time_fn


def test_metrics_jsonl(tmp_path):
    path = tmp_path / "m.jsonl"
    with MetricsLogger(path) as m:
        m.log(event="a", x=1.5, arr=jnp.asarray([1.0, 2.0]))
        m.log(event="b", n=np.int64(3))
    lines = [json.loads(l) for l in path.read_text().splitlines()]
    assert lines[0]["event"] == "a" and lines[0]["arr"] == [1.0, 2.0]
    assert lines[1]["n"] == 3


def test_icp_iteration_records():
    from icpx.cloud import PointCloud
    from icpx.io.loaders import synthetic_surface
    from icpx.registration.icp import ICPConfig, register

    src = PointCloud.create(synthetic_surface(500))
    res = register(src, src, ICPConfig(max_iters=3, diff_threshold=0.0))
    recs = icp_iteration_records(res)
    assert len(recs) == 3 and recs[0]["iter"] == 1


def test_checkpoint_pytree_roundtrip(tmp_path, key):
    state = {
        "pose": SE3.random(key),
        "step": jnp.int32(7),
        "hist": jnp.arange(5.0),
    }
    p = tmp_path / "ck.npz"
    save_checkpoint(p, state)
    back = load_checkpoint(p, state)
    assert np.allclose(np.asarray(back["pose"].R), np.asarray(state["pose"].R))
    assert int(back["step"]) == 7


def test_odometry_checkpoint_roundtrip(tmp_path, key):
    poses = SE3.random(key, batch_shape=(4,))
    ck = OdometryCheckpoint(
        frame_index=3,
        poses_R=np.asarray(poses.R),
        poses_t=np.asarray(poses.t),
        keyframe_index=2,
        edges=[(0, 2, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))],
    )
    p = tmp_path / "odo.npz"
    ck.save(p)
    back = OdometryCheckpoint.load(p)
    assert back.frame_index == 3 and back.keyframe_index == 2
    assert len(back.edges) == 1 and back.edges[0][:2] == (0, 2)
    assert np.allclose(back.poses_t, np.asarray(poses.t))
    assert len(back.poses()) == 4


def test_time_fn_blocks_each_rep():
    calls = []

    def f(x):
        calls.append(1)
        return x + 1.0

    t = time_fn(f, jnp.ones(8), reps=3)
    assert t >= 0 and len(calls) == 4  # 1 warmup + 3 reps


def test_speed_of_light():
    kind = "NVIDIA H100 80GB HBM3"
    out = kernel_speed_of_light(
        seconds=1e-3, flops=67e9, hbm_bytes=335e6, device_kind=kind
    )
    assert abs(out["f32_flops_frac"] - 1.0) < 1e-6
    assert abs(out["hbm_frac"] - 0.1) < 1e-6
    assert out["bound_frac"] == out["f32_flops_frac"]


def test_peaks_table_keyed_by_device_kind():
    from icpx.utils.profiling import device_peaks

    p = device_peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes"] == 3.35e12 and p["bf16_flops"] == 989e12
    assert p["power_limit_w"] == 700.0
    with pytest.raises(ValueError, match="no peak table entry"):
        device_peaks("cpu")
    with pytest.raises(ValueError):
        device_peaks()  # the test backend's CPU device is not a peak entry


def test_viz_renders(tmp_path):
    from icpx.cloud import PointCloud
    from icpx.io.loaders import synthetic_surface
    from icpx.viz import render_clouds, render_trajectory

    pc = PointCloud.create(synthetic_surface(500))
    out = tmp_path / "c.png"
    render_clouds(out, [pc, pc], ["a", "b"], title="t")
    assert out.stat().st_size > 1000
    poses = [SE3.identity()] * 3
    out2 = tmp_path / "t.png"
    render_trajectory(out2, poses, poses)
    assert out2.stat().st_size > 1000


def test_collective_traffic_extraction():
    """collective_traffic (the scaling model's input) finds collectives
    and sizes their per-device result bytes from compiled HLO."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from icpx.distributed.mesh import make_mesh
    from icpx.utils.hlo import collective_traffic, shape_bytes

    assert shape_bytes("f32[8,16]{1,0}") == 512
    assert shape_bytes("(f32[2]{0}, s32[4]{0})") == 24
    assert shape_bytes("pred[]") == 1  # scalar: empty dims = 1 element

    mesh = make_mesh(axis_names=("points",))

    @partial(
        jax.shard_map, mesh=mesh, in_specs=P("points"), out_specs=P(),
        check_vma=False,
    )
    def f(x):
        return jax.lax.psum(jnp.sum(x) * jnp.ones((4,), jnp.float32),
                            "points")

    txt = jax.jit(f).lower(jnp.ones((64,), jnp.float32)).compile().as_text()
    rows = collective_traffic(txt)
    ars = [r for r in rows if r.opcode == "all-reduce"]
    assert ars, f"no all-reduce found in {len(rows)} rows"
    assert any(r.bytes == 16 for r in ars), [r.bytes for r in ars]
