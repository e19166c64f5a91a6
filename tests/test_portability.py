"""What the package needs from its environment: the in-repo pytree
helper that replaced flax.struct, an import of icpx (and the main path)
with flax absent, the compile-cache location, the stall-watchdog
default, and entry points that refuse to measure without a GPU."""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icpx import struct

ROOT = Path(__file__).resolve().parents[1]


@struct.dataclass
class _Node:
    a: jax.Array
    b: Optional[jax.Array] = None
    name: str = struct.field(pytree_node=False, default="x")


def test_struct_flatten_unflatten_roundtrip():
    n = _Node(a=jnp.arange(3.0), b=jnp.ones(2), name="y")
    leaves, tree = jax.tree_util.tree_flatten(n)
    assert len(leaves) == 2
    back = jax.tree_util.tree_unflatten(tree, [x * 2 for x in leaves])
    assert isinstance(back, _Node) and back.name == "y"
    np.testing.assert_array_equal(back.a, [0.0, 2.0, 4.0])
    # None children are empty subtrees, not leaves
    assert len(jax.tree_util.tree_leaves(_Node(a=jnp.ones(1)))) == 1


def test_struct_replace_and_frozen():
    n = _Node(a=jnp.zeros(2))
    m = n.replace(name="z", b=jnp.ones(2))
    assert m.name == "z" and n.name == "x" and n.b is None
    with pytest.raises(dataclasses.FrozenInstanceError):
        n.a = jnp.ones(2)


def test_struct_static_fields_key_jit_cache():
    traces = []

    @jax.jit
    def f(node):
        traces.append(node.name)
        return node.a.sum()

    f(_Node(a=jnp.ones(2), name="p"))
    f(_Node(a=jnp.zeros(2), name="p"))
    f(_Node(a=jnp.ones(2), name="q"))
    assert traces == ["p", "q"]  # static field in the treedef


def test_core_pytrees_use_the_helper():
    """Every core pytree (cloud, SE3, tile index, results) round-trips
    through tree_map, including PointCloud's static feat_names."""
    from icpx.cloud import PointCloud

    pc = PointCloud.create(
        np.zeros((5, 3), np.float32), feats=np.ones((5, 1), np.float32),
        feat_names=("intensity",),
    )
    out = jax.tree_util.tree_map(lambda x: x, pc)
    assert out.feat_names == ("intensity",)
    assert out.capacity == pc.capacity


_NO_FLAX = textwrap.dedent(
    """
    import sys

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name == "flax" or name.startswith("flax."):
                raise ImportError("flax is blocked for this test")

    sys.meta_path.insert(0, _Block())
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, {root!r})
    import icpx
    import chip_smoke
    chip_smoke.phase_cat(reps=0)
    chip_smoke.phase_pair(8192, "b", reps=0)
    chip_smoke.phase_pair(8192, "c", reps=0, payload_infold_threshold=4096)
    chip_smoke.phase_odometry(n_frames=3, scan_points=1024, reps=0)
    assert "flax" not in sys.modules
    print("NO_FLAX_OK")
    """
)


def test_import_and_main_path_without_flax():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", _NO_FLAX.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_FLAX_OK" in out.stdout


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    from icpx import cli

    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.delenv("ICPX_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    cli._enable_compile_cache()
    # JAX reads the variable itself; the program sets no other path
    assert "jax_compilation_cache_dir" not in calls
    assert not (tmp_path / "c").exists()  # nothing created by the program


def test_compile_cache_fixed_in_checkout(monkeypatch, tmp_path):
    from icpx import cli

    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.delenv("ICPX_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(cli, "COMPILE_CACHE_DIR", tmp_path / ".jax_cache")
    cli._enable_compile_cache()
    assert calls["jax_compilation_cache_dir"] == str(tmp_path / ".jax_cache")
    assert (tmp_path / ".jax_cache").is_dir()
    # the real default sits at the checkout root and is gitignored
    monkeypatch.undo()
    assert cli.COMPILE_CACHE_DIR == ROOT / ".jax_cache"
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_stall_watchdog_only_in_multiprocess_runs(monkeypatch):
    from icpx.distributed.fault import default_stall_timeout

    assert default_stall_timeout() == 0.0
    assert default_stall_timeout(warmup=True) == 0.0
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    assert default_stall_timeout() == 600.0
    assert default_stall_timeout(warmup=True) == 1200.0


def test_require_gpu_refuses_cpu():
    from icpx.utils.device import NoGPUError, require_gpu

    with pytest.raises(NoGPUError, match="no GPU"):
        require_gpu()
    rec = require_gpu(allow_cpu=True)
    assert rec["platform"] == "cpu" and rec["count"] == 8


def test_chip_smoke_exits_nonzero_without_gpu(capsys):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    assert chip_smoke.main([]) != 0
    captured = capsys.readouterr()
    assert "no GPU" in captured.err and '"ok"' not in captured.out


def test_chip_smoke_alone_fails_without_the_repo(tmp_path):
    """Copied into a directory with nothing else of the repo, the script
    exits non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text()
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
