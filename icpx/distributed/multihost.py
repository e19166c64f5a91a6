"""Multi-host bring-up (SURVEY §2.3 P8, §5.8).

JAX's native runtime is the communication backend: no NCCL/MPI/Gloo —
`jax.distributed.initialize` wires the hosts, XLA compiles every
collective (psum/all_gather/ppermute/all_to_all) onto ICI within a slice
and DCN across slices. This module is the thin, testable bring-up layer:
environment-driven initialization, the global mesh helper, and a
host-data sharding utility.

Single-host processes (tests, the CPU mesh, one chip) skip
initialization transparently; everything in icpx.distributed works
unchanged because mesh axes are the only abstraction the algorithms see.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize the JAX distributed runtime when running multi-host.

    Arguments default from the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, or a
    cluster environment that initialize() autodetects).
    Returns True if multi-host initialization happened.
    """
    num = num_processes or _env_int("JAX_NUM_PROCESSES")
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    pid = process_id if process_id is not None else _env_int("JAX_PROCESS_ID")
    if addr is None and num is None:
        # managed clusters autodetect; bare single-host does nothing.
        try:
            if jax.process_count() > 1:
                return True
        except RuntimeError:
            pass
        return False
    jax.distributed.initialize(
        coordinator_address=addr,
        num_processes=num,
        process_id=pid,
    )
    return True


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def global_mesh(
    axis_names: Sequence[str] = ("hosts", "points"),
) -> Mesh:
    """A mesh spanning all processes' devices: first axis = hosts, the
    rest over each host's local devices."""
    devs = np.asarray(jax.devices())
    n_hosts = jax.process_count()
    local = len(devs) // n_hosts
    shape = (n_hosts, local) if len(axis_names) == 2 else (len(devs),)
    return Mesh(devs.reshape(shape), tuple(axis_names))


def host_local_shard(array: np.ndarray, axis: int = 0) -> np.ndarray:
    """This host's contiguous slice of a host-sharded numpy array (data
    loading: each host reads only its shard of the scan list / point
    rows)."""
    n = array.shape[axis]
    pc, pid = jax.process_count(), jax.process_index()
    per = n // pc
    sl = [slice(None)] * array.ndim
    sl[axis] = slice(pid * per, (pid + 1) * per)
    return array[tuple(sl)]
