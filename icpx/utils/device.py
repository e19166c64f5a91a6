"""What a measurement ran on: the JAX device and, on NVIDIA GPUs, the
card's name and power limit as `nvidia-smi` reports them.

Every benchmark result names its device; a measurement entry point that
finds no GPU fails instead of quietly timing the CPU.
"""

from __future__ import annotations

import subprocess
from typing import Dict


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, read
    in a child process that does not touch JAX."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_record() -> Dict[str, object]:
    """platform / device kind / device count as JAX reports them."""
    import jax

    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
    }


class NoGPUError(RuntimeError):
    """A measurement was asked for where JAX finds no GPU."""


def require_gpu(allow_cpu: bool = False) -> Dict[str, object]:
    """The device record; raises NoGPUError unless JAX's first device is
    a GPU (or `allow_cpu` is set for an explicit CPU rehearsal)."""
    try:
        rec = device_record()
    except RuntimeError as e:  # no backend could initialize
        raise NoGPUError(f"JAX found no usable device: {e}") from None
    if rec["platform"] != "gpu" and not allow_cpu:
        raise NoGPUError(
            f"no GPU: JAX's first device is {rec['platform']!r} "
            f"({rec['kind']}); this entry point measures the GPU only"
        )
    return rec
