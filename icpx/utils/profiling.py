"""Profiling helpers: wall timers, jax.profiler traces, speed-of-light
estimates (SURVEY §5.1 — the reference has no timing code at all).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax


class Timer:
    """Wall-clock timer that blocks on device results.

    with Timer() as t: out = f(x)
    t.elapsed -> seconds (f's outputs must be passed to t.block(out) or
    be side-effect-free sync code).
    """

    def __init__(self):
        self.elapsed = 0.0
        self._t0 = 0.0

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0

    def block(self, out):
        jax.block_until_ready(out)
        return out


def time_fn(fn, *args, reps: int = 5, warmup: int = 1):
    """Median wall seconds of fn(*args), each rep ended by
    `jax.block_until_ready` on its outputs (warmup reps compile)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


@contextlib.contextmanager
def trace_context(log_dir: str):
    """jax.profiler trace scope (view with TensorBoard / Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# Published peaks per device kind (`jax.devices()[0].device_kind`).
# NVIDIA H100 SXM5 data sheet and Hopper architecture white paper: dense
# rates without sparsity, at the board's full 700 W power limit. A card
# run below that limit cannot hold its top clock under load, so report
# its `power.limit` beside any share of these peaks.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "hbm_bytes": 3.35e12,
        "power_limit_w": 700.0,
    },
}


def device_peaks(device_kind: Optional[str] = None) -> Dict[str, float]:
    """Peak table entry for `device_kind` (default: the first JAX device).
    A kind with no published entry is an error, never a default."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return dict(PEAKS[device_kind])
    except KeyError:
        raise ValueError(
            f"no peak table entry for device kind {device_kind!r}; known: "
            f"{sorted(PEAKS)}"
        ) from None


def kernel_speed_of_light(
    *,
    seconds: float,
    flops: float = 0.0,
    hbm_bytes: float = 0.0,
    device_kind: Optional[str] = None,
) -> Dict[str, float]:
    """Fraction-of-peak summary for a measured kernel time.

    `flops` counts fp32 operations outside the tensor cores. Returns
    utilization fractions + the bound-resource estimate (the max
    fraction: what the kernel is limited by if it were at peak).
    """
    p = device_peaks(device_kind)
    out = {}
    if flops:
        out["f32_flops_frac"] = flops / seconds / p["f32_flops"]
    if hbm_bytes:
        out["hbm_frac"] = hbm_bytes / seconds / p["hbm_bytes"]
    out["bound_frac"] = max(out.values()) if out else 0.0
    return out
