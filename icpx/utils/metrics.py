"""Structured metrics: JSONL sink + per-iteration ICP records.

Replaces the reference's only observability — `cout` prints of iteration
number and diff (`myicp.cpp:125-126`) — with machine-readable records
(SURVEY §5.5): every run can emit {iter, diff, rmse, inliers} rows plus
arbitrary scalars, consumable by the bench harness.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Union

import numpy as np


class MetricsLogger:
    """Append-only JSONL metrics sink.

    Usage: `with MetricsLogger(path) as m: m.log(event="icp", rmse=...)`.
    `path=None` collects in memory only (`.records`).
    """

    def __init__(self, path: Union[str, os.PathLike, None] = None):
        self.path = Path(path) if path is not None else None
        self.records: List[Dict[str, Any]] = []
        self._fh = None

    def __enter__(self) -> "MetricsLogger":
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")
        return self

    def __exit__(self, *exc) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def log(self, **fields: Any) -> Dict[str, Any]:
        rec = {"ts": time.time()}
        for k, v in fields.items():
            rec[k] = _jsonable(v)
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec


def _jsonable(v: Any) -> Any:
    if isinstance(v, (np.floating, np.integer)):
        v = v.item()
    elif hasattr(v, "tolist"):
        arr = np.asarray(v)
        v = arr.item() if arr.ndim == 0 else arr.tolist()
    # strict-JSON safety: json.dumps would emit the bare token `Infinity`
    # for nonfinite floats, which non-Python consumers reject
    if isinstance(v, float) and not np.isfinite(v):
        return None
    if isinstance(v, list):
        return [
            None if isinstance(x, float) and not np.isfinite(x) else x
            for x in v
        ]
    return v


def icp_iteration_records(result) -> List[Dict[str, Any]]:
    """Expand an ICPResult's history arrays into per-iteration records."""
    diffs = np.asarray(result.diff_history)
    rmses = np.asarray(result.rmse_history)
    out = []
    for i, (d, r) in enumerate(zip(diffs, rmses)):
        if np.isnan(d):
            break
        out.append({"iter": i + 1, "diff": float(d), "rmse": float(r)})
    return out
