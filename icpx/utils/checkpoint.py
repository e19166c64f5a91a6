"""Checkpoint / resume (SURVEY §5.4 — absent in the reference).

Saves arbitrary pytrees of arrays (odometry state: poses, pose-graph
edges, keyframe clouds, RNG keys, iteration counters) as an .npz with a
JSON-encoded treedef manifest — dependency-free and portable. A restarted
odometry job resumes from the last saved frame (`OdometryCheckpoint`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, List, Optional, Tuple

import jax
import numpy as np

from icpx.geometry.se3 import SE3


def save_checkpoint(path, pytree) -> None:
    """Save a pytree of arrays. Containers: dict/list/tuple/SE3/dataclass
    pytrees registered with jax."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves, treedef = jax.tree_util.tree_flatten(pytree)
    arrays = {f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)}
    manifest = {"treedef": str(treedef), "n_leaves": len(leaves)}
    tmp = path.with_suffix(path.suffix + ".tmp")
    np.savez_compressed(
        tmp, __manifest__=json.dumps(manifest), **arrays
    )
    # np.savez appends .npz to the tmp name
    tmp_real = tmp if tmp.exists() else tmp.with_suffix(tmp.suffix + ".npz")
    os.replace(tmp_real, path)


def load_checkpoint(path, like) -> Any:
    """Load a checkpoint saved by `save_checkpoint` into the structure of
    `like` (an example pytree with the same treedef)."""
    with np.load(Path(path), allow_pickle=False) as z:
        manifest = json.loads(str(z["__manifest__"]))
        n = manifest["n_leaves"]
        leaves = [z[f"leaf_{i}"] for i in range(n)]
    treedef = jax.tree_util.tree_structure(like)
    if treedef.num_leaves != n:
        raise ValueError(
            f"checkpoint has {n} leaves, template has {treedef.num_leaves}"
        )
    saved_def = manifest.get("treedef")
    if saved_def is not None and saved_def != str(treedef):
        raise ValueError(
            "checkpoint tree structure does not match the template:\n"
            f"  saved:    {saved_def}\n  template: {treedef}"
        )
    return jax.tree_util.tree_unflatten(treedef, leaves)


@dataclasses.dataclass
class OdometryCheckpoint:
    """Resumable odometry state (host-side container).

    The optional per-frame arrays and motion-model state (`is_keyframe`,
    `rmse`, `motion_R/motion_t` = stacked [prev_rel, velocity],
    `model_warm`, `consecutive_rejects`) make `run_odometry(resume=...)`
    continue bit-exactly; older checkpoints without them still load (with
    those fields None) for pose/edge inspection.
    """

    frame_index: int
    poses_R: np.ndarray  # (M, 3, 3)
    poses_t: np.ndarray  # (M, 3)
    keyframe_index: int
    edges: List[Tuple[int, int, np.ndarray, np.ndarray]]  # (i, j, R, t)
    is_keyframe: Optional[np.ndarray] = None  # (M,) bool
    rmse: Optional[np.ndarray] = None  # (M,) float32
    motion_R: Optional[np.ndarray] = None  # (2, 3, 3): prev_rel, velocity
    motion_t: Optional[np.ndarray] = None  # (2, 3)
    model_warm: bool = False
    consecutive_rejects: int = 0
    # (K, N) bool post-scrub keyframe validity masks (dynamic-object
    # rejection); required to resume runs with dynamic_sigma > 0
    kf_masks: Optional[np.ndarray] = None
    # sliding-window backend state (backend="sliding_window"): the
    # MarginalPrior is a plain pytree — checkpointing it makes resume
    # bit-exact (re-marginalizing from saved
    # estimates linearizes at different points than the original run).
    # `win_active0` = first non-marginalized WINDOW node id;
    # `win_edges` = surviving window edges (i, j, R, t, weight) in
    # window-node ids; `win_prior_*` = MarginalPrior fields (None when
    # no marginalization has happened yet).
    win_active0: Optional[int] = None
    win_edges: Optional[List[Tuple[int, int, np.ndarray, np.ndarray, float]]] = None
    win_prior_nodes: Optional[np.ndarray] = None  # (P,) int32 window ids
    win_prior_H: Optional[np.ndarray] = None  # (P*6, P*6)
    win_prior_b: Optional[np.ndarray] = None  # (P*6,)
    win_prior_lin_R: Optional[np.ndarray] = None  # (P, 3, 3)
    win_prior_lin_t: Optional[np.ndarray] = None  # (P, 3)

    @classmethod
    def from_result(cls, result) -> "OdometryCheckpoint":
        """Build from a `frontend.OdometryResult` (full resumable state)."""
        m = result.motion
        return cls(
            frame_index=len(result.poses) - 1,
            poses_R=np.stack([np.asarray(p.R) for p in result.poses]),
            poses_t=np.stack([np.asarray(p.t) for p in result.poses]),
            keyframe_index=result.keyframe_indices[-1],
            edges=[
                (i, j, np.asarray(T.R), np.asarray(T.t))
                for (i, j, T) in result.edges
            ],
            is_keyframe=np.asarray(result.is_keyframe, bool),
            rmse=np.asarray(result.rmse, np.float32),
            motion_R=(
                np.stack([np.asarray(m.prev_rel.R), np.asarray(m.velocity.R)])
                if m is not None
                else None
            ),
            motion_t=(
                np.stack([np.asarray(m.prev_rel.t), np.asarray(m.velocity.t)])
                if m is not None
                else None
            ),
            model_warm=bool(m.model_warm) if m is not None else False,
            consecutive_rejects=(
                int(m.consecutive_rejects) if m is not None else 0
            ),
            kf_masks=(
                np.stack(result.keyframe_masks)
                if result.keyframe_masks is not None
                else None
            ),
            **cls._window_fields(getattr(result, "window", None)),
        )

    @staticmethod
    def _window_fields(win) -> dict:
        """Serialize a SlidingWindowBackend's resume-critical state."""
        if win is None:
            return {}
        out = {
            "win_active0": int(win.active0),
            "win_edges": [
                (int(i), int(j), np.asarray(m.R), np.asarray(m.t), float(w))
                for (i, j, m, w) in win.edges
            ],
        }
        if win.prior is not None:
            out.update(
                win_prior_nodes=np.asarray(win.prior.nodes, np.int32),
                win_prior_H=np.asarray(win.prior.H, np.float32),
                win_prior_b=np.asarray(win.prior.b, np.float32),
                win_prior_lin_R=np.asarray(win.prior.lin.R, np.float32),
                win_prior_lin_t=np.asarray(win.prior.lin.t, np.float32),
            )
        return out

    def save(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        extra = {}
        if self.is_keyframe is not None:
            extra["is_keyframe"] = np.asarray(self.is_keyframe, bool)
        if self.rmse is not None:
            extra["rmse"] = np.asarray(self.rmse, np.float32)
        if self.motion_R is not None:
            extra["motion_R"] = self.motion_R
            extra["motion_t"] = self.motion_t
            extra["model_warm"] = np.asarray(self.model_warm)
            extra["consecutive_rejects"] = np.asarray(
                self.consecutive_rejects, np.int32
            )
        if self.kf_masks is not None:
            extra["kf_masks"] = np.asarray(self.kf_masks, bool)
        if self.win_active0 is not None:
            we = self.win_edges or []
            extra["win_active0"] = np.asarray(self.win_active0, np.int32)
            extra["win_edge_i"] = np.asarray([e[0] for e in we], np.int32)
            extra["win_edge_j"] = np.asarray([e[1] for e in we], np.int32)
            extra["win_edge_R"] = (
                np.stack([e[2] for e in we])
                if we
                else np.zeros((0, 3, 3), np.float32)
            )
            extra["win_edge_t"] = (
                np.stack([e[3] for e in we])
                if we
                else np.zeros((0, 3), np.float32)
            )
            extra["win_edge_w"] = np.asarray(
                [e[4] for e in we], np.float32
            )
            if self.win_prior_nodes is not None:
                extra["win_prior_nodes"] = self.win_prior_nodes
                extra["win_prior_H"] = self.win_prior_H
                extra["win_prior_b"] = self.win_prior_b
                extra["win_prior_lin_R"] = self.win_prior_lin_R
                extra["win_prior_lin_t"] = self.win_prior_lin_t
        np.savez_compressed(
            path,
            frame_index=self.frame_index,
            poses_R=self.poses_R,
            poses_t=self.poses_t,
            keyframe_index=self.keyframe_index,
            edge_i=np.asarray([e[0] for e in self.edges], np.int32),
            edge_j=np.asarray([e[1] for e in self.edges], np.int32),
            edge_R=(
                np.stack([e[2] for e in self.edges])
                if self.edges
                else np.zeros((0, 3, 3), np.float32)
            ),
            edge_t=(
                np.stack([e[3] for e in self.edges])
                if self.edges
                else np.zeros((0, 3), np.float32)
            ),
            **extra,
        )

    @classmethod
    def load(cls, path) -> "OdometryCheckpoint":
        with np.load(Path(path)) as z:
            edges = [
                (int(i), int(j), R, t)
                for i, j, R, t in zip(
                    z["edge_i"], z["edge_j"], z["edge_R"], z["edge_t"]
                )
            ]
            return cls(
                frame_index=int(z["frame_index"]),
                poses_R=z["poses_R"],
                poses_t=z["poses_t"],
                keyframe_index=int(z["keyframe_index"]),
                edges=edges,
                is_keyframe=z["is_keyframe"] if "is_keyframe" in z else None,
                rmse=z["rmse"] if "rmse" in z else None,
                motion_R=z["motion_R"] if "motion_R" in z else None,
                motion_t=z["motion_t"] if "motion_t" in z else None,
                model_warm=(
                    bool(z["model_warm"]) if "model_warm" in z else False
                ),
                consecutive_rejects=(
                    int(z["consecutive_rejects"])
                    if "consecutive_rejects" in z
                    else 0
                ),
                kf_masks=z["kf_masks"] if "kf_masks" in z else None,
                win_active0=(
                    int(z["win_active0"]) if "win_active0" in z else None
                ),
                win_edges=(
                    [
                        (int(i), int(j), R, t, float(w))
                        for i, j, R, t, w in zip(
                            z["win_edge_i"],
                            z["win_edge_j"],
                            z["win_edge_R"],
                            z["win_edge_t"],
                            z["win_edge_w"],
                        )
                    ]
                    if "win_active0" in z
                    else None
                ),
                win_prior_nodes=(
                    z["win_prior_nodes"] if "win_prior_nodes" in z else None
                ),
                win_prior_H=z["win_prior_H"] if "win_prior_H" in z else None,
                win_prior_b=z["win_prior_b"] if "win_prior_b" in z else None,
                win_prior_lin_R=(
                    z["win_prior_lin_R"] if "win_prior_lin_R" in z else None
                ),
                win_prior_lin_t=(
                    z["win_prior_lin_t"] if "win_prior_lin_t" in z else None
                ),
            )

    def poses(self) -> List[SE3]:
        import jax.numpy as jnp

        return [
            SE3(R=jnp.asarray(R), t=jnp.asarray(t))
            for R, t in zip(self.poses_R, self.poses_t)
        ]
