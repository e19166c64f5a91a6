"""Scan-to-keyframe odometry frontend.

The reference registers exactly one pair per process run (`main.cpp:8-10`);
this is the multi-scan extension (SURVEY §7 layer 5): sequential scans are
registered against the current keyframe with a constant-velocity initial
guess, new keyframes spawn when motion exceeds thresholds, and
keyframe-to-keyframe relative transforms accumulate into pose-graph edges
for the backend (`icpx.odometry.posegraph`).

All frames must share one capacity so every registration reuses the same
compiled executable.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from icpx.cloud import PointCloud
from icpx.geometry.se3 import SE3
from icpx.kernels.normals import estimate_normals
from icpx.registration.icp import ICPConfig, ICPResult, register
from icpx.registration.pyramid import PyramidConfig, register_pyramid


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    icp: ICPConfig = ICPConfig(
        objective="symmetric",
        max_iters=12,
        diff_threshold=0.0,
        rmse_change_tol=1e-6,
        robust="huber",
    )
    pyramid_levels: int = 1  # 1 = single resolution
    pyramid_subsample: int = 4
    keyframe_trans: float = 0.5  # spawn keyframe beyond this motion
    keyframe_rot: float = 0.15  # radians
    constant_velocity_init: bool = True
    # Velocity-model smoothing (EMA in twist space). In locally-degenerate
    # scenes the raw constant-velocity init forms a positive feedback loop
    # with IRLS correspondence bias (measured runaway 1.27m max rel err ->
    # 0.04m with fixed 0.7 smoothing on a smooth-ground world),
    # but a FIXED factor lags aggressive motion. Default = ADAPTIVE: the
    # blend factor scales with the innovation magnitude
    # ||log(velocity^-1 vel_raw)||, so smooth scenes (tiny innovations:
    # exactly the runaway feedback regime) get heavy smoothing while
    # genuine accelerations (large innovations) pass through un-lagged.
    # Set velocity_damping < 1.0 for a fixed factor (overrides adaptive),
    # or adaptive_velocity=False with damping 1.0 for the raw model.
    velocity_damping: float = 1.0
    adaptive_velocity: bool = True
    # innovation (trans[m] + rot_weight*rot[rad]) at which the adaptive
    # blend reaches 1.0 (full adoption); below it, smoothing strengthens
    # linearly down to velocity_damping_min.
    innovation_scale: float = 0.5
    velocity_damping_min: float = 0.25
    # "scan_to_keyframe": register against the latest keyframe cloud.
    # "scan_to_map": register against a maintained voxel map (keyframes
    # merge into it) — drifts less, costs a map insert per keyframe.
    mode: str = "scan_to_keyframe"
    map_capacity: int = 65536
    map_cell: float = 0.1
    # Motion sanity gate: a registration whose pose moved further than
    # this from its initial guess is rejected (finite-but-wrong solutions
    # snowball through the constant-velocity model into divergence); the
    # frame dead-reckons on the motion model instead. <= 0 disables.
    max_correction_trans: float = 1.0
    max_correction_rot: float = 0.5
    # Dynamic-object rejection: after a frame's pose is accepted, points
    # whose residual to the keyframe exceeds `dynamic_sigma` x the median
    # residual are masked OUT of the frame before it can become a
    # keyframe / enter the map — moving objects (residuals ~ object
    # motion, not registration noise) never contaminate the reference
    # geometry. One extra NN pass per accepted frame. 0 disables.
    dynamic_sigma: float = 0.0
    dynamic_min_keep: float = 0.5  # never mask more than this fraction away
    # Incremental pose-graph backend over keyframes: "sliding_window"
    # maintains a SlidingWindowBackend (posegraph.py) during the run —
    # each spawned keyframe and its measured edge enter the window, the
    # window is optimized, nodes older than `window` are Schur-
    # marginalized into a dense prior, and the refined poses feed back
    # into the frontend's keyframe chain. "none" = raw odometry chain.
    backend: str = "none"
    window: int = 10
    # Stall watchdog (SURVEY §5.3): each frame's device fence runs under
    # a HeartbeatMonitor and raises CollectiveStallError after this many
    # seconds instead of hanging silently (the multi-host lost-peer
    # mode). 0 disables; -1 = auto (on only when jax.process_count() > 1,
    # see fault.default_stall_timeout).
    stall_timeout_s: float = -1.0


@dataclasses.dataclass
class MotionState:
    """Frontend motion-model state (checkpointed for exact resume)."""

    prev_rel: SE3  # kf_T_frame of the latest frame
    velocity: SE3  # smoothed inter-frame twist
    model_warm: bool
    consecutive_rejects: int


@dataclasses.dataclass
class OdometryResult:
    poses: List[SE3]  # world_T_frame per input frame
    is_keyframe: List[bool]
    rmse: List[float]
    # pose-graph edges between consecutive keyframes:
    edges: List[Tuple[int, int, SE3]]  # (frame_i, frame_j, i_T_j)
    keyframe_indices: List[int]
    # motion-model state after the last frame (None for empty runs);
    # feed back through run_odometry(resume=...) for exact continuation
    motion: Optional[MotionState] = None
    # post-scrub validity masks per keyframe (aligned with
    # keyframe_indices), populated when dynamic_sigma > 0 — checkpointed
    # so a resumed run registers against the same scrubbed reference
    # geometry as the uninterrupted one
    keyframe_masks: Optional[List] = None
    # the live SlidingWindowBackend when backend="sliding_window" — its
    # MarginalPrior + active window are checkpointed so resume is
    # bit-exact (re-marginalizing from saved
    # estimates produced a different prior than the uninterrupted run)
    window: Optional[object] = None


def blend_velocity(
    velocity: SE3,
    vel_raw: SE3,
    *,
    damping: float = 1.0,
    adaptive: bool = True,
    innovation_scale: float = 0.5,
    damping_min: float = 0.25,
    rot_weight: float = 1.0,
) -> SE3:
    """Twist-space EMA of the constant-velocity model (jit-safe; shared by
    the host frontend and the compiled whole-sequence path).

    b = damping when a fixed factor is configured (< 1.0); otherwise, when
    adaptive, b = clip(innovation / innovation_scale, damping_min, 1.0)
    with innovation = ||delta_t|| + rot_weight * ||delta_omega|| of
    log(velocity^-1 vel_raw). Zero steady-state lag for constant twist
    (circle arcs included); a cold start or a genuine acceleration has a
    large innovation and is adopted at b ~ 1 immediately.
    """
    if damping >= 1.0 and not adaptive:
        return vel_raw
    v_log = velocity.log()
    r_log = vel_raw.log()
    if damping < 1.0:
        b = jnp.float32(damping)
    else:
        delta = (velocity.inverse() @ vel_raw).log()
        innov = rot_weight * jnp.linalg.norm(
            delta[..., :3]
        ) + jnp.linalg.norm(delta[..., 3:])
        b = jnp.clip(
            innov / jnp.float32(innovation_scale), damping_min, 1.0
        )
    return SE3.exp((1.0 - b) * v_log + b * r_log)


def _mask_dynamic(
    frame: PointCloud, ref: PointCloud, rel: SE3, sigma: float,
    min_keep: float,
) -> PointCloud:
    """Mask out points whose post-registration residual to the reference
    cloud is an outlier (moving objects): residual > sigma * median.
    Falls back to keeping everything if the mask would drop more than
    (1 - min_keep) of the frame (e.g. genuinely poor overlap, where the
    median itself is inflated)."""
    from icpx.kernels.knn import nearest_neighbor
    from icpx.registration.step import _masked_quantile

    p = rel.apply(frame.xyz)
    d2, _ = nearest_neighbor(p, ref.xyz, ref_mask=ref.mask)
    dist = jnp.sqrt(d2)
    valid = frame.mask
    med = _masked_quantile(dist, valid.astype(jnp.float32), 0.5)
    keep = dist <= sigma * jnp.maximum(med, 1e-6)
    frac = (keep & valid).sum() / jnp.maximum(valid.sum(), 1)
    keep = keep | (frac < min_keep)
    return frame.replace(mask=valid & keep)


def _register_pair(
    src: PointCloud, tgt: PointCloud, cfg: OdometryConfig, init: SE3
) -> ICPResult:
    if cfg.pyramid_levels > 1:
        res, _ = register_pyramid(
            src,
            tgt,
            PyramidConfig(
                levels=cfg.pyramid_levels,
                subsample=cfg.pyramid_subsample,
                base=cfg.icp,
            ),
            init=init,
        )
        return res
    return register(src, tgt, cfg.icp, init=init)


def run_odometry(
    frames: Sequence[PointCloud],
    config: OdometryConfig = OdometryConfig(),
    resume: Optional["object"] = None,
) -> OdometryResult:
    """Sequential odometry over sensor-frame scans.

    Returns world poses with pose[0] = identity (world = first frame).

    `resume` continues a previous run exactly (SURVEY §5.4 "resume
    mid-sequence"): pass an `icpx.utils.checkpoint.OdometryCheckpoint`
    saved from a prior (possibly killed) run together with the FULL frame
    sequence; frames up to the checkpoint's `frame_index` are skipped and
    the restored keyframe/motion state makes the continuation bit-match an
    uninterrupted run.
    """
    if len(frames) == 0:
        return OdometryResult([], [], [], [], [])

    # Pre-compute normals once per frame (each frame serves as src and
    # possibly tgt later).
    frames = [
        f if f.normals is not None else estimate_normals(f, k=config.icp.k_normals)
        for f in frames
    ]

    poses: List[SE3] = [SE3.identity()]
    is_kf = [True]
    rmses = [0.0]
    edges: List[Tuple[int, int, SE3]] = []
    kf_indices = [0]

    use_map = config.mode == "scan_to_map"
    if use_map:
        from icpx.odometry.mapping import VoxelMap, insert_scan

        vmap = VoxelMap.create(
            config.map_capacity,
            config.map_cell,
            feat_names=frames[0].feat_names,
        )
        vmap = insert_scan(vmap, frames[0], SE3.identity())

    win = None
    if config.backend == "sliding_window":
        from icpx.odometry.posegraph import SlidingWindowBackend

        win = SlidingWindowBackend(window=config.window)
        win.add_keyframe(SE3.identity())
    elif config.backend != "none":
        raise ValueError(f"unknown backend {config.backend!r}")

    kf_cloud = frames[0]
    kf_pose = SE3.identity()
    kf_index = 0
    # kf_T_frame of the previous frame, and the last inter-frame delta.
    prev_rel = SE3.identity()
    velocity = SE3.identity()
    model_warm = False  # motion model untrustworthy until one accept
    consecutive_rejects = 0
    # which keyframe each frame's world pose chained from (the sliding-
    # window backend re-anchors non-keyframe poses when it refines
    # keyframes); keyframes are updated directly via their window node
    anchors: List[int] = [0]
    kf_masks: Optional[List] = (
        [np.asarray(frames[0].mask)] if config.dynamic_sigma > 0 else None
    )
    start = 1

    if resume is not None:
        ck = resume
        if ck.frame_index >= len(frames):
            raise ValueError(
                f"checkpoint frame_index {ck.frame_index} beyond the "
                f"{len(frames)} provided frames"
            )
        if ck.is_keyframe is None:
            raise ValueError(
                "checkpoint lacks resumable state (is_keyframe); it was "
                "saved by an older version or hand-built — cannot resume"
            )
        poses = ck.poses()
        is_kf = [bool(v) for v in ck.is_keyframe]
        rmses = [float(v) for v in (ck.rmse if ck.rmse is not None else [])]
        edges = [
            (int(i), int(j), SE3(R=jnp.asarray(R), t=jnp.asarray(t)))
            for (i, j, R, t) in ck.edges
        ]
        # the run that saved the checkpoint appended a closing edge for
        # its final segment; drop it (it is re-closed below at the new end)
        if (
            edges
            and edges[-1][1] == ck.frame_index
            and ck.frame_index != ck.keyframe_index
        ):
            edges.pop()
        kf_index = ck.keyframe_index
        kf_indices = [i for i, v in enumerate(is_kf) if v] or [0]
        # rebuild the keyframe-anchor chain for the restored frames
        anchors = [0]
        last_kf = 0
        for i in range(1, len(poses)):
            anchors.append(last_kf)
            if i < len(is_kf) and is_kf[i]:
                last_kf = i
        if config.dynamic_sigma > 0:
            if getattr(ck, "kf_masks", None) is None:
                raise ValueError(
                    "resume with dynamic_sigma > 0 needs the checkpoint's "
                    "keyframe masks (saved by runs with scrubbing on); "
                    "this checkpoint has none"
                )
            kf_masks = []
            for i, fi in enumerate(kf_indices):
                m = jnp.asarray(ck.kf_masks[i])
                frames[fi] = frames[fi].replace(mask=m)
                kf_masks.append(np.asarray(m))
        kf_cloud = frames[kf_index]
        kf_pose = poses[kf_index]
        if ck.motion_R is not None:
            prev_rel = SE3(
                R=jnp.asarray(ck.motion_R[0]), t=jnp.asarray(ck.motion_t[0])
            )
            velocity = SE3(
                R=jnp.asarray(ck.motion_R[1]), t=jnp.asarray(ck.motion_t[1])
            )
            model_warm = bool(ck.model_warm)
            consecutive_rejects = int(ck.consecutive_rejects)
        else:
            prev_rel = kf_pose.inverse() @ poses[ck.frame_index]
        if use_map:
            # rebuild the map from the checkpointed keyframes
            vmap = VoxelMap.create(
                config.map_capacity,
                config.map_cell,
                feat_names=frames[0].feat_names,
            )
            for i in kf_indices:
                vmap = insert_scan(vmap, frames[i], poses[i])
        if win is not None:
            win.poses = [poses[fi] for fi in kf_indices]
            if getattr(ck, "win_active0", None) is not None:
                # exact window state was checkpointed (surviving edges,
                # active0, MarginalPrior) — restore it verbatim so the
                # resumed run is bit-exact with the uninterrupted one
                win.active0 = int(ck.win_active0)
                win.edges = [
                    (i, j, SE3(R=jnp.asarray(R), t=jnp.asarray(t)), w)
                    for (i, j, R, t, w) in (ck.win_edges or [])
                ]
                if ck.win_prior_nodes is not None:
                    from icpx.odometry.posegraph import MarginalPrior

                    win.prior = MarginalPrior(
                        nodes=jnp.asarray(ck.win_prior_nodes),
                        H=jnp.asarray(ck.win_prior_H),
                        b=jnp.asarray(ck.win_prior_b),
                        lin=SE3(
                            R=jnp.asarray(ck.win_prior_lin_R),
                            t=jnp.asarray(ck.win_prior_lin_t),
                        ),
                    )
            else:
                # legacy checkpoint without window state: rebuild from
                # keyframes + edges and re-marginalize from the saved
                # estimates (close but not bit-exact)
                remap = {f: i for i, f in enumerate(kf_indices)}
                for (i, j, T) in edges:
                    if i in remap and j in remap:
                        win.add_edge(remap[i], remap[j], T)
                win.marginalize_to_window()
        start = ck.frame_index + 1

    from icpx.distributed.fault import default_stall_timeout, guarded_call

    stall_t = (
        default_stall_timeout()
        if config.stall_timeout_s < 0
        else config.stall_timeout_s
    )

    for k in range(start, len(frames)):
        init = prev_rel @ velocity if config.constant_velocity_init else prev_rel
        if use_map:
            # target = the world-frame map; transform is world_T_frame
            world_init = kf_pose @ init
            res = _register_pair(frames[k], vmap.as_cloud(), config, world_init)
            pose = res.transform
            rel = kf_pose.inverse() @ pose
        else:
            res = _register_pair(frames[k], kf_cloud, config, init)
            rel = res.transform  # kf_T_frame
            pose = kf_pose @ rel

        # Motion sanity gate: dead-reckon instead of accepting a jump.
        # Only once the motion model is warm (>= 1 accepted frame) — a
        # cold init IS far from the solution by construction — and with a
        # recovery valve: after 2 consecutive rejections, accept whatever
        # ICP found rather than dead-reckon into divergence forever.
        correction = init.inverse() @ rel
        # This scalar fetch is the frame's device-completion fence; under
        # the watchdog a stalled device/host raises instead of hanging
        # (checkpoint + --resume is the recovery path).
        corr_t = guarded_call(
            lambda c=correction: float(jnp.linalg.norm(c.t)), stall_t
        )
        # the remaining per-frame fetches ride the same watchdog: a
        # stalled collective can hold ANY device round trip, not just
        # the first
        corr_r, rel_t_np, res_rmse = guarded_call(
            lambda: (
                float(correction.rotation_angle()),
                np.asarray(rel.t),
                float(res.final_rmse),
            ),
            stall_t,
        )
        finite = np.isfinite(corr_t) and np.isfinite(rel_t_np).all()
        gate_on = (
            config.max_correction_trans > 0
            and model_warm
            and consecutive_rejects < 2
        )
        rejected = (not finite) or (
            gate_on
            and (
                corr_t > config.max_correction_trans
                or corr_r > config.max_correction_rot
            )
        )
        if rejected:
            rel = init
            pose = kf_pose @ rel
            rmses.append(float("inf"))
            consecutive_rejects += 1
        else:
            rmses.append(res_rmse)
            consecutive_rejects = 0
            model_warm = True
        poses.append(pose)
        anchors.append(kf_index)
        vel_raw = prev_rel.inverse() @ rel
        velocity = blend_velocity(
            velocity,
            vel_raw,
            damping=config.velocity_damping,
            adaptive=config.adaptive_velocity,
            innovation_scale=config.innovation_scale,
            damping_min=config.velocity_damping_min,
        )

        trans = float(jnp.linalg.norm(rel.t))
        rot = float(rel.rotation_angle())
        # rejected (dead-reckoned) frames never become keyframes or map
        # insertions: their pose is uncertain and would poison the map
        if (not rejected) and (
            trans > config.keyframe_trans or rot > config.keyframe_rot
        ):
            if config.dynamic_sigma > 0:
                # scrub moving objects before this frame becomes the
                # reference geometry (keyframe / map insertion)
                frames[k] = _mask_dynamic(
                    frames[k],
                    kf_cloud,
                    rel,
                    config.dynamic_sigma,
                    config.dynamic_min_keep,
                )
            edges.append((kf_index, k, rel))
            kf_cloud = frames[k]
            kf_pose = pose
            kf_index = k
            kf_indices.append(k)
            is_kf.append(True)
            prev_rel = SE3.identity()
            if kf_masks is not None:
                kf_masks.append(np.asarray(frames[k].mask))
            if win is not None:
                node = win.add_keyframe(pose)
                win.add_edge(node - 1, node, rel)
                win.step()  # optimize active window + marginalize
                # adopt refined keyframe poses (active + frozen) AND
                # re-anchor every non-keyframe pose on its keyframe's
                # correction, keeping the returned trajectory internally
                # consistent
                deltas = {}
                for off, fi in enumerate(kf_indices):
                    new_p = win.poses[off]
                    deltas[fi] = new_p @ poses[fi].inverse()
                    poses[fi] = new_p
                for f in range(1, len(poses)):
                    a = anchors[f]
                    if not is_kf[f] and a in deltas:
                        poses[f] = deltas[a] @ poses[f]
                kf_pose = win.poses[-1]
                pose = kf_pose
            if use_map:
                vmap = insert_scan(vmap, frames[k], pose)
        else:
            is_kf.append(False)
            prev_rel = rel

    # close the final segment so the pose graph spans the whole run
    if kf_index != len(frames) - 1:
        edges.append((kf_index, len(frames) - 1, prev_rel))

    return OdometryResult(
        poses=poses,
        is_keyframe=is_kf,
        rmse=rmses,
        edges=edges,
        keyframe_indices=kf_indices,
        motion=MotionState(
            prev_rel=prev_rel,
            velocity=velocity,
            model_warm=model_warm,
            consecutive_rejects=consecutive_rejects,
        ),
        keyframe_masks=kf_masks,
        window=win,
    )
