"""Pose-graph backend: batched Gauss-Newton over SE(3) with Schur
marginalization (SURVEY §2.3 P9).

Nodes are keyframe poses, edges are relative-pose measurements from the
frontend (or loop closures). Everything is batched and jit-compiled:

  * per-edge residual r_e = log(meas^-1 . (T_i E(d_i))^-1 . (T_j E(d_j)))
    with E = SE3.exp; the (6,6) Jacobian blocks w.r.t. d_i, d_j come from
    `jax.jacfwd` vmapped over edges — exact linearization, no hand-derived
    adjoint approximations to get wrong;
  * the 6Mx6M normal system assembles by scatter-add of edge blocks
    (edges are the DP axis: per-edge contributions are plain sums, so a
    sharded variant just psums them — same pattern as the ICP JtJ);
  * gauge freedom fixed by a strong prior on the anchor node;
  * `schur_condense` eliminates a chosen block of nodes from (H, b) via
    the Schur complement — the sliding-window marginalization primitive.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from icpx import struct

from icpx.geometry.se3 import SE3


@struct.dataclass
class PoseGraph:
    poses: SE3  # batched (M,)
    edge_i: jax.Array  # (E,) int32
    edge_j: jax.Array  # (E,) int32
    edge_meas: SE3  # batched (E,)  measured i_T_j
    edge_weight: jax.Array  # (E,) scalar information weights

    @property
    def n_nodes(self) -> int:
        return self.poses.t.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edge_i.shape[0]

    @classmethod
    def from_edge_list(cls, poses: SE3, edges, weights=None) -> "PoseGraph":
        """edges: sequence of (i, j, SE3 i_T_j) (host-side constructor)."""
        ei = jnp.asarray([e[0] for e in edges], jnp.int32)
        ej = jnp.asarray([e[1] for e in edges], jnp.int32)
        R = jnp.stack([e[2].R for e in edges])
        t = jnp.stack([e[2].t for e in edges])
        w = (
            jnp.ones((len(edges),), jnp.float32)
            if weights is None
            else jnp.asarray(weights, jnp.float32)
        )
        return cls(
            poses=poses, edge_i=ei, edge_j=ej, edge_meas=SE3(R=R, t=t), edge_weight=w
        )


def _edge_residual(
    Ti: SE3, Tj: SE3, meas: SE3, di: jax.Array, dj: jax.Array
) -> jax.Array:
    """(6,) residual of one edge at local perturbations (di, dj)."""
    Ti_p = Ti @ SE3.exp(di)
    Tj_p = Tj @ SE3.exp(dj)
    err = meas.inverse() @ Ti_p.inverse() @ Tj_p
    return err.log()


@partial(jax.jit, static_argnames=("iters",))
def optimize_pose_graph(
    graph: PoseGraph,
    *,
    iters: int = 10,
    damping: float = 1e-6,
    anchor: int = 0,
    anchor_weight: float = 1e6,
) -> Tuple[SE3, jax.Array]:
    """Damped Gauss-Newton. Returns (optimized poses, per-iter chi2)."""
    return _optimize_impl(
        graph,
        iters=iters,
        damping=damping,
        anchor=anchor,
        anchor_weight=anchor_weight,
    )


def _optimize_impl(
    graph: PoseGraph,
    *,
    iters: int,
    damping: float,
    anchor: int,
    anchor_weight: float,
    reduce=lambda x: x,
    anchor_scale: float = 1.0,
) -> Tuple[SE3, jax.Array]:
    """Shared GN core. `reduce` sums the assembled (H, b, chi2) across an
    edge partition (identity on a single device); `anchor_scale` divides
    the gauge prior so psum'd shards contribute it exactly once."""
    m = graph.n_nodes

    zero6 = jnp.zeros((6,), jnp.float32)

    def linearize(poses: SE3):
        Ti = SE3(R=poses.R[graph.edge_i], t=poses.t[graph.edge_i])
        Tj = SE3(R=poses.R[graph.edge_j], t=poses.t[graph.edge_j])

        r = jax.vmap(
            lambda a_R, a_t, b_R, b_t, m_R, m_t: _edge_residual(
                SE3(R=a_R, t=a_t),
                SE3(R=b_R, t=b_t),
                SE3(R=m_R, t=m_t),
                zero6,
                zero6,
            )
        )(Ti.R, Ti.t, Tj.R, Tj.t, graph.edge_meas.R, graph.edge_meas.t)

        Ji = jax.vmap(
            lambda a_R, a_t, b_R, b_t, m_R, m_t: jax.jacfwd(
                lambda d: _edge_residual(
                    SE3(R=a_R, t=a_t), SE3(R=b_R, t=b_t), SE3(R=m_R, t=m_t), d, zero6
                )
            )(zero6)
        )(Ti.R, Ti.t, Tj.R, Tj.t, graph.edge_meas.R, graph.edge_meas.t)
        Jj = jax.vmap(
            lambda a_R, a_t, b_R, b_t, m_R, m_t: jax.jacfwd(
                lambda d: _edge_residual(
                    SE3(R=a_R, t=a_t), SE3(R=b_R, t=b_t), SE3(R=m_R, t=m_t), zero6, d
                )
            )(zero6)
        )(Ti.R, Ti.t, Tj.R, Tj.t, graph.edge_meas.R, graph.edge_meas.t)
        return r, Ji, Jj

    def gn_step(poses: SE3):
        r, Ji, Jj = linearize(poses)
        w = graph.edge_weight[:, None, None]
        ei, ej = graph.edge_i, graph.edge_j

        H = jnp.zeros((m, m, 6, 6), jnp.float32)
        H = H.at[ei, ei].add(w * jnp.einsum("eki,ekj->eij", Ji, Ji))
        H = H.at[ei, ej].add(w * jnp.einsum("eki,ekj->eij", Ji, Jj))
        H = H.at[ej, ei].add(w * jnp.einsum("eki,ekj->eij", Jj, Ji))
        H = H.at[ej, ej].add(w * jnp.einsum("eki,ekj->eij", Jj, Jj))
        b = jnp.zeros((m, 6), jnp.float32)
        wr = graph.edge_weight[:, None] * r
        b = b.at[ei].add(jnp.einsum("eki,ek->ei", Ji, wr))
        b = b.at[ej].add(jnp.einsum("eki,ek->ei", Jj, wr))

        # gauge: strong prior pinning the anchor node at its current pose
        # (scaled so a psum across edge shards applies it exactly once)
        H = H.at[anchor, anchor].add(
            anchor_scale * anchor_weight * jnp.eye(6, dtype=jnp.float32)
        )
        chi2_local = jnp.sum(graph.edge_weight * jnp.sum(r * r, axis=1))
        H, b, chi2 = reduce((H, b, chi2_local))

        Hd = H.transpose(0, 2, 1, 3).reshape(6 * m, 6 * m)
        bd = b.reshape(6 * m)
        diag = jnp.diagonal(Hd)
        Hd = Hd + jnp.diag(damping * diag + 1e-9)
        delta = -jnp.linalg.solve(Hd, bd).reshape(m, 6)
        new_poses = jax.vmap(lambda R, t, d: (SE3(R=R, t=t) @ SE3.exp(d)))(
            poses.R, poses.t, delta
        )
        return SE3(R=new_poses.R, t=new_poses.t), chi2

    def body(poses, _):
        new_poses, chi2 = gn_step(poses)
        return new_poses, chi2

    poses, chi2s = jax.lax.scan(body, graph.poses, None, length=iters)
    return poses, chi2s


def optimize_pose_graph_sharded(
    graph: PoseGraph,
    mesh,
    *,
    iters: int = 10,
    damping: float = 1e-6,
    anchor: int = 0,
    anchor_weight: float = 1e6,
    edge_axis: str = "points",
) -> Tuple[SE3, jax.Array]:
    """Edge-sharded Gauss-Newton (SURVEY P9: DP over edges).

    Each device linearizes its shard of edges and assembles a partial
    (6M, 6M) normal system; one `psum` merges them and every device runs
    the identical dense solve — the same sufficient-statistics pattern as
    the sharded ICP JtJ. Edge count must be divisible by the axis size
    (pad with zero-weight self-edges via `pad_edges`).
    """
    from jax.sharding import PartitionSpec as P

    n_dev = mesh.shape[edge_axis]
    e = graph.n_edges
    if e % n_dev:
        raise ValueError(
            f"{e} edges not divisible by '{edge_axis}' size {n_dev}; "
            "pad with pad_edges()"
        )
    m = graph.n_nodes

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(None, None, None),  # poses R (replicated)
            P(None, None),  # poses t
            P(edge_axis),  # edge i
            P(edge_axis),  # edge j
            P(edge_axis, None, None),  # meas R
            P(edge_axis, None),  # meas t
            P(edge_axis),  # weights
        ),
        out_specs=(P(None, None, None), P(None, None), P(None)),
        check_vma=False,
    )
    def run(pR, pt, ei, ej, mR, mt, w):
        local = PoseGraph(
            poses=SE3(R=pR, t=pt),
            edge_i=ei,
            edge_j=ej,
            edge_meas=SE3(R=mR, t=mt),
            edge_weight=w,
        )
        poses, chi2 = _optimize_impl(
            local,
            iters=iters,
            damping=damping,
            anchor=anchor,
            anchor_weight=anchor_weight,
            reduce=lambda x: jax.lax.psum(x, edge_axis),
            anchor_scale=1.0 / n_dev,  # each shard adds its 1/n share
        )
        return poses.R, poses.t, chi2

    R, t, chi2 = run(
        graph.poses.R,
        graph.poses.t,
        graph.edge_i,
        graph.edge_j,
        graph.edge_meas.R,
        graph.edge_meas.t,
        graph.edge_weight,
    )
    return SE3(R=R, t=t), chi2


def pad_edges(graph: PoseGraph, multiple: int) -> PoseGraph:
    """Pad the edge list to a multiple with zero-weight self-edges."""
    e = graph.n_edges
    pad = (-e) % multiple
    if pad == 0:
        return graph
    eye_R = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (pad, 3, 3))
    return PoseGraph(
        poses=graph.poses,
        edge_i=jnp.concatenate([graph.edge_i, jnp.zeros(pad, jnp.int32)]),
        edge_j=jnp.concatenate([graph.edge_j, jnp.zeros(pad, jnp.int32)]),
        edge_meas=SE3(
            R=jnp.concatenate([graph.edge_meas.R, eye_R]),
            t=jnp.concatenate(
                [graph.edge_meas.t, jnp.zeros((pad, 3), jnp.float32)]
            ),
        ),
        edge_weight=jnp.concatenate(
            [graph.edge_weight, jnp.zeros(pad, jnp.float32)]
        ),
    )


# ---- scalable backend: block-sparse assembly + PCG + robust kernels ---------
#
# The dense path above assembles a (M, M, 6, 6) Hessian and dense-solves
# 6Mx6M — exact, fine for tens of keyframes, O(M^2) memory / O(M^3) solve
# beyond. The sparse path never materializes the
# off-diagonal structure: per-edge (6,6) blocks stay edge-indexed, the
# normal system is only ever applied as a matvec (scatter-add over edges),
# and a block-Jacobi-preconditioned conjugate gradient solves it. Robust
# edge kernels (Huber / DCS / Cauchy) reweight each Gauss-Newton round so
# a false loop closure cannot corrupt the solution unconditionally.

ROBUST_KERNELS = ("none", "huber", "dcs", "cauchy")


@struct.dataclass
class MarginalPrior:
    """Gaussian prior from Schur marginalization: the quadratic
    0.5 d^T H d + b^T d over the stacked local perturbations d of `nodes`,
    linearized at `lin` (first-estimate poses at marginalization time)."""

    nodes: jax.Array  # (P,) int32 node ids the prior couples
    H: jax.Array  # (P*6, P*6)
    b: jax.Array  # (P*6,)
    lin: SE3  # batched (P,) linearization poses

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]


def _edge_robust_weight(
    kind: str, chi2_e: jax.Array, delta: float
) -> jax.Array:
    """IRLS weight per edge from its (weighted) squared residual."""
    if kind == "none":
        return jnp.ones_like(chi2_e)
    if kind == "huber":
        s = jnp.sqrt(jnp.maximum(chi2_e, 1e-20))
        return jnp.minimum(1.0, delta / s)
    if kind == "dcs":
        # Dynamic Covariance Scaling (Agarwal et al. 2013): smooth
        # down-weighting, s -> 0 for gross outliers (false closures)
        s = jnp.minimum(1.0, 2.0 * delta / (delta + chi2_e))
        return s * s
    if kind == "cauchy":
        return 1.0 / (1.0 + chi2_e / (delta * delta))
    raise ValueError(f"robust kernel must be one of {ROBUST_KERNELS}")


def _linearize_edges(graph: PoseGraph, poses: SE3):
    """Per-edge residual + exact (6,6) Jacobians at zero perturbation."""
    zero6 = jnp.zeros((6,), jnp.float32)
    Ti = SE3(R=poses.R[graph.edge_i], t=poses.t[graph.edge_i])
    Tj = SE3(R=poses.R[graph.edge_j], t=poses.t[graph.edge_j])

    def one(a_R, a_t, b_R, b_t, m_R, m_t):
        A = SE3(R=a_R, t=a_t)
        B = SE3(R=b_R, t=b_t)
        M = SE3(R=m_R, t=m_t)
        r = _edge_residual(A, B, M, zero6, zero6)
        Ji = jax.jacfwd(lambda d: _edge_residual(A, B, M, d, zero6))(zero6)
        Jj = jax.jacfwd(lambda d: _edge_residual(A, B, M, zero6, d))(zero6)
        return r, Ji, Jj

    return jax.vmap(one)(
        Ti.R, Ti.t, Tj.R, Tj.t, graph.edge_meas.R, graph.edge_meas.t
    )


def _pcg(matvec, b, Minv_blocks, iters: int, tol: float):
    """Block-Jacobi preconditioned CG on the (M, 6) pytree-flat system."""

    def precond(r):
        return jnp.einsum("mij,mj->mi", Minv_blocks, r)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)
    bnorm = jnp.sqrt(jnp.sum(b * b)) + 1e-30

    def cond(state):
        k, _, r, _, _ = state
        return (k < iters) & (jnp.sqrt(jnp.sum(r * r)) > tol * bnorm)

    def body(state):
        k, x, r, p, rz = state
        Ap = matvec(p)
        alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return k + 1, x, r, p, rz_new

    _, x, _, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), x0, r0, p0, rz0)
    )
    return x


@partial(
    jax.jit,
    static_argnames=("iters", "cg_iters", "robust", "robust_delta"),
)
def optimize_pose_graph_sparse(
    graph: PoseGraph,
    *,
    iters: int = 10,
    cg_iters: int = 100,
    cg_tol: float = 1e-5,
    damping: float = 1e-6,
    anchor: int = 0,
    anchor_weight: float = 1e6,
    robust: str = "none",
    robust_delta: float = 1.0,
    prior: Optional[MarginalPrior] = None,
) -> Tuple[SE3, jax.Array]:
    """Scalable damped Gauss-Newton: block-sparse Hessian (never
    materialized), block-Jacobi PCG solve, optional robust edge kernel
    and marginalization prior. Returns (poses, per-iter chi2).

    Memory is O(M + E) and a 1,000-keyframe graph optimizes in seconds on
    CPU (tests/test_posegraph.py::test_sparse_scales_to_1000_keyframes),
    where the dense path's (M, M, 6, 6) Hessian alone would be 144 MB.
    """
    m = graph.n_nodes
    ei, ej = graph.edge_i, graph.edge_j
    eye6 = jnp.eye(6, dtype=jnp.float32)

    def gn_step(poses):
        r, Ji, Jj = _linearize_edges(graph, poses)
        chi2_e = graph.edge_weight * jnp.sum(r * r, axis=1)
        # robust_delta <= 0: adaptive kernel scale from the median edge
        # chi2 (scale-free). A fixed scale invites IRLS basin capture: a
        # gross outlier bends the graph's soft modes, its chi2 falls, its
        # weight recovers, and the wrong basin wins. The median tracks the
        # INLIER population, so the outlier stays downweighted all the
        # way to convergence.
        delta = (
            jnp.maximum(5.0 * jnp.median(chi2_e), 1e-8)
            if robust_delta <= 0
            else robust_delta
        )
        w = graph.edge_weight * _edge_robust_weight(robust, chi2_e, delta)
        wc = w[:, None, None]
        Hii = wc * jnp.einsum("eki,ekj->eij", Ji, Ji)
        Hjj = wc * jnp.einsum("eki,ekj->eij", Jj, Jj)
        Hij = wc * jnp.einsum("eki,ekj->eij", Ji, Jj)

        Hdiag = (
            jnp.zeros((m, 6, 6), jnp.float32).at[ei].add(Hii).at[ej].add(Hjj)
        )
        wr = w[:, None] * r
        b = (
            jnp.zeros((m, 6), jnp.float32)
            .at[ei]
            .add(jnp.einsum("eki,ek->ei", Ji, wr))
            .at[ej]
            .add(jnp.einsum("eki,ek->ei", Jj, wr))
        )
        Hdiag = Hdiag.at[anchor].add(anchor_weight * eye6)

        if prior is not None:
            pn = prior.nodes
            p = prior.n_nodes
            xi = jax.vmap(
                lambda lR, lt, R, t: (
                    SE3(R=lR, t=lt).inverse() @ SE3(R=R, t=t)
                ).log()
            )(prior.lin.R, prior.lin.t, poses.R[pn], poses.t[pn])
            grad_p = (prior.H @ xi.reshape(p * 6) + prior.b).reshape(p, 6)
            b = b.at[pn].add(grad_p)
            Hp_diag = prior.H.reshape(p, 6, p, 6)[
                jnp.arange(p), :, jnp.arange(p), :
            ]
            Hdiag = Hdiag.at[pn].add(Hp_diag)

        # Levenberg damping on the diagonal blocks
        dmask = eye6[None]
        Hdiag_d = Hdiag + damping * Hdiag * dmask + 1e-9 * dmask

        def matvec(x):
            y = jnp.einsum("mij,mj->mi", Hdiag_d, x)
            y = y.at[ei].add(jnp.einsum("eij,ej->ei", Hij, x[ej]))
            y = y.at[ej].add(jnp.einsum("eji,ej->ei", Hij, x[ei]))
            if prior is not None:
                pn = prior.nodes
                p = prior.n_nodes
                yp = (prior.H @ x[pn].reshape(p * 6)).reshape(p, 6)
                # diagonal blocks already inside Hdiag — subtract them back
                yp = yp - jnp.einsum(
                    "mij,mj->mi",
                    prior.H.reshape(p, 6, p, 6)[
                        jnp.arange(p), :, jnp.arange(p), :
                    ],
                    x[pn],
                )
                y = y.at[pn].add(yp)
            return y

        Minv = jnp.linalg.inv(Hdiag_d)
        delta = _pcg(matvec, -b, Minv, cg_iters, cg_tol)
        new_poses = jax.vmap(lambda R, t, d: SE3(R=R, t=t) @ SE3.exp(d))(
            poses.R, poses.t, delta
        )
        chi2 = jnp.sum(chi2_e)
        return SE3(R=new_poses.R, t=new_poses.t), chi2

    def body(poses, _):
        return gn_step(poses)

    poses, chi2s = jax.lax.scan(body, graph.poses, None, length=iters)
    return poses, chi2s


@partial(jax.jit, static_argnames=("n_keep",))
def schur_condense(
    H: jax.Array, b: jax.Array, n_keep: int
) -> Tuple[jax.Array, jax.Array]:
    """Schur-complement reduction of the trailing block.

    Given the (N, N) system partitioned as [[A, B], [B^T, C]] with the
    first `n_keep` rows kept and the rest marginalized, returns
    (A - B C^-1 B^T, b_a - B C^-1 b_c). `n_keep` is static.
    """
    A = H[:n_keep, :n_keep]
    B = H[:n_keep, n_keep:]
    C = H[n_keep:, n_keep:]
    C = C + 1e-9 * jnp.eye(C.shape[0], dtype=H.dtype)
    CinvBt = jnp.linalg.solve(C, B.T)
    Cinvbc = jnp.linalg.solve(C, b[n_keep:])
    return A - B @ CinvBt, b[:n_keep] - B @ Cinvbc


class SlidingWindowBackend:
    """Incremental pose-graph backend with automatic Schur marginalization
    (SURVEY §2.3 P9 "incremental"; wires `schur_condense` into the
    frontend).

    Keyframes enter via `add_keyframe`/`add_edge`; once the active window
    exceeds `window` nodes, the oldest node is marginalized: every factor
    touching it (edges, the running prior, the gauge prior on the first
    marginalization) is linearized at the current estimate, the node is
    Schur-eliminated, and the result becomes a dense `MarginalPrior` over
    its neighbors. Marginalized poses are frozen into the trajectory.

    Edges to already-marginalized nodes are rejected (use the global
    optimizer + full graph for loop closures beyond the window).
    """

    def __init__(
        self,
        window: int = 10,
        *,
        iters: int = 5,
        cg_iters: int = 100,
        robust: str = "dcs",
        robust_delta: float = 1.0,
        anchor_weight: float = 1e6,
        damping: float = 1e-6,
    ):
        self.window = int(window)
        self.iters = iters
        self.cg_iters = cg_iters
        self.robust = robust
        self.robust_delta = robust_delta
        self.anchor_weight = anchor_weight
        self.damping = damping
        self.poses: list = []  # SE3 per keyframe (world), all history
        self.active0 = 0  # first non-marginalized node
        self.edges: list = []  # (i, j, SE3 meas, weight) with global ids
        self.prior: Optional[MarginalPrior] = None  # nodes in GLOBAL ids

    # ---- graph construction ----
    def add_keyframe(self, pose: SE3) -> int:
        self.poses.append(pose)
        return len(self.poses) - 1

    def add_edge(self, i: int, j: int, meas: SE3, weight: float = 1.0):
        if min(i, j) < self.active0:
            raise ValueError(
                f"edge ({i},{j}) touches a marginalized node "
                f"(window starts at {self.active0})"
            )
        self.edges.append((i, j, meas, float(weight)))

    @property
    def n_active(self) -> int:
        return len(self.poses) - self.active0

    # ---- optimization ----
    def optimize(self) -> float:
        """Optimize the active window (prior + edges); returns final chi2."""
        a0 = self.active0
        if self.n_active < 2 or not self.edges:
            return 0.0
        poses = SE3(
            R=jnp.stack([p.R for p in self.poses[a0:]]),
            t=jnp.stack([p.t for p in self.poses[a0:]]),
        )
        graph = PoseGraph.from_edge_list(
            poses,
            [(i - a0, j - a0, m) for (i, j, m, _) in self.edges],
            weights=[w for (_, _, _, w) in self.edges],
        )
        prior = self._local_prior()
        # gauge: the first marginalization bakes the anchor into the prior
        anchor_w = self.anchor_weight if prior is None else 0.0
        opt, chi2 = optimize_pose_graph_sparse(
            graph,
            iters=self.iters,
            cg_iters=self.cg_iters,
            damping=self.damping,
            anchor=0,
            anchor_weight=anchor_w,
            robust=self.robust,
            robust_delta=self.robust_delta,
            prior=prior,
        )
        for k in range(self.n_active):
            self.poses[a0 + k] = SE3(R=opt.R[k], t=opt.t[k])
        return float(chi2[-1])

    def _local_prior(self) -> Optional[MarginalPrior]:
        if self.prior is None:
            return None
        return self.prior.replace(
            nodes=self.prior.nodes - jnp.int32(self.active0)
        )

    def marginalize_to_window(self):
        """Marginalize oldest nodes until the active set fits the window."""
        while self.n_active > self.window:
            self._marginalize_oldest()

    def step(self) -> float:
        """optimize + marginalize: call after adding a keyframe + edges."""
        chi2 = self.optimize()
        self.marginalize_to_window()
        return chi2

    # ---- marginalization ----
    def _marginalize_oldest(self):
        import numpy as np

        o = self.active0
        touching = [e for e in self.edges if o in (e[0], e[1])]
        keep_edges = [e for e in self.edges if o not in (e[0], e[1])]
        nodes = set()
        for (i, j, _, _) in touching:
            nodes.update((i, j))
        if self.prior is not None:
            nodes.update(int(x) for x in np.asarray(self.prior.nodes))
        nodes.discard(o)
        keep = sorted(nodes)
        S = keep + [o]  # marginalized node LAST (schur keeps the head)
        loc = {g: k for k, g in enumerate(S)}
        ns = len(S)
        H = np.zeros((ns * 6, ns * 6), np.float64)
        b = np.zeros((ns * 6,), np.float64)

        if touching:
            g = PoseGraph.from_edge_list(
                SE3(
                    R=jnp.stack([self.poses[k].R for k in S]),
                    t=jnp.stack([self.poses[k].t for k in S]),
                ),
                [(loc[i], loc[j], m) for (i, j, m, _) in touching],
                weights=[w for (_, _, _, w) in touching],
            )
            r, Ji, Jj = _linearize_edges(g, g.poses)
            r, Ji, Jj = map(np.asarray, (r, Ji, Jj))
            for e, (gi, gj, _, w) in enumerate(touching):
                li, lj = loc[gi] * 6, loc[gj] * 6
                Jie, Jje, re = Ji[e], Jj[e], r[e]
                H[li : li + 6, li : li + 6] += w * Jie.T @ Jie
                H[lj : lj + 6, lj : lj + 6] += w * Jje.T @ Jje
                H[li : li + 6, lj : lj + 6] += w * Jie.T @ Jje
                H[lj : lj + 6, li : li + 6] += w * Jje.T @ Jie
                b[li : li + 6] += w * Jie.T @ re
                b[lj : lj + 6] += w * Jje.T @ re

        if self.prior is not None:
            pn = np.asarray(self.prior.nodes)
            p = len(pn)
            xi = np.concatenate(
                [
                    np.asarray(
                        (
                            SE3(
                                R=self.prior.lin.R[k], t=self.prior.lin.t[k]
                            ).inverse()
                            @ self.poses[int(pn[k])]
                        ).log()
                    )
                    for k in range(p)
                ]
            )
            Hp = np.asarray(self.prior.H, np.float64)
            bp = np.asarray(self.prior.b, np.float64) + Hp @ xi
            idx = np.concatenate(
                [np.arange(loc[int(gk)] * 6, loc[int(gk)] * 6 + 6) for gk in pn]
            )
            H[np.ix_(idx, idx)] += Hp
            b[idx] += bp

        if self.prior is None:
            # first marginalization: fold the gauge prior on the anchor in
            lo = loc[o] * 6
            H[lo : lo + 6, lo : lo + 6] += self.anchor_weight * np.eye(6)

        Hk, bk = schur_condense(
            jnp.asarray(H, jnp.float32), jnp.asarray(b, jnp.float32),
            (ns - 1) * 6,
        )
        self.prior = MarginalPrior(
            nodes=jnp.asarray(keep, jnp.int32),
            H=Hk,
            b=bk,
            lin=SE3(
                R=jnp.stack([self.poses[k].R for k in keep]),
                t=jnp.stack([self.poses[k].t for k in keep]),
            ),
        )
        self.edges = keep_edges
        self.active0 = o + 1
