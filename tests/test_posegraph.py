"""Pose-graph Gauss-Newton + Schur condensation."""

import jax
import jax.numpy as jnp
import numpy as np

from icpx.geometry.se3 import SE3
from icpx.odometry.posegraph import (
    PoseGraph,
    optimize_pose_graph,
    schur_condense,
)


def _chain_gt(m, key):
    """Ground-truth chain of poses + exact consecutive edges."""
    deltas = SE3.exp(0.3 * jax.random.normal(key, (m - 1, 6)))
    poses = [SE3.identity()]
    for k in range(m - 1):
        poses.append(poses[-1] @ SE3(R=deltas.R[k], t=deltas.t[k]))
    gt = SE3(R=jnp.stack([p.R for p in poses]), t=jnp.stack([p.t for p in poses]))
    edges = [
        (k, k + 1, SE3(R=deltas.R[k], t=deltas.t[k])) for k in range(m - 1)
    ]
    return gt, edges


def test_recovers_chain_from_noisy_init(key):
    m = 12
    k1, k2 = jax.random.split(key)
    gt, edges = _chain_gt(m, k1)
    # loop closure edge first->last (true relative pose)
    loop = SE3(R=gt.R[0], t=gt.t[0]).inverse() @ SE3(R=gt.R[-1], t=gt.t[-1])
    edges.append((0, m - 1, loop))
    # perturb all but the anchor
    noise = SE3.exp(0.1 * jax.random.normal(k2, (m, 6)))
    init = SE3(
        R=jnp.concatenate([gt.R[:1], (gt.R @ noise.R)[1:]]),
        t=jnp.concatenate([gt.t[:1], (gt.t + noise.t)[1:]]),
    )
    graph = PoseGraph.from_edge_list(init, edges)
    opt, chi2 = optimize_pose_graph(graph, iters=10)
    # chi2 decreases and final poses match GT (up to anchor gauge)
    assert float(chi2[-1]) < float(chi2[0]) * 1e-4
    rot_err = np.asarray(SE3(R=opt.R, t=opt.t).distance_to(gt)[0])
    t_err = np.asarray(SE3(R=opt.R, t=opt.t).distance_to(gt)[1])
    assert rot_err.max() < 2e-3, rot_err.max()
    assert t_err.max() < 2e-3, t_err.max()


def test_consistent_graph_stays_put(key):
    m = 6
    gt, edges = _chain_gt(m, key)
    graph = PoseGraph.from_edge_list(gt, edges)
    opt, chi2 = optimize_pose_graph(graph, iters=3)
    assert float(chi2[0]) < 1e-8
    assert np.allclose(np.asarray(opt.t), np.asarray(gt.t), atol=1e-4)


def test_edge_weights_downweight_bad_edge(key):
    m = 8
    k1, k2 = jax.random.split(key)
    gt, edges = _chain_gt(m, k1)
    # corrupt one edge but give it (near) zero weight
    bad = SE3.exp(jnp.asarray([0.5, -0.3, 0.2, 1.0, -1.0, 0.5]))
    edges.append((1, 5, bad))
    weights = [1.0] * (len(edges) - 1) + [1e-6]
    noise = SE3.exp(0.05 * jax.random.normal(k2, (m, 6)))
    init = SE3(R=gt.R @ noise.R, t=gt.t + noise.t)
    graph = PoseGraph.from_edge_list(init, edges, weights)
    opt, _ = optimize_pose_graph(graph, iters=10)
    # the anchor was initialized noisy: compare in the anchor's gauge
    rel_opt = SE3(R=opt.R[0], t=opt.t[0]).inverse() @ SE3(R=opt.R, t=opt.t)
    rel_gt = SE3(R=gt.R[0], t=gt.t[0]).inverse() @ gt
    _, t_err = rel_opt.distance_to(rel_gt)
    assert np.asarray(t_err).max() < 5e-3


def test_schur_condense_matches_full_solve(rng):
    n, keep = 30, 18
    A = rng.normal(size=(n, n)).astype(np.float32)
    H = A @ A.T + n * np.eye(n, dtype=np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    x_full = np.linalg.solve(H, b)
    Hs, bs = schur_condense(jnp.asarray(H), jnp.asarray(b), keep)
    x_kept = np.linalg.solve(np.asarray(Hs), np.asarray(bs))
    assert np.allclose(x_kept, x_full[:keep], atol=1e-3)


# ---- sparse backend (block-sparse PCG + robust kernels + window) ------------


def test_sparse_matches_dense(key):
    from icpx.odometry.posegraph import optimize_pose_graph_sparse

    m = 12
    k1, k2 = jax.random.split(key)
    gt, edges = _chain_gt(m, k1)
    loop = SE3(R=gt.R[0], t=gt.t[0]).inverse() @ SE3(R=gt.R[-1], t=gt.t[-1])
    edges.append((0, m - 1, loop))
    noise = SE3.exp(0.1 * jax.random.normal(k2, (m, 6)))
    init = SE3(
        R=jnp.concatenate([gt.R[:1], (gt.R @ noise.R)[1:]]),
        t=jnp.concatenate([gt.t[:1], (gt.t + noise.t)[1:]]),
    )
    graph = PoseGraph.from_edge_list(init, edges)
    dense, _ = optimize_pose_graph(graph, iters=10)
    sparse, chi2 = optimize_pose_graph_sparse(graph, iters=10, cg_iters=200)
    _, t_err = SE3(R=sparse.R, t=sparse.t).distance_to(
        SE3(R=dense.R, t=dense.t)
    )
    assert np.asarray(t_err).max() < 1e-3
    assert float(chi2[-1]) < float(chi2[0]) * 1e-4


def test_sparse_scales_to_1000_keyframes(key):
    """1,000-keyframe graph optimizes in < 5 s on
    CPU (the dense Hessian alone would be 144 MB / O(M^3) solve)."""
    import time

    from icpx.odometry.posegraph import optimize_pose_graph_sparse

    m = 1000
    k1, k2 = jax.random.split(key)
    deltas = SE3.exp(
        jnp.concatenate(
            [0.05 * jax.random.normal(k1, (m - 1, 3)),
             0.3 * jnp.ones((m - 1, 1)),
             jnp.zeros((m - 1, 2))], axis=1,
        )
    )
    poses = [SE3.identity()]
    for k in range(m - 1):
        poses.append(poses[-1] @ SE3(R=deltas.R[k], t=deltas.t[k]))
    gt = SE3(
        R=jnp.stack([p.R for p in poses]), t=jnp.stack([p.t for p in poses])
    )
    edges = [
        (k, k + 1, SE3(R=deltas.R[k], t=deltas.t[k])) for k in range(m - 1)
    ]
    # sprinkle loop closures every 100 nodes
    for a in range(0, m - 200, 100):
        b = a + 150
        loop = SE3(R=gt.R[a], t=gt.t[a]).inverse() @ SE3(R=gt.R[b], t=gt.t[b])
        edges.append((a, b, loop))
    noise = SE3.exp(0.02 * jax.random.normal(k2, (m, 6)))
    init = SE3(
        R=jnp.concatenate([gt.R[:1], (gt.R @ noise.R)[1:]]),
        t=jnp.concatenate([gt.t[:1], (gt.t + noise.t)[1:]]),
    )
    graph = PoseGraph.from_edge_list(init, edges)
    from icpx.odometry.posegraph import optimize_pose_graph_sparse as f

    _ = f(graph, iters=1, cg_iters=10)  # compile outside the timing
    t0 = time.perf_counter()
    opt, chi2 = f(graph, iters=8, cg_iters=150)
    jax.block_until_ready(opt.t)
    wall = time.perf_counter() - t0
    assert wall < 5.0, f"1000-kf optimize took {wall:.1f}s"
    assert float(chi2[-1]) < float(chi2[0]) * 1e-2
    _, t_err = SE3(R=opt.R, t=opt.t).distance_to(gt)
    assert np.asarray(t_err).max() < 0.05


def test_false_closure_robust_kernel(key):
    """one injected false closure shifts the
    solution < 10% (ATE sense) with the DCS kernel; without it the
    solution is visibly corrupted."""
    from icpx.odometry.evaluate import ate_rmse
    from icpx.odometry.posegraph import optimize_pose_graph_sparse

    m = 30
    k1, k2 = jax.random.split(key)
    gt, edges = _chain_gt(m, k1)
    noise = SE3.exp(0.05 * jax.random.normal(k2, (m, 6)))
    init = SE3(
        R=jnp.concatenate([gt.R[:1], (gt.R @ noise.R)[1:]]),
        t=jnp.concatenate([gt.t[:1], (gt.t + noise.t)[1:]]),
    )
    # a comprehensively WRONG closure between distant nodes
    bad = SE3.exp(jnp.asarray([0.4, -0.2, 0.3, 2.0, -1.5, 1.0]))
    edges_bad = edges + [(2, m - 3, bad)]
    g_clean = PoseGraph.from_edge_list(init, edges)
    g_bad = PoseGraph.from_edge_list(init, edges_bad)

    def ate(opt):
        ps = [SE3(R=opt.R[i], t=opt.t[i]) for i in range(m)]
        gts = [SE3(R=gt.R[i], t=gt.t[i]) for i in range(m)]
        return ate_rmse(ps, gts, align=False)

    clean, _ = optimize_pose_graph_sparse(g_clean, iters=10)
    naive, _ = optimize_pose_graph_sparse(g_bad, iters=10)
    robust, _ = optimize_pose_graph_sparse(
        g_bad, iters=15, robust="dcs", robust_delta=0.0
    )
    ate_clean, ate_naive, ate_rob = ate(clean), ate(naive), ate(robust)
    assert ate_naive > ate_clean * 3  # the bad edge does real damage
    assert ate_rob < ate_clean + 0.1 * max(ate_naive, 1e-9)


def test_sliding_window_marginalization(key):
    """Window backend tracks the full optimizer on a chain and
    marginalizes automatically past the window length."""
    from icpx.odometry.posegraph import SlidingWindowBackend

    m = 25
    k1, k2 = jax.random.split(key)
    gt, edges = _chain_gt(m, k1)
    noise = SE3.exp(0.05 * jax.random.normal(k2, (m - 1, 6)))

    win = SlidingWindowBackend(window=8, iters=5, robust="none")
    win.add_keyframe(SE3(R=gt.R[0], t=gt.t[0]))
    for k in range(m - 1):
        meas = edges[k][2]
        noisy_pose = win.poses[-1] @ meas @ SE3(
            R=noise.R[k], t=0.02 * noise.t[k]
        )
        win.add_keyframe(noisy_pose)
        win.add_edge(k, k + 1, meas)
        win.step()
    assert win.active0 == m - win.window  # marginalization actually ran
    assert win.prior is not None
    opt = SE3(
        R=jnp.stack([p.R for p in win.poses]),
        t=jnp.stack([p.t for p in win.poses]),
    )
    _, t_err = opt.distance_to(gt)
    # exact edges: optimized chain must sit on GT despite noisy inits
    assert np.asarray(t_err).max() < 1e-2


def test_window_rejects_marginalized_edge(key):
    from icpx.odometry.posegraph import SlidingWindowBackend

    gt, edges = _chain_gt(10, key)
    win = SlidingWindowBackend(window=3, iters=2)
    win.add_keyframe(SE3(R=gt.R[0], t=gt.t[0]))
    for k in range(9):
        win.add_keyframe(SE3(R=gt.R[k + 1], t=gt.t[k + 1]))
        win.add_edge(k, k + 1, edges[k][2])
        win.step()
    import pytest

    with pytest.raises(ValueError):
        win.add_edge(0, 9, edges[0][2])
