"""The fused GPU NN fold (kernels/fold_triton.py): the Pallas kernel in
interpret mode against its plain-jnp reference and the XLA fold, its
miss and padding contracts, its refusal to run uncompiled off the GPU,
and the payload-mode choice that routes registrations to it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icpx.kernels.blocknn import (
    _candidate_tiles,
    block_nn_payload,
    build_kd_index,
    tile_payload,
)
from icpx.kernels.fold_triton import (
    fold_nn,
    fold_nn_reference,
    fold_tables,
)
from icpx.registration.icp import ICPConfig, _effective_payload_mode


def _problem(rng, n_ref, n_query, q_tile, d_extra, ref_tile=64):
    r = rng.uniform(-1, 1, (n_ref, 3)).astype(np.float32)
    q = (r[:n_query] + rng.normal(0, 0.01, (n_query, 3))).astype(np.float32)
    ridx = build_kd_index(r, tile_size=ref_tile)
    qidx = build_kd_index(q, tile_size=q_tile)
    extra = rng.normal(size=(n_ref, d_extra)).astype(np.float32)
    pl_tiles = jnp.concatenate(
        [ridx.tiles, tile_payload(ridx, jnp.asarray(extra))], axis=2
    )
    return ridx, qidx, pl_tiles


# tile counts: 2900 queries / Sq=16 -> 256 po2 KD tiles; slicing off 3
# leaves 253 (odd), which every rows > Sq group size must pad
@pytest.mark.parametrize(
    "q_tile,rows,drop,d_extra",
    [
        (32, 16, 0, 3),   # program = half a query tile, normals payload
        (32, 32, 3, 3),   # program = one tile
        (16, 64, 3, 3),   # 4 tiles per program, 253 tiles -> padded
        (16, 128, 3, 9),  # 8 tiles per program, GICP-width payload
        (32, 64, 1, 9),   # 2 tiles per program, odd tile count
    ],
)
def test_fold_interpret_matches_reference_and_xla(
    rng, q_tile, rows, drop, d_extra
):
    ridx, qidx, pl_tiles = _problem(rng, 4000, 2900, q_tile, d_extra)
    tiles = qidx.tiles[: qidx.n_tiles - drop]
    cand, _ = _candidate_tiles(tiles, ridx, 6)
    tabs = fold_tables(ridx, pl_tiles)
    d_k, p_k = fold_nn(tiles, cand, tabs, rows=rows, interpret=True)
    d_r, p_r = fold_nn_reference(tiles, cand, tabs, chunk=7)
    assert p_k.shape == (tiles.shape[0] * q_tile, 3 + d_extra)
    # same arithmetic on the CPU: bit-identical to the reference
    np.testing.assert_array_equal(np.asarray(d_k), np.asarray(d_r))
    np.testing.assert_array_equal(np.asarray(p_k), np.asarray(p_r))

    # against the XLA fold (norm-expansion scoring): same rows except
    # at near-ties, and the distances agree to fp32 rounding
    d_x, p_x = block_nn_payload(
        tiles, ridx, pl_tiles, k_tiles=6, cand_tiles=cand
    )
    order = np.asarray(qidx.order)[: tiles.shape[0] * q_tile]
    qv = order >= 0
    d_k, p_k, d_x, p_x = (np.asarray(a)[qv] for a in (d_k, p_k, d_x, p_x))
    same = (p_k == p_x).all(axis=1)
    assert same.mean() > 0.999
    np.testing.assert_allclose(d_k, d_x, rtol=1e-4, atol=1e-6)
    # every kernel payload row is an exact table row
    table = np.asarray(pl_tiles).reshape(-1, 3 + d_extra)
    hit = np.isfinite(d_k)
    rows_in_table = {tuple(r) for r in table}
    assert all(tuple(r) in rows_in_table for r in p_k[hit][:200])


def test_fold_all_sentinel_candidates_miss(rng):
    """A query tile whose candidate tiles hold only sentinel padding gets
    d2 = inf and a zero payload (the infold contract), not a pad row."""
    ridx, qidx, pl_tiles = _problem(rng, 1000, 1000, 32, 3)
    # an index with trailing all-padding tiles: build over 1000 points
    # at S=64 pads to 16 tiles, the last ones partly empty; force every
    # candidate of the first 4 query tiles onto a pure-padding tile
    pad = jnp.full((1, 64, 3), 1e8, jnp.float32)
    from icpx.kernels.blocknn import TileIndex

    idx = TileIndex(
        tiles=jnp.concatenate([ridx.tiles, pad]),
        box_lo=jnp.concatenate([ridx.box_lo, pad[:, 0]]),
        box_hi=jnp.concatenate([ridx.box_hi, -pad[:, 0]]),
        centroids=jnp.concatenate([ridx.centroids, pad[:, 0]]),
        order=jnp.concatenate([ridx.order, -jnp.ones(64, jnp.int32)]),
    )
    pl_all = jnp.concatenate(
        [pl_tiles, jnp.full((1, 64, 6), 7.0, jnp.float32)]
    )
    cand, _ = _candidate_tiles(qidx.tiles, idx, 4)
    empty = idx.n_tiles - 1
    cand = cand.at[:4].set(empty)
    d, p = fold_nn(
        qidx.tiles, cand, fold_tables(idx, pl_all), interpret=True
    )
    d, p = np.asarray(d), np.asarray(p)
    assert np.isinf(d[: 4 * 32]).all()
    assert (p[: 4 * 32] == 0).all()
    assert np.isfinite(d[4 * 32:][np.asarray(qidx.order)[4 * 32:] >= 0]).all()


def test_fold_refuses_to_run_uncompiled_off_gpu(rng):
    ridx, qidx, pl_tiles = _problem(rng, 512, 512, 32, 3)
    cand, _ = _candidate_tiles(qidx.tiles, ridx, 2)
    assert jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError, match="interpret=True"):
        fold_nn(qidx.tiles, cand, fold_tables(ridx, pl_tiles))


def test_fold_shape_contract(rng):
    ridx, qidx, pl_tiles = _problem(rng, 512, 512, 32, 3)
    cand, _ = _candidate_tiles(qidx.tiles, ridx, 2)
    tabs = fold_tables(ridx, pl_tiles)
    # payload lanes padded to a power of two, unpadded on return
    assert tabs.payload.shape == (ridx.n_tiles * 64, 8) and tabs.d == 6
    with pytest.raises(ValueError, match="power of two"):
        fold_nn(qidx.tiles, cand, tabs, rows=24, interpret=True)
    with pytest.raises(ValueError, match="power of two"):
        fold_nn(qidx.tiles[:, :24], cand, tabs, interpret=True)
    with pytest.raises(ValueError, match="match the index"):
        fold_tables(ridx, pl_tiles[:, :32])


def test_resolve_payload_on_gpu_backend(monkeypatch):
    """auto picks the fold kernel on a GPU from fold_threshold target
    points; the CPU backend never picks it; no frozen candidates or a
    feature metric fall back to the XLA infold/gather paths."""
    cfg = ICPConfig()
    assert cfg.resolve_payload(1 << 23) == "infold"  # CPU backend
    assert cfg.resolve_payload(1 << 20) == "gather"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert cfg.resolve_payload(1 << 20) == "fold"
    assert cfg.resolve_payload(1 << 23) == "fold"
    assert cfg.resolve_payload((1 << 20) - 1) == "gather"
    assert ICPConfig(payload_mode="infold").resolve_payload(1 << 23) == (
        "infold"
    )
    kw = dict(use_feat=False)
    assert _effective_payload_mode(cfg, 1 << 23, will_freeze=True, **kw) == (
        "fold"
    )
    assert _effective_payload_mode(
        cfg, 1 << 23, will_freeze=False, **kw
    ) == "infold"
    assert _effective_payload_mode(
        cfg, 1 << 20, will_freeze=False, **kw
    ) == "gather"
    assert _effective_payload_mode(
        cfg, 1 << 23, use_feat=True, will_freeze=True
    ) == "infold"


def test_resolve_precisions_are_backend_independent(monkeypatch):
    """Score and payload precisions resolve to true fp32 on every
    backend ("high" would mean TF32 on an NVIDIA GPU)."""
    for backend in ("cpu", "gpu"):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        cfg = ICPConfig()
        assert cfg.resolve_score_prec() == "highest"
        assert cfg.resolve_payload_prec() == "highest"
    assert ICPConfig(score_precision="bf16").resolve_score_prec() == "bf16"
    with pytest.raises(ValueError):
        ICPConfig(payload_prec="high")
    with pytest.raises(ValueError):
        ICPConfig(payload_mode="vmem")


@pytest.mark.gpu
def test_fold_compiled_matches_reference_on_gpu(gpu, rng):
    """On the card: the compiled kernel against the jnp reference (FMA
    contraction may swap near-ties only)."""
    ridx, qidx, pl_tiles = _problem(rng, 200_000, 100_000, 64, 3, 128)
    cand, _ = _candidate_tiles(qidx.tiles, ridx, 6)
    tabs = fold_tables(ridx, pl_tiles)
    d_k, p_k = fold_nn(qidx.tiles, cand, tabs)
    d_r, p_r = fold_nn_reference(qidx.tiles, cand, tabs)
    same = (np.asarray(p_k) == np.asarray(p_r)).all(axis=1)
    assert same.mean() > 1 - 1e-4
    np.testing.assert_allclose(
        np.asarray(d_k), np.asarray(d_r), rtol=1e-5, atol=1e-7
    )
