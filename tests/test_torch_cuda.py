"""The port's CUDA kernel on the card, against its plain PyTorch version.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
without one. The file imports neither jax nor pioran_tpu, so it runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from pioran_tpu_torch.ops import cuda_celerite
from pioran_tpu_torch.ops.cuda_celerite import batched_loglike, batched_loglike_plain


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    from pioran_tpu_torch.config import require_cuda

    return require_cuda()


def _problem(B, J, N, seed):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 100, N))
    a = rng.uniform(0.1, 0.6, (B, J))
    b = rng.uniform(0.0, 0.2, (B, J))
    c = rng.uniform(0.05, 0.35, (B, J))
    d = rng.uniform(0.0, 0.4, (B, J))
    y = rng.normal(size=(B, N))
    s2 = rng.uniform(0.05, 0.15, (B, N))
    a[0] = -50.0 * a[0]  # lane 0 is not positive definite
    return a, b, c, d, t, y, s2


# f64: the two differ only in the order of their sums; f32: as chip_smoke.py
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 5e-2)])
@pytest.mark.parametrize("J", [1, 3, 4, 5, 20, 21, 32])
@pytest.mark.parametrize("with_dt", [False, True])
def test_kernel_matches_plain_on_card(card, dtype, tol, J, with_dt):
    """A ragged batch edge (37 chains), J on both sides of the kernel's
    rounding of J up to 4 and at its ends, a non-PD lane, with and without
    host spacings."""
    a, b, c, d, t, y, s2 = _problem(37, J, 300, seed=J)
    args = [torch.as_tensor(x, dtype=dtype, device=card) for x in (a, b, c, d, t, y, s2)]
    dt = torch.as_tensor(np.diff(t), device=card) if with_dt else None
    before = cuda_celerite.LAUNCHES
    k = batched_loglike(*args, dt)
    assert cuda_celerite.LAUNCHES == before + 1
    p = batched_loglike_plain(*args, dt)
    torch.cuda.synchronize()
    assert torch.equal(torch.isneginf(k), torch.isneginf(p)) and bool(k[0] == -math.inf)
    fin = torch.isfinite(p)
    # lane 0 is -inf; at J = 1 two more chains draw a single term with
    # b d > a c, not a positive-definite kernel, and are -inf in both
    assert int(fin.sum()) == (36 if J > 1 else 34)
    err = (k[fin] - p[fin]).abs()
    if dtype == torch.float64:
        err = err / p[fin].abs()
    assert float(err.max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 5e-2)])
@pytest.mark.parametrize("J", [1, 20])
def test_kernel_single_chain_on_card(card, dtype, tol, J):
    """B = 1: one warp in one block, and a series that is not a whole
    number of the kernel's 32-step blocks (N = 70)."""
    a, b, c, d, t, y, s2 = _problem(2, J, 70, seed=J + 40)
    args = [torch.as_tensor(x[1:] if x.ndim == 2 else x, dtype=dtype, device=card)
            for x in (a, b, c, d, t, y, s2)]
    k = batched_loglike(*args)
    p = batched_loglike_plain(*args)
    torch.cuda.synchronize()
    assert k.shape == (1,) and bool(torch.isfinite(k).all()) and bool(torch.isfinite(p).all())
    err = (k - p).abs()
    if dtype == torch.float64:
        err = err / p.abs()
    assert float(err.max()) <= tol


@pytest.mark.cuda
def test_wrapper_rejects_mixed_inputs_on_card(card):
    a, b, c, d, t, y, s2 = (torch.as_tensor(x, device=card)
                            for x in _problem(4, 5, 20, seed=1))
    with pytest.raises(ValueError, match="sigma2"):
        batched_loglike(a, b, c, d, t, y, s2.float())
    too_many = cuda_celerite.MAX_TERMS + 1
    with pytest.raises(ValueError, match=f"at most {cuda_celerite.MAX_TERMS}"):
        batched_loglike(*(torch.as_tensor(x, device=card) for x in _problem(2, too_many, 10, 2)))


# ---------------------------------------------------------------------------
# the adjoint kernels K3 (celerite_fwd_aug) and K4 (celerite_bwd)
# ---------------------------------------------------------------------------


def _rel_rows(x, ref):
    """Largest 2-norm relative error over the leading axis."""
    x, ref = x.double().reshape(x.shape[0], -1), ref.double().reshape(ref.shape[0], -1)
    return float(((x - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-300)).max())


def _adjoint_rows(fin, ll, res, grads):
    """ll, the residual tables and the cotangents as (rows, ...) tensors
    over the finite chains (t's cotangent, summed over chains, as one row)."""
    out = [ll[fin][:, None]] + [x[fin] for x in res]
    return out + [x[None] if x.dim() == 1 else x[fin] for x in grads]


# f64: the kernels and the plain loops differ only in the order of their
# sums and in K4's use of the symmetry of T00 and T11 (tolerance 1e-9).
# f32 (the card's working type): both are held against the f64 plain
# loops, and the kernels may be at most 4x as far off as the f32 plain
# loops are (or 1e-5 relative), since float32 rounding dominates there.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("J", [3, 20, 32])
@pytest.mark.parametrize("with_dt", [False, True])
def test_adjoint_kernels_match_plain_on_card(card, dtype, J, with_dt):
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp

    a, b, c, d, t, y, s2 = _problem(37, J, 100, seed=J)
    args64 = [torch.as_tensor(x, dtype=torch.float64, device=card) for x in (a, b, c, d, t, y, s2)]
    args = [x.to(dtype) for x in args64]
    dt = torch.as_tensor(np.diff(t), device=card) if with_dt else None
    n3, n4 = vjp.FWD_AUG_LAUNCHES, vjp.BWD_LAUNCHES
    ll, res = vjp.fwd_aug(*args, dt=dt, kc=8)
    g = torch.where(torch.isfinite(ll), torch.linspace(0.5, 1.5, 37, dtype=dtype, device=card), 0.0)
    grads = vjp.bwd(*args, res, g, dt=dt, kc=8)
    torch.cuda.synchronize()
    assert (vjp.FWD_AUG_LAUNCHES, vjp.BWD_LAUNCHES) == (n3 + 1, n4 + 1)
    ll_p, res_p = vjp.fwd_aug_plain(*args64, dt=dt, kc=8)
    grads_p = vjp.bwd_plain(*args64, res_p, g.double(), dt=dt, kc=8)
    assert torch.equal(torch.isneginf(ll), torch.isneginf(ll_p)) and bool(ll[0] == -math.inf)
    for x in grads:
        assert x.dim() == 1 or bool((x[0] == 0).all())  # the non-PD lane
    fin = torch.isfinite(ll_p)
    ours = _adjoint_rows(fin, ll, res, grads)
    refs = _adjoint_rows(fin, ll_p, res_p, grads_p)
    if dtype == torch.float64:
        bounds = [1e-9] * len(refs)
    else:
        ll_q, res_q = vjp.fwd_aug_plain(*args, dt=dt, kc=8)
        own = _adjoint_rows(fin, ll_q, res_q, vjp.bwd_plain(*args, res_q, g, dt=dt, kc=8))
        bounds = [max(4.0 * _rel_rows(q, r), 1e-5) for q, r in zip(own, refs)]
    for i, (x, r, bound) in enumerate(zip(ours, refs, bounds)):
        assert _rel_rows(x, r) <= bound, i


@pytest.mark.cuda
def test_adjoint_wrappers_reject_what_the_kernels_do_not_take(card):
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp

    args = [torch.as_tensor(x, device=card) for x in _problem(2, vjp.MAX_TERMS + 1, 10, 2)]
    with pytest.raises(ValueError, match=f"at most {vjp.MAX_TERMS}"):
        vjp.fwd_aug(*args)
    with pytest.raises(ValueError, match=f"at most {vjp.MAX_TERMS}"):
        vjp.bwd(*args, (), torch.ones(2, dtype=torch.float64, device=card))
    args = [torch.as_tensor(x, device=card) for x in _problem(2, 4, 10, 3)]
    with pytest.raises(ValueError, match="float32 or float64"):
        vjp.fwd_aug(*(x.half() for x in args))
    ll, res = vjp.fwd_aug(*args)
    with pytest.raises(ValueError, match="residual table"):
        vjp.bwd(*args, res[:6] + (res[6][:, :1],), torch.ones_like(ll))


@pytest.mark.cuda
def test_backward_on_card_runs_the_kernels_only(card, monkeypatch):
    """Value and gradient of a CUDA batch go through K3 and K4 (their
    counters move) and never through the plain versions."""
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp

    def refuse(*_a, **_k):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(vjp, "fwd_aug_plain", refuse)
    monkeypatch.setattr(vjp, "bwd_plain", refuse)
    monkeypatch.setattr(cuda_celerite, "batched_loglike_plain", refuse)
    args = [torch.as_tensor(x, device=card).requires_grad_(True)
            for x in _problem(9, 20, 64, seed=5)]
    n1, n3, n4 = cuda_celerite.LAUNCHES, vjp.FWD_AUG_LAUNCHES, vjp.BWD_LAUNCHES
    ll = batched_loglike(*args)
    grads = torch.autograd.grad(ll.sum(), args)
    torch.cuda.synchronize()
    assert (cuda_celerite.LAUNCHES, vjp.FWD_AUG_LAUNCHES, vjp.BWD_LAUNCHES) == (n1, n3 + 1, n4 + 1)
    assert bool((grads[0][0] == 0).all()) and bool(torch.isneginf(ll[0]))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with torch.no_grad():
        batched_loglike(*args)
    assert cuda_celerite.LAUNCHES == n1 + 1


# ---------------------------------------------------------------------------
# the multi-dataset kernels: K2 (celerite_fwd_multi) and the per-lane K3/K4
# ---------------------------------------------------------------------------


def _ragged(B, J, N, seed):
    """Per-lane grids edge-padded past ragged lengths (one lane full), their
    host spacings, and lane 0 not positive definite."""
    a, b, c, d, _, y, s2 = _problem(B, J, N, seed)
    rng = np.random.default_rng(seed + 100)
    T = np.sort(rng.uniform(0, 100, (B, N)), axis=1)
    nv = rng.integers(N // 3, N + 1, B)
    nv[1] = N
    for i, m in enumerate(nv):
        T[i, m:] = T[i, m - 1]
    live = np.arange(N)[None, :] < nv[:, None]
    return (a, b, c, d, T, y, np.where(live, s2, 1.0)), np.diff(T, axis=1), nv


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 5e-2)])
@pytest.mark.parametrize("J", [1, 3, 4, 5, 20, 21, 32])
@pytest.mark.parametrize("with_dt", [False, True])
def test_multi_kernel_matches_plain_on_card(card, dtype, tol, J, with_dt):
    """K2 on a ragged batch edge (37 chains) against its plain version."""
    args, DT, nv = _ragged(37, J, 120, seed=J)
    targs = [torch.as_tensor(x, dtype=dtype, device=card) for x in args]
    nv = torch.as_tensor(nv, device=card)
    dt = torch.as_tensor(DT, device=card) if with_dt else None
    before = cuda_celerite.MULTI_LAUNCHES
    k = cuda_celerite.batched_loglike_multi(*targs, nv, dt)
    assert cuda_celerite.MULTI_LAUNCHES == before + 1
    p = cuda_celerite.batched_loglike_multi_plain(*targs, nv, dt)
    torch.cuda.synchronize()
    assert torch.equal(torch.isneginf(k), torch.isneginf(p)) and bool(k[0] == -math.inf)
    fin = torch.isfinite(p)
    # lane 0 is -inf; at J = 1 two more chains draw a single term with
    # b d > a c, not a positive-definite kernel, and are -inf in both
    assert int(fin.sum()) == (36 if J > 1 else 34)
    err = (k[fin] - p[fin]).abs()
    if dtype == torch.float64:
        err = err / p[fin].abs()
    assert float(err.max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 5e-2)])
def test_multi_kernel_short_series_on_card(card, dtype, tol):
    """K2 with n_valid 0 (the value is 0: no step counts), 1 and 2 beside
    full and ragged lanes, against its plain version."""
    args, _, nv = _ragged(6, 20, 45, seed=11)
    args = list(args)
    nv[2:] = [0, 1, 2, 33]
    T = args[4]
    for i, m in enumerate(nv):
        T[i, max(m, 1):] = T[i, max(m, 1) - 1]
    live = np.arange(45)[None, :] < nv[:, None]
    args[6] = np.where(live, args[6], 1.0)
    targs = [torch.as_tensor(x, dtype=dtype, device=card) for x in args]
    tnv = torch.as_tensor(nv, device=card)
    for dt in (None, torch.as_tensor(np.diff(T, axis=1), device=card)):
        k = cuda_celerite.batched_loglike_multi(*targs, tnv, dt)
        p = cuda_celerite.batched_loglike_multi_plain(*targs, tnv, dt)
        torch.cuda.synchronize()
        assert bool(k[0] == -math.inf) and bool(p[0] == -math.inf)
        assert float(k[2]) == 0.0 and float(p[2]) == 0.0
        fin = torch.isfinite(p)
        assert int(fin.sum()) == 5 and bool(torch.isfinite(k[fin]).all())
        err = (k[fin] - p[fin]).abs()
        if dtype == torch.float64:
            err = err / p[fin].abs().clamp_min(1e-300)
        assert float(err.max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_multi_kernel_on_one_grid_is_k1_on_card(card, dtype):
    """K2 with every lane on one grid and n_valid = N gives K1's values."""
    a, b, c, d, t, y, s2 = (torch.as_tensor(x, dtype=dtype, device=card)
                            for x in _problem(37, 20, 200, seed=4))
    k1 = batched_loglike(a, b, c, d, t, y, s2)
    k2 = cuda_celerite.batched_loglike_multi(a, b, c, d, t.expand(37, 200), y, s2,
                                             torch.full((37,), 200, device=card))
    fin = torch.isfinite(k1)
    assert torch.equal(fin, torch.isfinite(k2))
    rel = float(((k2[fin] - k1[fin]).abs() / k1[fin].abs()).max())
    assert rel <= (1e-12 if dtype == torch.float64 else 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("J", [3, 20, 32])
@pytest.mark.parametrize("with_dt", [False, True])
def test_per_lane_adjoint_kernels_match_plain_on_card(card, dtype, J, with_dt):
    """Per-lane K3/K4 against their plain versions, as the shared-grid test
    above; t, y and sigma2 cotangents are exactly zero past n_valid."""
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp

    args, DT, nv = _ragged(37, J, 100, seed=J)
    args64 = [torch.as_tensor(x, dtype=torch.float64, device=card) for x in args]
    args = [x.to(dtype) for x in args64]
    nv = torch.as_tensor(nv, device=card)
    live = torch.arange(100, device=card)[None, :] < nv[:, None]
    dt = torch.as_tensor(DT, device=card) if with_dt else None
    n3, n4 = vjp.FWD_AUG_MULTI_LAUNCHES, vjp.BWD_MULTI_LAUNCHES
    ll, res = vjp.fwd_aug(*args, dt=dt, kc=8, n_valid=nv)
    g = torch.where(torch.isfinite(ll), torch.linspace(0.5, 1.5, 37, dtype=dtype, device=card), 0.0)
    grads = vjp.bwd(*args, res, g, dt=dt, kc=8, n_valid=nv)
    torch.cuda.synchronize()
    assert (vjp.FWD_AUG_MULTI_LAUNCHES, vjp.BWD_MULTI_LAUNCHES) == (n3 + 1, n4 + 1)
    ll_p, res_p = vjp.fwd_aug_plain(*args64, dt=dt, kc=8, n_valid=nv)
    grads_p = vjp.bwd_plain(*args64, res_p, g.double(), dt=dt, kc=8, n_valid=nv)
    assert torch.equal(torch.isneginf(ll), torch.isneginf(ll_p)) and bool(ll[0] == -math.inf)
    assert grads[4].shape == (37, 100)
    for x in grads:
        assert bool((x[0] == 0).all())  # the non-PD lane
    for x in grads[4:]:
        assert bool((x[~live] == 0).all())
    fin = torch.isfinite(ll_p)
    ours = _adjoint_rows(fin, ll, res, grads)
    refs = _adjoint_rows(fin, ll_p, res_p, grads_p)
    if dtype == torch.float64:
        bounds = [1e-9] * len(refs)
    else:
        ll_q, res_q = vjp.fwd_aug_plain(*args, dt=dt, kc=8, n_valid=nv)
        own = _adjoint_rows(fin, ll_q, res_q,
                            vjp.bwd_plain(*args, res_q, g, dt=dt, kc=8, n_valid=nv))
        bounds = [max(4.0 * _rel_rows(q, r), 1e-5) for q, r in zip(own, refs)]
    for i, (x, r, bound) in enumerate(zip(ours, refs, bounds)):
        assert _rel_rows(x, r) <= bound, i


def _rows_rel(x, ref):
    """2-norm relative error of each row (the leading axis)."""
    x, ref = x.double().reshape(x.shape[0], -1), ref.double().reshape(ref.shape[0], -1)
    return (x - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-300)


def _spread_ok(x, own, ref):
    """PERF.md's float32 gate on many rows: at the median and the 90th
    percentile of the rows, the kernel's error within 3x the plain
    float32 loop's own (or 1e-7)."""
    qs = torch.tensor([0.5, 0.9], dtype=torch.float64, device=ref.device)
    k50, k90 = torch.quantile(_rows_rel(x, ref), qs).tolist()
    q50, q90 = torch.quantile(_rows_rel(own, ref), qs).tolist()
    return k50 <= max(3.0 * q50, 1e-7) and k90 <= max(3.0 * q90, 1e-7)


def _adjoint_vs_plain(card, dtype, np_args, DT, kc, nv=None, spread=False):
    """K3 and K4 (one launch each) against their plain versions on the
    same inputs, with the tolerances above; returns K4's launch shape.
    ``spread``: float32 gated by :func:`_spread_ok` instead."""
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp

    B = np_args[0].shape[0]
    args64 = [torch.as_tensor(x, dtype=torch.float64, device=card) for x in np_args]
    args = [x.to(dtype) for x in args64]
    dt = None if DT is None else torch.as_tensor(DT, device=card)
    kw = dict(dt=dt, kc=kc)
    if nv is not None:
        kw["n_valid"] = torch.as_tensor(nv, device=card)
    counts = lambda: (vjp.FWD_AUG_LAUNCHES + vjp.FWD_AUG_MULTI_LAUNCHES  # noqa: E731
                      + vjp.WIDE_FWD_AUG_LAUNCHES + vjp.WIDE_FWD_AUG_MULTI_LAUNCHES,
                      vjp.BWD_LAUNCHES + vjp.BWD_MULTI_LAUNCHES
                      + vjp.WIDE_BWD_LAUNCHES + vjp.WIDE_BWD_MULTI_LAUNCHES)
    n3, n4 = counts()
    ll, res = vjp.fwd_aug(*args, **kw)
    g = torch.where(torch.isfinite(ll), torch.linspace(0.5, 1.5, B, dtype=dtype, device=card), 0.0)
    grads = vjp.bwd(*args, res, g, **kw)
    torch.cuda.synchronize()
    assert counts() == (n3 + 1, n4 + 1)
    ll_p, res_p = vjp.fwd_aug_plain(*args64, **kw)
    grads_p = vjp.bwd_plain(*args64, res_p, g.double(), **kw)
    assert torch.equal(torch.isneginf(ll), torch.isneginf(ll_p))
    if nv is not None:
        live = torch.arange(args[4].shape[1], device=card)[None, :] < kw["n_valid"][:, None]
        for x in grads[4:]:
            assert bool((x[~live] == 0).all())
    fin = torch.isfinite(ll_p)
    assert bool(fin.any())
    ours = _adjoint_rows(fin, ll, res, grads)
    refs = _adjoint_rows(fin, ll_p, res_p, grads_p)
    if dtype == torch.float64:
        bounds = [1e-9] * len(refs)
    else:
        ll_q, res_q = vjp.fwd_aug_plain(*args, **kw)
        own = _adjoint_rows(fin, ll_q, res_q, vjp.bwd_plain(*args, res_q, g, **kw))
        bounds = [max(4.0 * _rel_rows(q, r), 1e-5) for q, r in zip(own, refs)]
    for i, (x, r, bound) in enumerate(zip(ours, refs, bounds)):
        if spread and dtype == torch.float32:
            assert _spread_ok(x, own[i], r), i
        else:
            assert _rel_rows(x, r) <= bound, i
    J = args[0].shape[1]
    if J > vjp.NARROW_TERMS:
        sms = torch.cuda.get_device_properties(card).multi_processor_count
        return vjp.wide_shape(J, dtype, B, kc, sms)
    return vjp.bwd_launch_shape(dtype, J, kc, B)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("J", [3, 20, 32])
@pytest.mark.parametrize("kc", [1, 3, 8, 103])
@pytest.mark.parametrize("batch", [1, 37])
def test_adjoint_kernels_across_chunk_lengths_on_card(card, dtype, J, kc, batch):
    """Shared grid, N = 100: checkpoints every step, every 3, every 8 and
    once (kc = N + 3, swept in sub-chunks of at most 32 steps with the T
    recursion replayed from the checkpoint); one chain, or 37 with a
    non-PD lane (not a multiple of the chains per block). float64 at
    J = 32 sweeps kc = 8 in sub-chunks shorter than the chunk."""
    np_args = _problem(37, J, 100, seed=J + kc)
    if batch == 1:
        np_args = tuple(x[1:2] if x.ndim == 2 else x for x in np_args)
    cpb, ks, _ = _adjoint_vs_plain(card, dtype, np_args, None, kc)
    if dtype == torch.float64 and J == 32 and kc == 8:
        assert ks < kc
    assert cpb >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("J", [3, 20, 32])
@pytest.mark.parametrize("kc", [1, 3, 8, 103])
def test_per_lane_adjoint_kernels_across_chunk_lengths_on_card(card, dtype, J, kc):
    """Per-lane ragged grids (37 chains, ragged n_valid, host spacings) at
    the same chunk lengths; cotangents exactly zero past n_valid."""
    args, DT, nv = _ragged(37, J, 100, seed=J + kc)
    _adjoint_vs_plain(card, dtype, args, DT, kc, nv)


@pytest.mark.cuda
def test_multi_backward_on_card_runs_the_kernels_only(card, monkeypatch):
    """Value and gradient of a ragged CUDA batch go through the per-lane K3
    and K4 and never through a plain version; without a gradient, K2."""
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp

    def refuse(*_a, **_k):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(vjp, "fwd_aug_plain", refuse)
    monkeypatch.setattr(vjp, "bwd_plain", refuse)
    monkeypatch.setattr(cuda_celerite, "_plain", refuse)
    args, DT, nv = _ragged(9, 20, 64, seed=5)
    args = [torch.as_tensor(x, device=card).requires_grad_(True) for x in args]
    nv, dt = torch.as_tensor(nv, device=card), torch.as_tensor(DT, device=card)
    counts = lambda: (cuda_celerite.MULTI_LAUNCHES, vjp.FWD_AUG_MULTI_LAUNCHES,  # noqa: E731
                      vjp.BWD_MULTI_LAUNCHES)
    n2, n3, n4 = counts()
    ll = cuda_celerite.batched_loglike_multi(*args, nv, dt)
    grads = torch.autograd.grad(ll.sum(), args)
    torch.cuda.synchronize()
    assert counts() == (n2, n3 + 1, n4 + 1)
    assert bool((grads[0][0] == 0).all()) and bool(torch.isneginf(ll[0]))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with torch.no_grad():
        cuda_celerite.batched_loglike_multi(*args, nv, dt)
    assert counts() == (n2 + 1, n3 + 1, n4 + 1)


# ---------------------------------------------------------------------------
# the table-streaming kernel K0 (celerite_tables)
# ---------------------------------------------------------------------------


def _tables_check(k, p, dtype, tol):
    """K0 against the plain loop: the same -inf lanes (lane 0 among
    them), the finite values within the gate."""
    assert torch.equal(torch.isneginf(k), torch.isneginf(p)) and bool(k[0] == -math.inf)
    fin = torch.isfinite(p)
    assert bool(torch.isfinite(k[fin]).all())
    err = (k[fin] - p[fin]).abs()
    if dtype == torch.float64:
        err = err / p[fin].abs()
    assert float(err.max()) <= tol
    return int(fin.sum())


def _tables_run(card, B, J, N, seed, dtype, tol, phi_rows=False, shape=None):
    """K0 (one launch) and its plain version on the same tables: from
    build_tables, or with phi drawn row by row (halves unequal, first row
    not zero)."""
    a, b, c, d, t, y, s2 = (torch.as_tensor(x, dtype=dtype, device=card)
                            for x in _problem(B, J, N, seed))
    U, V, phi = cuda_celerite.build_tables(a, b, c, d, t)
    if phi_rows:
        rng = np.random.default_rng(seed + 1)
        phi = torch.as_tensor(rng.uniform(0.2, 1.0, tuple(U.shape)), dtype=dtype, device=card)
        assert not torch.equal(phi[:, :J], phi[:, J:])
    before = cuda_celerite.TABLES_LAUNCHES
    if shape is None:
        k = cuda_celerite.loglike_from_tables(U, V, phi, y, s2, a.sum(1))
    else:
        k = cuda_celerite._launch_tables(U, V, phi, y, s2, a.sum(1), shape=shape)
    assert cuda_celerite.TABLES_LAUNCHES == before + 1
    p = cuda_celerite.loglike_from_tables_plain(U, V, phi, y, s2, a.sum(1))
    torch.cuda.synchronize()
    return _tables_check(k, p, dtype, tol)


# f64: the kernel and the plain loop differ only in the order of their
# sums; f32: as chip_smoke.py (0.05 nats, K1's gate)
TABLES_GATES = [(torch.float64, 1e-9), (torch.float32, 5e-2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TABLES_GATES)
@pytest.mark.parametrize("J", [1, 3, 20, 21, 32])
def test_tables_kernel_matches_plain_on_card(card, dtype, tol, J):
    """K0 on tables from build_tables, a ragged batch edge (37 chains), J
    on both sides of the kernel's rounding of J up to 4 and at its ends,
    a non-PD lane; one launch per call."""
    fin = _tables_run(card, 37, J, 300, J, dtype, tol)
    # at J = 1 two more chains draw a single term with b d > a c, not a
    # positive-definite kernel, and are -inf in both
    assert fin == (36 if J > 1 else 34)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TABLES_GATES)
@pytest.mark.parametrize("B", [1, 37, "sms", 4095])
def test_tables_kernel_batch_widths_on_card(card, dtype, tol, B):
    """One chain; a ragged edge; as many chains as SMs; 4095 chains
    (several rounds over the SMs, a last block part empty, copies
    narrower than 16 bytes since B is odd)."""
    if B == "sms":
        B = torch.cuda.get_device_properties(card).multi_processor_count
    if B == 1:  # lane 0 of _problem is the non-PD one: take the second
        a, b, c, d, t, y, s2 = (torch.as_tensor(x[1:2] if x.ndim == 2 else x, dtype=dtype,
                                                device=card) for x in _problem(2, 20, 70, 41))
        U, V, phi = cuda_celerite.build_tables(a, b, c, d, t)
        k = cuda_celerite.loglike_from_tables(U, V, phi, y, s2, a.sum(1))
        p = cuda_celerite.loglike_from_tables_plain(U, V, phi, y, s2, a.sum(1))
        torch.cuda.synchronize()
        err = float((k - p).abs()[0]) / (float(p.abs()[0]) if dtype == torch.float64 else 1.0)
        assert bool(torch.isfinite(k).all()) and err <= tol
        return
    assert _tables_run(card, B, 20, 300, B, dtype, tol) == B - 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TABLES_GATES)
@pytest.mark.parametrize("J", [3, 20])
@pytest.mark.parametrize("B", [37, 40])
def test_tables_kernel_unequal_phi_on_card(card, dtype, tol, J, B):
    """phi drawn row by row, its halves unequal and its first row not
    zero: the kernel never assumes build_tables' [ec; ec]."""
    assert _tables_run(card, B, J, 300, J + B, dtype, tol, phi_rows=True) == B - 1


# every count of chains a block the host can pick, with chunks of 4, 8
# and 16 steps (and 32 with one chain a block), where the four buffers fit
# in a block's shared memory at J = 20
TABLES_SHAPES = [(dtype, tol, chains, steps) for dtype, tol in TABLES_GATES
                 for chains in (1, 2, 4) for steps in (4, 8, 16, 32)
                 if (steps < 32 or chains == 1)
                 and chains * steps * (2 if dtype == torch.float64 else 1) <= 64]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,chains,steps", TABLES_SHAPES)
@pytest.mark.parametrize("B", [37, 40])
def test_tables_kernel_each_shape_on_card(card, dtype, tol, chains, steps, B):
    """Each launch shape on a ragged B (4-byte copies, idle warps) and on
    B = 40 (16-byte copies where the chains a block allow), N = 70 (no
    whole number of chunks), unequal phi halves."""
    assert _tables_run(card, B, 20, 70, B + chains, dtype, tol, phi_rows=True,
                       shape=(chains, steps)) == B - 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tables_shape_the_host_picks_on_card(card, dtype):
    """A count of chains a block from 1, 2, 4 and a chunk of 4 to 32
    steps that keep at least one block resident; one round over the SMs
    while B allows one warp a scheduler (4 x the SM count). A shape that
    does not fit raises."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for B in (1, 128, sms, sms + 1, 1024, 4096):
        sh = cuda_celerite.tables_launch_shape(B, 20, dtype)
        assert sh["sms"] == sms and sh["blocks_per_sm"] >= 1 and sh["smem"] <= 232448
        assert sh["chains"] in (1, 2, 4) and sh["steps"] in (4, 8, 16, 32)
        blocks = -(-B // sh["chains"])
        if B <= 4 * sms:
            assert blocks <= sms * sh["blocks_per_sm"]
    a, b, c, d, t, y, s2 = (torch.as_tensor(x, dtype=dtype, device=card)
                            for x in _problem(8, 32, 40, 3))
    U, V, phi = cuda_celerite.build_tables(a, b, c, d, t)
    with pytest.raises(RuntimeError, match="celerite_tables launch failed"):
        cuda_celerite._launch_tables(U, V, phi, y, s2, a.sum(1), shape=(8, 8))
    with pytest.raises(RuntimeError, match="celerite_tables launch failed"):
        cuda_celerite._launch_tables(U, V, phi, y, s2, a.sum(1), shape=(4, 32 * 1024))
    with pytest.raises(RuntimeError, match="celerite_tables launch failed"):
        cuda_celerite._launch_tables(U, V, phi, y, s2, a.sum(1), shape=(3, 8))


@pytest.mark.cuda
def test_tables_kernel_is_k1_on_card(card):
    """float64: K0 through batched_loglike_tables equals K1 on the same
    inputs (no host spacings) within 1e-9 relative."""
    args = [torch.as_tensor(x, device=card) for x in _problem(70, 20, 485, seed=11)]
    k0 = cuda_celerite.batched_loglike_tables(*args)
    k1 = batched_loglike(*args)
    torch.cuda.synchronize()
    fin = torch.isfinite(k1)
    assert torch.equal(fin, torch.isfinite(k0))
    assert float(((k0[fin] - k1[fin]).abs() / k1[fin].abs()).max()) <= 1e-9


@pytest.mark.cuda
def test_tables_wrapper_rejects_on_card(card, monkeypatch):
    """A CUDA tensor never reaches the plain loop; what K0 does not take
    raises."""
    def refuse(*_a, **_k):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(cuda_celerite, "loglike_from_tables_plain", refuse)
    a, b, c, d, t, y, s2 = (torch.as_tensor(x, device=card) for x in _problem(4, 5, 20, seed=1))
    U, V, phi = cuda_celerite.build_tables(a, b, c, d, t)
    cuda_celerite.loglike_from_tables(U, V, phi, y, s2, a.sum(1))
    with pytest.raises(ValueError, match="sigma2"):
        cuda_celerite.loglike_from_tables(U, V, phi, y, s2.float(), a.sum(1))
    wide = torch.zeros(20, 2 * cuda_celerite.MAX_TERMS + 2, 4, dtype=U.dtype, device=card)
    with pytest.raises(ValueError, match=f"at most {cuda_celerite.MAX_TERMS}"):
        cuda_celerite.loglike_from_tables(wide, wide, wide, y, s2, a.sum(1))
    with pytest.raises(ValueError, match="no gradient"):
        cuda_celerite.batched_loglike_tables(a.requires_grad_(True), b, c, d, t, y, s2)


# ---------------------------------------------------------------------------
# the GP object API and the post-fit diagnostics on the card
# ---------------------------------------------------------------------------


def _gp_problem(B, J, N, seed):
    """(a, b, c, d) (B, J) with a c > b d term by term (positive
    definite), sorted t (N,), y, sigma2 (B, N); row 0 made not positive
    definite."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.1, 1.0, (B, J))
    b = 0.1 * a * rng.uniform(0.0, 1.0, (B, J))
    c = rng.uniform(0.05, 0.5, (B, J))
    d = c * rng.uniform(0.0, 1.0, (B, J))
    t = np.sort(rng.uniform(0.0, 80.0, N))
    y = rng.normal(size=(B, N))
    s2 = rng.uniform(0.05, 0.2, (B, N))
    a[0] = -50.0 * a[0]
    return a, b, c, d, t, y, s2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 5e-2)])
def test_gp_logpdf_runs_k1_on_card(card, dtype, tol):
    """ConditionedGP.logpdf on CUDA tensors is one K1 launch and equals
    the CPU's plain loop (f64 relative, f32 in nats); row 0 is -inf."""
    from pioran_tpu_torch.convert import gp_from_numpy

    a, b, c, d, t, y, s2 = _gp_problem(6, 20, 150, seed=21)
    fx = gp_from_numpy(a, b, c, d, t, s2, mean=0.1, device=card, dtype=dtype)
    before = cuda_celerite.LAUNCHES
    lp = fx.logpdf(torch.as_tensor(y, dtype=dtype, device=card))
    assert cuda_celerite.LAUNCHES == before + 1
    ref = gp_from_numpy(a, b, c, d, t, s2, mean=0.1, device="cpu").logpdf(torch.as_tensor(y))
    lp = lp.double().cpu()
    assert bool(torch.isneginf(lp[0])) and bool(torch.isneginf(ref[0]))
    err = (lp[1:] - ref[1:]).abs()
    if dtype == torch.float64:
        err = err / ref[1:].abs()
    assert float(err.max()) <= tol


@pytest.mark.cuda
def test_posterior_solve_runs_k3k4_on_card(card, monkeypatch):
    """The posterior solve on CUDA tensors: z = -ȳ of one K3 and one K4
    launch, never the plain scans; it equals the three-scan solve run on
    the CPU to 1e-9 in 2-norm per row, NaN on the -inf row; the
    posterior mean (both methods) equals the dense predictor to 1e-8."""
    from pioran_tpu_torch.convert import gp_from_numpy
    from pioran_tpu_torch.models.gp import posterior
    from pioran_tpu_torch.ops import celerite as cel, cuda_celerite_vjp as vjp, direct

    a, b, c, d, t, y, s2 = _gp_problem(5, 20, 160, seed=22)
    z_ref = cel.celerite_factor_solve(*(torch.as_tensor(x) for x in (a, b, c, d, t, y, s2)))[0]

    def refuse(*_a, **_k):
        raise AssertionError("a plain loop ran on CUDA tensors")

    for name in ("celerite_factor_solve", "_factor", "_forward_sub"):
        monkeypatch.setattr(cel, name, refuse)
    fx = gp_from_numpy(a, b, c, d, t, s2, device=card)
    ty = torch.as_tensor(y, device=card)
    before = (vjp.FWD_AUG_LAUNCHES, vjp.BWD_LAUNCHES)
    z = cel._solve(fx.gp.kernel, fx.t, ty, fx.sigma2).cpu()
    assert (vjp.FWD_AUG_LAUNCHES, vjp.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert bool(torch.isnan(z[0]).all())
    assert float((torch.linalg.vector_norm(z[1:] - z_ref[1:], dim=-1)
                  / torch.linalg.vector_norm(z_ref[1:], dim=-1)).max()) <= 1e-9
    tau = torch.linspace(-5.0, 85.0, 200, dtype=torch.float64, device=card)
    keep = slice(1, None)
    post = posterior(gp_from_numpy(a[keep], b[keep], c[keep], d[keep], t, s2[keep],
                                   device=card), ty[keep])
    ref = direct.predict_direct(post.fx.gp.kernel, tau, post.fx.t, post.y, post.fx.sigma2)
    for method in ("matmul", "scan"):
        mu = post.mean(tau, method=method)
        assert float((torch.linalg.vector_norm(mu - ref, dim=-1)
                      / torch.linalg.vector_norm(ref, dim=-1)).max()) <= 1e-8


@pytest.mark.cuda
def test_posterior_predict_checks_on_card(card, tmp_path):
    """run_posterior_predict_checks on CUDA tensors without figures: the
    text artifacts, finite, K3/K4 launched by the time-series check."""
    import os

    from pioran_tpu_torch import ScalableGP, SingleBendingPowerLaw, approx
    from pioran_tpu_torch.diagnostics import run_posterior_predict_checks
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp

    rng = np.random.default_rng(23)
    t = np.sort(rng.uniform(0.0, 200.0, 90))
    y = np.exp(rng.normal(0.0, 0.3, 90))
    yerr = 0.05 * y
    P = 16
    samples = np.column_stack([rng.uniform(0.3, 1.0, P), 10 ** rng.uniform(-2.0, -1.5, P),
                               rng.uniform(2.5, 3.2, P), 10 ** rng.uniform(-1.8, -1.2, P),
                               rng.uniform(0.8, 1.3, P), rng.normal(0.0, 0.05, P)])
    f_min, f_max = 1.0 / (t[-1] - t[0]), 1.0 / np.min(np.diff(t)) / 2.0

    def gp_model(tt, yy, ee, params):
        kern = approx(SingleBendingPowerLaw(params[:, 0], params[:, 1], params[:, 2]),
                      f_min, f_max, 20, params[:, 3])
        return ScalableGP(params[:, 5:6], kern)(tt, params[:, 4:5] * ee**2 / yy**2)

    before = vjp.BWD_LAUNCHES
    path = str(tmp_path) + "/"
    run_posterior_predict_checks(
        samples, ["a1", "f1", "a2", "variance", "nu", "mu"],
        {"psd": ["a1", "f1", "a2"], "norm": "variance", "scale_err": "nu", "mean": "mu"},
        t, y, yerr, SingleBendingPowerLaw, gp_model, True, n_samples=P, path=path,
        generator=torch.Generator(device=card).manual_seed(0), make_figures=False,
        device=card)
    assert vjp.BWD_LAUNCHES > before
    for name in ("psd_ppc_data.txt", "psd_noise_levels.txt", "lsp_ppc_data.txt",
                 "binned_lsp_data.txt", "ppc_timeseries_quantiles.txt",
                 "ppc_residuals_quantiles.txt", "ppc_residuals_mean.txt", "ppc_t_pred.txt",
                 "ppc_residuals_acvf.txt"):
        assert np.all(np.isfinite(np.loadtxt(os.path.join(path, name)))), name
    assert np.loadtxt(os.path.join(path, "psd_ppc_data.txt")).shape == (11, 1000)


# ---------------------------------------------------------------------------
# checkpoints and the multi-device code on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_checkpoint_from_cuda_restores_onto_card(card, tmp_path):
    """A state of CUDA tensors and a CUDA generator saved and restored
    onto the card: the same values and dtypes on the card, and the
    generator's seed and Philox offset back, so it draws what it would
    have drawn."""
    from pioran_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint

    gen = torch.Generator(device=card).manual_seed(11)
    torch.randn(1001, generator=gen, device=card)  # an offset that is not a multiple of 4
    state = {"x": torch.randn(64, 3, generator=gen, device=card, dtype=torch.float32),
             "logZ": torch.tensor(2.5, device=card, dtype=torch.float64), "i": 7, "gen": gen}
    save_checkpoint(str(tmp_path), state, 7)
    expected = torch.rand(513, generator=gen, device=card)
    template = dict(state, gen=torch.Generator(device=card).manual_seed(0))
    got, step = restore_checkpoint(str(tmp_path), template)
    assert step == 7 and got["i"] == 7 and got["gen"] is template["gen"]
    for k in ("x", "logZ"):
        assert got[k].is_cuda and got[k].dtype == state[k].dtype
        assert torch.equal(got[k], state[k])
    assert torch.equal(torch.rand(513, generator=got["gen"], device=card), expected)


@pytest.mark.cuda
def test_smc_resume_bit_equal_on_card(card, tmp_path):
    """run_smc_resumable on CUDA tensors with a CUDA generator, resumed
    from a mid-run checkpoint, equals run_smc bit for bit."""
    import os
    import shutil

    from pioran_tpu_torch.samplers.smc import run_smc, run_smc_resumable

    def loglike(Z):
        return -0.5 * torch.sum((Z - 1.0) ** 2 / 0.25, dim=1)

    def logprior(Z):
        return -0.5 * torch.sum(Z**2, dim=1)

    z0 = torch.as_tensor(np.random.default_rng(1).normal(size=(1024, 3)), device=card)
    kw = dict(num_moves=4, move="mala")
    ref = run_smc(loglike, logprior, z0, torch.Generator(device=card).manual_seed(0), **kw)
    full = str(tmp_path / "full")
    run_smc_resumable(loglike, logprior, z0, torch.Generator(device=card).manual_seed(0),
                      full, max_to_keep=1000, **kw)
    mid = f"step_{max(ref.num_steps // 2, 1):08d}"
    os.makedirs(str(tmp_path / "mid"))
    shutil.copy(os.path.join(full, mid), str(tmp_path / "mid"))
    res = run_smc_resumable(loglike, logprior, z0, torch.Generator(device=card).manual_seed(0),
                            str(tmp_path / "mid"), **kw)
    assert res.num_steps == ref.num_steps and torch.equal(res.logZ, ref.logZ)
    assert torch.equal(res.particles, ref.particles)


@pytest.mark.cuda
def test_sharded_batched_fn_on_nccl_world_of_one(card):
    """A one-rank NCCL group and its CUDA mesh: sharded_batched_fn runs K1
    once at the full width and returns the unsharded values; the mesh
    refuses a spec that is not on the rank's own device."""
    import socket
    from datetime import timedelta

    import torch.distributed as dist

    from pioran_tpu_torch import parallel as par
    from pioran_tpu_torch.parallel.mesh import check_device

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    par.initialize_distributed(init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
                               timeout=timedelta(seconds=60))
    try:
        assert dist.get_backend() == "nccl"
        mesh = par.make_mesh("chains", device_type="cuda")
        a, b, c, d, t, y, s2 = _problem(64, 20, 300, seed=5)
        args = [torch.as_tensor(x, device=card) for x in (a, b, c, d, t, y, s2)]
        rows = torch.arange(64, device=card)

        def batch(idx):
            return batched_loglike(*(x[idx] for x in args[:4]), args[4], args[5][idx],
                                   args[6][idx])

        before = cuda_celerite.LAUNCHES
        got = par.sharded_batched_fn(batch, mesh, "chains")(rows)
        assert cuda_celerite.LAUNCHES == before + 1
        assert torch.equal(got, batch(rows))
        with pytest.raises(ValueError, match="this rank's device"):
            check_device(mesh, "cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the wide kernels past 32 terms (csrc/celerite_wide.cu): K1, K2, K0, K3, K4
# ---------------------------------------------------------------------------

WIDE_J = [33, 40, 64, 65, 70, 100, 128]


def _wide_counts():
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp

    return {"fwd": cuda_celerite.WIDE_LAUNCHES, "multi": cuda_celerite.WIDE_MULTI_LAUNCHES,
            "tables": cuda_celerite.WIDE_TABLES_LAUNCHES,
            "fwd_aug": vjp.WIDE_FWD_AUG_LAUNCHES, "bwd": vjp.WIDE_BWD_LAUNCHES,
            "fwd_aug_multi": vjp.WIDE_FWD_AUG_MULTI_LAUNCHES,
            "bwd_multi": vjp.WIDE_BWD_MULTI_LAUNCHES,
            "narrow": (cuda_celerite.LAUNCHES, cuda_celerite.MULTI_LAUNCHES,
                       cuda_celerite.TABLES_LAUNCHES, vjp.FWD_AUG_LAUNCHES, vjp.BWD_LAUNCHES,
                       vjp.FWD_AUG_MULTI_LAUNCHES, vjp.BWD_MULTI_LAUNCHES)}


def _moved(before, **expected):
    """The wide counters moved by ``expected`` and no warp-per-chain one moved."""
    after = _wide_counts()
    assert after["narrow"] == before["narrow"]
    for k, v in before.items():
        if k != "narrow":
            assert after[k] - v == expected.get(k, 0), k


def _values_close(k, p, dtype, tol):
    assert torch.equal(torch.isneginf(k), torch.isneginf(p)) and bool(k[0] == -math.inf)
    fin = torch.isfinite(p)
    assert int(fin.sum()) == k.shape[0] - 1
    err = (k[fin] - p[fin]).abs()
    if dtype == torch.float64:
        err = err / p[fin].abs()
    assert float(err.max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 5e-2)])
@pytest.mark.parametrize("J", WIDE_J)
@pytest.mark.parametrize("with_dt", [False, True])
def test_wide_kernel_matches_plain_on_card(card, dtype, tol, J, with_dt):
    """The wide K1 on a ragged batch (37 chains, lane 0 not positive
    definite) against its plain version; no warp-per-chain kernel runs."""
    a, b, c, d, t, y, s2 = _problem(37, J, 100, seed=J)
    args = [torch.as_tensor(x, dtype=dtype, device=card) for x in (a, b, c, d, t, y, s2)]
    dt = torch.as_tensor(np.diff(t), device=card) if with_dt else None
    before = _wide_counts()
    k = batched_loglike(*args, dt)
    _moved(before, fwd=1)
    p = batched_loglike_plain(*args, dt)
    torch.cuda.synchronize()
    _values_close(k, p, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 5e-2)])
@pytest.mark.parametrize("J", WIDE_J)
def test_wide_multi_kernel_matches_plain_on_card(card, dtype, tol, J):
    """The wide K2 on ragged per-chain grids with host spacings."""
    args, DT, nv = _ragged(37, J, 100, seed=J)
    targs = [torch.as_tensor(x, dtype=dtype, device=card) for x in args]
    nv, dt = torch.as_tensor(nv, device=card), torch.as_tensor(DT, device=card)
    before = _wide_counts()
    k = cuda_celerite.batched_loglike_multi(*targs, nv, dt)
    _moved(before, multi=1)
    p = cuda_celerite.batched_loglike_multi_plain(*targs, nv, dt)
    torch.cuda.synchronize()
    _values_close(k, p, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TABLES_GATES)
@pytest.mark.parametrize("J", WIDE_J)
def test_wide_tables_kernel_matches_plain_on_card(card, dtype, tol, J):
    """The wide K0 against its plain version, with unequal phi halves."""
    a, b, c, d, t, y, s2 = (torch.as_tensor(x, dtype=dtype, device=card)
                            for x in _problem(37, J, 100, seed=J + 3))
    U, V, phi = cuda_celerite.build_tables(a, b, c, d, t)
    phi[:, J:] *= 0.97
    before = _wide_counts()
    k = cuda_celerite.loglike_from_tables(U, V, phi, y, s2, a.sum(1))
    _moved(before, tables=1)
    p = cuda_celerite.loglike_from_tables_plain(U, V, phi, y, s2, a.sum(1))
    torch.cuda.synchronize()
    _values_close(k, p, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("J", WIDE_J)
@pytest.mark.parametrize("with_dt", [False, True])
def test_wide_adjoint_kernels_match_plain_on_card(card, dtype, J, with_dt):
    """The wide K3 and K4 on a shared grid against their plain versions
    (37 chains, lane 0 non-PD: -inf and a zero gradient); float32 under
    PERF.md's gate on the rows' median and 90th percentile."""
    np_args = _problem(37, J, 100, seed=J)
    before = _wide_counts()
    _adjoint_vs_plain(card, dtype, np_args, np.diff(np_args[4]) if with_dt else None, 8,
                      spread=True)
    _moved(before, fwd_aug=1, bwd=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("J", WIDE_J)
def test_wide_per_lane_adjoint_kernels_match_plain_on_card(card, dtype, J):
    """The wide per-lane K3 and K4 on ragged grids; the t, y and sigma2
    cotangents exactly zero past n_valid."""
    args, DT, nv = _ragged(37, J, 100, seed=J)
    before = _wide_counts()
    _adjoint_vs_plain(card, dtype, args, DT, 8, nv, spread=True)
    _moved(before, fwd_aug_multi=1, bwd_multi=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 5e-2)])
def test_wide_per_lane_past_64_on_card(card, dtype, tol):
    """The per-lane K2, K3 and K4 past the registers (J = 100) on ragged
    grids of more chains than the card has SMs (140), against their plain
    versions: K2 by value, K3/K4 as the other adjoint tests."""
    args, DT, nv = _ragged(140, 100, 100, seed=100)
    targs = [torch.as_tensor(x, dtype=dtype, device=card) for x in args]
    tnv, dt = torch.as_tensor(nv, device=card), torch.as_tensor(DT, device=card)
    before = _wide_counts()
    k = cuda_celerite.batched_loglike_multi(*targs, tnv, dt)
    _moved(before, multi=1)
    p = cuda_celerite.batched_loglike_multi_plain(*targs, tnv, dt)
    torch.cuda.synchronize()
    _values_close(k, p, dtype, tol)
    before = _wide_counts()
    _adjoint_vs_plain(card, dtype, args, DT, 8, nv, spread=True)
    _moved(before, fwd_aug_multi=1, bwd_multi=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kc", [1, 3, 8, 103])
@pytest.mark.parametrize("J,B", [(40, 37), (40, 140), (128, 140)],
                         ids=["J40-B37", "J40-B140", "J128-B140"])
def test_wide_adjoint_chunk_lengths_and_placements_on_card(card, dtype, kc, J, B):
    """The wide K4 with checkpoints every step, every 3, every 8 and once
    (kc = N + 3: sub-chunks that divide the 8-step window, with the T
    recursion replayed from the checkpoint), at each placement its launch
    shape picks: at J = 40 the register design (G in registers, the T
    slots in shared memory, fewer or more chains than SMs alike), at
    J = 128 past the registers, with G's tail and the slots in the device
    scratch (with the ks = 8 sub-chunk's rows they exceed shared memory)."""
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    np_args = _problem(B, J, 100, seed=kc)
    shape = _adjoint_vs_plain(card, dtype, np_args, None, kc, spread=True)
    assert (B > sms) == (B == 140)  # 37 chains below the card's SMs, 140 above
    if J == 40:
        assert shape.cpt == 40 and shape.chunk_scratch == 0
        assert 1 <= shape.ks <= min(kc, vjp.WIDE_TAB)
        assert kc <= vjp.WIDE_TAB or vjp.WIDE_TAB % shape.ks == 0
    else:
        assert (shape.cpt, shape.ks) == (128, min(kc, vjp.WIDE_TAB))
        assert shape.carry_scratch and shape.chunk_scratch


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wide_adjoint_at_the_fit_batch_on_card(card, dtype):
    """The wide K3 and K4 at the DRWCelerite SMC fit's batch (B = 1024,
    J = 40) against their plain versions, at the placement the launch
    shape takes there: registers, the T slots in shared memory, and in
    float32 all 8 steps of a chunk in K4's slots and two or more K3
    chains an SM."""
    np_args = _problem(1024, 40, 60, seed=11)
    shape = _adjoint_vs_plain(card, dtype, np_args, None, 8, spread=True)
    assert shape.cpt == 40 and shape.chunk_scratch == 0 and shape.carry_scratch == 0
    if dtype == torch.float32:
        assert shape.ks == 8 and shape.fwd_chains >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("J", [64, 65])
def test_wide_design_switch_on_card(card, dtype, J):
    """Both sides of the J where the wide kernels leave the register
    design for its form past the registers (past 64 terms): K1, K3 and K4
    against their plain versions."""
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp

    np_args = _problem(37, J, 100, seed=J)
    shape = _adjoint_vs_plain(card, dtype, np_args, None, 8, spread=True)
    assert shape.cpt == (64 if J <= 64 else 68)
    args = [torch.as_tensor(x, dtype=dtype, device=card) for x in np_args]
    before = _wide_counts()
    k = batched_loglike(*args)
    _moved(before, fwd=1)
    p = batched_loglike_plain(*args)
    torch.cuda.synchronize()
    fin = torch.isfinite(p)
    assert torch.equal(torch.isfinite(k), fin) and not bool(fin[0]) and bool(fin.any())
    err = (k[fin] - p[fin]).abs()
    if dtype == torch.float64:
        assert float((err / p[fin].abs()).max()) <= 1e-9
    else:
        assert float(err.max()) <= 5e-2


@pytest.mark.cuda
def test_wide_backward_on_card_runs_the_kernels_only(card, monkeypatch):
    """Past 32 terms a CUDA batch reaches only the wide kernels: value and
    gradient through the wide K3/K4, without a gradient the wide K1, on a
    shared grid and on ragged grids; the plain versions never run."""
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp

    def refuse(*_a, **_k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for mod, name in ((vjp, "fwd_aug_plain"), (vjp, "bwd_plain"), (cuda_celerite, "_plain"),
                      (cuda_celerite, "batched_loglike_plain"),
                      (cuda_celerite, "loglike_from_tables_plain")):
        monkeypatch.setattr(mod, name, refuse)
    args = [torch.as_tensor(x, device=card).requires_grad_(True)
            for x in _problem(9, 40, 64, seed=5)]
    before = _wide_counts()
    ll = batched_loglike(*args)
    grads = torch.autograd.grad(ll.sum(), args)
    with torch.no_grad():
        batched_loglike(*args)
        cuda_celerite.batched_loglike_tables(*args)
    torch.cuda.synchronize()
    _moved(before, fwd=1, tables=1, fwd_aug=1, bwd=1)
    assert bool((grads[0][0] == 0).all()) and bool(torch.isneginf(ll[0]))
    assert all(bool(torch.isfinite(g).all()) for g in grads)

    rag, DT, nv = _ragged(9, 40, 64, seed=6)
    rag = [torch.as_tensor(x, device=card).requires_grad_(True) for x in rag]
    nv, dt = torch.as_tensor(nv, device=card), torch.as_tensor(DT, device=card)
    before = _wide_counts()
    ll = cuda_celerite.batched_loglike_multi(*rag, nv, dt)
    grads = torch.autograd.grad(ll.sum(), rag)
    with torch.no_grad():
        cuda_celerite.batched_loglike_multi(*rag, nv, dt)
    torch.cuda.synchronize()
    _moved(before, multi=1, fwd_aug_multi=1, bwd_multi=1)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.cuda
def test_wide_and_narrow_forms_agree_on_card(card):
    """At J = 32 the wide entry (called directly, the register design)
    equals the warp-per-chain kernel within 1e-9 in float64: the same
    function; the design past the registers refuses J <= 64."""
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp

    a, b, c, d, t, y, s2 = (torch.as_tensor(x, device=card) for x in _problem(37, 32, 200, 8))
    k1 = batched_loglike(a, b, c, d, t, y, s2)
    lib = vjp._wide_lib()
    fin = torch.isfinite(k1)
    for cpt in (vjp.wide_cpt(32), 68):  # the register design; past the registers
        out = torch.empty_like(k1)
        args = [x.contiguous() for x in (a, b, c, d, t)] + [None, y, s2, out, None]
        err = lib.celerite_wide_fwd_f64(*[None if x is None else x.data_ptr() for x in args],
                                        37, 32, 200, cpt, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if cpt == 68:
            assert err != 0
            continue
        assert err == 0
        assert torch.equal(fin, torch.isfinite(out))
        assert float(((out[fin] - k1[fin]).abs() / k1[fin].abs()).max()) <= 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 5e-2)])
@pytest.mark.parametrize("J", [65, 70, 100, 128])
@pytest.mark.parametrize("B", [1, 37, 1024])
def test_past_64_kernels_match_plain_on_card(card, dtype, tol, J, B):
    """The design past the registers (64 < J <= 128) at one chain, a
    ragged batch and the fit's batch: K1, K3 and K4 against their plain
    versions (K3/K4 under _adjoint_vs_plain's gates: float32 on the rows'
    median and 90th percentile), with the placement the launch shape
    takes at that batch; in float32 the forward tail in shared memory. One
    chain is row 1 of the 37-chain problem: float64 against the plain
    versions, and in float32 (one row has no median to gate) equal bit
    for bit to that row of the 37-chain launch."""
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp

    np_args = _problem(max(B, 37), J, 60, seed=J + 37 * (B > 1))
    if B == 1:
        np_args = tuple(x if x.ndim == 1 else x[1:2] for x in np_args)
    if B == 1 and dtype == torch.float32:
        full = [torch.as_tensor(x, dtype=dtype, device=card)
                for x in _problem(37, J, 60, seed=J)]
        one = [x if x.dim() == 1 else x[1:2].contiguous() for x in full]
        k_full, k_one = batched_loglike(*full), batched_loglike(*one)
        ll_f, res_f = vjp.fwd_aug(*full)
        ll_o, res_o = vjp.fwd_aug(*one)
        g_f = torch.where(torch.isfinite(ll_f), torch.ones_like(ll_f), torch.zeros_like(ll_f))
        grads_f = vjp.bwd(*full, res_f, g_f)
        grads_o = vjp.bwd(*one, res_o, g_f[1:2])
        torch.cuda.synchronize()
        assert torch.equal(k_one, k_full[1:2]) and torch.equal(ll_o, ll_f[1:2])
        for x, y in zip(res_o, res_f):
            assert torch.equal(x, y[1:2])
        for x, y in zip(grads_o, grads_f):
            if x.dim() == 2:  # per-chain rows (t-bar is summed over the chains)
                assert torch.equal(x, y[1:2])
        assert bool(torch.isfinite(k_one).all())
        return
    args = [torch.as_tensor(x, dtype=dtype, device=card) for x in np_args]
    before = _wide_counts()
    k = batched_loglike(*args)
    p = batched_loglike_plain(*args)
    torch.cuda.synchronize()
    _moved(before, fwd=1)
    fin = torch.isfinite(p)
    assert torch.equal(torch.isfinite(k), fin)
    if bool(fin.any()):
        err = (k[fin] - p[fin]).abs()
        err = err / p[fin].abs() if dtype == torch.float64 else err
        assert float(err.max()) <= tol
    shape = _adjoint_vs_plain(card, dtype, np_args, None, 8, spread=B > 1)
    assert shape.cpt == -(-J // 4) * 4
    if dtype == torch.float32:
        assert shape.fwd_scratch == 0


# ---------------------------------------------------------------------------
# the carry entries of K1, K3 and K4 (a block of a series split along time)
# ---------------------------------------------------------------------------

CARRY_J = [3, 20, 32, 40, 70]  # warp-per-chain and wide, J at and past 32


def _carry_problem(J, dtype, card, N=300, seed=60):
    """Inputs on the card, the spacings with a leading 0 (N,), a g (B,)
    that is 0 on the non-PD lane 0."""
    a, b, c, d, t, y, s2 = (torch.as_tensor(x, dtype=dtype, device=card)
                            for x in _problem(37, J, N, seed + J))
    dt = torch.diff(t)
    dtg = torch.cat([dt.new_zeros(1), dt])
    g = torch.linspace(0.5, 1.5, 37, dtype=dtype, device=card)
    g[0] = 0.0
    return (a, b, c, d, t, y, s2), dtg, g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("J", CARRY_J)
def test_carry_entries_match_plain_on_card(card, dtype, J):
    """Each carry entry on the second block of a series (steps 100 to
    232: not a whole number of 32-step tables or kc = 8 chunks), started
    from the state after the first block and, for K4, from the adjoint
    carry of the third: its partials, carry out, residual tables and
    cotangents against its plain version's, float64 within 1e-9 relative;
    float32 as chip_smoke.py's phase 6 gates it, each output within 3 x
    the plain float32 loop's own error against the plain float64 loop on
    the same inputs."""
    _carry_vs_plain(card, dtype, J, spread=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("J", [100, 128])
def test_past_64_carry_entries_match_plain_on_card(card, dtype, J):
    """As test_carry_entries_match_plain_on_card past the registers, with
    float32 gated as the wide kernels' are (PERF.md §2): each output
    within 3 x the plain float32 loop's own error at the median and 90th
    percentile of the chains' rows, the time partials (which the entry
    sums over the chains) taken chain by chain."""
    _carry_vs_plain(card, dtype, J, spread=True)


def _carry_vs_plain(card, dtype, J, spread):
    from pioran_tpu_torch.ops import cuda_celerite as cc, cuda_celerite_vjp as vjp

    (a, b, c, d, t, y, s2), dtg, g = _carry_problem(J, dtype, card)
    blocks = [slice(0, 100), slice(100, 233), slice(233, 300)]

    def x(sl, xs=(a, b, c, d, t, y, s2, dtg)):
        return (*xs[:4], xs[4][sl], xs[5][:, sl], xs[6][:, sl], xs[7][sl])

    _, cin = cc._plain(*x(blocks[0]), None, carry=vjp.neutral_carry(37, J, a))
    _, c2, _ = vjp.fwd_aug_plain(*x(blocks[1]), carry=cin)
    _, _, r3 = vjp.fwd_aug_plain(*x(blocks[2]), carry=c2)
    ain = vjp.bwd_plain(*x(blocks[2])[:7], r3, g, dtg[blocks[2]],
                        carry=a.new_zeros(37, vjp.adjoint_width(J)))[-1]

    def counts():
        return (cc.CARRY_LAUNCHES + cc.WIDE_CARRY_LAUNCHES,
                vjp.FWD_AUG_CARRY_LAUNCHES + vjp.WIDE_FWD_AUG_CARRY_LAUNCHES,
                vjp.BWD_CARRY_LAUNCHES + vjp.WIDE_BWD_CARRY_LAUNCHES)

    n1 = counts()
    k1 = cc.loglike_carry(*x(blocks[1]), cin)
    k3 = vjp.fwd_aug_carry(*x(blocks[1]), cin)
    k4 = vjp.bwd_carry(*x(blocks[1])[:7], k3[2], g, dtg[blocks[1]], ain)
    torch.cuda.synchronize()
    assert tuple(m - n for m, n in zip(counts(), n1)) == (1, 1, 1)
    assert bool((k4[-1][0] == 0).all()) and bool((k4[0][0] == 0).all())  # g = 0 on lane 0

    def plain(xs, cin, ain, g):
        p1 = cc._plain(*xs, None, carry=cin)
        p3 = vjp.fwd_aug_plain(*xs, carry=cin)
        return p1, p3, vjp.bwd_plain(*xs[:7], p3[2], g, xs[7], carry=ain)

    def rows(o1, o3, o4):
        """Chain rows, lane 0 (not positive definite) left out; the time
        partials, summed over the chains, as one row each."""
        out = [o1[0], o1[1], o3[0], o3[1], *o3[2][:6], *(z for z in o4 if z.dim() > 1)]
        return [z[1:] for z in out] + [z[None] for z in o4[4:6]]

    got = rows(k1, k3, k4)
    same = rows(*plain(x(blocks[1]), cin, ain, g))
    if dtype == torch.float64:
        for k, p in zip(got, same):
            assert _rel_rows(k, p) <= 1e-9
        return
    up = lambda z: z.double()  # noqa: E731
    ref = rows(*plain(tuple(map(up, x(blocks[1]))), up(cin), up(ain), up(g)))
    if not spread:
        for k, q, r in zip(got, same, ref):
            assert _rel_rows(k, r) <= max(3.0 * _rel_rows(q, r), 1e-5)
        return
    for k, q, r in zip(got[:-2], same[:-2], ref[:-2]):
        assert _spread_ok(k, q, r)
    # the time partials are summed over the chains: each chain's own, from
    # a cotangent on that chain alone (the others' are exact zeros)
    xs, xs64 = x(blocks[1]), tuple(map(up, x(blocks[1])))
    res_q = vjp.fwd_aug_plain(*xs, carry=cin)[2]
    res_r = vjp.fwd_aug_plain(*xs64, carry=up(cin))[2]
    parts = ([], [], [])
    for ch in range(1, 37):
        gc = torch.zeros_like(g)
        gc[ch] = g[ch]
        outs = (vjp.bwd_carry(*xs[:7], k3[2], gc, xs[7], ain),
                vjp.bwd_plain(*xs[:7], res_q, gc, xs[7], carry=ain),
                vjp.bwd_plain(*xs64[:7], res_r, up(gc), xs64[7], carry=up(ain)))
        for lst, o in zip(parts, outs):
            lst.append(torch.stack(o[4:6]))
    k, q, r = (torch.stack(lst) for lst in parts)  # (chains, t/dt, N)
    for i in (0, 1):
        assert _spread_ok(k[:, i], q[:, i], r[:, i])


@pytest.mark.cuda
@pytest.mark.parametrize("J", CARRY_J)
def test_carry_entries_chained_equal_one_launch_on_card(card, J):
    """The series in three blocks (100, 133 and 67 steps), each carry
    entry started from the carry the block before ended with, against one
    launch of the entry without a carry: the value and every cotangent,
    float64 within 1e-9 relative, the non-PD lane -inf with a zero
    gradient."""
    _chained(card, J, [slice(0, 100), slice(100, 233), slice(233, 300)])


@pytest.mark.cuda
@pytest.mark.parametrize("J", [65, 100, 128])
def test_past_64_carry_entries_chained_over_four_blocks_on_card(card, J):
    """The carry entries past the registers, the series in four blocks
    (70, 77, 80 and 73 steps), against one launch, as
    test_carry_entries_chained_equal_one_launch_on_card."""
    _chained(card, J, [slice(0, 70), slice(70, 147), slice(147, 227), slice(227, 300)])


def _chained(card, J, blocks):
    from pioran_tpu_torch.ops import cuda_celerite as cc, cuda_celerite_vjp as vjp

    (a, b, c, d, t, y, s2), dtg, g = _carry_problem(J, torch.float64, card, seed=70)
    args = (a, b, c, d, t, y, s2)
    dt = dtg[1:]
    ll = batched_loglike(*args, dt)
    ll3, res = vjp.fwd_aug(*args, dt=dt)
    grads = vjp.bwd(*args, res, g, dt=dt)
    carry, c3 = vjp.neutral_carry(37, J, a), vjp.neutral_carry(37, J, a)
    parts, parts3, saved = [], [], []
    for sl in blocks:
        xs = (a, b, c, d, t[sl], y[:, sl], s2[:, sl], dtg[sl])
        p, carry = cc.loglike_carry(*xs, carry)
        q, c3, r = vjp.fwd_aug_carry(*xs, c3)
        parts.append(p)
        parts3.append(q)
        saved.append(r)
    ain = a.new_zeros(37, vjp.adjoint_width(J))
    outs = [None] * len(blocks)
    for k in reversed(range(len(blocks))):
        sl = blocks[k]
        outs[k] = vjp.bwd_carry(a, b, c, d, t[sl], y[:, sl], s2[:, sl], saved[k], g, dtg[sl], ain)
        ain = outs[k][-1]
    torch.cuda.synchronize()

    def value(ps):
        v = -0.5 * (sum(p[:, 0] for p in ps) + sum(p[:, 1] for p in ps) + 300 * math.log(2 * math.pi))
        ok = torch.stack([p[:, 2] for p in ps]).min(0).values > 0
        return torch.where(ok, v, torch.full_like(v, -math.inf))

    for v in (value(parts), value(parts3)):
        assert torch.equal(torch.isneginf(v), torch.isneginf(ll)) and bool(torch.isneginf(v[0]))
        assert float(((v - ll).abs() / ll.abs())[1:].max()) <= 1e-9
    coefs = [sum(o[i] for o in outs) for i in range(4)]
    tb, dtb = torch.cat([o[4] for o in outs]), torch.cat([o[5] for o in outs])
    tbar = tb + dtb - torch.cat([dtb[1:], dtb.new_zeros(1)])
    mine = (*coefs, tbar, torch.cat([o[6] for o in outs], 1), torch.cat([o[7] for o in outs], 1))
    for k, r in zip(mine, grads):
        if k.dim() == 1:
            assert _rel_rows(k[None], r[None]) <= 1e-9
        else:
            assert _rel_rows(k[1:], r[1:]) <= 1e-9 and bool((k[0] == 0).all())


@pytest.mark.cuda
def test_run_block_past_64_moves_only_the_wide_carry_counters_on_card(card):
    """``seq_scan.run_block`` over 2 blocks at J = 100 (the seq path's
    one-block helper past the registers), forward without and with a
    gradient, then K4's carry entry back over the blocks: each wide carry
    counter moves by 2, every other kernel counter stays, and the chained
    value is one launch's within 1e-9 in float64."""
    from pioran_tpu_torch.ops import cuda_celerite as cc, cuda_celerite_vjp as vjp
    from pioran_tpu_torch.parallel.seq_scan import run_block

    J, B = 100, 8
    (a, b, c, d, t, y, s2), dtg, _ = _carry_problem(J, torch.float64, card)
    a, b, c, d, y, s2 = a[:B], b[:B], c[:B], d[:B], y[:B], s2[:B]
    g = torch.linspace(0.5, 1.5, B, dtype=a.dtype, device=card)
    g[0] = 0.0
    blocks = [slice(0, 150), slice(150, 300)]
    names = [(cc, n) for n in ("LAUNCHES", "MULTI_LAUNCHES", "TABLES_LAUNCHES", "CARRY_LAUNCHES",
                               "WIDE_LAUNCHES", "WIDE_MULTI_LAUNCHES", "WIDE_TABLES_LAUNCHES",
                               "WIDE_CARRY_LAUNCHES")]
    names += [(vjp, f"{w}{k}{m}_LAUNCHES") for w in ("", "WIDE_") for k in ("FWD_AUG", "BWD")
              for m in ("", "_MULTI", "_CARRY")]
    before = [getattr(m, n) for m, n in names]
    for grad in (False, True):
        carry, parts, saved = vjp.neutral_carry(B, J, a), [], []
        for sl in blocks:
            p, carry, res = run_block(a, b, c, d, t[sl], y[:, sl], s2[:, sl], dtg[sl], carry, grad)
            parts.append(p)
            saved.append(res)
    ain = a.new_zeros(B, vjp.adjoint_width(J))
    for k in reversed(range(len(blocks))):
        sl = blocks[k]
        ain = vjp.bwd_carry(a, b, c, d, t[sl], y[:, sl], s2[:, sl], saved[k], g, dtg[sl], ain)[-1]
    torch.cuda.synchronize()
    moved = {n: getattr(m, n) - v for (m, n), v in zip(names, before) if getattr(m, n) != v}
    assert moved == {"WIDE_CARRY_LAUNCHES": 2, "WIDE_FWD_AUG_CARRY_LAUNCHES": 2,
                     "WIDE_BWD_CARRY_LAUNCHES": 2}
    ll = batched_loglike(a, b, c, d, t, y, s2, dtg[1:])
    v = -0.5 * (sum(p[:, 0] for p in parts) + sum(p[:, 1] for p in parts)
                + t.shape[0] * math.log(2 * math.pi))
    fin = torch.isfinite(ll)
    assert bool(~fin[0]) and int(fin.sum()) == B - 1
    assert float(((v - ll).abs() / ll.abs())[fin].max()) <= 1e-9
