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
@pytest.mark.parametrize("J", [3, 20, 32])
@pytest.mark.parametrize("with_dt", [False, True])
def test_kernel_matches_plain_on_card(card, dtype, tol, J, with_dt):
    """A ragged batch edge (37 chains), J across the kernel's three widths,
    a non-PD lane, with and without host spacings."""
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
    assert int(fin.sum()) == 36
    err = (k[fin] - p[fin]).abs()
    if dtype == torch.float64:
        err = err / p[fin].abs()
    assert float(err.max()) <= tol


@pytest.mark.cuda
def test_wrapper_rejects_mixed_inputs_on_card(card):
    a, b, c, d, t, y, s2 = (torch.as_tensor(x, device=card)
                            for x in _problem(4, 5, 20, seed=1))
    with pytest.raises(ValueError, match="sigma2"):
        batched_loglike(a, b, c, d, t, y, s2.float())
    with pytest.raises(ValueError, match="at most 32"):
        batched_loglike(*(torch.as_tensor(x, device=card) for x in _problem(2, 33, 10, 2)))


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

    args = [torch.as_tensor(x, device=card) for x in _problem(2, 33, 10, 2)]
    with pytest.raises(ValueError, match="at most 32"):
        vjp.fwd_aug(*args)
    with pytest.raises(ValueError, match="at most 32"):
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
@pytest.mark.parametrize("J", [3, 20, 32])
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
    assert int(fin.sum()) == 36
    err = (k[fin] - p[fin]).abs()
    if dtype == torch.float64:
        err = err / p[fin].abs()
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
