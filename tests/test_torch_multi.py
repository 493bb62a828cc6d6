"""PyTorch port parity: the ragged multi-dataset likelihood.

``logl_masked``, the plain version of K2 (``batched_loglike_multi_plain``)
and the per-lane plain versions of K3/K4 (``fwd_aug_plain``/``bwd_plain``
with per-chain t, dt and ``n_valid``) against the JAX package's masked
scan, its Pallas multi-dataset kernel and its Pallas adjoint (interpret
mode); the ``batched_loglike_multi`` autograd Function against autograd
through ``logl_masked`` and finite differences. float64 on the CPU,
inputs from numpy; the ragged lengths follow the JAX package's own test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu.ops import celerite as jcel
from pioran_tpu.ops.pallas_celerite import _scan_batched_multi, batched_loglike_pallas_multi
from pioran_tpu.ops.pallas_celerite_vjp import bwd_pallas, fwd_aug_pallas
from pioran_tpu_torch.convert import multi_inputs_from_numpy
from pioran_tpu_torch.ops import celerite as tcel
from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp
from pioran_tpu_torch.ops.cuda_celerite import (
    batched_loglike_multi,
    batched_loglike_multi_plain,
    batched_loglike_plain,
)

torch.set_num_threads(1)

NV = np.array([70, 50, 70, 33, 64])
B, N, J, KC = 5, 70, 4, 8
NAMES = ("a", "b", "c", "d", "t", "y", "sigma2")


def _ragged(seed, non_pd=False, n_valid=NV, n=N, j=J):
    """Per-lane sorted grids, each edge-padded past its length (dt = 0 on
    the padding, as run_inference_many pads), and their host spacings."""
    rng = np.random.default_rng(seed)
    batch = len(n_valid)
    T = np.sort(rng.uniform(0, 100, (batch, n)), axis=1)
    for i, m in enumerate(n_valid):
        T[i, m:] = T[i, m - 1]
    a = rng.uniform(0.1, 0.6, (batch, j))
    b = rng.uniform(0.0, 0.2, (batch, j))
    c = rng.uniform(0.05, 0.35, (batch, j))
    d = rng.uniform(0.0, 0.4, (batch, j))
    y = rng.normal(size=(batch, n))
    s2 = rng.uniform(0.05, 0.15, (batch, n))
    if non_pd:
        a[0] = -50.0 * a[0]
    return [a, b, c, d, T, y, s2], np.diff(T, axis=1)


def _t(xs):
    return [torch.as_tensor(x, dtype=torch.float64) for x in xs]


def _live(n_valid=NV, n=N):
    return np.arange(n)[None, :] < np.asarray(n_valid)[:, None]


def _mask(x, live):
    """Zero (B, N) cotangents past n_valid (the JAX wrapper does the same)."""
    x = np.asarray(x)
    return np.where(live, x, 0.0) if x.shape == live.shape else x


def _rel(x, ref):
    """2-norm relative error per leading row (whole array for 1-D)."""
    x, ref = np.atleast_2d(x), np.atleast_2d(ref)
    num = np.linalg.norm((x - ref).reshape(x.shape[0], -1), axis=1)
    den = np.linalg.norm(ref.reshape(ref.shape[0], -1), axis=1)
    return float(np.max(num / np.maximum(den, 1e-300)))


@jax.jit
def _jax_masked(a, b, c, d, T, y, s2, nv, dt):
    return jax.vmap(jcel.logl_masked)(a, b, c, d, T, y, s2, nv, dt)


@pytest.mark.parametrize("with_dt", [False, True])
def test_logl_masked_matches_jax(with_dt):
    args, DT = _ragged(seed=1)
    s2m = np.where(_live(), args[6], 1.0)
    jargs = [jnp.asarray(x) for x in args[:6]] + [jnp.asarray(s2m), jnp.asarray(NV, float)]
    ref = np.asarray(_jax_masked(*jargs, jnp.asarray(DT)) if with_dt
                     else jax.vmap(jcel.logl_masked)(*jargs))
    out = tcel.logl_masked(*_t(args[:6] + [s2m]), torch.as_tensor(NV),
                           dt=torch.as_tensor(DT) if with_dt else None)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-10)


@pytest.mark.parametrize("with_dt,j", [(False, J), (True, J), (True, 40)],
                         ids=["False", "True", "True-J40"])
def test_multi_plain_matches_pallas_and_scan(with_dt, j):
    """K2's plain version and the CPU dispatcher against the Pallas
    multi-dataset kernel (interpret mode) and the masked scan; lane 0 is
    not positive definite and gives -inf. J = 40: past 32 terms, the
    DRWCelerite flagship's width."""
    args, DT = _ragged(seed=2, non_pd=True, j=j)
    jargs = [jnp.asarray(x) for x in args]
    jnv, jdt = jnp.asarray(NV, float), jnp.asarray(DT) if with_dt else None
    pallas = np.asarray(batched_loglike_pallas_multi(*jargs, n_valid=jnv, dt=jdt, chunk=16,
                                                     interpret=True))
    scan = np.asarray(_scan_batched_multi(*jargs, jnv, dt=jdt))
    tdt = torch.as_tensor(DT) if with_dt else None
    plain = batched_loglike_multi_plain(*_t(args), torch.as_tensor(NV), dt=tdt).numpy()
    disp = batched_loglike_multi(*_t(args), torch.as_tensor(NV), dt=tdt).numpy()
    for ref in (pallas, scan):
        assert np.isneginf(ref[0])
        for out in (plain, disp):
            assert np.isneginf(out[0])
            np.testing.assert_allclose(out[1:], ref[1:], rtol=1e-10)


@pytest.mark.parametrize("with_dt", [False, True])
def test_multi_plain_on_one_grid_equals_k1_plain(with_dt):
    """Every lane on the same grid with n_valid = N: K2's plain version is
    K1's."""
    args, _ = _ragged(seed=3, n_valid=[N] * B)
    t = args[4][0]
    dt = torch.as_tensor(np.diff(t)) if with_dt else None
    k1 = batched_loglike_plain(*_t(args[:4] + [t] + args[5:]), dt=dt)
    k2 = batched_loglike_multi_plain(*_t(args[:4] + [np.tile(t, (B, 1))] + args[5:]),
                                     torch.full((B,), N), dt=None if dt is None
                                     else dt.expand(B, N - 1))
    torch.testing.assert_close(k2, k1, rtol=1e-12, atol=0)


@jax.jit
def _scan_multi_vjp(g, nv, *args):
    ll, f = jax.vjp(lambda *ar: _scan_batched_multi(*ar, nv), *args)
    return ll, f(g)


@pytest.mark.parametrize("with_dt", [False, True])
def test_per_lane_adjoint_matches_pallas_and_scan_vjp(with_dt):
    """ll and the seven cotangents of the per-lane plain K3/K4 against the
    Pallas adjoint with n_valid (interpret mode), and, on the positive
    definite lanes, against jax.vjp of the masked scan; the ragged lanes
    keep their own t cotangent rows (no sum over chains), and cotangents
    past n_valid are compared masked, as the JAX wrapper returns them.
    The non-PD lane 0 gets exact zeros (the scan VJP would give NaN)."""
    args, DT = _ragged(seed=4, non_pd=True)
    live = _live()
    args[6] = np.where(live, args[6], 1.0)
    g = np.random.default_rng(5).normal(size=B)
    jargs = [jnp.asarray(x) for x in args]
    jnv, jdt = jnp.asarray(NV, float), jnp.asarray(DT) if with_dt else None
    ll_p, res = fwd_aug_pallas(*jargs, n_valid=jnv, dt=jdt, chunk=16, kc=KC, interpret=True)
    g0 = np.where(np.isfinite(np.asarray(ll_p)), g, 0.0)
    grads_p = bwd_pallas(*jargs, res, jnp.asarray(g0), n_valid=jnv, dt=jdt, chunk=16,
                         kc=KC, interpret=True)
    ll_s, grads_s = _scan_multi_vjp(jnp.asarray(g[1:]), jnv[1:],
                                    *(x[1:] for x in jargs))

    targs = _t(args)
    tdt = torch.as_tensor(DT) if with_dt else None
    ll, tabs = vjp.fwd_aug_plain(*targs, dt=tdt, kc=KC, n_valid=torch.as_tensor(NV))
    grads = vjp.bwd_plain(*targs, tabs, torch.as_tensor(g0), dt=tdt, kc=KC,
                          n_valid=torch.as_tensor(NV))
    assert grads[4].shape == (B, N)
    assert np.isneginf(ll[0].item()) and np.isneginf(np.asarray(ll_p)[0])
    np.testing.assert_allclose(ll[1:].numpy(), np.asarray(ll_p)[1:], rtol=1e-10)
    np.testing.assert_allclose(ll[1:].numpy(), np.asarray(ll_s), rtol=1e-10)
    for name, ours, rp, rs in zip(NAMES, grads, grads_p, grads_s):
        ours = _mask(ours.numpy(), live)
        assert np.all(ours[0] == 0.0), name
        np.testing.assert_allclose(ours, _mask(rp, live), rtol=1e-8, atol=1e-10, err_msg=name)
        np.testing.assert_allclose(ours[1:], _mask(rs, live[1:]), rtol=1e-8, atol=1e-10,
                                   err_msg=name)
    # the kernel's own cotangents are already exactly zero past n_valid
    for ours in grads[4:]:
        assert np.all(ours.numpy()[~live] == 0.0)


def test_autograd_function_matches_logl_masked():
    """batched_loglike_multi's backward (the per-lane K3/K4 plain
    versions) against autograd through logl_masked, for every input;
    t, y and sigma2 cotangents are zero past n_valid."""
    args, _ = _ragged(seed=6)
    live = torch.as_tensor(_live())
    nv = torch.as_tensor(NV)
    g = torch.as_tensor(np.random.default_rng(7).normal(size=B))
    ours = [x.requires_grad_(True) for x in _t(args)]
    refs = [x.requires_grad_(True) for x in _t(args)]
    out = batched_loglike_multi(*ours, nv)
    ref = tcel.logl_masked(*refs[:6], torch.where(live, refs[6], 1.0), nv)
    torch.testing.assert_close(out, ref, rtol=1e-10, atol=0)
    go = torch.autograd.grad(out, ours, g)
    gr = torch.autograd.grad(ref, refs, g)
    for name, x, r in zip(NAMES, go, gr):
        assert _rel(x.numpy(), r.numpy()) <= 1e-9, name
        if x.shape == live.shape:
            assert bool((x[~live] == 0).all()), name


def test_gradcheck_small_ragged():
    """torch.autograd.gradcheck (finite differences) at B = 2, J = 2,
    N = 12, one lane ragged."""
    args, _ = _ragged(seed=8, n_valid=[12, 7], n=12, j=2)
    ins = [x.requires_grad_(True) for x in _t(args)]
    nv = torch.as_tensor([12, 7])
    assert torch.autograd.gradcheck(
        lambda *ar: batched_loglike_multi(*ar, nv), ins, eps=1e-6, atol=1e-5, rtol=1e-4)


def test_zero_gradient_on_neg_inf_lanes():
    args, DT = _ragged(seed=9, non_pd=True)
    ins = [x.requires_grad_(True) for x in _t(args)]
    ll = batched_loglike_multi(*ins, torch.as_tensor(NV), torch.as_tensor(DT))
    assert bool(torch.isneginf(ll[0])) and bool(torch.isfinite(ll[1:]).all())
    grads = torch.autograd.grad(ll.sum(), ins)
    for name, gr in zip(NAMES, grads):
        assert bool((gr[0] == 0).all()), name
        assert bool(torch.isfinite(gr).all()), name


def test_no_grad_multi_runs_no_adjoint(monkeypatch):
    """Without a gradient the forward is K2's plain loop on sigma2 set to 1
    past n_valid, and saves nothing; with one, the value is the same."""
    args, DT = _ragged(seed=10)
    targs, nv, tdt = _t(args), torch.as_tensor(NV), torch.as_tensor(DT)
    s2m = torch.where(torch.as_tensor(_live()), targs[6], 1.0)
    plain = batched_loglike_multi_plain(*targs[:6], s2m, nv, tdt)
    real_fwd_aug = vjp.fwd_aug_plain

    def refuse(*_a, **_k):
        raise AssertionError("the adjoint ran without a gradient")

    monkeypatch.setattr(vjp, "fwd_aug_plain", refuse)
    out = batched_loglike_multi(*targs, nv, tdt)
    assert out.grad_fn is None
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    monkeypatch.setattr(vjp, "fwd_aug_plain", real_fwd_aug)
    a = targs[0].clone().requires_grad_(True)
    out_g = batched_loglike_multi(a, *targs[1:], nv, tdt)
    assert out_g.grad_fn is not None
    torch.testing.assert_close(out_g.detach(), plain, rtol=0, atol=0)


@pytest.mark.parametrize("bad,match", [
    (dict(t=np.zeros((B + 1, N))), "t: expected"),
    (dict(dt=np.zeros((B, N))), "dt must be"),
    (dict(n_valid=np.zeros(B + 1)), "n_valid must be"),
    (dict(t=np.zeros(N), dt=np.zeros(N - 1)), "n_valid needs per-lane"),
])
def test_check_inputs_per_lane_shapes(bad, match):
    """What the per-lane kernels would be refused is refused on the host."""
    args, DT = _ragged(seed=11)
    kw = dict(zip(NAMES, _t(args)), dt=torch.as_tensor(DT), n_valid=torch.as_tensor(NV))
    kw.update({k: torch.as_tensor(v) for k, v in bad.items()})
    with pytest.raises(ValueError, match=match):
        vjp.check_inputs(*(kw[k] for k in NAMES), kw["dt"], kw["n_valid"])


def test_check_inputs_per_lane_defaults():
    args, DT = _ragged(seed=12)
    dt, nv = vjp.check_inputs(*_t(args), torch.as_tensor(DT).float(), None)
    assert dt.dtype == torch.float64 and nv.dtype == torch.int32
    assert nv.tolist() == [N] * B
    dt, nv = vjp.check_inputs(*_t(args), None, torch.as_tensor(NV, dtype=torch.float64))
    assert dt is None and nv.dtype == torch.int32 and nv.tolist() == NV.tolist()


def test_multi_inputs_from_numpy():
    args, DT = _ragged(seed=13)
    T, dt, Y, E, nv = multi_inputs_from_numpy(args[4], DT, args[5], args[6], NV,
                                              device="cpu", dtype=torch.float32)
    assert [x.dtype for x in (T, dt, Y, E)] == [torch.float32] * 4
    assert nv.dtype == torch.int32 and nv.tolist() == NV.tolist()
    assert T.shape == (B, N) and dt.shape == (B, N - 1) and T.device.type == "cpu"
    np.testing.assert_array_equal(dt.numpy(), DT.astype(np.float32))
