"""PyTorch port parity: the celerite adjoint (K3 and K4's plain versions).

``fwd_aug_plain`` and ``bwd_plain`` against the JAX package's Pallas
adjoint run in interpret mode and against ``jax.vjp`` of its scan; the
``batched_loglike`` autograd Function against autograd through the plain
forward loop and ``torch.autograd.gradcheck``; the ported scan ``logl``
and dense oracle against JAX's. float64 on the CPU, inputs from numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu.models.kernels import CeleriteKernel as JKernel
from pioran_tpu.ops import direct as jdirect
from pioran_tpu.ops.pallas_celerite import _scan_batched
from pioran_tpu.ops.pallas_celerite_vjp import bwd_pallas, fwd_aug_pallas
from pioran_tpu_torch.models.kernels import CeleriteKernel
from pioran_tpu_torch.ops import celerite as tcel
from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp
from pioran_tpu_torch.ops import direct as tdirect
from pioran_tpu_torch.ops.cuda_celerite import batched_loglike, batched_loglike_plain

torch.set_num_threads(1)

B, N, KC = 3, 37, 8  # N is not a multiple of kc
NAMES = ("a", "b", "c", "d", "t", "y", "sigma2")


def _problem(J, seed, non_pd=False, n=N, batch=B):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 100, n))
    a = rng.uniform(0.1, 0.6, (batch, J))
    b = rng.uniform(0.0, 0.2, (batch, J))
    c = rng.uniform(0.05, 0.35, (batch, J))
    d = rng.uniform(0.0, 0.4, (batch, J))
    y = rng.normal(size=(batch, n))
    s2 = rng.uniform(0.05, 0.15, (batch, n))
    if non_pd:
        a[0] = -50.0 * a[0]
    return a, b, c, d, t, y, s2


def _t(xs):
    return [torch.as_tensor(x, dtype=torch.float64) for x in xs]


def _rel(x, ref):
    """2-norm relative error per leading row (whole array for 1-D)."""
    x, ref = np.atleast_2d(x), np.atleast_2d(ref)
    num = np.linalg.norm((x - ref).reshape(x.shape[0], -1), axis=1)
    den = np.linalg.norm(ref.reshape(ref.shape[0], -1), axis=1)
    return float(np.max(num / np.maximum(den, 1e-300)))


@jax.jit
def _scan_vjp(g, *args):
    """ll and the seven cotangents of the JAX scan, jitted (eager
    dispatch of the scan's VJP takes several times longer)."""
    ll, f = jax.vjp(_scan_batched, *args)
    return ll, f(g)


def _jax_adjoint(args, g, dt):
    jargs = [jnp.asarray(x) for x in args]
    jdt = None if dt is None else jnp.asarray(dt)
    ll, res = fwd_aug_pallas(*jargs, dt=jdt, chunk=16, kc=KC, interpret=True)
    grads = bwd_pallas(*jargs, res, jnp.asarray(g), dt=jdt, chunk=16, kc=KC,
                       interpret=True)
    return np.asarray(ll), res, [np.asarray(x) for x in grads]


@pytest.mark.parametrize("with_dt", [False, True])
@pytest.mark.parametrize("J", [4, 8])
def test_plain_adjoint_matches_pallas(J, with_dt):
    """ll, every residual table and all seven cotangents of the plain
    versions against the Pallas adjoint (interpret mode), un-padded."""
    args = _problem(J, seed=J)
    dt = np.diff(args[4]) if with_dt else None
    g = np.random.default_rng(1).normal(size=B)
    ll_ref, res_ref, grads_ref = _jax_adjoint(args, g, dt)

    targs = _t(args)
    tdt = None if dt is None else torch.as_tensor(dt)
    ll, res = vjp.fwd_aug_plain(*targs, dt=tdt, kc=KC)
    np.testing.assert_allclose(ll.numpy(), ll_ref, rtol=1e-12)
    # the Pallas tables are (N_padded, J8, B_padded); ours (B, N, J)
    for ours, ref in zip(res[:4], res_ref[:4]):
        ref = np.asarray(ref)[:N, :J, :B].transpose(2, 0, 1)
        assert _rel(ours.numpy(), ref) <= 1e-12
    for ours, ref in zip(res[4:6], res_ref[4:6]):
        assert _rel(ours.numpy(), np.asarray(ref)[:N, :B].T) <= 1e-12
    nck = -(-N // KC)
    ref = np.asarray(res_ref[6])[:nck, :, :J, :J, :B].transpose(4, 0, 1, 2, 3)
    assert res[6].shape == (B, nck, 3, J, J)
    assert _rel(res[6].numpy(), ref) <= 1e-12

    grads = vjp.bwd_plain(*targs, res, torch.as_tensor(g), dt=tdt, kc=KC)
    for name, ours, ref in zip(NAMES, grads, grads_ref):
        assert _rel(ours.numpy(), ref) <= 1e-10, name


@pytest.mark.parametrize("with_dt", [False, True])
@pytest.mark.parametrize("J", [4, 8, 40, 70])
def test_plain_adjoint_matches_scan_vjp(J, with_dt):
    """The seven cotangents against jax.vjp of the scan, with a non-PD
    lane whose ll is -inf and whose gradient is exactly zero. The scan
    would give NaN there, so the reference runs on the other chains
    (dt = diff(t) exactly, so the scan takes no dt)."""
    args = _problem(J, seed=10 + J, non_pd=True)
    g = np.random.default_rng(2).normal(size=B)
    jargs = [jnp.asarray(x[1:] if x.ndim == 2 else x) for x in args]
    ll_ref, refs = _scan_vjp(jnp.asarray(g[1:]), *jargs)
    refs = [np.asarray(x) for x in refs]

    targs = _t(args)
    tdt = torch.as_tensor(np.diff(args[4])) if with_dt else None
    ll, res = vjp.fwd_aug_plain(*targs, dt=tdt, kc=KC)
    assert bool(torch.isneginf(ll[0]))
    np.testing.assert_allclose(ll[1:].numpy(), np.asarray(ll_ref), rtol=1e-12)
    g_t = torch.where(torch.isfinite(ll), torch.as_tensor(g), 0.0)
    grads = [x.numpy() for x in vjp.bwd_plain(*targs, res, g_t, dt=tdt, kc=KC)]
    for name, ours, ref in zip(NAMES, grads, refs):
        if name == "t":  # summed over chains
            assert _rel(ours, ref) <= 1e-10, name
            continue
        assert np.all(ours[0] == 0.0), name  # exact zeros on the -inf chain
        assert _rel(ours[1:], ref) <= 1e-10, name
    if not with_dt:
        # the ported scan logl and its autograd gradient, on the same chains
        ta = _t([x[1:] if x.ndim == 2 else x for x in args])
        ta[0].requires_grad_(True)
        out = tcel.logl(*ta)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ll_ref), rtol=1e-12)
        (ga,) = torch.autograd.grad(out, ta[0], torch.as_tensor(g[1:]))
        assert _rel(ga.numpy(), refs[0]) <= 1e-10


def test_autograd_function_matches_plain_autograd():
    """batched_loglike's backward (K3/K4's plain versions) against autograd
    through the plain forward loop, for every input. dt gets no gradient,
    and t's cotangent assumes dt = diff(t), as in the JAX package: the
    reference takes its spacings from t, which here gives the same dt."""
    args = _t(_problem(5, seed=3))
    dt = torch.as_tensor(np.diff(args[4].numpy()))
    g = torch.as_tensor(np.random.default_rng(4).normal(size=B))
    ours = [x.clone().requires_grad_(True) for x in args]
    refs = [x.clone().requires_grad_(True) for x in args]
    out = batched_loglike(*ours, dt)
    ref = batched_loglike_plain(*refs)
    torch.testing.assert_close(out, ref, rtol=1e-13, atol=0)
    go = torch.autograd.grad(out, ours, g)
    gr = torch.autograd.grad(ref, refs, g)
    for name, x, r in zip(NAMES, go, gr):
        assert _rel(x.numpy(), r.numpy()) <= 1e-10, name


def test_gradcheck_small():
    """torch.autograd.gradcheck (finite differences) at N = 12."""
    args = [x.requires_grad_(True) for x in _t(_problem(3, seed=5, n=12, batch=2))]
    assert torch.autograd.gradcheck(
        lambda *ar: batched_loglike(*ar), args, eps=1e-6, atol=1e-5, rtol=1e-4)


def test_zero_gradient_on_neg_inf_rows():
    """A non-PD chain's ll is -inf and its gradient exactly zero; the
    other chains are untouched."""
    args = [x.requires_grad_(True) for x in _t(_problem(4, seed=6, non_pd=True))]
    ll = batched_loglike(*args)
    assert bool(torch.isneginf(ll[0])) and bool(torch.isfinite(ll[1:]).all())
    grads = torch.autograd.grad(ll[torch.isfinite(ll)].sum() + 0.0 * ll[0], args,
                                retain_graph=True)
    for name, gr in zip(NAMES, grads):
        if gr.dim() == 2:
            assert bool((gr[0] == 0).all()), name
            assert bool(torch.isfinite(gr[1:]).all()), name
    # -inf in the sum itself: the chain's cotangent is zeroed, the rest finite
    grads = torch.autograd.grad(ll.sum(), args)
    assert all(bool(torch.isfinite(gr).all()) for gr in grads)
    assert bool((grads[0][0] == 0).all())


def test_no_grad_forward_runs_no_adjoint():
    """Without a gradient the forward is the plain K1 loop and saves no
    tables; with one, the Function's value is the same."""
    args = _t(_problem(4, seed=7))
    plain = batched_loglike_plain(*args)
    out = batched_loglike(*args)
    assert out.grad_fn is None
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    a = args[0].clone().requires_grad_(True)
    out_g = batched_loglike(a, *args[1:])
    assert out_g.grad_fn is not None
    torch.testing.assert_close(out_g.detach(), plain, rtol=0, atol=0)


def test_kc_changes_nothing_but_the_checkpoints():
    args = _t(_problem(4, seed=8))
    g = torch.ones(B, dtype=torch.float64)
    outs = []
    for kc in (1, 5, 8, N + 3):
        ll, res = vjp.fwd_aug_plain(*args, kc=kc)
        assert res[6].shape[1] == -(-N // kc)
        outs.append([x.numpy() for x in vjp.bwd_plain(*args, res, g, kc=kc)])
    for o in outs[1:]:
        for x, r in zip(o, outs[0]):
            assert _rel(x, r) <= 1e-12


def test_scan_logl_and_direct_match_jax():
    """The dense Cholesky oracle against JAX's ``direct`` and against the
    ported scan ``logl`` and the kernels' plain forward (the scan itself
    is held against JAX's in test_plain_adjoint_matches_scan_vjp)."""
    args = _problem(4, seed=9)
    out = tcel.logl(*_t(args)).numpy()
    np.testing.assert_allclose(batched_loglike_plain(*_t(args)).numpy(), out, rtol=1e-12)
    # dense oracle: one chain, the scan's value
    kern = CeleriteKernel(*(torch.as_tensor(x[0]) for x in args[:4]))
    dense = float(tdirect.log_likelihood_direct(kern, *_t((args[4], args[5][0], args[6][0]))))
    jdense = float(jdirect.log_likelihood_direct(
        JKernel(*(jnp.asarray(x[0]) for x in args[:4])),
        *(jnp.asarray(x) for x in (args[4], args[5][0], args[6][0]))))
    assert abs(dense / jdense - 1.0) <= 1e-12
    assert abs(-dense / out[0] - 1.0) <= 1e-10


def test_residual_bytes():
    """The device memory K3 writes and K4 reads: the per-step tables and
    the T checkpoints (K4's own working set is in shared memory)."""
    tables, ckpts = vjp.residual_bytes(512, 20, 485, kc=8)
    assert tables == 4 * 512 * 485 * 82
    assert ckpts == 4 * 512 * 61 * 3 * 400


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kc", [1, 2, 3, 4, 8, 16, 489])
def test_bwd_launch_shape_fits_shared_memory(dtype, kc):
    """Every J the kernels take, at every batch: the block's shared memory
    fits the H100's 232,448 bytes. Up to 32 terms (the warp-per-chain K4):
    at least one chain a block and a sub-chunk of 1 <= ks <= kc steps (at
    most 32: one lane keeps a step's per-step cotangents). Past 32 (the
    wide K4 and forward kernels, a block a chain): ks = min(kc, 8), and
    what shared memory does not hold in the device scratch; the forward
    state of the DRWCelerite flagship (J = 40) fits shared memory, that
    of float64 at J = 100 does not."""
    for J in range(1, vjp.NARROW_TERMS + 1):
        for batch in (1, 16, 37, 512, 1024, 4096):
            cpb, ks, smem = vjp.bwd_launch_shape(dtype, J, kc, batch)
            assert 1 <= cpb <= 4 and 1 <= ks <= min(kc, 32)
            assert 0 < smem <= vjp.SMEM_BYTES and smem % cpb == 0
            assert cpb <= -(-batch // vjp.H100_SMS)  # small batches spread over the SMs
    for J in range(vjp.NARROW_TERMS + 1, vjp.MAX_TERMS + 1):
        R = 2 * J
        for batch in (1, 1024):
            ks, smem, carry, chunk = vjp.wide_bwd_shape(J, kc, dtype, batch)
            assert ks == min(kc, vjp.WIDE_SUB) and 0 < smem <= vjp.SMEM_BYTES
            assert carry in (0, R * R) and chunk in (0, 3 * ks * J * (J | 1))
            assert chunk or batch <= vjp.H100_SMS  # more chains than SMs: occupancy first
        assert vjp.wide_fwd_scratch(J, dtype) in (0, R * R)
    assert vjp.wide_fwd_scratch(40, dtype) == 0
    assert vjp.wide_fwd_scratch(100, torch.float64) == 200 * 200


def test_bwd_launch_shape_choices():
    """The flagship chunk fits whole with four chains a block (B = 512);
    the NUTS batch (B = 16) takes one chain a block; float64 at J = 32
    sweeps kc = 8 in sub-chunks of 6."""
    assert vjp.bwd_launch_shape(torch.float32, 20, 8, 512) == (4, 8, 4 * 55456)
    assert vjp.bwd_launch_shape(torch.float32, 20, 8, 16)[:2] == (1, 8)
    assert vjp.bwd_launch_shape(torch.float64, 32, 8, 512)[:2] == (1, 6)
