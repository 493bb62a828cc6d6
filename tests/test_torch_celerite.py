"""PyTorch port parity: the batched celerite likelihood.

``batched_loglike_plain`` (the CUDA kernel's plain PyTorch version)
against the JAX package's fused Pallas kernel run in interpret mode and
against its lax.scan oracle, on the same numpy inputs, float64 on CPU.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu.ops import celerite as jcel
from pioran_tpu.ops.pallas_celerite import _scan_batched, batched_loglike_pallas_fused
from pioran_tpu_torch.convert import coefficients_from_numpy
from pioran_tpu_torch.ops import celerite as tcel
from pioran_tpu_torch.ops import cuda_celerite
from pioran_tpu_torch.ops.cuda_celerite import batched_loglike, batched_loglike_plain

torch.set_num_threads(1)


def _problem(B, J, N, seed=0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 100, N))
    a = rng.uniform(0.1, 0.6, (B, J))
    b = rng.uniform(0.0, 0.2, (B, J))
    c = rng.uniform(0.05, 0.35, (B, J))
    d = rng.uniform(0.0, 0.4, (B, J))
    y = rng.normal(size=(B, N))
    s2 = rng.uniform(0.05, 0.15, (B, N))
    return a, b, c, d, t, y, s2


def _torch(*xs, dtype=torch.float64):
    return [torch.as_tensor(x, dtype=dtype) for x in xs]


@pytest.mark.parametrize("with_dt", [False, True])
@pytest.mark.parametrize("B,J,N", [
    (5, 3, 70),    # J not a multiple of 8, N not a multiple of the chunk
    (4, 8, 64),    # aligned
    (3, 20, 41),   # the flagship J
    (3, 40, 41),   # past 32 terms: the DRWCelerite flagship (20 components)
    (2, 70, 23),   # ... at 35 components
])
def test_plain_matches_pallas_and_scan(B, J, N, with_dt):
    a, b, c, d, t, y, s2 = _problem(B, J, N, seed=B + J)
    dt = np.diff(t) if with_dt else None
    jdt = None if dt is None else jnp.asarray(dt)
    jargs = [jnp.asarray(x) for x in (a, b, c, d, t, y, s2)]
    fused = np.asarray(batched_loglike_pallas_fused(*jargs, dt=jdt, chunk=16,
                                                    interpret=True))
    scan = np.asarray(_scan_batched(*jargs, dt=jdt))
    kern = coefficients_from_numpy(a, b, c, d, device="cpu")
    out = batched_loglike_plain(*kern.coefficients(), *_torch(t, y, s2),
                                None if dt is None else torch.as_tensor(dt)).numpy()
    np.testing.assert_allclose(out, fused, rtol=1e-12)
    np.testing.assert_allclose(out, scan, rtol=1e-12)


def test_non_pd_lane_is_neg_inf():
    a, b, c, d, t, y, s2 = _problem(2, 2, 30, seed=4)
    a[0] = -a[0] * 50.0
    out = batched_loglike_plain(*_torch(a, b, c, d, t, y, s2)).numpy()
    ref = np.asarray(_scan_batched(*[jnp.asarray(x) for x in (a, b, c, d, t, y, s2)]))
    assert out[0] == -np.inf and ref[0] == -np.inf
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-12)


def test_float32_close_to_jax_float32():
    """Both packages in float32 (the card's working type): within 1e-3 nats."""
    a, b, c, d, t, y, s2 = _problem(6, 8, 80, seed=7)
    f32 = [np.asarray(x, np.float32) for x in (a, b, c, d, t, y, s2)]
    ref = np.asarray(_scan_batched(*[jnp.asarray(x) for x in f32]))
    out = batched_loglike_plain(*_torch(*f32, dtype=torch.float32))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=0)


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    a, b, c, d, t, y, s2 = _torch(*_problem(3, 4, 25, seed=9))
    before = cuda_celerite.LAUNCHES
    out = batched_loglike(a, b, c, d, t, y, s2)
    assert cuda_celerite.LAUNCHES == before
    torch.testing.assert_close(out, batched_loglike_plain(a, b, c, d, t, y, s2),
                               rtol=0, atol=0)


def test_backward_raises():
    """The backward no longer raises: on CPU tensors it runs the adjoint
    kernels' plain versions, and its gradient equals autograd through
    the plain forward loop."""
    a, b, c, d, t, y, s2 = _torch(*_problem(2, 3, 20, seed=1))
    a.requires_grad_(True)
    (ga,) = torch.autograd.grad(batched_loglike(a, b, c, d, t, y, s2).sum(), a)
    (ref,) = torch.autograd.grad(batched_loglike_plain(a, b, c, d, t, y, s2).sum(), a)
    torch.testing.assert_close(ga, ref, rtol=1e-10, atol=1e-12)


def test_wrapper_rejects_more_than_32_terms():
    """Past 32 terms the wide kernels take over, up to MAX_TERMS; more
    than that, the wrapper raises before touching the card, naming the
    limit."""
    too_many = cuda_celerite.MAX_TERMS + 1
    a, b, c, d, t, y, s2 = _torch(*_problem(2, too_many, 10))
    with pytest.raises(ValueError, match=f"at most {cuda_celerite.MAX_TERMS} terms"):
        cuda_celerite._launch(a, b, c, d, t, y, s2, None)


def test_exp_neg_and_tables_match_jax():
    """The plain K5 counterpart, build_uv and stable_sum vs the JAX package."""
    u = np.concatenate([np.linspace(0, 0.05, 200), np.linspace(0, 120, 300), [1e13]])
    for dt in (np.float32, np.float64):
        out = tcel.exp_neg(torch.as_tensor(u.astype(dt))).numpy()
        ref = np.asarray(jcel.exp_neg(jnp.asarray(u.astype(dt))))
        if dt == np.float64:
            np.testing.assert_allclose(out, ref, rtol=1e-15)
            continue
        # the f32 polynomial is within ~2 ulps of exp(-u) (of the float32
        # u); XLA's CPU float32 exp2 is itself up to ~30 ulps off for
        # 2^-k with k >= 13, so the JAX values only agree to 4e-6 there,
        # and XLA flushes results below 2^-126 to zero
        exact32 = np.exp(-u.astype(np.float32).astype(np.float64))
        np.testing.assert_allclose(out, exact32, rtol=3e-7, atol=1e-38)
        np.testing.assert_allclose(out, ref, rtol=4e-6, atol=2e-38)
    a, b, c, d, t, _, _ = _problem(1, 5, 40, seed=2)
    ref = jcel.build_uv(*(jnp.asarray(x[0]) for x in (a, b, c, d)), jnp.asarray(t))
    out = tcel.build_uv(*(torch.as_tensor(x[0]) for x in (a, b, c, d)), torch.as_tensor(t))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-14, atol=1e-300)
    x = np.random.default_rng(0).normal(size=1000)
    assert math.isclose(float(tcel.stable_sum(torch.as_tensor(x))),
                        float(jcel.stable_sum(jnp.asarray(x))), rel_tol=1e-14)

