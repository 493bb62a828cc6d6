"""PyTorch port parity: the dense predictors (``ops/direct.py``), the
posterior mean and prior draws of ``ops/celerite.py`` against the JAX
package's (CPU, float64), and the card's posterior-solve route run on
the CPU: z = -ȳ of the adjoint pair's plain versions against the
three-scan solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pioran_tpu.models.kernels import CeleriteKernel as JKernel
from pioran_tpu.ops import celerite as jcel
from pioran_tpu.ops import direct as jdirect
from pioran_tpu_torch.models.kernels import CeleriteKernel
from pioran_tpu_torch.ops import celerite as tcel
from pioran_tpu_torch.ops import direct as tdirect

torch.set_num_threads(1)


def _problem(B, J, N, seed):
    """(a, b, c, d) (B, J) with a c > b d term by term (a positive
    definite kernel), sorted t (N,), y (B, N), sigma2 (B, N), and sorted
    targets tau (M,) inside, between and outside the data."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.1, 1.0, (B, J))
    b = 0.1 * a * rng.uniform(0.0, 1.0, (B, J))
    c = rng.uniform(0.05, 0.5, (B, J))
    d = c * rng.uniform(0.0, 1.0, (B, J))
    t = np.sort(rng.uniform(0.0, 60.0, N))
    y = rng.normal(size=(B, N))
    s2 = rng.uniform(0.05, 0.2, (B, N))
    tau = np.sort(np.concatenate([t[::4], rng.uniform(-5.0, 65.0, 30)]))
    return a, b, c, d, t, y, s2, tau


def _kernels(a, b, c, d):
    return (CeleriteKernel(*(torch.as_tensor(x) for x in (a, b, c, d))),
            JKernel(*(jnp.asarray(x) for x in (a, b, c, d))))


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


def test_direct_predictors_match_jax():
    """predict_direct (with and without the covariance) and
    predict_cov_direct against the JAX package's, 1e-10; batched (B, J)
    coefficients give the row-by-row results."""
    a, b, c, d, t, y, s2, tau = _problem(2, 3, 40, seed=0)
    tk, _ = _kernels(a, b, c, d)
    tt, ty, ts2, ttau = (torch.as_tensor(x) for x in (t, y, s2, tau))
    mean, cov = tdirect.predict_direct(tk, ttau, tt, ty, ts2, with_covariance=True)
    assert mean.shape == (2, len(tau)) and cov.shape == (2, len(tau), len(tau))
    assert torch.equal(tdirect.predict_direct(tk, ttau, tt, ty, ts2), mean)
    assert torch.equal(tdirect.predict_cov_direct(tk, ttau, tt, ts2), cov)

    def jax_rows(a_, b_, c_, d_, t_, y_, s2_, tau_):
        return jax.vmap(lambda *r: jdirect.predict_direct(
            JKernel(*r[:4]), tau_, t_, r[4], r[5], with_covariance=True))(
                a_, b_, c_, d_, y_, s2_)

    jmean, jcov = jax.jit(jax_rows)(*(jnp.asarray(x) for x in (a, b, c, d, t, y, s2, tau)))
    for i in range(2):
        assert _rel(mean[i].numpy(), jmean[i]) <= 1e-10
        assert _rel(cov[i].numpy(), jcov[i]) <= 1e-10


def test_predict_matches_direct():
    """predict (the gated sweeps) and predict_matmul against the dense
    predict_direct, 1e-8, batched over B = 3 kernels, with and without
    host spacings dt."""
    a, b, c, d, t, y, s2, tau = _problem(3, 4, 60, seed=1)
    tk, _ = _kernels(a, b, c, d)
    tt, ty, ts2, ttau = (torch.as_tensor(x) for x in (t, y, s2, tau))
    ref = tdirect.predict_direct(tk, ttau, tt, ty, ts2).numpy()
    dt = torch.as_tensor(np.diff(t))
    for fn in (tcel.predict, tcel.predict_matmul):
        for spacing in (None, dt):
            mu = fn(tk, ttau, tt, ty, ts2, dt=spacing)
            assert mu.shape == (3, len(tau))
            for i in range(3):
                assert _rel(mu[i].numpy(), ref[i]) <= 1e-8


def test_simulate_from_normals_matches_jax():
    """_simulate_from_normals fed the JAX draw's own normals
    (``jax.random.normal(key, (N,))``) against ``simulate(key, ...)``,
    1e-10, and log_likelihood against the JAX package's."""
    a, b, c, d, t, y, s2, _ = _problem(1, 3, 50, seed=2)
    a, b, c, d, y, s2 = (x[0] for x in (a, b, c, d, y, s2))
    tk, jk = _kernels(a, b, c, d)
    key = jax.random.PRNGKey(3)
    jt, js2 = jnp.asarray(t), jnp.asarray(s2)
    ref = np.asarray(jax.jit(lambda k: jcel.simulate(k, jk, jt, js2))(key))
    q = np.array(jax.random.normal(key, (len(t),), dtype=jnp.float64))
    draw = tcel._simulate_from_normals(torch.as_tensor(q), tk, torch.as_tensor(t),
                                       torch.as_tensor(s2))
    assert draw.shape == (len(t),)
    assert _rel(draw.numpy(), ref) <= 1e-10
    ll = float(tcel.log_likelihood(tk, torch.as_tensor(t), torch.as_tensor(y),
                                   torch.as_tensor(s2)))
    jll = float(jax.jit(lambda: jcel.log_likelihood(jk, jt, jnp.asarray(y), js2))())
    assert abs(ll / jll - 1.0) <= 1e-10


def test_simulate_statistics():
    """Prior draws whitened by the dense Cholesky factor are N(0, I): the
    mean within 0.02 and the variance within 3% of 1 (the JAX package's
    gate, tests/test_celerite.py), 500 draws from one (500, J) kernel."""
    rng = np.random.default_rng(1)
    t = torch.as_tensor(np.sort(rng.uniform(0.0, 50.0, 150)))
    one = [torch.tensor(v, dtype=torch.float64) for v in
           ([1.3, 1.0], [0.1, 0.0], [0.5, 0.1], [3.2, 0.0])]  # celerite + exp terms
    kern = CeleriteKernel(*(x.expand(500, 2) for x in one))
    s2 = torch.full((150,), 0.01, dtype=torch.float64)
    draws = tcel.simulate(torch.Generator().manual_seed(2), kern, t, s2)
    assert draws.shape == (500, 150)
    K = tdirect.covariance_matrix(CeleriteKernel(*one), t, t) + torch.diag(s2)
    whitened = torch.linalg.solve_triangular(torch.linalg.cholesky(K), draws.T, upper=False)
    assert abs(float(whitened.mean())) < 0.02
    assert abs(float(whitened.var(unbiased=False)) - 1.0) <= 3e-2


def test_card_solve_route_on_cpu():
    """The posterior solve the card runs, z = -ȳ of the adjoint pair
    under a unit cotangent, here through K3/K4's plain versions
    (``fwd_aug_plain``, ``bwd_plain``), against the three-scan solve
    ``celerite_factor_solve``, 1e-10 per row; the dispatcher ``_solve``
    takes the scan on CPU tensors."""
    a, b, c, d, t, y, s2, _ = _problem(3, 4, 60, seed=4)
    ta, tb, tc, td, tt, ty, ts2 = (torch.as_tensor(x) for x in (a, b, c, d, t, y, s2))
    z_adj, ok = tcel._solve_adjoint(ta, tb, tc, td, tt, ty, ts2)
    z_ref = tcel.celerite_factor_solve(ta, tb, tc, td, tt, ty, ts2)[0]
    assert bool(ok.all())
    for i in range(3):
        assert _rel(z_adj[i].numpy(), z_ref[i].numpy()) <= 1e-10
    z = tcel._solve(CeleriteKernel(ta, tb, tc, td), tt, ty, ts2)
    assert torch.equal(z, z_ref)
