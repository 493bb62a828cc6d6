"""PyTorch port parity: the GP object API (``models/gp.py``) against the
JAX package's (CPU, float64).

The same numpy inputs, made from a seed, build a JAX ``ConditionedGP``
and, through ``convert.gp_from_numpy``, the port's. On the CPU the
port's ``logpdf`` runs K1's plain version (K3/K4's under a gradient) and
its posterior solve the three-scan solve. The builders' ``gp_model``
callables are held against the JAX builders' row by row.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu import inference as jinf
from pioran_tpu.models import gp as jgp
from pioran_tpu.models.kernels import CeleriteKernel as JKernel
from pioran_tpu_torch import inference as tinf
from pioran_tpu_torch.convert import gp_from_numpy
from pioran_tpu_torch.models import gp as tgp
from pioran_tpu_torch.models.kernels import CeleriteKernel

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


def _problem(B, J, N, seed):
    """(a, b, c, d) (B, J) with a c > b d term by term (a positive
    definite kernel), sorted t (N,), y (B, N), sigma2 (B, N)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.1, 1.0, (B, J))
    b = 0.1 * a * rng.uniform(0.0, 1.0, (B, J))
    c = rng.uniform(0.05, 0.5, (B, J))
    d = c * rng.uniform(0.0, 1.0, (B, J))
    t = np.sort(rng.uniform(0.0, 60.0, N))
    y = rng.normal(size=(B, N))
    s2 = rng.uniform(0.05, 0.2, (B, N))
    return a, b, c, d, t, y, s2


def _jgp(a, b, c, d, t, s2, mean):
    kern = JKernel(*(jnp.asarray(x) for x in (a, b, c, d)))
    return jgp.ScalableGP(mean, kern)(jnp.asarray(t), jnp.asarray(s2))


def _jit(fn, *args):
    """``fn`` of numpy inputs through the JAX package, jitted (one
    compilation instead of an eager trace of every scan step)."""
    return jax.jit(fn)(*(jnp.asarray(x) for x in args))


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


# the sinusoid of the periodic model's CustomMean, in either package
def _sin_mean(xp, A=0.7, T0=13.0, phi=0.4, mu=0.3):
    return lambda x: A * xp.sin(2.0 * np.pi * x / T0 + phi) + mu


def test_constructors():
    a, b, c, d, t, y, s2 = _problem(1, 3, 20, seed=0)
    kern = CeleriteKernel(*(torch.as_tensor(x[0]) for x in (a, b, c, d)))
    tt = torch.as_tensor(t)
    g0 = tgp.ScalableGP(kern)
    assert isinstance(g0, tgp.GaussianProcess) and g0.mean == 0.0 and g0.kernel is kern
    g1 = tgp.ScalableGP(0.5, kern)
    assert g1.mean == 0.5 and g1.kernel is kern
    fx = g1(tt)
    assert isinstance(fx, tgp.ConditionedGP) and fx.gp is g1
    assert torch.equal(fx.sigma2, torch.zeros(20, dtype=torch.float64))
    assert torch.equal(g1(tt, 0.1).sigma2, torch.full((20,), 0.1, dtype=torch.float64))
    post = tgp.posterior(fx, y[0])
    assert isinstance(post, tgp.PosteriorGP) and post.fx is fx
    assert post.y.dtype == torch.float64 and post.y.shape == (20,)
    with pytest.raises(ValueError):
        post.mean(method="dense")
    fx2 = gp_from_numpy(a[0], b[0], c[0], d[0], t, s2[0], mean=0.5, device="cpu")
    assert fx2.t.dtype == torch.float64 and fx2.sigma2.shape == (20,)
    assert float(fx2.gp.mean) == 0.5


@pytest.mark.parametrize("mean_kind", ["constant", "custom"])
def test_logpdf_matches_jax(mean_kind):
    """logpdf (the celerite path) and logpdf_direct (the dense oracle)
    with a constant and a CustomMean mean, 1e-10 relative."""
    a, b, c, d, t, y, s2 = _problem(1, 4, 60, seed=1)
    a, b, c, d, y, s2 = (x[0] for x in (a, b, c, d, y, s2))
    if mean_kind == "constant":
        jmean, tmean = 0.3, 0.3
    else:
        jmean, tmean = jgp.CustomMean(_sin_mean(jnp)), tgp.CustomMean(_sin_mean(torch))
    tfx = gp_from_numpy(a, b, c, d, t, s2, device="cpu")
    tfx = tgp.ScalableGP(tmean, tfx.gp.kernel)(tfx.t, tfx.sigma2)
    ty = torch.as_tensor(y)

    def jax_values(*args):
        jfx = _jgp(*args[:6], jmean)
        return jfx.logpdf(args[6]), jfx.logpdf_direct(args[6])

    ref, ref_direct = (float(x) for x in _jit(jax_values, a, b, c, d, t, s2, y))
    lp = tfx.logpdf(ty)
    assert lp.shape == ()
    assert abs(float(lp) / ref - 1.0) <= 1e-10
    assert abs(float(tfx.logpdf_direct(ty)) / ref_direct - 1.0) <= 1e-10


def test_batched_matches_rows():
    """A (B, J) kernel conditions B GPs at once: logpdf, logpdf_direct,
    the posterior mean, cov and std equal the row-by-row results."""
    B = 4
    a, b, c, d, t, y, s2 = _problem(B, 3, 40, seed=2)
    mean = np.linspace(-0.2, 0.4, B)[:, None]
    fx = gp_from_numpy(a, b, c, d, t, s2, mean=mean, device="cpu")
    tau = torch.as_tensor(np.linspace(t[0] - 2.0, t[-1] + 2.0, 25))
    ty = torch.as_tensor(y)
    post = tgp.posterior(fx, ty)
    batched = [fx.logpdf(ty), fx.logpdf_direct(ty), post.mean(tau),
               post.mean(tau, method="scan"), post.cov(tau), post.std(tau)]
    assert [tuple(x.shape) for x in batched] == [(B,), (B,), (B, 25), (B, 25), (B, 25, 25),
                                                (B, 25)]
    for i in range(B):
        fi = gp_from_numpy(a[i], b[i], c[i], d[i], t, s2[i], mean=mean[i, 0], device="cpu")
        pi = tgp.posterior(fi, ty[i])
        rows = [fi.logpdf(ty[i]), fi.logpdf_direct(ty[i]), pi.mean(tau),
                pi.mean(tau, method="scan"), pi.cov(tau), pi.std(tau)]
        for x, r in zip(batched, rows):
            assert _rel(x[i].numpy(), r.numpy()) <= 1e-12


def test_posterior_matches_jax():
    """PosteriorGP mean (both methods), cov and std against the JAX
    PosteriorGP, 1e-9, on targets inside, between and outside the data."""
    a, b, c, d, t, y, s2 = _problem(1, 4, 50, seed=3)
    a, b, c, d, y, s2 = (x[0] for x in (a, b, c, d, y, s2))
    tau = np.sort(np.concatenate([t[::5], np.linspace(t[0] - 3.0, t[-1] + 3.0, 40)]))

    def jax_values(a_, b_, c_, d_, t_, s2_, y_, tau_):
        post = jgp.posterior(_jgp(a_, b_, c_, d_, t_, s2_, 0.2), y_)
        return (post.mean(tau_), post.mean(tau_, method="scan"), post.mean(),
                post.cov(tau_), post.std(tau_))

    refs = _jit(jax_values, a, b, c, d, t, s2, y, tau)
    tpost = tgp.posterior(gp_from_numpy(a, b, c, d, t, s2, mean=0.2, device="cpu"), y)
    ttau = torch.as_tensor(tau)
    ours = (tpost.mean(ttau), tpost.mean(ttau, method="scan"), tpost.mean(),
            tpost.cov(ttau), tpost.std(ttau))
    for x, r in zip(ours, refs):
        assert _rel(x.numpy(), r) <= 1e-9


def test_posterior_sample_matches_jax():
    """PosteriorGP.sample through its normals-taking twin, fed the JAX
    draw's own normals, against the JAX draw (the jitter rule 1e-12
    trace / M included), 1e-9."""
    a, b, c, d, t, y, s2 = _problem(1, 3, 40, seed=4)
    a, b, c, d, y, s2 = (x[0] for x in (a, b, c, d, y, s2))
    tau = np.linspace(t[0], t[-1], 30)
    key = jax.random.PRNGKey(5)

    def jax_draw(a_, b_, c_, d_, t_, s2_, y_, tau_):
        return jgp.posterior(_jgp(a_, b_, c_, d_, t_, s2_, 0.0), y_).sample(
            key, tau_, num_samples=3)

    ref = np.asarray(_jit(jax_draw, a, b, c, d, t, s2, y, tau))
    eps = np.array(jax.random.normal(key, (3, 30), dtype=jnp.float64))
    tpost = tgp.posterior(gp_from_numpy(a, b, c, d, t, s2, device="cpu"), y)
    draw = tpost._sample_from_normals(torch.as_tensor(eps), torch.as_tensor(tau))
    assert draw.shape == (3, 30)
    assert _rel(draw.numpy(), ref) <= 1e-9
    gen = torch.Generator().manual_seed(0)
    assert tpost.sample(gen, torch.as_tensor(tau), num_samples=2).shape == (2, 30)


def test_logpdf_gradient_matches_jax():
    """The gradient of logpdf with respect to the coefficients and y
    (the port: K3/K4's plain versions under autograd) against ``jax.grad``
    row by row at N = 48, 1e-8 relative per row (row by row, not a
    jitted vmap: ROADMAP §3; jitted, since an eager trace of the scan
    takes six seconds a row here)."""
    B = 2
    a, b, c, d, t, y, s2 = _problem(B, 3, 48, seed=6)
    coefs = [torch.tensor(x, requires_grad=True) for x in (a, b, c, d)]
    ty = torch.tensor(y, requires_grad=True)
    fx = tgp.ScalableGP(0.1, CeleriteKernel(*coefs))(torch.as_tensor(t), torch.as_tensor(s2))
    fx.logpdf(ty).sum().backward()
    grads = [x.grad.numpy() for x in (*coefs, ty)]

    def jlogpdf(a_, b_, c_, d_, y_, s2_):
        fx_ = jgp.ScalableGP(0.1, JKernel(a_, b_, c_, d_))(jnp.asarray(t), s2_)
        return fx_.logpdf(y_)

    jg = jax.jit(jax.grad(jlogpdf, argnums=(0, 1, 2, 3, 4)))
    for i in range(B):
        ref = jg(*(jnp.asarray(x[i]) for x in (a, b, c, d, y, s2)))
        for g, r in zip(grads, ref):
            assert _rel(g[i], r) <= 1e-8


def test_neginf_row_gives_nan_posterior_mean():
    """A row whose kernel is not positive definite has logpdf -inf, and
    its posterior mean is NaN by either method (the solve refuses it
    rather than return the prior mean); the other rows are finite."""
    a, b, c, d, t, y, s2 = _problem(3, 3, 30, seed=7)
    a[1] = -50.0 * a[1]
    post = tgp.posterior(gp_from_numpy(a, b, c, d, t, s2, device="cpu"), y)
    lp = post.fx.logpdf(post.y)
    assert bool(torch.isneginf(lp[1])) and bool(torch.isfinite(lp[[0, 2]]).all())
    for method in ("matmul", "scan"):
        mu = post.mean(method=method)
        assert bool(torch.isnan(mu[1]).all())
        assert bool(torch.isfinite(mu[[0, 2]]).all())


def _curve():
    path = os.path.join(DATA, "simu_single", "simu_single_subset_time_series.txt")
    with open(path) as fh:
        for line in fh:
            if line.startswith("#mean: "):
                left, right = line[len("#mean: "):].split(" va: ")
                xbar, va = float(left), float(right)
                break
    A = np.loadtxt(path)[:64]
    return A[:, 0], A[:, 1], A[:, 2], xbar, va


# builder, its keywords, two theta rows in spec order
GP_MODELS = {
    "single": ("single_bending_model", {},
               [[0.76, 2.78, 0.0041, 0.022, 1.11, 0.25], [0.5, 3.1, 0.01, 0.05, 0.9, 0.1]]),
    "single_c": ("single_bending_model", {"use_c": True},
                 [[0.76, 2.78, 0.0041, 0.022, 1.11, 0.25, 0.1],
                  [0.5, 3.1, 0.01, 0.05, 0.9, 0.1, 0.3]]),
    "double": ("double_bending_model", {},
               [[0.3, 1.9, 3.2, 0.003, 0.04, 0.03, 1.0, 0.2],
                [0.8, 2.2, 3.6, 0.006, 0.02, 0.05, 1.2, 0.1]]),
    "periodic": ("periodic_rednoise_model", {},
                 [[0.76, 2.78, 0.0041, 0.022, 1.11, 0.25, 0.3, 1.0, 40.0],
                  [0.5, 3.1, 0.01, 0.05, 0.9, 0.1, 0.8, 4.0, 90.0]]),
    "carma21": ("carma_model", {"p": 2, "q": 1},
                [[0.05, 0.3, 0.4, 0.03, 1.1, 0.2], [0.2, 0.6, 1.5, 0.05, 0.9, 0.1]]),
}


@pytest.mark.parametrize("name", sorted(GP_MODELS))
def test_builder_gp_model_matches_jax(name):
    """``spec.gp_model`` (two rows at once) against the JAX builder's
    ``gp_model`` row by row: the GP's logpdf of the log fluxes (of y for
    the periodic model) to 1e-10, and ``psd_model`` is the JAX class's
    counterpart."""
    builder, kw, rows = GP_MODELS[name]
    t, y, yerr, xbar, va = _curve()
    jspec = getattr(jinf, builder)(t, y, yerr, xbar, va, **kw)
    tspec = getattr(tinf, builder)(t, y, yerr, xbar, va, device="cpu", **kw)
    assert (tspec.psd_model is None) == (jspec.psd_model is None)
    if jspec.psd_model is not None:
        assert tspec.psd_model.__name__ == jspec.psd_model.__name__
    obs = y if name == "periodic" else np.log(y)
    fx = tspec.gp_model(t, y, yerr, np.asarray(rows))
    lp = fx.logpdf(torch.as_tensor(obs)).numpy()
    assert lp.shape == (2,)
    jlogpdf = jax.jit(lambda row: jspec.gp_model(jnp.asarray(t), jnp.asarray(y),
                                                 jnp.asarray(yerr), row).logpdf(jnp.asarray(obs)))
    for i, row in enumerate(rows):
        ref = float(jlogpdf(jnp.asarray(row)))
        assert abs(lp[i] / ref - 1.0) <= 1e-10


def test_root_surface_matches_jax():
    """The port's root exports every name of the JAX package's root
    except ``use_x64``, JAX's global 64-bit switch: the port's entry
    points take ``dtype=`` (float64 by default) instead."""
    import ast

    import pioran_tpu
    import pioran_tpu_torch

    # the names pioran_tpu/__init__.py binds (not the submodules other
    # tests happen to have imported)
    with open(pioran_tpu.__file__) as fh:
        tree = ast.parse(fh.read())
    names = {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
             for a in node.names}
    missing = {n for n in names if not n.startswith("_")} - set(dir(pioran_tpu_torch))
    assert missing == {"use_x64"}
    assert pioran_tpu_torch.celerite_ops.log_likelihood is pioran_tpu_torch.log_likelihood
    assert pioran_tpu_torch.direct_ops.predict_cov_direct is not None
