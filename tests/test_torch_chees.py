"""PyTorch port parity: the gradient path and its samplers.

The port's copy of ``mcmc_stats`` and ChEES's scalar helpers against the
JAX package's; ChEES-HMC (diagonal and dense metrics) and ADVI on the
analytic Gaussian targets of ``tests/test_samplers.py``; the flagship
model's batched log-posterior gradient against JAX's; the prior
bijectors' gradients; and tiny ``run_inference(sampler="chees")`` and
``"advi"`` runs against the JAX package's result layout. CPU, float64.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu import inference as jinf
from pioran_tpu.samplers import chees as jchees
from pioran_tpu.utils import mcmc_stats as jstats
from pioran_tpu_torch import inference as tinf
from pioran_tpu_torch.samplers import chees as tchees
from pioran_tpu_torch.samplers.advi import run_advi
from pioran_tpu_torch.utils import mcmc_stats as tstats

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


def _simu(n=None):
    A = np.loadtxt(os.path.join(DATA, "simu.txt"))[:n]
    xbar, va = float(np.mean(np.log(A[:, 1]))), float(np.var(np.log(A[:, 1])))
    return A[:, 0], A[:, 1], A[:, 2], xbar, va


@pytest.mark.parametrize("shape", [(4, 200, 3), (8, 33), (2, 3, 2)])
def test_mcmc_stats_copy_matches_jax(shape):
    """Same numpy chains, same numbers (to 1e-12); the tiny case covers
    the NaN paths (fewer than 4 draws)."""
    rng = np.random.default_rng(sum(shape))
    chains = np.cumsum(rng.normal(size=shape), axis=1) * 0.1 + rng.normal(size=shape)
    out, ref = tstats.summarize_chains(chains), jstats.summarize_chains(chains)
    assert out.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-12, equal_nan=True, err_msg=k)


def test_halton_and_adam_match_jax_exactly():
    for i in (0, 1, 2, 7, 24, 499, 2899, 123456):
        assert tchees._halton(i) == float(jchees._halton(jnp.asarray(i)))
    st_t = tchees._AdamState(0.0, 0.0, 0)
    st_j = jchees._AdamState(jnp.zeros(()), jnp.zeros(()), jnp.zeros((), jnp.int32))
    for grad in (0.3, -1.7, 2e-3, 0.0, 5.5):
        st_t, dt = tchees._adam_update(st_t, grad)
        st_j, dj = jchees._adam_update(st_j, jnp.asarray(grad))
        assert dt == float(dj)
        assert (st_t.m, st_t.v, st_t.t) == (float(st_j.m), float(st_j.v), int(st_j.t))


def _gauss_logp(cov):
    prec = torch.linalg.inv(torch.as_tensor(cov))
    return lambda Z: -0.5 * torch.sum((Z @ prec) * Z, dim=1)


def test_chees_diag_correlated_gaussian():
    """As the JAX package's test_chees_correlated_gaussian (64 chains,
    400 + 400 iterations, same targets)."""
    cov = np.array([[2.0, 1.2, 0.3], [1.2, 1.5, 0.5], [0.3, 0.5, 1.0]])
    z0 = torch.as_tensor(np.random.default_rng(1).normal(size=(64, 3)))
    samples, stats = tchees.run_chees(_gauss_logp(cov), z0, torch.Generator().manual_seed(0),
                                      num_warmup=400, num_samples=400, max_leapfrogs=64)
    s = samples.reshape(-1, 3).numpy()
    assert int(stats["n_leapfrogs"].min()) >= 1
    np.testing.assert_allclose(s.mean(0), 0.0, atol=0.15)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.3)


def test_chees_dense_correlated_gaussian():
    """As test_chees_dense_mass_correlated_gaussian: condition number
    ~250, 128 chains, same targets and the learned metric's diagonal."""
    rho = 0.98
    cov = np.array([[4.0, rho * 2.0 * 0.5, 0.0], [rho * 2.0 * 0.5, 0.25, 0.0],
                    [0.0, 0.0, 1.0]])
    z0 = torch.as_tensor(np.random.default_rng(1).normal(size=(128, 3)))
    samples, stats = tchees.run_chees(_gauss_logp(cov), z0, torch.Generator().manual_seed(0),
                                      num_warmup=400, num_samples=400, max_leapfrogs=64,
                                      mass="dense")
    s = samples.reshape(-1, 3).numpy()
    assert int(stats["n_leapfrogs"].min()) >= 1
    np.testing.assert_allclose(s.mean(0), 0.0, atol=0.12)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.25)
    np.testing.assert_allclose(stats["inv_mass"].numpy(), np.diag(cov), rtol=0.6)


def test_chees_thin_and_divergence_guard():
    """thin keeps every k-th draw; a log-posterior that is -inf over half
    the space (divergent proposals) leaves every draw finite and inside."""
    logp = lambda Z: torch.where(Z[:, 0] > 0, -0.5 * torch.sum(Z**2, 1),  # noqa: E731
                                 torch.full_like(Z[:, 0], -float("inf")))
    z0 = torch.rand((16, 2), dtype=torch.float64) + 0.1
    samples, stats = tchees.run_chees(logp, z0, torch.Generator().manual_seed(3),
                                      num_warmup=60, num_samples=40, thin=4)
    assert samples.shape == (10, 16, 2) and stats["logp"].shape == (10, 16)
    assert stats["n_leapfrogs"].shape == (100,)
    assert bool(torch.isfinite(samples).all()) and bool((samples[..., 0] > 0).all())


def test_advi_gaussian_posterior():
    """As the JAX package's test_advi_gaussian_posterior: mean, marginal
    stddevs and ELBO = logZ on a conjugate Gaussian."""
    d, s0, s = 4, 2.0, 0.5
    y = torch.tensor([0.3, -1.2, 0.8, 2.0], dtype=torch.float64)
    post_var = 1.0 / (1.0 / s0**2 + 1.0 / s**2)
    post_mean = y.numpy() * post_var / s**2
    logZ_true = float(-0.5 * np.sum(y.numpy() ** 2) / (s0**2 + s**2)
                      - d / 2 * np.log(2 * np.pi * (s0**2 + s**2)))

    def logpost(Z):
        ll = -0.5 * torch.sum((y - Z) ** 2, 1) / s**2 - d / 2 * np.log(2 * np.pi * s**2)
        lp = -0.5 * torch.sum(Z**2, 1) / s0**2 - d / 2 * np.log(2 * np.pi * s0**2)
        return ll + lp

    res = run_advi(logpost, torch.zeros(d, dtype=torch.float64),
                   torch.Generator().manual_seed(0), num_steps=1500, num_draws=4000)
    np.testing.assert_allclose(res.mu.numpy(), post_mean, atol=0.05)
    np.testing.assert_allclose(np.exp(res.log_sigma.numpy()), np.sqrt(post_var), rtol=0.15)
    assert abs(float(res.logZ_lower) - logZ_true) < 0.1
    np.testing.assert_allclose(res.samples.numpy().mean(0), post_mean, atol=0.1)
    assert res.elbo_trace.shape == (1500,) and bool(torch.isfinite(res.elbo_trace).all())


def test_flagship_logpost_gradient_matches_jax():
    """∇ of the flagship spec's batched log-posterior (64-point subset,
    J = 8) against jax.vmap(jax.grad(logpost_unconstrained)) on 16 rows.
    Tolerance 1e-8 relative per row: the J x J basis solve agrees with
    JAX's normwise to 1e-12, and the 64-point covariance's conditioning
    amplifies that by up to ~1e4 in the gradient."""
    data = _simu(64)
    jspec = jinf.single_bending_model(*data, n_components=8)
    tspec = tinf.single_bending_model(*data, n_components=8, device="cpu")
    U = np.random.default_rng(3).uniform(0.1, 0.9, (16, 6))
    Z = np.asarray(jax.vmap(jspec.prior.to_unconstrained)(
        jax.vmap(jspec.prior.transform)(jnp.asarray(U))))
    # jitted: eager dispatch of the scan's VJP takes several times longer
    lp_ref, g_ref = jax.jit(jax.vmap(jax.value_and_grad(jspec.logpost_unconstrained)))(
        jnp.asarray(Z))
    lp_ref, g_ref = np.asarray(lp_ref), np.asarray(g_ref)
    Zt = torch.tensor(Z).requires_grad_(True)
    lp = tspec.logpost_batch(Zt)
    (g,) = torch.autograd.grad(lp.sum(), Zt)
    fin = np.isfinite(lp_ref)
    assert fin.sum() >= 12
    np.testing.assert_array_equal(np.isfinite(lp.detach().numpy()), fin)
    np.testing.assert_allclose(lp.detach().numpy()[fin], lp_ref[fin], rtol=1e-10)
    g = g.numpy()
    rel = np.linalg.norm(g - g_ref, axis=1) / np.linalg.norm(g_ref, axis=1)
    assert np.max(rel[fin]) <= 1e-8
    # a -inf likelihood row keeps the prior's finite gradient (the kernel
    # path zeroes the likelihood's share, where the JAX scan gives NaN)
    assert np.all(np.isfinite(g[~fin]))
    # the one-row method agrees with the batch
    one = float(tspec.logpost_unconstrained(torch.tensor(Z[0])))
    assert abs(one - float(lp[0].detach())) <= 1e-10 * abs(float(lp[0].detach()))


def test_flagship_prior_bijectors_autograd_clean():
    """from_unconstrained and unconstrained_logpdf of the flagship prior
    (the dependent pair and the four others) differentiate like JAX's."""
    jspec = jinf.single_bending_model(*_simu(32), n_components=4)
    tspec = tinf.single_bending_model(*_simu(32), n_components=4, device="cpu")
    Z = np.random.default_rng(5).normal(size=(8, 6))
    jp, tp = jspec.prior, tspec.prior

    def jf(z):
        return jp.unconstrained_logpdf(z) + jnp.sum(jnp.sin(jp.from_unconstrained(z)))

    ref = np.asarray(jax.vmap(jax.grad(jf))(jnp.asarray(Z)))
    Zt = torch.as_tensor(Z).requires_grad_(True)
    val = tp.unconstrained_logpdf(Zt) + torch.sum(torch.sin(tp.from_unconstrained(Zt)), -1)
    (g,) = torch.autograd.grad(val.sum(), Zt)
    np.testing.assert_allclose(g.numpy(), ref, rtol=1e-12, atol=1e-14)


def _keys_and_header(log_dir):
    with open(os.path.join(log_dir, "info", "results.json")) as fh:
        res = json.load(fh)
    with open(os.path.join(log_dir, "chains", "equal_weighted_post.txt")) as fh:
        return set(res), res, fh.readline()


@pytest.mark.parametrize("sampler,kw", [
    ("chees", dict(num_chains=4, num_warmup=6, num_samples=6, init="advi", mass="dense",
                   hmc_max_leapfrogs=4)),
    ("advi", dict(num_warmup=10, num_samples=20)),
], ids=["chees-advi-dense", "advi"])
def test_run_inference_gradient_samplers_write_jax_layout(sampler, kw, tmp_path, monkeypatch):
    """Tiny runs of both packages write the same result keys, results.json
    keys and posterior-file header. The port runs the flagship model; the
    JAX package runs the same prior and names with a quadratic stand-in
    likelihood (its layout does not depend on the likelihood, and its
    compile of the celerite scan's VJP inside the sampler would take most
    of a minute). The ADVI seeding is cut to 20 steps in both."""
    data = _simu(32)
    jseed = jinf.advi_seeded_inits
    monkeypatch.setattr(jinf, "advi_seeded_inits",
                        lambda spec, key, C: jseed(spec, key, C, num_steps=20))
    tseed = tinf.advi_seeded_inits
    monkeypatch.setattr(tinf, "advi_seeded_inits",
                        lambda spec, gen, C: tseed(spec, gen, C, num_steps=20))
    jflag = jinf.single_bending_model(*data, n_components=4)
    mean = jnp.asarray([0.8, 2.8, 0.004, 0.02, 1.1, 0.25])
    jspec = jinf.GPModelSpec(
        prior=jflag.prior, loglike=lambda th: -0.5 * jnp.sum((th - mean) ** 2),
        names=jflag.names, gp_model=None, psd_model=None,
        paramnames_split=jflag.paramnames_split, t=jflag.t, y=jflag.y, yerr=jflag.yerr,
        f_min=jflag.f_min, f_max=jflag.f_max,
        loglike_batch=lambda TH: -0.5 * jnp.sum((TH - mean) ** 2, axis=-1))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    ref = jinf.run_inference(jspec, sampler=sampler, key=jax.random.PRNGKey(0),
                             log_dir=jdir, **kw)
    out = tinf.run_inference(tinf.single_bending_model(*data, n_components=4, device="cpu"),
                             sampler=sampler, seed=0, log_dir=tdir, **kw)
    assert out.keys() == ref.keys()
    assert out["samples"].shape == np.asarray(ref["samples"]).shape
    assert np.all(np.isfinite(out["samples"]))
    assert out["ncall"] == ref["ncall"] if sampler == "advi" else out["ncall"] > 0
    jkeys, jres, jhead = _keys_and_header(jdir)
    tkeys, tres, thead = _keys_and_header(tdir)
    assert tkeys == jkeys and thead == jhead
    assert tres["posterior"].keys() == jres["posterior"].keys()
    if sampler == "chees":
        assert len(tres["rhat"]) == len(jres["rhat"]) == 6
