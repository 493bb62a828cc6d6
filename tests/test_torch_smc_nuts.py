"""PyTorch port parity: tempered SMC and NUTS.

The deterministic helpers of both samplers held exactly against the JAX
package's (float64); the samplers on the analytic targets of
``tests/test_samplers.py`` with its gates (the two packages draw from
different random streams, so that parity is statistical); and short
``run_inference(sampler="smc" | "nuts")`` runs of the flagship model on
a cut of the light curve, against the JAX package's result layout. CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu import inference as jinf
from pioran_tpu.samplers import nuts as jnuts
from pioran_tpu.samplers import smc as jsmc
from pioran_tpu_torch import inference as tinf
from pioran_tpu_torch.samplers import nuts as tnuts
from pioran_tpu_torch.samplers import smc as tsmc

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


# ---------------------------------------------------------------------------
# deterministic helpers, exactly
# ---------------------------------------------------------------------------


def test_popcount_and_trailing_ones_match_jax():
    n = np.arange(1024)
    for tf, jf in ((tnuts._popcount, jnuts._popcount),
                   (tnuts._trailing_ones, jnuts._trailing_ones)):
        assert np.array_equal(tf(torch.as_tensor(n)).numpy(), np.asarray(jf(jnp.asarray(n))))


@pytest.mark.parametrize("num_warmup", [10, 60, 500])
def test_warmup_schedule_matches_jax(num_warmup):
    assert np.array_equal(tnuts.warmup_schedule(num_warmup),
                          np.asarray(jnuts.warmup_schedule(num_warmup)))


def test_dual_averaging_matches_jax():
    """50 dual-averaging updates from step size 0.1, every field equal."""
    acc = np.random.default_rng(0).uniform(size=50)
    sj = jnuts._da_init(jnp.asarray(0.1))
    st = tnuts._da_init(torch.tensor(0.1, dtype=torch.float64))
    for a in acc:
        sj = jnuts._da_update(sj, jnp.asarray(a), 0.8)
        st = tnuts._da_update(st, torch.tensor(a, dtype=torch.float64), 0.8)
        assert [float(x) for x in st] == [float(x) for x in sj]


@pytest.mark.parametrize("lam", [0.0, 0.3, 0.999])
def test_ess_fraction_and_dlambda_match_jax(lam):
    """The same log-likelihoods give the same ESS fraction (to rounding of
    the sums) and the same bisected temperature step, exactly."""
    ll = np.random.default_rng(int(lam * 1000)).normal(-500.0, 40.0, 1024)
    ess_j = float(jsmc._ess_fraction(jnp.asarray(lam * ll)))
    ess_t = float(tsmc._ess_fraction(torch.as_tensor(lam * ll)))
    assert ess_t == pytest.approx(ess_j, rel=1e-14)
    dl_j = float(jsmc._find_dlambda(jnp.asarray(ll), jnp.asarray(lam), 0.8))
    dl_t = float(tsmc._find_dlambda(torch.as_tensor(ll), torch.tensor(lam, dtype=torch.float64),
                                    0.8))
    assert dl_t == dl_j
    for move in ("rwm", "mala"):
        assert float(tsmc._default_scale(6, move, torch.float64)) == float(
            jsmc._default_scale(6, move, jnp.float64))


def test_systematic_resample_matches_jax_given_its_uniform():
    key = jax.random.PRNGKey(3)
    log_w = np.random.default_rng(9).normal(size=1000)
    ref = np.asarray(jsmc.systematic_resample(key, jnp.asarray(log_w)))
    u = torch.tensor(float(jax.random.uniform(key, (), dtype=jnp.float64)), dtype=torch.float64)
    out = tsmc.systematic_resample(None, torch.as_tensor(log_w), u=u)
    assert np.array_equal(out.numpy(), ref)


def test_resampling_without_a_finite_weight_picks_what_jax_picks():
    """Every log weight -inf (every particle's log-likelihood -inf): the
    weights are NaN, and the port's indices pick the particles the JAX
    package's pick, not an index out of range."""
    key = jax.random.PRNGKey(4)
    log_w = np.full(16, -np.inf)
    parts = jnp.arange(16.0)[:, None]
    ref = np.asarray(parts[jsmc.systematic_resample(key, jnp.asarray(log_w))][:, 0])
    u = torch.tensor(float(jax.random.uniform(key, (), dtype=jnp.float64)), dtype=torch.float64)
    out = tsmc.systematic_resample(None, torch.as_tensor(log_w), u=u)
    assert np.array_equal(torch.arange(16.0)[out].numpy(), ref)


# ---------------------------------------------------------------------------
# the analytic targets of tests/test_samplers.py, with its gates
# ---------------------------------------------------------------------------


def test_nuts_correlated_gaussian():
    cov = np.array([[2.0, 1.2, 0.3], [1.2, 1.5, 0.5], [0.3, 0.5, 1.0]])
    prec = torch.linalg.inv(torch.as_tensor(cov))
    z0 = torch.as_tensor(np.random.default_rng(1).normal(size=(8, 3)))
    samples, stats = tnuts.run_nuts(lambda Z: -0.5 * torch.sum((Z @ prec) * Z, dim=1), z0,
                                    torch.Generator().manual_seed(0),
                                    num_warmup=300, num_samples=500)
    assert samples.shape == (8, 500, 3)
    assert stats["depth"].shape == stats["num_leaves"].shape == (8, 500)
    assert stats["step_size"].shape == (8,) and stats["inv_mass"].shape == (8, 3)
    # per-chain adaptation: each chain its own step size
    assert len(set(stats["step_size"].tolist())) == 8
    s = samples.reshape(-1, 3).numpy()
    assert float(stats["diverging"].double().mean()) < 0.01
    np.testing.assert_allclose(s.mean(0), 0.0, atol=0.12)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.25)


def test_nuts_banana_no_nans():
    """Curved banana: every draw finite, every chain moves."""

    def logp(Z):
        x, y = Z[:, 0], Z[:, 1]
        return -0.5 * (x**2 / 4.0 + (y - x**2 / 4.0) ** 2)

    z0 = 0.1 * torch.as_tensor(np.random.default_rng(3).normal(size=(4, 2)))
    samples, _ = tnuts.run_nuts(logp, z0, torch.Generator().manual_seed(2),
                                num_warmup=300, num_samples=400)
    s = samples.numpy()
    assert np.all(np.isfinite(s))
    assert np.all(s.std(axis=1)[:, 0] > 0.5)


def test_nuts_no_samples_and_exact_leaf_count():
    """num_samples=0 returns empty draws; num_leaves counts every
    leapfrog: one logp_batch evaluation of all chains per leaf step, and
    the chains' leaves never exceed the steps taken."""
    calls = []

    def logp(Z):
        calls.append(Z.shape[0])
        return -0.5 * torch.sum(Z * Z, dim=1)

    z0 = torch.as_tensor(np.random.default_rng(4).normal(size=(5, 2)))
    samples, stats = tnuts.run_nuts(logp, z0, torch.Generator().manual_seed(4),
                                    num_warmup=7, num_samples=0)
    assert samples.shape == (5, 0, 2) and stats["logp"].shape == (5, 0)
    leaves = stats["warmup_num_leaves"]
    assert leaves.shape == (5, 7)
    steps = len(calls) - 1  # the first call is the start's value+gradient
    assert bool((leaves.sum(1) <= steps).all()) and int(leaves.sum(1).max()) >= 1
    # every leaf of a tree of depth d: at most 2^d - 1 leapfrogs
    assert bool((leaves <= 2 ** stats["warmup_depth"] - 1).all())


def test_smc_gaussian_evidence():
    d, s0, s = 4, 2.0, 0.5
    y = torch.tensor([0.3, -1.2, 0.8, 2.0], dtype=torch.float64)

    def loglike(Z):
        return -0.5 * torch.sum((y - Z) ** 2, 1) / s**2 - d / 2 * np.log(2 * np.pi * s**2)

    def logprior(Z):
        return -0.5 * torch.sum(Z**2, 1) / s0**2 - d / 2 * np.log(2 * np.pi * s0**2)

    logZ_true = float(-0.5 * np.sum(y.numpy() ** 2) / (s0**2 + s**2)
                      - d / 2 * np.log(2 * np.pi * (s0**2 + s**2)))
    p0 = s0 * torch.as_tensor(np.random.default_rng(0).normal(size=(1024, d)))
    res = tsmc.run_smc(loglike, logprior, p0, torch.Generator().manual_seed(1))
    assert abs(float(res.logZ) - logZ_true) < 0.15
    post_mean = y.numpy() * s0**2 / (s0**2 + s**2)
    np.testing.assert_allclose(res.particles.mean(0).numpy(), post_mean, atol=0.1)
    post_std = np.sqrt(s0**2 * s**2 / (s0**2 + s**2))
    np.testing.assert_allclose(res.particles.std(0).numpy(), post_std, rtol=0.15)
    assert float(res.lambdas[res.num_steps - 1]) == 1.0


# ---------------------------------------------------------------------------
# run_inference on the flagship model
# ---------------------------------------------------------------------------


def _simu(n):
    A = np.loadtxt(os.path.join(DATA, "simu.txt"))[:n]
    xbar, va = float(np.mean(np.log(A[:, 1]))), float(np.var(np.log(A[:, 1])))
    return A[:, 0], A[:, 1], A[:, 2], xbar, va


def _keys_and_header(log_dir):
    with open(os.path.join(log_dir, "info", "results.json")) as fh:
        res = json.load(fh)
    with open(os.path.join(log_dir, "chains", "equal_weighted_post.txt")) as fh:
        return set(res), res, fh.readline()


def _jax_standin(data):
    """The JAX package's flagship prior and names with a quadratic stand-in
    likelihood: its layout does not depend on the likelihood, and its
    compile of the celerite adjoint inside the samplers would take most of
    a minute."""
    jflag = jinf.single_bending_model(*data, n_components=4)
    mean = jnp.asarray([0.8, 2.8, 0.004, 0.02, 1.1, 0.25])
    return jinf.GPModelSpec(
        prior=jflag.prior, loglike=lambda th: -0.5 * jnp.sum((th - mean) ** 2),
        names=jflag.names, gp_model=None, psd_model=None,
        paramnames_split=jflag.paramnames_split, t=jflag.t, y=jflag.y, yerr=jflag.yerr,
        f_min=jflag.f_min, f_max=jflag.f_max,
        loglike_batch=lambda TH: -0.5 * jnp.sum((TH - mean) ** 2, axis=-1))


@pytest.mark.parametrize("sampler,kw", [
    ("smc", dict(num_particles=32, num_moves=2)),
    ("nuts", dict(num_chains=2, num_warmup=3, num_samples=4)),
])
def test_run_inference_smc_nuts_write_jax_layout(sampler, kw, tmp_path, monkeypatch):
    """Short runs on the flagship model (32 points, J = 4): the JAX
    package's result keys, results.json keys and posterior header; finite
    values; ncall = temper steps x moves x particles for SMC and the exact
    leapfrog count for NUTS."""
    data = _simu(32)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    ref = jinf.run_inference(_jax_standin(data), sampler=sampler, key=jax.random.PRNGKey(0),
                             log_dir=jdir, **kw)
    nuts_stats = []
    run_nuts = tinf.run_nuts

    def spy(*a, **k):
        out = run_nuts(*a, **k)
        nuts_stats.append(out[1])
        return out

    monkeypatch.setattr(tinf, "run_nuts", spy)
    spec = tinf.single_bending_model(*data, n_components=4, device="cpu")
    out = tinf.run_inference(spec, sampler=sampler, seed=0, log_dir=tdir, **kw)
    assert out.keys() == ref.keys()
    assert out["samples"].shape == np.asarray(ref["samples"]).shape
    assert np.all(np.isfinite(out["samples"]))
    assert np.all(np.isfinite(out["posterior"]["mean"]))
    assert np.isfinite(out["maximum_likelihood"]["logl"])
    if sampler == "smc":
        assert np.isfinite(out["logz"]) and out["num_temper_steps"] >= 1
        assert out["ncall"] == out["num_temper_steps"] * kw["num_moves"] * kw["num_particles"]
    else:
        st = nuts_stats[0]
        assert out["ncall"] == int(st["num_leaves"].sum() + st["warmup_num_leaves"].sum())
        assert len(out["rhat"]) == len(out["ess_bulk"]) == 6
    jkeys, jres, jhead = _keys_and_header(jdir)
    tkeys, tres, thead = _keys_and_header(tdir)
    assert tkeys == jkeys and thead == jhead
    assert tres["posterior"].keys() == jres["posterior"].keys()


def test_run_inference_nuts_no_samples(tmp_path):
    """num_samples=0: no draws, NaN summaries, the warmup's leapfrogs
    counted, the files written."""
    spec = tinf.single_bending_model(*_simu(32), n_components=4, device="cpu")
    out = tinf.run_inference(spec, sampler="nuts", num_chains=2, num_warmup=2, num_samples=0,
                             log_dir=str(tmp_path))
    assert out["samples"].shape == (0, 6)
    assert out["ncall"] >= 2
    assert np.all(np.isnan(out["posterior"]["mean"])) and np.all(np.isnan(out["rhat"]))
    for rel in (("chains", "equal_weighted_post.txt"), ("info", "results.json")):
        assert os.path.isfile(os.path.join(str(tmp_path), *rel))


def test_run_inference_defaults_to_smc(monkeypatch):
    """As in the JAX package, a spec alone runs SMC, with MALA moves."""
    spec = tinf.single_bending_model(*_simu(32), n_components=4, device="cpu")
    seen = []
    run_smc = tinf.run_smc

    def spy(*a, **k):
        seen.append(k)
        return run_smc(*a, **k)

    monkeypatch.setattr(tinf, "run_smc", spy)
    out = tinf.run_inference(spec, num_particles=32, num_moves=1)
    assert out["sampler"] == "smc" and np.isfinite(out["logz"])
    assert seen and seen[0]["move"] == "mala"
