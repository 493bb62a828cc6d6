"""PyTorch port parity: the multi-dataset entry point ``run_inference_many``.

The many-model's batched log-posterior (value and gradient) against a JAX
expression built from the JAX package's public pieces as its
``run_inference_many`` builds it, on three ragged cuts of the reference
light curve; a short CPU run against the JAX function's result layout and
the dataset-mean gate of its own smoke test. float64 on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu import inference as jinf
from pioran_tpu.models.psd import SingleBendingPowerLaw as JSBPL
from pioran_tpu.ops import pallas_celerite as jpc
from pioran_tpu.ops.approx import approx as japprox
from pioran_tpu.priors import Gamma, LogNormal, LogUniform, Normal, PriorSet, TwoUniformDependent
from pioran_tpu_torch import inference as tinf

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


def _cuts(*bounds):
    A = np.loadtxt(os.path.join(DATA, "simu.txt"))
    return [(A[lo:hi, 0], A[lo:hi, 1], A[lo:hi, 2]) for lo, hi in bounds]


# the three ragged datasets of tests/test_inference_parity.py's smoke test
FULL = ((0, 200), (100, 350), (0, None))


def _jax_logpost(datasets, C, n_components):
    """The JAX package's run_inference_many model (inference.py:1063-1128),
    rebuilt from its public pieces: (prior, logpost_batch)."""
    D, Ns = len(datasets), [len(d[0]) for d in datasets]
    Nmax = max(Ns)

    def pad(x, fill):
        x = np.asarray(x, np.float64)
        return np.concatenate([x, np.full(Nmax - len(x), x[-1] if fill == "edge" else fill)])

    T = jnp.asarray(np.stack([pad(d[0], "edge") for d in datasets]))
    DT = jnp.asarray(np.stack([np.diff(pad(d[0], "edge")) for d in datasets]))
    Y = jnp.asarray(np.stack([pad(d[1], 1.0) for d in datasets]))
    E = jnp.asarray(np.stack([pad(d[2], 1.0) for d in datasets]))
    NV = jnp.asarray(Ns, float)
    xbar = jnp.asarray([np.mean(np.log(d[1])) for d in datasets])
    sd5 = jnp.asarray([5.0 * np.std(np.log(d[1])) for d in datasets])
    f_min = min(1.0 / float(d[0][-1] - d[0][0]) for d in datasets)
    f_max = max(1.0 / float(np.min(np.diff(d[0]))) / 2.0 for d in datasets)
    prior = PriorSet([
        ("alphas", TwoUniformDependent(0.0, 1.5, 4.0)),
        ("f_1", LogUniform(f_min / 20.0 * 4.0, f_max * 20.0 / 4.0)),
        ("variance", LogNormal(2 * -1.5, np.sqrt(2.0) * 1.0)),
        ("nu", Gamma(2.0, 0.5)),
        ("mu_std", Normal(0.0, 1.0)),
    ])
    ds = jnp.repeat(jnp.arange(D), C)

    def coeffs_one(th):
        kern = japprox(JSBPL(th[0], th[2], th[1]), f_min, f_max, n_components, th[3],
                       20.0, 20.0, basis_function="SHO")
        return kern.coefficients()

    def logpost_batch(Z):
        TH = jax.vmap(prior.from_unconstrained)(Z)
        a, b, c, d = jax.vmap(coeffs_one)(TH)
        mu = xbar[ds] + sd5[ds] * TH[:, 5]
        s2 = TH[:, 4][:, None] * E[ds] ** 2 / Y[ds] ** 2
        ll = jpc.batched_loglike_multi(a, b, c, d, T[ds], jnp.log(Y)[ds] - mu[:, None],
                                       s2, NV[ds], DT[ds])
        return jax.vmap(prior.unconstrained_logpdf)(Z) + ll

    return prior, logpost_batch


def test_many_logpost_matches_jax():
    """Value (1e-10 relative) and gradient (1e-8 relative per row) of the
    port's many-model log-posterior against the JAX expression, at 12 rows
    (3 datasets x 4 chains, n_components = 6) drawn from the prior."""
    datasets, C = _cuts(*FULL), 4
    jprior, jlogpost = _jax_logpost(datasets, C, 6)
    U = np.random.default_rng(3).uniform(0.1, 0.9, (3 * C, 6))
    Z = np.asarray(jax.vmap(jprior.to_unconstrained)(jax.vmap(jprior.transform)(jnp.asarray(U))))
    lp_ref, vjp = jax.vjp(jax.jit(jlogpost), jnp.asarray(Z))
    (g_ref,) = vjp(jnp.ones(3 * C))
    lp_ref, g_ref = np.asarray(lp_ref), np.asarray(g_ref)

    model = tinf._many_model(datasets, n_components=6, device="cpu")
    Zt = torch.tensor(Z).requires_grad_(True)
    lp = model.logpost_batch(Zt)
    (g,) = torch.autograd.grad(lp.sum(), Zt)
    fin = np.isfinite(lp_ref)
    assert fin.sum() >= 10
    np.testing.assert_array_equal(np.isfinite(lp.detach().numpy()), fin)
    np.testing.assert_allclose(lp.detach().numpy()[fin], lp_ref[fin], rtol=1e-10)
    g = g.numpy()
    rel = np.linalg.norm(g - g_ref, axis=1) / np.linalg.norm(g_ref, axis=1)
    assert np.max(rel[fin]) <= 1e-8
    np.testing.assert_allclose(model.xbar, [np.mean(np.log(d[1])) for d in datasets], rtol=1e-15)


def test_run_inference_many_cpu(tmp_path, monkeypatch):
    """A short run on three ragged cuts (N <= 120): per-dataset results
    with the JAX function's keys (the JAX run uses a quadratic stand-in
    likelihood, since its layout does not depend on the likelihood), the
    ds{i} files, and each dataset's mu finite and within 2.0 of its
    log-mean, as tests/test_inference_parity.py gates the JAX run."""
    datasets = _cuts((0, 60), (100, 145), (250, 330))
    kw = dict(num_chains=4, num_warmup=12, num_samples=12, max_leapfrogs=4, n_components=4)
    monkeypatch.setattr(jpc, "batched_loglike_multi",
                        lambda a, b, c, d, *_r: -0.5 * jnp.sum(a**2 + c**2, axis=1))
    ref = jinf.run_inference_many(datasets, key=jax.random.PRNGKey(0),
                                  log_dir=str(tmp_path / "jax"), **kw)
    out = tinf.run_inference_many(datasets, seed=0, log_dir=str(tmp_path / "torch"),
                                  device="cpu", **kw)
    assert len(out) == len(ref) == 3
    for i, (r, j, d) in enumerate(zip(out, ref, datasets)):
        assert r.keys() == j.keys()
        assert r["samples"].shape == np.asarray(j["samples"]).shape == (4 * 12, 6)
        m = np.asarray(r["posterior"]["mean"])
        assert np.all(np.isfinite(m))
        assert abs(m[5] - float(np.mean(np.log(d[1])))) < 2.0
        assert len(r["rhat"]) == len(r["ess_bulk"]) == 6 and r["ncall"] > 0
        for side in ("jax", "torch"):
            base = tmp_path / side / f"ds{i}"
            assert (base / "chains" / "equal_weighted_post.txt").is_file()
        with open(tmp_path / "torch" / f"ds{i}" / "info" / "results.json") as fh:
            tres = json.load(fh)
        with open(tmp_path / "jax" / f"ds{i}" / "info" / "results.json") as fh:
            jres = json.load(fh)
        assert tres.keys() == jres.keys()
        assert tres["posterior"].keys() == jres["posterior"].keys()


def test_run_inference_many_starts_from_prior_draws(monkeypatch):
    """As in the JAX package, the D C chains start from prior draws, the
    first draws of the seeded generator, and ChEES runs with its default
    (diagonal) metric."""
    datasets = _cuts((0, 40), (300, 330))
    seen = {}

    def fake_chees(logpost_batch, z0, gen, **kw):
        seen["z0"], seen["kw"] = z0, kw
        return z0[None].repeat(4, 1, 1), {"n_leapfrogs": np.ones(8, np.int64)}

    monkeypatch.setattr(tinf, "run_chees", fake_chees)
    tinf.run_inference_many(datasets, seed=7, num_chains=5, num_warmup=4, num_samples=4,
                            n_components=4, device="cpu")
    prior = tinf._many_model(datasets, n_components=4, device="cpu").prior
    z0 = prior.to_unconstrained(prior.sample((10,), generator=torch.Generator().manual_seed(7),
                                             dtype=torch.float64))
    torch.testing.assert_close(seen["z0"], z0, rtol=0, atol=0)
    assert "mass" not in seen["kw"]


def test_run_inference_many_is_seeded():
    """One seed gives the same draws twice; another seed gives others."""
    datasets = _cuts((0, 40), (300, 330))
    kw = dict(num_chains=3, num_warmup=4, num_samples=4, max_leapfrogs=2, n_components=4,
              device="cpu")
    a, b, c = (tinf.run_inference_many(datasets, seed=s, **kw) for s in (1, 1, 2))
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x["samples"], y["samples"])
        assert not np.array_equal(x["samples"], z["samples"])


def test_run_inference_many_refuses_mesh_and_other_samplers():
    with pytest.raises(NotImplementedError, match="step 13"):
        tinf.run_inference_many(_cuts((0, 30)), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="ChEES"):
        tinf.run_inference_many(_cuts((0, 30)), sampler="nuts", device="cpu")
