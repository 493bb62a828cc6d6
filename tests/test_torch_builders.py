"""PyTorch port parity: the double-bending and periodic-in-red-noise
model builders against the JAX package's (CPU, float64).

Each builder's batched likelihood at the reference's stored
maximum-likelihood point (tests/data/*/results.json, the JAX package's
own gate in tests/test_parity_models.py) and at 8 prior draws made with
numpy. Their gradients are in tests/test_torch_builders_grad.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu import inference as jinf
from pioran_tpu_torch import inference as tinf

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
# dataset, light curve, stored order -> spec order, JAX and port builders
MODELS = {
    "double": ("simu_double", "simu_double_subset_time_series.txt", [0, 2, 4, 1, 3, 5, 6, 7],
               jinf.double_bending_model, tinf.double_bending_model),
    "periodic": ("simu_periodic", "simu_periodic_rednoise_subset_time_series.txt",
                 [0, 2, 1, 3, 4, 5, 6, 7, 8],
                 jinf.periodic_rednoise_model, tinf.periodic_rednoise_model),
}


def _load(name):
    dirname, fname = MODELS[name][:2]
    path = os.path.join(DATA, dirname, fname)
    with open(path) as fh:
        for line in fh:
            if line.startswith("#mean: "):
                left, right = line[len("#mean: "):].split(" va: ")
                xbar, va = float(left), float(right)
                break
    A = np.loadtxt(path)
    with open(os.path.join(DATA, dirname, "results.json")) as fh:
        stored = json.load(fh)
    return stored, (A[:, 0], A[:, 1], A[:, 2], xbar, va)


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    name = request.param
    stored, data = _load(name)
    jspec = MODELS[name][3](*data)
    tspec = MODELS[name][4](*data, device="cpu")
    return name, stored, jspec, tspec


def test_spec_matches_jax(model):
    _, _, jspec, tspec = model
    assert tspec.names == jspec.names and tspec.prior.dim == jspec.prior.dim
    assert tspec.paramnames_split == jspec.paramnames_split
    assert (tspec.f_min, tspec.f_max) == (jspec.f_min, jspec.f_max)
    assert tspec.carma_pq is None and tspec.dtype == torch.float64


def test_stored_ml_point(model):
    """The stored maximum-likelihood point reproduces the stored logl to
    1e-6 (as in tests/test_parity_models.py); the stored posterior mean
    sits below it, by less than 30."""
    name, stored, _, tspec = model
    perm = MODELS[name][2]
    ml = stored["maximum_likelihood"]
    th = torch.tensor([[ml["point"][i] for i in perm],
                       [stored["posterior"]["mean"][i] for i in perm]], dtype=torch.float64)
    ll, llm = tspec.loglike_batch(th).tolist()
    assert abs(ll - ml["logl"]) < 1e-6, ll
    assert ml["logl"] - 30.0 < llm <= ml["logl"] + 1e-6
    assert abs(float(tspec.loglike(th[0])) - ll) <= 1e-12 * abs(ll)


def test_prior_draws_match_jax(model):
    """8 prior draws (unit-cube points from a numpy seed through both
    priors): the port's batched likelihood against the JAX package's
    batched likelihood (1e-9 relative) and against its per-row
    ``spec.loglike``. The two JAX forms differ by up to 1.6e-9 on the
    periodic model's second row, where the covariance is ill
    conditioned, so the per-row gate is 1e-9 or twice that spread,
    whichever is larger."""
    _, _, jspec, tspec = model
    U = np.random.default_rng(0).uniform(0.02, 0.98, (8, jspec.prior.dim))
    th_ref = jax.vmap(jspec.prior.transform)(jnp.asarray(U))
    th = tspec.prior.transform(torch.as_tensor(U))
    np.testing.assert_allclose(th.numpy(), np.asarray(th_ref), rtol=1e-12)
    ref = np.asarray(jspec.loglike_batch(th_ref))
    row = np.asarray(jax.jit(jax.vmap(jspec.loglike))(th_ref))
    out = tspec.loglike_batch(th).numpy()
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    fin = np.isfinite(ref)
    assert fin.sum() >= 6
    assert np.max(np.abs(out[fin] / ref[fin] - 1.0)) <= 1e-9
    spread = np.abs(row[fin] / ref[fin] - 1.0)
    assert np.all(np.abs(out[fin] / row[fin] - 1.0) <= np.maximum(1e-9, 2.0 * spread))
