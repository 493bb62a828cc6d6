"""PyTorch port parity: the CARMA(p, q) model builder against the JAX
package's (CPU, float64).

``carma_model`` for (p, q) in {(2,0), (2,1), (3,2), (4,1)}, with and
without the flux offset c: the spec and the batched likelihood at 8
prior draws made with numpy. CARMA's J = ceil(p/2) is 1 or 2: the
kernels' smallest instantiation. The gradients are in
tests/test_torch_builders_grad.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu import inference as jinf
from pioran_tpu_torch import inference as tinf

torch.set_num_threads(1)

PATH = os.path.join(os.path.dirname(__file__), "data", "simu_single",
                    "simu_single_subset_time_series.txt")
CONFIGS = [(p, q, use_c) for p, q in [(2, 0), (2, 1), (3, 2), (4, 1)] for use_c in (False, True)]


def _data(n=None):
    with open(PATH) as fh:
        for line in fh:
            if line.startswith("#mean: "):
                left, right = line[len("#mean: "):].split(" va: ")
                xbar, va = float(left), float(right)
                break
    A = np.loadtxt(PATH)[:n]
    return A[:, 0], A[:, 1], A[:, 2], xbar, va


def _specs(p, q, use_c, n=None):
    data = _data(n)
    return (jinf.carma_model(*data, p=p, q=q, use_c=use_c),
            tinf.carma_model(*data, p=p, q=q, use_c=use_c, device="cpu"))


@pytest.mark.parametrize("p,q,use_c", CONFIGS)
def test_carma_prior_draws_match_jax(p, q, use_c):
    """The spec (names, prior, split, carma_pq) and the batched likelihood
    at 8 prior draws: 1e-9 relative to the JAX package's batched
    likelihood and to its per-row ``spec.loglike``; -inf on the same rows."""
    jspec, tspec = _specs(p, q, use_c)
    assert tspec.names == jspec.names and tspec.prior.dim == jspec.prior.dim
    assert tspec.paramnames_split == jspec.paramnames_split
    assert tspec.carma_pq == jspec.carma_pq == (p, q)
    U = np.random.default_rng(10 * p + q).uniform(0.02, 0.98, (8, jspec.prior.dim))
    th_ref = jax.vmap(jspec.prior.transform)(jnp.asarray(U))
    th = tspec.prior.transform(torch.as_tensor(U))
    np.testing.assert_allclose(th.numpy(), np.asarray(th_ref), rtol=1e-12)
    ref = np.asarray(jspec.loglike_batch(th_ref))
    row = np.asarray(jax.jit(jax.vmap(jspec.loglike))(th_ref))
    out = tspec.loglike_batch(th).numpy()
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    fin = np.isfinite(ref)
    assert fin.sum() >= 6
    for r in (ref, row):
        assert np.max(np.abs(out[fin] / r[fin] - 1.0)) <= 1e-9
