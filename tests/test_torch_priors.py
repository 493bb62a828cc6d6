"""PyTorch port parity: prior distributions and PriorSet.

Every distribution's quantile transform, log density and unconstrained
views go through the JAX package (vmapped over rows) and
pioran_tpu_torch (batched over rows) on the same numpy inputs, float64
on CPU, rtol 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu import priors as jpr
from pioran_tpu_torch import priors as tpr
from pioran_tpu_torch.convert import prior_set_from_numpy

torch.set_num_threads(1)

DISTS = {
    "uniform": ("Uniform", (-1.5, 2.5)),
    "loguniform": ("LogUniform", (1e-4, 3.0)),
    "normal": ("Normal", (0.3, 1.7)),
    "lognormal": ("LogNormal", (-3.0, 1.4142135623730951)),
    "gamma": ("Gamma", (2.0, 0.5)),
    "gamma_small_shape": ("Gamma", (0.7, 3.0)),
    "two_uniform": ("TwoUniformDependent", (0.0, 1.5, 4.0)),
    "three_uniform": ("ThreeUniformDependent", (0.1, 1.0, 3.0)),
    "two_loguniform": ("TwoLogUniformDependent", (1e-3, 10.0)),
}


def _pair(kind):
    name, args = DISTS[kind]
    return getattr(jpr, name)(*args), getattr(tpr, name)(*args)


def _unit(rows, dim, seed=0):
    """Unit-cube rows, including points close to both faces."""
    u = np.random.default_rng(seed).uniform(0.0, 1.0, (rows, dim))
    u[0], u[1] = 1e-7, 1.0 - 1e-7
    return u if dim > 1 else u[:, 0]


def _close(out, ref):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12, atol=0)


@pytest.mark.parametrize("kind", sorted(DISTS))
def test_distribution_matches_jax(kind):
    jd, td = _pair(kind)
    u = _unit(64, jd.dim, seed=len(kind))
    U = torch.as_tensor(u)
    x_ref = jax.vmap(jd.quantile)(jnp.asarray(u))
    x = td.quantile(U)
    _close(x, x_ref)
    # log density on the transformed points and on points outside the support
    _close(td.logpdf(x), jax.vmap(jd.logpdf)(x_ref))
    shift = np.asarray(x_ref) - 10.0
    _close(td.logpdf(torch.as_tensor(shift)), jax.vmap(jd.logpdf)(jnp.asarray(shift)))
    # the bijector view, on interior points
    inner = slice(2, None)
    z_ref = jax.vmap(jd.to_unconstrained)(x_ref[inner])
    z = td.to_unconstrained(x[inner])
    _close(z, z_ref)
    _close(td.from_unconstrained(z), jax.vmap(jd.from_unconstrained)(z_ref))
    _close(td.unconstrained_logpdf(z), jax.vmap(jd.unconstrained_logpdf)(z_ref))


def test_gamma_quantile_brackets_extreme_rows():
    """The batched bisection expands each row's bracket until every row
    holds its root: u next to 1 needs several doublings."""
    jd, td = _pair("gamma")
    u = np.array([1e-12, 0.5, 1.0 - 1e-12, 1.0 - 1e-15])
    _close(td.quantile(torch.as_tensor(u)), jax.vmap(jd.quantile)(jnp.asarray(u)))


def _items_from_jax(prior_set):
    return [(name, type(d).__name__,
             {f.name: np.asarray(getattr(d, f.name)) for f in dataclasses.fields(d)})
            for name, d in zip(prior_set.names, prior_set.dists)]


def _flagship_jax_prior():
    return jpr.PriorSet([
        ("alphas", jpr.TwoUniformDependent(0.0, 1.5, 4.0)),
        ("f_1", jpr.LogUniform(2e-4, 2.5)),
        ("variance", jpr.LogNormal(-3.0, np.sqrt(2.0))),
        ("nu", jpr.Gamma(2.0, 0.5)),
        ("mu", jpr.Normal(0.25, 2.1)),
        ("c", jpr.LogUniform(1e-6, 0.5)),
    ])


def test_prior_set_round_trip_and_parity():
    jset = _flagship_jax_prior()
    tset = prior_set_from_numpy(_items_from_jax(jset))
    assert tset.names == jset.names and tset.dim == jset.dim == 7
    assert [type(d).__name__ for d in tset.dists] == [type(d).__name__ for d in jset.dists]
    for jd, td in zip(jset.dists, tset.dists):
        for f in dataclasses.fields(jd):
            assert getattr(td, f.name) == float(np.asarray(getattr(jd, f.name)))
    u = _unit(128, 7, seed=3)
    th_ref = jax.vmap(jset.transform)(jnp.asarray(u))
    th = tset.transform(torch.as_tensor(u))
    assert tuple(th.shape) == (128, 7)
    _close(th, th_ref)
    _close(tset.logpdf(th), jax.vmap(jset.logpdf)(th_ref))
    z_ref = jax.vmap(jset.to_unconstrained)(th_ref[2:])
    z = tset.to_unconstrained(th[2:])
    _close(z, z_ref)
    _close(tset.from_unconstrained(z), jax.vmap(jset.from_unconstrained)(z_ref))
    _close(tset.unconstrained_logpdf(z), jax.vmap(jset.unconstrained_logpdf)(z_ref))
    # one unbatched row works too
    _close(tset.transform(torch.as_tensor(u[5])), jset.transform(jnp.asarray(u[5])))


def test_prior_set_from_numpy_rejects_unknown_class():
    with pytest.raises(ValueError, match="not a distribution"):
        prior_set_from_numpy([("x", "PriorSet", {})])


def test_sample_uses_the_generator():
    """sample() draws through the caller's torch.Generator: same seed,
    same draws; the draws lie in the prior's support."""
    tset = prior_set_from_numpy(_items_from_jax(_flagship_jax_prior()))
    draw = lambda s: tset.sample((500,), generator=torch.Generator().manual_seed(s))  # noqa: E731
    x = draw(0)
    assert torch.equal(x, draw(0)) and not torch.equal(x, draw(1))
    assert tuple(x.shape) == (500, 7)
    assert bool(torch.isfinite(tset.logpdf(x)).all())
    d = tpr.TwoUniformDependent(0.0, 1.5, 4.0)
    s = d.sample((100,), generator=torch.Generator().manual_seed(2))
    assert tuple(s.shape) == (100, 2) and bool((s[:, 1] >= s[:, 0]).all())
