"""PyTorch port parity: the gradients of the model builders' batched
log-posteriors (the port's adjoint: K3 and K4's plain versions on the
CPU) against ``jax.grad`` of the JAX specs' ``logpost_unconstrained``
(CPU, float64), at 4 rows, 1e-8 relative per row.

The JAX gradient is taken row by row, jitted. With jax 0.9.0 on the CPU,
``jax.jit(jax.vmap(jax.grad(...)))`` over 4 rows at N = 485 lands up to
8e-5 (double, periodic) and 6e-2 (CARMA) away from central differences,
and for CARMA at J = 2 and N = 485 even the per-row jitted gradient is
5e3-7e4 off, where the port's agrees with the differences to their own
error (``tools/jax_grad_check.py``; ROADMAP §3). Those CARMA cases run
against ``jax.grad`` on the first 64 points and against central
differences of the JAX log-posterior on the full light curve.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu import inference as jinf
from pioran_tpu_torch import inference as tinf
from pioran_tpu_torch.samplers.chees import batch_value_and_grad

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
LIGHT_CURVES = {
    "double": ("simu_double", "simu_double_subset_time_series.txt"),
    "periodic": ("simu_periodic", "simu_periodic_rednoise_subset_time_series.txt"),
    "carma": ("simu_single", "simu_single_subset_time_series.txt"),
}
BUILDERS = {
    "double": (jinf.double_bending_model, tinf.double_bending_model),
    "periodic": (jinf.periodic_rednoise_model, tinf.periodic_rednoise_model),
    "carma": (jinf.carma_model, tinf.carma_model),
}


def _specs(name, n=None, **kw):
    path = os.path.join(DATA, *LIGHT_CURVES[name])
    with open(path) as fh:
        for line in fh:
            if line.startswith("#mean: "):
                left, right = line[len("#mean: "):].split(" va: ")
                xbar, va = float(left), float(right)
                break
    A = np.loadtxt(path)[:n]
    data = (A[:, 0], A[:, 1], A[:, 2], xbar, va)
    jb, tb = BUILDERS[name]
    return jb(*data, **kw), tb(*data, device="cpu", **kw)


def _rows(jspec, seed):
    """4 unconstrained rows from unit-cube points in [0.1, 0.9] of a numpy
    seed, through the JAX prior."""
    U = np.random.default_rng(seed).uniform(0.1, 0.9, (4, jspec.prior.dim))
    return np.asarray(jax.vmap(jspec.prior.to_unconstrained)(
        jax.vmap(jspec.prior.transform)(jnp.asarray(U))))


def _check_against_jax(jspec, tspec, Z):
    vg = jax.jit(jax.value_and_grad(jspec.logpost_unconstrained))
    ref = [vg(jnp.asarray(z)) for z in Z]
    lp_ref = np.array([float(v) for v, _ in ref])
    g_ref = np.stack([np.asarray(g) for _, g in ref])
    lp, g = batch_value_and_grad(tspec.logpost_batch, torch.tensor(Z))
    assert np.all(np.isfinite(lp_ref))
    np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=1e-10)
    g = g.numpy()
    rel = np.linalg.norm(g - g_ref, axis=1) / np.linalg.norm(g_ref, axis=1)
    assert np.max(rel) <= 1e-8
    return g


@pytest.mark.parametrize("name", ["double", "periodic"])
def test_logpost_gradient_matches_jax(name):
    """The full light curves (485 points, J = 20). For the periodic model
    the A, phi and T0 entries reach the likelihood only through
    y - mean(t), the kernels' y cotangent."""
    jspec, tspec = _specs(name)
    Z = _rows(jspec, 3)
    g = _check_against_jax(jspec, tspec, Z)
    if name == "periodic":
        assert np.all(np.abs(g[:, 6:]) > 0)


@pytest.mark.parametrize("p,q,use_c,n", [(2, 1, False, None), (2, 0, True, None),
                                         (3, 2, True, 64), (4, 1, False, 64)])
def test_carma_logpost_gradient_matches_jax(p, q, use_c, n):
    """CARMA at J = 1 on the full light curve, J = 2 on its first 64
    points."""
    jspec, tspec = _specs("carma", n, p=p, q=q, use_c=use_c)
    Z = _rows(jspec, 7)
    _check_against_jax(jspec, tspec, Z)


@pytest.mark.parametrize("p,q,use_c", [(3, 2, True), (4, 1, False)])
def test_carma_logpost_gradient_matches_finite_differences(p, q, use_c):
    """CARMA at J = 2 on the full light curve: the port's gradient against
    central differences (step 1e-6 in unconstrained space) of the JAX
    package's jitted log-posterior, 1e-6 relative per row (the
    differences' own error is ~1e-9)."""
    jspec, tspec = _specs("carma", p=p, q=q, use_c=use_c)
    Z = _rows(jspec, 7)
    f = jax.jit(jax.vmap(jspec.logpost_unconstrained))
    h = 1e-6
    E = h * np.eye(Z.shape[1])
    fd = np.stack([(np.asarray(f(jnp.asarray(z + E))) - np.asarray(f(jnp.asarray(z - E))))
                   / (2 * h) for z in Z])
    _, g = batch_value_and_grad(tspec.logpost_batch, torch.tensor(Z))
    rel = np.linalg.norm(g.numpy() - fd, axis=1) / np.linalg.norm(fd, axis=1)
    assert np.max(rel) <= 1e-6
