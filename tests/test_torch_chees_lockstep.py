"""ChEES-HMC and ADVI held in lock-step with the JAX package, one
iteration at a time, on the CPU in float64.

Both transitions get the same random numbers: before each iteration the
draws are derived from the JAX carry's key as the JAX transition derives
them (``key, k_mom, k_acc = split(key, 3)``; the momenta's normals from
k_mom, the accept uniforms from k_acc) and handed to the port through a
test-only patch of ``torch.randn`` / ``torch.rand``. With the draws equal,
each iteration of the port restarted from JAX's state must give the same
leapfrog count, the same step size, trajectory length, its average,
dual-averaging state and metric factor to 1e-9 relative (1e-7 on the
stiff flagship target), the same positions to 1e-6; a free-running port
must take the same leapfrog count at every iteration while its positions
stay within 1e-6 of JAX's. ADVI likewise: the per-step ELBO normals of
``run_advi``, and the prior draws and chain normals of
``advi_seeded_inits``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu import inference as jinf
from pioran_tpu.samplers import advi as jadvi
from pioran_tpu.samplers import chees as jchees
from pioran_tpu_torch import inference as tinf
from pioran_tpu_torch.samplers import advi as tadvi
from pioran_tpu_torch.samplers import chees as tchees

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
RTOL = 1e-9


class _Draws:
    """Stands in for ``torch.randn`` and ``torch.rand``: hands out queued
    arrays, each checked against the shape asked for."""

    def __init__(self):
        self.queue = []

    def push(self, *arrays):
        self.queue.extend(np.asarray(a) for a in arrays)

    def __call__(self, *shape, generator=None, dtype=None, device=None, **_):
        shape = tuple(shape[0]) if len(shape) == 1 and not isinstance(shape[0], int) else shape
        assert self.queue, "the port drew more random numbers than were queued"
        x = self.queue.pop(0)
        assert x.shape == shape, (x.shape, shape)
        return torch.as_tensor(x.copy(), dtype=dtype)


@pytest.fixture
def draws(monkeypatch):
    d = _Draws()
    monkeypatch.setattr(torch, "randn", d)
    monkeypatch.setattr(torch, "rand", d)
    yield d
    assert not d.queue, "queued draws left over"


def _close(a, b, what, it, rtol=RTOL, atol=1e-300):
    a, b = np.asarray(a, np.float64), np.asarray(np.array(b), np.float64)
    assert np.allclose(a, b, rtol=rtol, atol=atol), (
        f"{what} at iteration {it}: {a} vs {b}")


def _port_state(carry):
    """The port's transition state holding the JAX carry's values."""
    z, logp, grad, eps, lt, adam, da, chol, cov, _, lt_avg = carry
    t = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    return {"z": t(z), "logp": t(logp), "grad": t(grad), "step_size": float(eps),
            "log_tau": float(lt), "adam": tchees._AdamState(float(adam.m), float(adam.v),
                                                            int(adam.t)),
            "da": tuple(float(x) for x in da), "chol": t(chol), "cov_ema": t(cov),
            "lt_avg": float(lt_avg)}


def _lockstep(draws, jlogp, tlogp, z0, num_warmup, num_samples, mass, max_leapfrogs,
              key=0, rtol=RTOL):
    """Drives both transitions side by side. Two port states run: one
    restarted from the JAX carry at every iteration, so that each
    iteration's transition is held against JAX's from the same state and
    draws (the scalars and the metric factor to ``rtol``, positions to
    1e-6), and one free-running, whose leapfrog counts must equal JAX's at
    every iteration while its positions stay within 1e-6 of JAX's. They do
    not stay there: rounding differences of 1e-16 grow along a
    trajectory, chaotically and in either package, past 1e-6 within 40-90
    iterations on these targets."""
    C, dim = z0.shape
    jtrans, jinit = jchees.make_chees_transition(
        jlogp, C, dim, jnp.float64, num_warmup, max_leapfrogs=max_leapfrogs, mass=mass)
    jstep = jax.jit(jtrans)
    carry = jax.jit(jinit)(jnp.asarray(z0), jax.random.PRNGKey(key), 0.1, 1.0)
    ttrans, tinit = tchees.make_chees_transition(
        tlogp, C, dim, torch.float64, "cpu", num_warmup, max_leapfrogs=max_leapfrogs,
        mass=mass)
    state_f = tinit(torch.as_tensor(z0), 0.1, 1.0)
    together = True
    total = num_warmup + num_samples
    nsteps = []
    for it in range(total):
        _, k_mom, k_acc = jax.random.split(carry[9], 3)
        xi = jax.random.normal(k_mom, (C, dim), jnp.float64)
        u = jax.random.uniform(k_acc, (C,), jnp.float64)
        warm = it < num_warmup
        start = carry
        carry, out = jstep(carry, (jnp.asarray(it, jnp.int32), jnp.asarray(warm)))
        n_ref = int(out[3])
        draws.push(xi, u)
        state, (_, _, _, n) = ttrans(_port_state(start), it, warm, None)
        assert n == n_ref, f"n_steps part at iteration {it}: {n} vs {n_ref}"
        # logs of lengths (tau, its average, the step size's dual-averaging
        # iterates) cross zero: held absolutely, which holds the lengths
        # themselves to rtol relative
        _close(state["step_size"], carry[3], "step size", it, rtol)
        _close(state["log_tau"], carry[4], "log tau", it, 0, rtol)
        _close(state["lt_avg"], carry[10], "lt_avg", it, 0, rtol)
        for k, (x, y) in enumerate(zip(state["da"], carry[6])):
            _close(x, y, f"dual averaging [{k}]", it, 0, rtol)
        _close(state["chol"], carry[7], "chol", it, rtol)
        _close(state["z"], carry[0], "z", it, rtol=0, atol=1e-6)
        if together:
            draws.push(xi, u)
            state_f, (_, _, _, n) = ttrans(state_f, it, warm, None)
            assert n == n_ref, f"free-running n_steps part at iteration {it}: {n} vs {n_ref}"
            together = bool(np.abs(state_f["z"].numpy() - np.asarray(carry[0])).max() <= 1e-6)
        nsteps.append(n)
    return np.asarray(nsteps)


def _ridge():
    """A correlated 6-d Gaussian with a 0.98 ridge between two coordinates."""
    sd = np.array([2.0, 0.5, 1.0, 0.3, 1.5, 0.8])
    corr = np.eye(6)
    corr[0, 1] = corr[1, 0] = 0.98
    corr[2, 4] = corr[4, 2] = -0.6
    cov = corr * np.outer(sd, sd)
    prec = np.linalg.inv(cov)
    jprec, tprec = jnp.asarray(prec), torch.as_tensor(prec)
    return (lambda z: -0.5 * z @ jprec @ z,
            lambda Z: -0.5 * torch.sum((Z @ tprec) * Z, dim=1))


@pytest.mark.parametrize("mass", ["dense", "diag"])
def test_chees_ridge_gaussian_lockstep(draws, mass):
    """64 chains, 100 warmup + 60 samples: the metric updates at
    iterations 24 and 49, the frozen tail and the end of warmup."""
    jlogp, tlogp = _ridge()
    z0 = np.random.default_rng(11).normal(size=(64, 6)) * 2.0
    n = _lockstep(draws, jlogp, tlogp, z0, 100, 60, mass, 128)
    assert n.max() > 1


def _flagship(n, J=8):
    A = np.loadtxt(os.path.join(DATA, "simu.txt"))[:n]
    xbar, va = float(np.mean(np.log(A[:, 1]))), float(np.var(np.log(A[:, 1])))
    data = (A[:, 0], A[:, 1], A[:, 2], xbar, va)
    # J = 8, as test_torch_chees.py's flagship gradient test
    return (jinf.single_bending_model(*data, n_components=J),
            tinf.single_bending_model(*data, n_components=J, device="cpu"))


def _flagship_start(jspec, C, seed):
    U = np.random.default_rng(seed).uniform(0.3, 0.7, (C, 6))
    return np.asarray(jax.vmap(jspec.prior.to_unconstrained)(
        jax.vmap(jspec.prior.transform)(jnp.asarray(U))))


class _JaxLogp(torch.autograd.Function):
    """A torch function whose values and gradients are JAX's ``vg`` (a
    jitted batched value-and-gradient) on the same rows."""

    @staticmethod
    def forward(ctx, Z, vg):
        lp, g = vg(jnp.asarray(Z.detach().numpy()))
        ctx.save_for_backward(torch.as_tensor(np.array(g)))
        return torch.as_tensor(np.array(lp))

    @staticmethod
    def backward(ctx, gout):
        (g,) = ctx.saved_tensors
        return gout[:, None] * g, None


def test_chees_flagship_lockstep(draws):
    """The flagship spec on its first 128 points, 16 chains, dense metric,
    50 warmup + 20 samples at most 16 leapfrogs, both transitions on JAX's
    log-posterior (the port's through a bridge), so that only the
    transitions' arithmetic differs. Each iteration is held to 1e-7, not
    1e-9: on this stiff target one 16-step trajectory amplifies rounding,
    and the port against itself with one-ulp noise on the gradient moves
    the step size by up to 1.4e-8 in one iteration (the JAX transition
    differs from the port's by up to 4.6e-9). Leapfrog counts and
    positions as in the ridge cases."""
    jspec, _ = _flagship(128)
    z0 = _flagship_start(jspec, 16, 2)
    vg = jax.jit(jax.vmap(jax.value_and_grad(jspec.logpost_unconstrained)))
    n = _lockstep(draws, jspec.logpost_unconstrained, lambda Z: _JaxLogp.apply(Z, vg), z0,
                  50, 20, "dense", 16, key=3, rtol=1e-7)
    assert n.max() > 1


def _jax_advi_normals(key, num_steps, num_mc, D, num_draws):
    """The normals JAX's run_advi draws, in the order the port draws them:
    one (num_mc, D) a step, the final draws, the final ELBO's 64."""
    _, k_fit, k_draw, k_final = jax.random.split(key, 4)
    steps = [jax.random.normal(k, (num_mc, D), jnp.float64)
             for k in jax.random.split(k_fit, num_steps)]
    return steps + [jax.random.normal(k_draw, (num_draws, D), jnp.float64),
                    jax.random.normal(k_final, (64, D), jnp.float64)]


def test_run_advi_lockstep(draws):
    """run_advi on the ridge Gaussian, 200 Adam steps of 8 draws from the
    same start: mu, log_sigma and the ELBO trace to 1e-9."""
    jlogp, tlogp = _ridge()
    z0 = np.full(6, 0.5)
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda z, k: jadvi.run_advi(jlogp, z, k, num_steps=200, num_draws=4))(
        jnp.asarray(z0), key)
    draws.push(*_jax_advi_normals(key, 200, 8, 6, 4))
    out = tadvi.run_advi(tlogp, torch.as_tensor(z0), None, num_steps=200, num_draws=4)
    _close(out.mu, ref.mu, "mu", 200)
    _close(out.log_sigma, ref.log_sigma, "log_sigma", 200)
    _close(out.elbo_trace, ref.elbo_trace, "ELBO trace", 200)


def test_advi_seeded_inits_flagship_lockstep(draws, monkeypatch):
    """advi_seeded_inits with 60 ADVI steps on the flagship prior (its
    spec at 32 points, J = 4) with a quadratic stand-in likelihood in both
    packages, as test_torch_chees.py's layout test does (the flagship
    likelihood's lock-step is test_chees_flagship_lockstep's; the JAX
    compile of ADVI through it would take most of a minute): the best of
    the same 256 prior draws, then the same fit and the same chain
    normals, to 1e-9."""
    jflag, tspec = _flagship(32, 4)
    mean = np.array([0.8, 2.8, 0.004, 0.02, 1.1, 0.25])
    jmean, tmean = jnp.asarray(mean), torch.as_tensor(mean)
    jspec = jinf.GPModelSpec(
        prior=jflag.prior, loglike=lambda th: -0.5 * jnp.sum((th - jmean) ** 2),
        names=jflag.names, gp_model=None, psd_model=None,
        paramnames_split=jflag.paramnames_split, t=jflag.t, y=jflag.y, yerr=jflag.yerr,
        f_min=jflag.f_min, f_max=jflag.f_max)
    monkeypatch.setattr(tspec, "loglike_batch",
                        lambda TH: -0.5 * torch.sum((TH - tmean) ** 2, dim=-1))
    key = jax.random.PRNGKey(9)
    C = 8
    ref = jinf.advi_seeded_inits(jspec, key, C, num_steps=60)
    k1, k2, k3 = jax.random.split(key, 3)
    prior_draws = np.asarray(jax.vmap(jspec.prior.sample)(jax.random.split(k1, 256)))
    monkeypatch.setattr(tspec.prior, "sample",
                        lambda shape, generator=None, dtype=None, device=None:
                        torch.as_tensor(prior_draws, dtype=dtype))
    draws.push(*_jax_advi_normals(k2, 60, 8, 6, 1),
               jax.random.normal(k3, (C, 6), jnp.float64))
    out = tinf.advi_seeded_inits(tspec, None, C, num_steps=60)
    _close(out, ref, "chain inits", 60, atol=1e-12)
