"""PyTorch port parity: PSD models and the PSD -> celerite approximation.

The same inputs, made with numpy from a seed, go through the JAX package
(CPU, float64) and pioran_tpu_torch (CPU, float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pioran_tpu as jp
from pioran_tpu.ops import approx as japprox
import pioran_tpu_torch as tp
from pioran_tpu_torch.ops import approx as tapprox

torch.set_num_threads(1)

# reference test/test_psd.jl:38 (the same vector as tests/test_psd.py)
GOLDEN_AMPLITUDES = np.array([
    1.3749158408973243, 0.26031747510091013, 0.06961116778917277,
    0.013679642568525807, 0.0037949128465199307, 0.0008858780578830132,
    0.00023278915565955668, 5.714159750636342e-5, 1.463191298808472e-5,
    3.6532013241322788e-6, 9.262211884550235e-7, 2.3267166983266322e-7,
    5.877072005450016e-8, 1.4801031386988674e-8, 3.728877337268077e-9,
    9.44575715327315e-10, 2.3313738171903584e-10, 6.377629826311069e-11,
    1.119218106083312e-11, 6.962520986945091e-12,
])

PSDS = {
    "powerlaw": ("PowerLaw", (1.7,)),
    "single": ("SingleBendingPowerLaw", (0.3, 0.02, 2.93)),
    "double": ("DoubleBendingPowerLaw", (0.3, 0.02, 1.4, 10.2, 2.93)),
    "qpo": ("QPO", (2.0, 0.3, 12.0)),
    "lorentzian": ("Lorentzian", (1.5, 0.4, 0.05)),
}


@pytest.mark.parametrize("kind", sorted(PSDS))
def test_psd_values(kind):
    name, args = PSDS[kind]
    f = 10 ** np.linspace(-3, 2, 500)
    ref = np.asarray(getattr(jp, name)(*args)(jnp.asarray(f)))
    out = getattr(tp, name)(*args)(torch.as_tensor(f)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-13)


def test_psd_sum_and_batched_parameters():
    """A SumPSD, and (B,)-shaped parameters on a shared grid -> (B, F)."""
    rng = np.random.default_rng(3)
    f = 10 ** np.linspace(-2, 1, 50)
    a1, f1, a2 = rng.uniform(0.1, 1.0, 4), rng.uniform(0.01, 1, 4), rng.uniform(2, 4, 4)
    model = tp.SingleBendingPowerLaw(torch.as_tensor(a1), torch.as_tensor(f1),
                                     torch.as_tensor(a2)) + tp.QPO(1.0, 0.5, 8.0)
    out = model(torch.as_tensor(f)).numpy()
    assert out.shape == (4, 50)
    for i in range(4):
        ref = jp.SingleBendingPowerLaw(a1[i], f1[i], a2[i]) + jp.QPO(1.0, 0.5, 8.0)
        np.testing.assert_allclose(out[i], np.asarray(ref(jnp.asarray(f))), rtol=1e-13)
    cont, feats = tp.separate_psd(model)
    assert isinstance(cont, tp.SingleBendingPowerLaw) and len(feats) == 1


def test_golden_coefficients():
    """The exact amplitude vector pinned by the reference's test-suite."""
    ps = tp.SingleBendingPowerLaw(0.3, 0.02, 2.93)
    a = tp.get_approx_coefficients(ps, 0.02, 1.52e2, n_components=20)
    np.testing.assert_allclose(a.numpy(), GOLDEN_AMPLITUDES, rtol=1e-8)


@pytest.mark.parametrize("basis", ["SHO", "DRWCelerite"])
@pytest.mark.parametrize("integrated", [True, False])
@pytest.mark.parametrize("with_qpo", [False, True])
def test_approx_matches_jax_batched(basis, integrated, with_qpo):
    """B = 16 chains through one batched approx == JAX's vmapped approx."""
    B, J = 16, 20
    f_min, f_max = 1.0 / 1000.0, 0.5
    rng = np.random.default_rng(11)
    a1 = rng.uniform(0.0, 1.5, B)
    a2 = rng.uniform(2.0, 4.0, B)
    f1 = np.exp(rng.uniform(np.log(1e-3), np.log(0.5), B))
    var = rng.lognormal(-3.0, 1.0, B)
    qpo = (0.3, 0.05, 10.0)

    def jfn(a1, f1, a2, var):
        m = jp.SingleBendingPowerLaw(a1, f1, a2)
        if with_qpo:
            m = m + jp.QPO(*qpo)
        return jp.approx(m, f_min, f_max, J, var, basis_function=basis,
                         is_integrated_power=integrated).coefficients()

    ref = jax.vmap(jfn)(*(jnp.asarray(x) for x in (a1, f1, a2, var)))
    T = torch.as_tensor
    m = tp.SingleBendingPowerLaw(T(a1), T(f1), T(a2))
    if with_qpo:
        m = m + tp.QPO(*qpo)
    out = tp.approx(m, f_min, f_max, J, T(var), basis_function=basis,
                    is_integrated_power=integrated).coefficients()
    # normwise per chain: the J x J basis solve is accurate to ~1e-15 of
    # the largest amplitude, but the smallest amplitudes are ~1e-12 of it
    # and LAPACK's and XLA's triangular solves round them differently
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        o, r = o.numpy(), np.asarray(r)
        err = np.max(np.abs(o - r), axis=-1) / np.max(np.abs(r), axis=-1)
        assert float(np.max(err)) <= 1e-12


def test_band_integrals_match_jax():
    rng = np.random.default_rng(5)
    a, c = rng.uniform(0.1, 1, 20), np.exp(rng.uniform(-5, 2, 20))
    b, d = rng.uniform(0.0, 0.5, 3), rng.uniform(0.1, 2, 3)
    for basis in ("SHO", "DRWCelerite"):
        ref = japprox.integrate_basis_function(jnp.asarray(a), jnp.asarray(c),
                                               0.01, 3.0, basis)
        out = tapprox.integrate_basis_function(torch.as_tensor(a), torch.as_tensor(c),
                                               torch.tensor(0.01, dtype=torch.float64),
                                               torch.tensor(3.0, dtype=torch.float64),
                                               basis)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12)
    ref = japprox.integrate_psd_feature(*(jnp.asarray(x) for x in (a[:3], b, c[:3], d)),
                                        0.01, 3.0)
    out = tapprox.integrate_psd_feature(*(torch.as_tensor(x) for x in (a[:3], b, c[:3], d)),
                                        0.01, 3.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12)


def test_celerite_kernel_algebra():
    """Terms, sums, scaling, k(tau) and the PSD of CeleriteKernel."""
    tau = np.linspace(0.0, 5.0, 40)
    f = 10 ** np.linspace(-2, 1, 30)
    jk = jp.sho_term(1.3, 2.0) + jp.exp_term(0.7, 0.4) + jp.celerite_term(0.5, 0.1, 0.3, 1.1)
    tk = tp.sho_term(1.3, 2.0) + tp.exp_term(0.7, 0.4) + tp.celerite_term(0.5, 0.1, 0.3, 1.1)
    tk = 2.0 * tk
    jk = 2.0 * jk
    for o, r in zip(tk.coefficients(), jk.coefficients()):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-15)
    np.testing.assert_allclose(tk(torch.as_tensor(tau)).numpy(),
                               np.asarray(jk(jnp.asarray(tau))), rtol=1e-13)
    np.testing.assert_allclose(tk.psd(torch.as_tensor(f)).numpy(),
                               np.asarray(jk.psd(jnp.asarray(f))), rtol=1e-13)
    np.testing.assert_allclose(
        tp.celerite_covariance(torch.as_tensor(tau), 0.5, 0.1, 0.3, 1.1).numpy(),
        np.asarray(jp.celerite_covariance(jnp.asarray(tau), 0.5, 0.1, 0.3, 1.1)), rtol=1e-13)
    for Q in (0.5, 0.8, 0.3):
        np.testing.assert_allclose(tp.SHO(1.1, 0.7, Q)(torch.as_tensor(tau)).numpy(),
                                   np.asarray(jp.SHO(1.1, 0.7, Q)(jnp.asarray(tau))),
                                   rtol=1e-13)
    np.testing.assert_allclose(
        tp.Exp(torch.tensor(1.1, dtype=torch.float64), 0.7).psd(torch.as_tensor(f)).numpy(),
        np.asarray(jp.Exp(1.1, 0.7).psd(jnp.asarray(f))), rtol=1e-13)
