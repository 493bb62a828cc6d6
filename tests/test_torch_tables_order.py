"""The step order of the table-streaming kernel K0, checked on the CPU.

``csrc/celerite_tables.cu`` evaluates the recursion over the U, V and
phi tables in K1's reassociated order (``tests/test_torch_fwd_order.py``),
with phi applied row by row: the kernel never assumes that phi's two
halves are equal. With u_n = phi_n o U_n and e_n = phi_n o W_{n-1}:

    S_n  = (phi_n phi_n^T) o S_{n-1} + D_{n-1} e_n e_n^T
    P_n  = S_{n-1} u_n        Q_n = u_n . P_n        h_n = u_n . f_{n-1}
    g_n  = u_n . W_{n-1}
    D_n  = sum(a) + sigma2_n - Q_n - D_{n-1} g_n^2
    zp_n = y_n - h_n - zp_{n-1} g_n
    W_n  = (V_n - phi_n o (P_n + D_{n-1} g_n W_{n-1})) / D_n

with one reciprocal of D_n shared by W_n and zp_n^2 / D_n. This file
transcribes that order step for step in PyTorch and holds it against
K0's plain version (``loglike_from_tables_plain``, the TPU kernel's
statements) and, on tables from ``build_tables``, against the JAX
package's ``batched_loglike_pallas`` in interpret mode: float64 within
1e-9 relative, float32 within 0.05 nats, and the same -inf lanes. On
tables whose phi halves differ (and whose first row is not zero) the
plain loop is the only referee, since the JAX entry point builds its own
tables.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu.ops.pallas_celerite import batched_loglike_pallas
from pioran_tpu_torch import SingleBendingPowerLaw, approx, single_bending_model
from pioran_tpu_torch.ops.cuda_celerite import build_tables, loglike_from_tables_plain

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
SUBSET = os.path.join("simu_single", "simu_single_subset_time_series.txt")
DTYPES = [torch.float64, torch.float32]


def reassociated(U, V, phi, y, sigma2, suma):
    """(B,) log-likelihoods in K0's step order; U, V, phi (N, 2J, B)
    tables with rows [J cos-type; J sin-type], y and sigma2 (B, N), suma
    (B,)."""
    N, R, B = U.shape
    J = R // 2
    S00, S01, S11 = (U.new_zeros(B, J, J) for _ in range(3))
    W0, W1, f0, f1 = (U.new_zeros(B, J) for _ in range(4))
    Dp, zpp = U.new_zeros(B), U.new_zeros(B)
    logdet, clog, quad, cquad = (U.new_zeros(B) for _ in range(4))
    minD = torch.full((B,), math.inf, dtype=U.dtype)

    def kahan(total, comp, x):
        xc = x - comp
        tt = total + xc
        return tt, (tt - total) - xc

    for n in range(N):
        U0, U1 = U[n, :J].T, U[n, J:].T
        V0, V1 = V[n, :J].T, V[n, J:].T
        p0, p1 = phi[n, :J].T, phi[n, J:].T
        u0, u1 = p0 * U0, p1 * U1
        # the look-ahead work: S_{n-1} u_n, its quadratic form, u_n . f_{n-1}
        P0 = (S00 @ u0[:, :, None] + S01 @ u1[:, :, None])[..., 0]
        P1 = (S01.transpose(1, 2) @ u0[:, :, None] + S11 @ u1[:, :, None])[..., 0]
        Q = torch.sum(u0 * P0 + u1 * P1, 1)
        h = torch.sum(u0 * f0 + u1 * f1, 1)
        # the serial chain: one reduction, scalars, one reciprocal
        g = torch.sum(u0 * W0 + u1 * W1, 1)
        Dg = Dp * g
        Dn = (suma + sigma2[:, n] - Q) - Dg * g
        zpn = (y[:, n] - h) - zpp * g
        r = 1.0 / Dn
        W0n = (V0 - p0 * (P0 + Dg[:, None] * W0)) * r[:, None]
        W1n = (V1 - p1 * (P1 + Dg[:, None] * W1)) * r[:, None]
        # S_n = (phi phi^T) o S_{n-1} + a e^T, e = phi o W_{n-1}, a = D_{n-1} e
        e0, e1 = p0 * W0, p1 * W1
        a0, a1 = e0 * Dp[:, None], e1 * Dp[:, None]
        S00 = a0[:, :, None] * e0[:, None, :] + (p0[:, :, None] * p0[:, None, :]) * S00
        S01 = a0[:, :, None] * e1[:, None, :] + (p0[:, :, None] * p1[:, None, :]) * S01
        S11 = a1[:, :, None] * e1[:, None, :] + (p1[:, :, None] * p1[:, None, :]) * S11
        f0 = p0 * (f0 + W0 * zpp[:, None])
        f1 = p1 * (f1 + W1 * zpp[:, None])
        W0, W1, Dp, zpp = W0n, W1n, Dn, zpn
        logdet, clog = kahan(logdet, clog, torch.log(torch.abs(Dn)))
        quad, cquad = kahan(quad, cquad, zpn * zpn * r)
        minD = torch.minimum(minD, Dn)
    ll = -0.5 * (logdet + quad + N * math.log(2.0 * math.pi))
    ok = (minD > 0) & torch.isfinite(ll)
    return torch.where(ok, ll, torch.full_like(ll, -math.inf))


def _flagship(B, seed):
    """(a, b, c, d, t, y, sigma2) float64 of the flagship model (J = 20) on
    the reference's 485-point subset at B parameter rows about the
    reference posterior (0.3 sd), from the port's own basis
    approximation; lane 0 is forced non-PD."""
    import json

    with open(os.path.join(DATA, "simu_single", "is_referee.json")) as fh:
        ref = json.load(fh)
    rng = np.random.default_rng(seed)
    th = np.asarray(ref["is_mean"]) + 0.3 * np.asarray(ref["is_std"]) * rng.normal(size=(B, 6))
    th[:, 0] = th[:, 0].clip(0.01, 1.49)
    th[:, 1] = np.maximum(th[:, 1], th[:, 0] + 0.01).clip(max=3.99)
    th[:, 3] = th[:, 3].clip(min=1e-4)
    th[:, 4] = th[:, 4].clip(min=0.2)
    A = np.loadtxt(os.path.join(DATA, SUBSET))
    spec = single_bending_model(A[:, 0], A[:, 1], A[:, 2], 0.0, 1.0, device="cpu")
    th = torch.as_tensor(th, dtype=torch.float64)
    lo, hi = spec.f_min / 20.0 * 4.0, spec.f_max * 20.0 / 4.0
    th[:, 2] = th[:, 2].clamp(lo * 1.01, hi * 0.99)
    kern = approx(SingleBendingPowerLaw(th[:, 0], th[:, 2], th[:, 1]),
                  spec.f_min, spec.f_max, 20, th[:, 3])
    a, b, c, d = (x.clone() for x in kern.coefficients())
    a[0] = -50.0 * a[0]
    y = torch.log(torch.as_tensor(A[:, 1]))[None, :] - th[:, 5:6]
    s2 = th[:, 4:5] * torch.as_tensor(A[:, 2] ** 2 / A[:, 1] ** 2)[None, :]
    return [x.numpy() for x in (a, b, c, d, torch.as_tensor(A[:, 0]), y, s2)]


def _synthetic(B, J, N, seed):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 100, N))
    a = rng.uniform(0.1, 0.6, (B, J))
    b = rng.uniform(0.0, 0.2, (B, J))
    c = rng.uniform(0.05, 0.35, (B, J))
    d = rng.uniform(0.0, 0.4, (B, J))
    y = rng.normal(size=(B, N))
    s2 = rng.uniform(0.05, 0.15, (B, N))
    a[0] = -50.0 * a[0]  # lane 0 is not positive definite
    return [a, b, c, d, t, y, s2]


def _close(ours, ref, dtype, rel64=1e-9, nats32=0.05):
    """The same -inf lanes (lane 0 and no other), and the finite values
    within the gate."""
    assert ours[0] == -np.inf
    np.testing.assert_array_equal(np.isneginf(ours), np.isneginf(ref))
    fin = np.isfinite(ref)
    assert fin.sum() == len(ref) - 1 and np.isfinite(ours[fin]).all()
    err = np.abs(ours[fin] - ref[fin])
    if dtype == torch.float64:
        assert float((err / np.abs(ref[fin])).max()) <= rel64
    else:
        assert float(err.max()) <= nats32


def _check_built(inputs, dtype):
    """K0's order on tables from build_tables, against the plain loop on
    the same tables and the Pallas kernel (interpret mode) on the same
    coefficients."""
    a, b, c, d, t, y, s2 = (torch.as_tensor(x, dtype=dtype) for x in inputs)
    U, V, phi = build_tables(a, b, c, d, t)
    ours = reassociated(U, V, phi, y, s2, a.sum(1)).numpy()
    plain = loglike_from_tables_plain(U, V, phi, y, s2, a.sum(1)).numpy()
    jtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    pallas = np.asarray(batched_loglike_pallas(
        *[jnp.asarray(x, dtype=jtype) for x in inputs], chunk=16, block_b=8, interpret=True))
    for ref in (plain, pallas):
        _close(ours, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_order_matches_plain_and_pallas_flagship(dtype):
    """6 flagship rows at N = 485, J = 20."""
    _check_built(_flagship(6, seed=0), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("J", [1, 3, 5, 21, 32])
def test_order_matches_plain_and_pallas_widths(J, dtype):
    _check_built(_synthetic(6, J, 40, seed=J), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("J", [3, 20])
def test_order_with_unequal_phi_halves(J, dtype):
    """phi drawn row by row: its two halves differ and its first row is
    not zero. The plain loop is the referee."""
    inputs = _synthetic(6, J, 70, seed=J + 100)
    a, b, c, d, t, y, s2 = (torch.as_tensor(x, dtype=dtype) for x in inputs)
    U, V, _ = build_tables(a, b, c, d, t)
    rng = np.random.default_rng(J + 200)
    phi = torch.as_tensor(rng.uniform(0.2, 1.0, U.shape), dtype=dtype)
    assert not torch.equal(phi[:, :J], phi[:, J:])
    ours = reassociated(U, V, phi, y, s2, a.sum(1)).numpy()
    plain = loglike_from_tables_plain(U, V, phi, y, s2, a.sum(1)).numpy()
    _close(ours, plain, dtype)
