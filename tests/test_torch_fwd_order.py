"""The step order of the forward kernels K1/K2, checked on the CPU.

``csrc/celerite_fwd.cu`` evaluates the celerite recursion in a
reassociated order, so that the O(J^2) work of a step runs one step
ahead, off the step's serial chain. With u_n = ec_n o U_n and
e_n = ec_n o W_{n-1}:

    S_n  = (ec_n ec_n^T) o S_{n-1} + D_{n-1} e_n e_n^T
    P_n  = S_{n-1} u_n        Q_n = u_n . P_n        h_n = u_n . f_{n-1}
    g_n  = u_n . W_{n-1}
    D_n  = sum(a) + sigma2_n - Q_n - D_{n-1} g_n^2
    zp_n = y_n - h_n - zp_{n-1} g_n
    W_n  = (V_n - ec_n o (P_n + D_{n-1} g_n W_{n-1})) / D_n

with one reciprocal of D_n shared by W_n and zp_n^2 / D_n. K1's carry
entry starts a block from a carried state (S, W, D, f, zp): its first
step's look-ahead terms P_0 = S_in u_0, g_0 = u_0 . W_in and
e_0 = ec_0 o W_in come from that state, and its first spacing is the one
to the previous block's last point. The plain
versions (``batched_loglike_plain``) keep the JAX package's order. This
file transcribes the kernels' order step for step in PyTorch and holds it
against the plain version and against the JAX package's fused Pallas
kernel in interpret mode: float64 within 1e-9 relative (5e-10 at an
ill-conditioned flagship point, the agreed limit there), float32 within
0.05 nats, and the same -inf lanes. The float32 exp is the plain
versions' ``exp_neg``, so only the order differs.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu.ops.pallas_celerite import batched_loglike_pallas_fused
from pioran_tpu_torch import SingleBendingPowerLaw, approx, single_bending_model
from pioran_tpu_torch.ops.celerite import exp_neg
from pioran_tpu_torch.ops import cuda_celerite as cc, cuda_celerite_vjp as vjp
from pioran_tpu_torch.ops.cuda_celerite import batched_loglike_plain

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
SUBSET = os.path.join("simu_single", "simu_single_subset_time_series.txt")
# a prior draw of the flagship on simu.txt (tests/test_torch_inference.py's
# rows) where the 490 x 490 covariance's condition number is 3.6e10
ILL_THETA = [0.97337, 3.68869, 0.00100, 0.18325, 0.66895, 1.45653]


def reassociated(a, b, c, d, t, y, sigma2, dt=None, carry=None):
    """(B,) log-likelihoods in the kernels' step order; a, b, c, d (B, J),
    t (N,), y and sigma2 (B, N), dt an optional (N-1,) host spacing. With
    a forward ``carry`` (the carry entry): dt (N,) holds every step's
    spacing, the boundary's first, the loop starts from the carried
    state, and the result is (partials (B, 3), carry out)."""
    B, J = a.shape
    N = t.shape[0]
    suma = torch.sum(a, dim=1)
    if carry is None:
        spacing = torch.diff(t) if dt is None else torch.as_tensor(dt).to(a.dtype)
        spacing = torch.cat([spacing.new_zeros(1), spacing])
        S00, S01, S11 = (a.new_zeros(B, J, J) for _ in range(3))
        W0, W1, f0, f1 = (a.new_zeros(B, J) for _ in range(4))
        Dp, zpp = a.new_zeros(B), a.new_zeros(B)
    else:
        spacing = torch.as_tensor(dt).to(a.dtype)
        S00, S01, S11, W0, W1, f0, f1, Dp, zpp = vjp.carry_state(carry, J)
    logdet, clog, quad, cquad = (a.new_zeros(B) for _ in range(4))
    minD = torch.full((B,), math.inf, dtype=a.dtype)

    def kahan(total, comp, x):
        xc = x - comp
        tt = total + xc
        return tt, (tt - total) - xc

    for n in range(N):
        co, si = torch.cos(d * t[n]), torch.sin(d * t[n])
        ec = exp_neg(c * spacing[n])
        u0 = ec * (a * co + b * si)
        u1 = ec * (a * si - b * co)
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
        W0n = (co - ec * (P0 + Dg[:, None] * W0)) * r[:, None]
        W1n = (si - ec * (P1 + Dg[:, None] * W1)) * r[:, None]
        # S_n = ee o S_{n-1} + a e^T, e = ec o W_{n-1}, a = D_{n-1} e; and f_n
        ee = ec[:, :, None] * ec[:, None, :]
        e0, e1 = ec * W0, ec * W1
        a0, a1 = e0 * Dp[:, None], e1 * Dp[:, None]
        S00 = a0[:, :, None] * e0[:, None, :] + ee * S00
        S01 = a0[:, :, None] * e1[:, None, :] + ee * S01
        S11 = a1[:, :, None] * e1[:, None, :] + ee * S11
        f0 = ec * (f0 + W0 * zpp[:, None])
        f1 = ec * (f1 + W1 * zpp[:, None])
        W0, W1, Dp, zpp = W0n, W1n, Dn, zpn
        logdet, clog = kahan(logdet, clog, torch.log(torch.abs(Dn)))
        quad, cquad = kahan(quad, cquad, zpn * zpn * r)
        minD = torch.minimum(minD, Dn)
    if carry is not None:
        return (torch.stack([logdet, quad, minD], dim=1),
                vjp.pack_carry(S00, S01, S11, W0, W1, f0, f1, Dp, zpp))
    ll = -0.5 * (logdet + quad + N * math.log(2.0 * math.pi))
    ok = (minD > 0) & torch.isfinite(ll)
    return torch.where(ok, ll, torch.full_like(ll, -math.inf))


def _referee_rows(B, rng):
    """Flagship parameter rows about the reference posterior (0.3 sd), in
    the prior's support, as chip_smoke.py scatters them."""
    import json

    with open(os.path.join(DATA, "simu_single", "is_referee.json")) as fh:
        ref = json.load(fh)
    th = np.asarray(ref["is_mean"]) + 0.3 * np.asarray(ref["is_std"]) * rng.normal(size=(B, 6))
    th[:, 0] = th[:, 0].clip(0.01, 1.49)
    th[:, 1] = np.maximum(th[:, 1], th[:, 0] + 0.01).clip(max=3.99)
    th[:, 3] = th[:, 3].clip(min=1e-4)
    th[:, 4] = th[:, 4].clip(min=0.2)
    return th


def _flagship(th, light_curve=SUBSET):
    """(a, b, c, d, t, y, sigma2) float64 of the flagship model (J = 20) on
    a light curve (the reference's 485-point subset by default) at
    parameter rows ``th``, from the port's own basis approximation; lane 0
    is forced non-PD."""
    A = np.loadtxt(os.path.join(DATA, light_curve))
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
    t = torch.as_tensor(A[:, 0])
    return [x.numpy() for x in (a, b, c, d, t, y, s2)]


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


def _check(inputs, dt, rel64=1e-9, nats32=0.05, dtypes=(torch.float64, torch.float32)):
    """The kernels' order against the plain version and the Pallas kernel
    (interpret mode), in float64 and float32."""
    for dtype in dtypes:
        jtype = jnp.float64 if dtype == torch.float64 else jnp.float32
        args = [torch.as_tensor(x, dtype=dtype) for x in inputs]
        tdt = None if dt is None else torch.as_tensor(dt)
        ours = reassociated(*args, tdt).numpy()
        plain = batched_loglike_plain(*args, tdt).numpy()
        pallas = np.asarray(batched_loglike_pallas_fused(
            *[jnp.asarray(x, dtype=jtype) for x in inputs],
            dt=None if dt is None else jnp.asarray(dt, dtype=jtype),
            chunk=64, interpret=True))
        assert ours[0] == -np.inf
        for ref in (plain, pallas):
            np.testing.assert_array_equal(np.isneginf(ours), np.isneginf(ref))
            fin = np.isfinite(ref)
            assert fin.sum() == len(ref) - 1 and np.isfinite(ours[fin]).all()
            err = np.abs(ours[fin] - ref[fin])
            if dtype == torch.float64:
                assert float((err / np.abs(ref[fin])).max()) <= rel64
            else:
                assert float(err.max()) <= nats32


@pytest.mark.parametrize("with_dt", [False, True])
def test_order_matches_plain_and_pallas_flagship(with_dt):
    """16 flagship rows at N = 485, J = 20."""
    inputs = _flagship(_referee_rows(16, np.random.default_rng(0)))
    _check(inputs, np.diff(inputs[4]) if with_dt else None)


@pytest.mark.parametrize("J", [1, 3, 5, 21, 32])
def test_order_matches_plain_and_pallas_widths(J):
    inputs = _synthetic(6, J, 70, seed=J)
    _check(inputs, np.diff(inputs[4]))


def test_order_at_the_ill_conditioned_point():
    """float64 at condition 3.6e10, within the agreed 5e-10. In float32
    the point is not positive definite for the plain loop and the Pallas
    kernel alike, and the kernels' order must say -inf there too."""
    inputs = _flagship(np.array([ILL_THETA, ILL_THETA]), "simu.txt")
    dt = np.diff(inputs[4])
    _check(inputs, dt, rel64=5e-10, dtypes=(torch.float64,))
    args = [torch.as_tensor(x, dtype=torch.float32) for x in inputs]
    ours = reassociated(*args, torch.as_tensor(dt)).numpy()
    plain = batched_loglike_plain(*args, torch.as_tensor(dt)).numpy()
    pallas = np.asarray(batched_loglike_pallas_fused(
        *[jnp.asarray(x, dtype=jnp.float32) for x in inputs],
        dt=jnp.asarray(dt, dtype=jnp.float32), chunk=64, interpret=True))
    assert np.isneginf(ours).all() and np.isneginf(plain).all() and np.isneginf(pallas).all()


@pytest.mark.parametrize("J", [3, 20, 32])
def test_order_with_a_carry_at_block_boundaries(J):
    """The kernels' order started from a carried state at 3 block
    boundaries (blocks of 24 steps, not a whole number of the kernels'
    32-step tables): the chained value equals one pass in that order up to
    the partial sums' order (1e-12 relative), and the chained values and
    every carry out agree with the plain carry version's (1e-9 relative,
    the order's rounding), float64; lane 0 is -inf in all three."""
    a, b, c, d, t, y, s2 = (torch.as_tensor(x) for x in _synthetic(5, J, 96, seed=50 + J))
    dt = torch.diff(t)
    dtg = torch.cat([dt.new_zeros(1), dt])
    one = reassociated(a, b, c, d, t, y, s2, dt)
    K = 24
    ours = plain = vjp.neutral_carry(5, J, a)
    parts_o, parts_p = [], []
    for k in range(4):
        sl = slice(k * K, (k + 1) * K)
        xs = (a, b, c, d, t[sl], y[:, sl], s2[:, sl], dtg[sl])
        po, ours = reassociated(*xs, carry=ours)
        pp, plain = cc.loglike_carry(*xs, plain)
        parts_o.append(po)
        parts_p.append(pp)
        assert float(((ours - plain).norm(dim=1) / plain.norm(dim=1))[1:].max()) <= 1e-9

    def ll(parts):
        P = sum(parts)
        minD = torch.stack([p[:, 2] for p in parts]).min(0).values
        v = -0.5 * (P[:, 0] + P[:, 1] + 96 * math.log(2.0 * math.pi))
        return torch.where(minD > 0, v, torch.full_like(v, -math.inf))

    lo, lp = ll(parts_o), ll(parts_p)
    assert bool(torch.isneginf(lo[0]) & torch.isneginf(lp[0]) & torch.isneginf(one[0]))
    assert float(((lo - one).abs() / one.abs())[1:].max()) <= 1e-12
    assert float(((lo - lp).abs() / lp.abs())[1:].max()) <= 1e-9
