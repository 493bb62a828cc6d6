"""PyTorch port parity: CARMA models (``models/carma.py``), the root
predicates (``utils/roots.py``) and ``convert.carma_from_numpy``.

The reference's golden values (test/test_carma.jl, as in
tests/test_carma.py); the batched real-arithmetic path against the JAX
package's real path (float64, <= 1e-12) and against the port's own
complex oracle; the oracle's covariance and PSD against the celerite
form; float32 coefficients against float64 ones; and the committed
CARMA(2,1) run's maximum-likelihood point.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu import inference as jinf
from pioran_tpu.models import carma as jc
from pioran_tpu.utils import roots as jr
from pioran_tpu_torch import convert, inference as tinf
from pioran_tpu_torch.models import carma as tc
from pioran_tpu_torch.models.kernels import celerite_psd
from pioran_tpu_torch.utils import roots as tr

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
RA32 = np.array([
    -0.042163209825323775 + 1.1115603157767922j,
    -0.042163209825323775 - 1.1115603157767922j,
    -0.7599101571312047 + 0.0j,
])
BETA32 = np.array([3.9413022090550216, 11.38193903188344, 1.0])
PQ = [(2, 0), (2, 1), (3, 2), (4, 1)]


def test_quad2roots():
    qa = [0.025443151049354032, 0.04252858046335997, 2.5980088198563633]
    expected = np.array([
        -0.021264290231679986 + 0.1580853598860341j,
        -0.021264290231679986 - 0.1580853598860341j,
        -2.5980088198563633 + 0.0j,
    ])
    out = tc.quad2roots(qa)
    assert out.dtype == torch.complex128
    np.testing.assert_allclose(out.numpy(), expected, rtol=1e-12)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jc.quad2roots(qa)))


def test_roots2coeffs():
    r = np.array([
        -0.012721575524677016 + 0.20583182936448363j,
        -0.012721575524677016 - 0.20583182936448363j,
        -2.5980088198563633 + 0.0j,
    ])
    expected = [0.11048962713978024, 0.10863011129451944, 2.6234519709057174, 1.0]
    out = tc.roots2coeffs(torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(np.real(out), expected, rtol=1e-12)
    np.testing.assert_allclose(np.imag(out), 0.0, atol=1e-14)
    np.testing.assert_allclose(out, np.asarray(jc.roots2coeffs(jnp.asarray(r))), rtol=1e-14)


def test_celerite_coefs_golden():
    """Golden CARMA(3,2) celerite coefficients (reference test_carma.jl:51-69)."""
    model = tc.CARMA.create(3, 2, torch.as_tensor(RA32), BETA32, 1.3)
    a, b, c, d = (x.numpy() for x in model.celerite_coefficients())
    np.testing.assert_allclose(a, [1.332733901854476, -0.03273390185447589], rtol=1e-10)
    np.testing.assert_allclose(b, [-0.026820976815752837, 0.0], atol=1e-12)
    np.testing.assert_allclose(c, [0.042163209825323775, 0.7599101571312047], rtol=1e-12)
    np.testing.assert_allclose(d, [-1.1115603157767922, 0.0], atol=1e-12)


def test_carma_rejects_bad_orders():
    with pytest.raises(ValueError, match="q must be <= p"):
        tc.CARMA.create(1, 2, torch.as_tensor(RA32[2:]), BETA32, 1.0)
    with pytest.raises(ValueError, match="length of AR roots"):
        tc.CARMA.create(2, 2, torch.as_tensor(RA32), BETA32, 1.0)


def test_carma_acvf_matches_celerite_repr():
    """The celerite representation reproduces the analytic autocovariance
    (reference test_carma.jl:96-113)."""
    t = torch.linspace(0, 150, 1000, dtype=torch.float64)
    model = tc.CARMA.create(3, 2, torch.as_tensor(RA32), BETA32, 1.3)
    np.testing.assert_allclose(model.celerite()(t).numpy(), model(t).numpy(),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("is_ip", [False, True])
def test_carma_psd_matches_celerite_psd(is_ip):
    """The CARMA PSD is the sum of its celerite terms' PSDs (reference
    test_carma.jl:115-141), and the port's equals the JAX package's."""
    f = torch.as_tensor(10.0 ** np.linspace(-3, 3, 1000))
    model = tc.CARMA.create(3, 2, torch.as_tensor(RA32), BETA32, 1.0, is_integrated_power=is_ip)
    a, b, c, d = model.celerite_coefficients()
    psd_cel = sum(celerite_psd(f, a[i], b[i], c[i], d[i]) for i in range(a.shape[0]))
    np.testing.assert_allclose(psd_cel.numpy(), model.psd(f).numpy(), rtol=1e-9)
    ref = jc.CARMA.create(3, 2, jnp.asarray(RA32), jnp.asarray(BETA32), 1.0,
                          is_integrated_power=is_ip)
    np.testing.assert_allclose(model.psd(f).numpy(), np.asarray(ref.psd(jnp.asarray(f.numpy()))),
                               rtol=1e-12)


def _random_roots(rng, order, B):
    """(re, im) lists of B rows of random roots: conjugate pairs, then a
    real root when the order is odd."""
    re_l, im_l = [], []
    for _ in range(order // 2):
        x, y = -rng.uniform(0.1, 2, B), rng.uniform(0.01, 3, B)
        re_l += [x, x]
        im_l += [y, -y]
    if order % 2:
        re_l.append(-rng.uniform(0.1, 2, B))
        im_l.append(np.zeros(B))
    return re_l, im_l


@pytest.mark.parametrize("p,q", PQ)
def test_real_path_matches_jax_and_complex_oracle(p, q):
    """Five rows of random roots through the batched real path at once:
    beta, the (B, J) coefficients and the PSD against the JAX package's
    real path row by row (<= 1e-12) and against the complex oracle (the
    JAX test's tolerances: beta 1e-12, coefficients 1e-9, PSD 1e-8)."""
    B = 5
    rng = np.random.default_rng(p * 10 + q)
    are, aim = _random_roots(rng, p, B)
    mre, mim = _random_roots(rng, q, B)
    T = lambda xs: [torch.as_tensor(x) for x in xs]  # noqa: E731
    beta = (tc.poly_from_conjugate_pairs(T(mre[0:2 * (q // 2):2]), T(mim[0:2 * (q // 2):2]),
                                         T(mre[q - 1:q] if q % 2 else []))
            if q else torch.ones(B, 1, dtype=torch.float64))
    assert tuple(beta.shape) == (B, q + 1)
    coefs = tc.carma_celerite_coefs_real(p, T(are), T(aim), beta, norm=torch.full((B,), 1.7, dtype=torch.float64))
    assert all(tuple(x.shape) == (B, p // 2 + p % 2) for x in coefs)
    f = torch.as_tensor(np.geomspace(1e-3, 10, 64))
    psd = tc.carma_psd_real(f, p, q, T(are), T(aim), beta, 1.7)
    assert tuple(psd.shape) == (B, 64)
    for i in range(B):
        row = lambda xs: [jnp.asarray(x[i]) for x in xs]  # noqa: E731
        jbeta = (jc.poly_from_conjugate_pairs(row(mre[0:2 * (q // 2):2]),
                                              row(mim[0:2 * (q // 2):2]),
                                              row(mre[q - 1:q] if q % 2 else []))
                 if q else jnp.ones(1))
        np.testing.assert_allclose(beta[i].numpy(), np.asarray(jbeta), rtol=1e-12)
        ref = jc.carma_celerite_coefs_real(p, row(are), row(aim), jbeta, norm=1.7)
        for x, r in zip(coefs, ref):
            np.testing.assert_allclose(x[i].numpy(), np.asarray(r), rtol=1e-12, atol=1e-300)
        np.testing.assert_allclose(
            psd[i].numpy(),
            np.asarray(jc.carma_psd_real(jnp.asarray(f.numpy()), p, q, row(are), row(aim),
                                         jbeta, 1.7)), rtol=1e-12)
        # the complex oracle
        roots = torch.as_tensor(np.array([are[k][i] + 1j * aim[k][i] for k in range(p)]))
        mroots = np.array([mre[k][i] + 1j * mim[k][i] for k in range(q)])
        beta_c = (np.real(tc.roots2coeffs(torch.as_tensor(mroots)).numpy()) if q else np.ones(1))
        np.testing.assert_allclose(beta[i].numpy(), beta_c, rtol=1e-12)
        oracle = tc.carma_celerite_coefs(p, roots, torch.as_tensor(beta_c), norm=1.7)
        for x, r in zip(coefs, oracle):
            np.testing.assert_allclose(x[i].numpy(), r.numpy(), rtol=1e-9, atol=1e-300)
        model = tc.CARMA.create(p, q, roots, beta_c, norm=1.7)
        np.testing.assert_allclose(psd[i].numpy(), model.psd(f).numpy(), rtol=1e-8)


@pytest.mark.parametrize("p,q", PQ)
def test_carma_from_numpy(p, q):
    """A JAX CARMA's fields as numpy, rebuilt by carma_from_numpy (from
    the roots and from the quadratic coefficients): the same covariance,
    PSD and celerite coefficients as the JAX model."""
    qa, qb = jc.sample_quad(p, q, jax.random.PRNGKey(p * 7 + q), 1e-3, 1e1)
    roots = np.asarray(jc.quad2roots(qa))
    beta = np.real(np.asarray(jc.roots2coeffs(jc.quad2roots(qb)))) if q else np.ones(1)
    ref = jc.CARMA.create(p, q, jnp.asarray(roots), jnp.asarray(beta), 2.5)
    tau = np.linspace(0, 300, 200)
    f = np.geomspace(1e-4, 10, 200)
    for kw in (dict(roots=roots), dict(quad=qa)):
        model = convert.carma_from_numpy(p, q, beta, 2.5, device="cpu", **kw)
        assert model.roots.dtype == torch.complex128 and (model.p, model.q) == (p, q)
        np.testing.assert_allclose(model(torch.as_tensor(tau)).numpy(),
                                   np.asarray(ref(jnp.asarray(tau))), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(model.psd(torch.as_tensor(f)).numpy(),
                                   np.asarray(ref.psd(jnp.asarray(f))), rtol=1e-12)
        for x, r in zip(model.celerite_coefficients(), ref.celerite_coefficients()):
            np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=1e-12, atol=1e-300)
    with pytest.raises(ValueError, match="exactly one"):
        convert.carma_from_numpy(p, q, beta, device="cpu")


def test_sample_quad_matches_jax_and_is_valid():
    """An integer seed gives the JAX package's draws (which seed numpy's
    generator with one integer drawn from the key); a torch.Generator
    gives valid roots: conjugate pairs in the band, ordered."""
    for p in range(1, 6):
        for q in range(1, p):
            key = jax.random.PRNGKey(100 * p + q)
            seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
            for x, r in zip(tc.sample_quad(p, q, seed, 1e-3, 1e2),
                            jc.sample_quad(p, q, key, 1e-3, 1e2)):
                np.testing.assert_array_equal(x, r)
            gen = torch.Generator().manual_seed(p * 10 + q)
            for quad in tc.sample_quad(p, q, gen, 1e-3, 1e2):
                r = tc.quad2roots(quad).numpy()
                assert tr.check_conjugate_pair(r)
                assert tr.check_roots_bounds(r, 1e-3, 1e2)
                assert tr.check_order_imag_roots(r)


def test_root_predicates_match_jax():
    """The host checks on single root vectors, and the batched predicate
    on a batch of rows, against the JAX package's checks and its jittable
    predicate row by row."""
    rng = np.random.default_rng(5)
    rows = []
    for _ in range(40):
        pairs = [(-rng.uniform(-0.2, 1.2), rng.uniform(-0.3, 1.2)) for _ in range(2)]
        r = [complex(x, y) for x, y in pairs for y in (y, -y)]
        if rng.uniform() < 0.2:  # break a conjugate pair
            r[1] = complex(r[1].real + 0.1, r[1].imag)
        r.append(complex(-rng.uniform(-0.2, 1.2), 0.0))
        rows.append(r)
    R = np.asarray(rows)
    for r in R:
        assert tr.check_conjugate_pair(r) == jr.check_conjugate_pair(r)
        assert tr.check_roots_bounds(r, 0.01, 1.0) == jr.check_roots_bounds(r, 0.01, 1.0)
        assert tr.check_order_imag_roots(r) == jr.check_order_imag_roots(r)
    for n in (1, 2, 3, 5):  # the ordering check needs two pairs
        out = tr.roots_valid_batch(torch.as_tensor(R[:, :n]), 0.01, 1.0).numpy()
        ref = np.array([bool(jr.roots_valid_jit(jnp.asarray(r[:n]), 0.01, 1.0)) for r in R])
        np.testing.assert_array_equal(out, ref)
        assert 0 < out.sum() < len(R) or n == 1
    # a real tensor is roots on the real axis
    real = torch.tensor([[-0.5, -0.2], [0.1, -0.2]], dtype=torch.float64)
    assert tr.roots_valid_batch(real, 0.01, 1.0).tolist() == [False, False]
    assert tr.roots_valid_batch(real[:, 1:], 0.01, 1.0).tolist() == [True, True]


def _subset():
    path = os.path.join(HERE, "data", "simu_single", "simu_single_subset_time_series.txt")
    with open(path) as fh:
        for line in fh:
            if line.startswith("#mean: "):
                left, right = line[len("#mean: "):].split(" va: ")
                xbar, va = float(left), float(right)
                break
    A = np.loadtxt(path)
    return A[:, 0], A[:, 1], A[:, 2], xbar, va


@pytest.mark.parametrize("p,q", PQ)
def test_float32_coefficients_against_float64(p, q):
    """The carma_model coefficient map in float32 against float64 on 4096
    prior draws of the flagship subset's band, eight of them on corners
    of the unit cube. The partial fractions divide by Re r and by root
    differences, and terms of opposite sign cancel (sum_j |a_j| reaches
    ~70 x the variance at p = 4), so a and b are gated relative to the
    row's sum_j (|a_j| + |b_j|): 1e-3 (measured: <= 8.4e-6 at p <= 3,
    1.4e-4 at p = 4 on a corner of the band); c and d relative to the
    row's largest root modulus: 1e-6 (measured <= 8.4e-8, the float32
    rounding of the inputs). Rows where float64 itself is not finite (a
    corner that repeats an AR root) are left out."""
    data = _subset()
    grab = []
    real_loglike = tinf.batched_loglike

    def spy(a, b, c, d, *rest):
        grab.append((a, b, c, d))
        return a.sum(-1)

    U = np.random.default_rng(p * 10 + q).uniform(0.0, 1.0, (4096, 3 + p + q))
    U[:8] = np.round(U[:8])  # rows on the cube's corners, then the band edges
    U = np.clip(U, 1e-6, 1.0 - 1e-6)
    tinf.batched_loglike = spy
    try:
        for dtype in (torch.float64, torch.float32):
            spec = tinf.carma_model(*data, p=p, q=q, device="cpu", dtype=dtype)
            spec.loglike_batch(spec.prior.transform(torch.as_tensor(U, dtype=torch.float64))
                               .to(dtype))
    finally:
        tinf.batched_loglike = real_loglike
    (a, b, c, d), (a32, b32, c32, d32) = grab
    assert a32.dtype == torch.float32 and a.dtype == torch.float64
    # corner rows can repeat an AR root: a division by zero in either dtype
    fin = torch.isfinite(a).all(-1)
    assert int(fin.sum()) >= 4090 and bool(torch.isfinite(a32[fin]).all())
    scale_ab = (a[fin].abs() + b[fin].abs()).sum(-1, keepdim=True)
    scale_cd = torch.sqrt(c[fin] ** 2 + d[fin] ** 2).max(-1, keepdim=True).values
    for x, x32, scale, tol in ((a, a32, scale_ab, 1e-3), (b, b32, scale_ab, 1e-3),
                               (c, c32, scale_cd, 1e-6), (d, d32, scale_cd, 1e-6)):
        assert float(((x32[fin].double() - x[fin]).abs() / scale).max()) <= tol


def test_carma_ml_point_recompute():
    """The committed CARMA(2,1) run's maximum-likelihood point
    (artifacts/tpu_parity, a float32 run): the port's float64 likelihood
    there is the JAX package's to 1e-12 and within 0.3 of the stored
    logl (the bound of tests/test_tpu_artifacts.py)."""
    with open(os.path.join(HERE, "..", "artifacts", "tpu_parity", "summary.json")) as fh:
        entry = json.load(fh)["runs"]["carma_ns"]
    data = _subset()
    spec = tinf.carma_model(*data, p=2, q=1, device="cpu")
    assert spec.names == entry["paramnames"] and spec.carma_pq == (2, 1)
    ll = float(spec.loglike(torch.tensor(entry["ml_point"], dtype=torch.float64)))
    jspec = jinf.carma_model(*data, p=2, q=1)
    ref = float(jax.jit(jspec.loglike)(jnp.asarray(entry["ml_point"])))
    assert abs(ll / ref - 1.0) <= 1e-12
    assert abs(ll - entry["ml_logl"]) < 0.3, (ll, entry["ml_logl"])
