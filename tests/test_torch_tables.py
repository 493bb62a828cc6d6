"""PyTorch port parity: the table-streaming likelihood (K0).

The port's ``build_tables`` against the JAX package's, and K0's plain
version (``loglike_from_tables_plain``, fed the JAX package's own tables)
and ``batched_loglike_tables`` against ``batched_loglike_pallas`` run in
Pallas interpret mode, at the shapes of ``tests/test_pallas_celerite.py``;
a non-positive-definite lane, equality with K1's plain version, and the
wrapper's refusals. CPU, float64. The CUDA kernel itself is held against
the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 13).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu.ops.pallas_celerite import batched_loglike_pallas
from pioran_tpu.ops.pallas_celerite import build_tables as jax_build_tables
from pioran_tpu_torch.convert import tables_from_numpy
from pioran_tpu_torch.ops import cuda_celerite
from pioran_tpu_torch.ops.cuda_celerite import (
    batched_loglike_plain, batched_loglike_tables, build_tables, loglike_from_tables,
    loglike_from_tables_plain)

torch.set_num_threads(1)

SHAPES = [(6, 4, 50), (5, 3, 70), (130, 5, 33)]  # (B, J, N)


def _problem(B, J, N, seed):
    """Inputs from numpy; lane 1 is not positive definite."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 100, N))
    a = rng.uniform(0.1, 0.6, (B, J))
    b = rng.uniform(0.0, 0.2, (B, J))
    c = rng.uniform(0.05, 0.35, (B, J))
    d = rng.uniform(0.0, 0.4, (B, J))
    y = rng.normal(size=(B, N))
    s2 = rng.uniform(0.05, 0.15, (B, N))
    a[1] = -50.0 * a[1]
    return a, b, c, d, t, y, s2


def _torch(*xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize("B,J,N", SHAPES)
def test_build_tables_matches_jax(B, J, N):
    """Same U, V, phi (N, 2J, B), block row layout, phi's first row zero:
    normwise per table within 1e-12 relative."""
    a, b, c, d, t, _, _ = _problem(B, J, N, seed=B)
    ref = jax_build_tables(*(jnp.asarray(x) for x in (a, b, c, d, t)))
    out = build_tables(*_torch(a, b, c, d, t))
    for name, x, r in zip(("U", "V", "phi"), out, ref):
        r = np.asarray(r)
        assert x.shape == r.shape == (N, 2 * J, B), name
        rel = np.linalg.norm(x.numpy() - r) / np.linalg.norm(r)
        assert rel <= 1e-12, f"{name}: {rel:.3e}"
    assert float(out[2][0].abs().max()) == 0.0


@pytest.mark.parametrize("B,J,N", SHAPES)
def test_tables_likelihood_matches_pallas_interpret(B, J, N):
    """K0's plain version on the JAX package's own tables, and the port's
    entry point on the same inputs, against the TPU kernel in interpret
    mode: rtol 1e-10, the non-PD lane -inf in all three."""
    a, b, c, d, t, y, s2 = _problem(B, J, N, seed=B + 1)
    ja = [jnp.asarray(x) for x in (a, b, c, d, t, y, s2)]
    ref = np.asarray(batched_loglike_pallas(*ja, chunk=16, interpret=True))
    U, V, phi = tables_from_numpy(*(np.asarray(x) for x in jax_build_tables(*ja[:5])),
                                  device="cpu")
    ta, tb, tc, td, tt, ty, ts2 = _torch(a, b, c, d, t, y, s2)
    from_jax_tables = loglike_from_tables_plain(U, V, phi, ty, ts2, ta.sum(1)).numpy()
    entry = batched_loglike_tables(ta, tb, tc, td, tt, ty, ts2).numpy()
    assert np.isneginf(ref[1])
    fin = np.isfinite(ref)
    assert int(fin.sum()) == B - 1
    for out in (from_jax_tables, entry):
        assert np.array_equal(np.isneginf(out), ~fin)
        np.testing.assert_allclose(out[fin], ref[fin], rtol=1e-10)


def test_non_pd_lane_is_minus_inf():
    """A lane whose factorisation is not positive definite gives -inf,
    never NaN; the others stay finite."""
    a, b, c, d, t, y, s2 = _torch(*_problem(4, 3, 40, seed=7))
    a[2] = -a[2]
    out = batched_loglike_tables(a, b, c, d, t, y, s2)
    assert torch.isneginf(out[1]) and torch.isneginf(out[2])
    assert bool(torch.isfinite(out[[0, 3]]).all())
    assert not bool(torch.isnan(out).any())


@pytest.mark.parametrize("B,J,N", SHAPES)
def test_tables_equal_k1_plain(B, J, N):
    """K0 and K1 compute the same likelihood on the same inputs (no host
    spacings): within 1e-10 relative, the same -inf lanes."""
    args = _torch(*_problem(B, J, N, seed=B + 2))
    k0 = batched_loglike_tables(*args)
    k1 = batched_loglike_plain(*args)
    assert torch.equal(torch.isneginf(k0), torch.isneginf(k1))
    fin = torch.isfinite(k1)
    rel = ((k0[fin] - k1[fin]).abs() / k1[fin].abs()).max()
    assert float(rel) <= 1e-10


def test_tables_wrapper_refuses_a_gradient():
    """K0 has no adjoint: an input that requires a gradient raises, and
    under no_grad the same call runs."""
    a, b, c, d, t, y, s2 = _torch(*_problem(3, 2, 20, seed=3))
    a.requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient"):
        batched_loglike_tables(a, b, c, d, t, y, s2)
    U, V, phi = build_tables(*(x.detach() for x in (a, b, c, d, t)))
    with pytest.raises(ValueError, match="no gradient"):
        loglike_from_tables(U, V, phi, y.requires_grad_(True), s2, a.detach().sum(1))
    with torch.no_grad():
        assert batched_loglike_tables(a, b, c, d, t, y, s2).shape == (3,)


@pytest.mark.parametrize("what", ["odd-R", "J>32", "dtype", "shape"])
def test_tables_checks_what_the_kernel_does_not_take(what):
    """The CUDA wrapper's input check, run on CPU tensors."""
    U, V, phi = build_tables(*_torch(*_problem(3, 2, 10, seed=4)[:5]))
    y, s2, suma = torch.zeros(3, 10), torch.ones(3, 10), torch.ones(3)
    y, s2, suma = (x.double() for x in (y, s2, suma))
    if what == "odd-R":
        U, V, phi = (x[:, :3] for x in (U, V, phi))
    elif what == "J>32":
        U, V, phi = (torch.zeros(10, 66, 3, dtype=torch.float64) for _ in range(3))
    elif what == "dtype":
        y = y.float()
    else:
        suma = suma[:2]
    with pytest.raises(ValueError, match={"odd-R": "even R", "J>32": "at most 32",
                                          "dtype": "y", "shape": "suma"}[what]):
        cuda_celerite._check_tables(U, V, phi, y, s2, suma)
