"""PyTorch port parity: the Kalman-filter likelihoods (``ops.kalman``).

The port's sequential filter and its log-depth associative filter
against ``pioran_tpu.ops.kalman`` on the same numpy inputs in float64 on
the CPU (JAX in x64): values, autograd gradients against ``jax.grad``,
and the float32 guard. On the flagship approximated kernels (SHO and
DRWCelerite bases) both are held against the port's celerite likelihood
with the tolerances of the JAX package's own ``tests/test_kalman.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu.ops import kalman as jk
from pioran_tpu_torch.models.psd import SingleBendingPowerLaw
from pioran_tpu_torch.ops import kalman as tk
from pioran_tpu_torch.ops.approx import approx
from pioran_tpu_torch.ops.celerite import log_likelihood

torch.set_num_threads(1)

# eager JAX dispatches the scans op by op: jit them (one compile a shape)
J_SEQ, J_ASSOC = jax.jit(jk.logl_kalman_sequential), jax.jit(jk.logl_kalman)
FLAGSHIP = (0.76, 0.004, 2.78, 0.022)  # alpha_1, f_1, alpha_2, variance


def _random_problem(seed, N=120, J=3):
    """tests/test_kalman.py's problem: celerite-stable coefficients
    (a c >= |b d|) on a random grid, as numpy float64 arrays."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 50, N))
    y = rng.normal(size=N)
    sigma2 = 0.05 + 0.1 * rng.uniform(size=N)
    a = rng.uniform(0.5, 2.0, J)
    c = rng.uniform(0.1, 1.0, J)
    d = rng.uniform(0.0, 2.0, J)
    b = rng.uniform(0.0, 1.0, J) * a * c / np.maximum(d, 1e-3)
    b = np.minimum(b, a)
    return a, b, c, d, t, y, sigma2


def _torch(args, dtype=torch.float64):
    return [torch.as_tensor(x, dtype=dtype) for x in args]


def _jax(args, dtype=jnp.float64):
    return [jnp.asarray(x, dtype=dtype) for x in args]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_sequential_matches_jax(seed):
    args = _random_problem(seed)
    ref = float(J_SEQ(*_jax(args)))
    out = float(tk.logl_kalman_sequential(*_torch(args)))
    np.testing.assert_allclose(out, ref, rtol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_associative_matches_jax(seed):
    args = _random_problem(seed)
    ref = float(J_ASSOC(*_jax(args)))
    out = float(tk.logl_kalman(*_torch(args)))
    np.testing.assert_allclose(out, ref, rtol=1e-8)


@pytest.mark.parametrize("N", [1, 2, 3, 5, 8, 33])
def test_associative_scan_lengths_match_jax(N):
    """The odd/even recursion at lengths where each branch (odd, even,
    a single element, empty pairs) is taken."""
    args = _random_problem(11, N=N, J=2)
    np.testing.assert_allclose(float(tk.logl_kalman(*_torch(args))),
                               float(J_ASSOC(*_jax(args))), rtol=1e-10)


def _flagship(simu_log_data, basis):
    t, y, yerr = simu_log_data
    yv = np.log(y)
    s2 = yerr**2 / y**2
    yc = yv - yv.mean()
    f_min = 1.0 / float(t[-1] - t[0])
    f_max = 0.5 / float(np.min(np.diff(t)))
    a1, f1, a2, var = (torch.tensor(x, dtype=torch.float64) for x in FLAGSHIP)
    kern = approx(SingleBendingPowerLaw(a1, f1, a2), f_min, f_max, 20, var,
                  basis_function=basis)
    return kern, torch.as_tensor(t), torch.as_tensor(yc), torch.as_tensor(s2)


@pytest.mark.parametrize("sequential,rtol", [(True, 1e-8), (False, 1e-6)])
@pytest.mark.parametrize("basis", ["SHO", "DRWCelerite"])
def test_flagship_kernels_match_celerite(simu_log_data, basis, sequential, rtol):
    """The flagship J = 20 SHO basis (b = a boundary terms) and the
    DRWCelerite basis (b = sqrt(3) a, an indefinite per-term Pinf, J =
    40) against the port's celerite likelihood."""
    kern, t, yc, s2 = _flagship(simu_log_data, basis)
    ll_cel = float(log_likelihood(kern, t, yc, s2))
    ll = float(tk.log_likelihood_kalman(kern, t, yc, s2, sequential=sequential))
    np.testing.assert_allclose(ll, ll_cel, rtol=rtol)


@pytest.mark.parametrize("sequential", [True, False])
def test_gradient_matches_jax_grad(sequential):
    a, b, c, d, t, y, s2 = _random_problem(7, N=60, J=2)
    jfn = jk.logl_kalman_sequential if sequential else jk.logl_kalman
    tfn = tk.logl_kalman_sequential if sequential else tk.logl_kalman
    ref = jax.jit(jax.grad(lambda p: jfn(*p, jnp.asarray(t), jnp.asarray(y),
                                         jnp.asarray(s2))))(
        tuple(jnp.asarray(x) for x in (a, b, c, d)))
    coefs = [torch.tensor(x, requires_grad=True) for x in (a, b, c, d)]
    tfn(*coefs, *_torch((t, y, s2))).backward()
    for g, r in zip(coefs, ref):
        assert torch.all(torch.isfinite(g.grad))
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(r), rtol=1e-5)


def test_associative_gradient_matches_sequential():
    """tests/test_kalman.py's check on the port alone: the two filters'
    autograd gradients agree."""
    args = _random_problem(7, N=60, J=2)
    grads = []
    for fn in (tk.logl_kalman, tk.logl_kalman_sequential):
        coefs = [torch.tensor(x, requires_grad=True) for x in args[:4]]
        fn(*coefs, *_torch(args[4:])).backward()
        grads.append([g.grad.numpy() for g in coefs])
    for g, r in zip(*grads):
        np.testing.assert_allclose(g, r, rtol=1e-5)


@pytest.mark.parametrize("sequential", [True, False])
@pytest.mark.parametrize("case", ["random", "SHO", "DRWCelerite"])
def test_float32_as_jax(simu_log_data, case, sequential):
    """float32 inputs: where the JAX filter's guard returns -inf the port's
    does too, and where it returns a value the port returns one within
    float32 rounding of it (1e-3 relative)."""
    if case == "random":
        args = _random_problem(3)
    else:
        kern, t, yc, s2 = _flagship(simu_log_data, case)
        args = [x.numpy() for x in (*kern.coefficients(), t, yc, s2)]
    jfn = J_SEQ if sequential else J_ASSOC
    tfn = tk.logl_kalman_sequential if sequential else tk.logl_kalman
    ref = jfn(*_jax(args, jnp.float32))
    assert ref.dtype == jnp.float32
    ref = float(ref)
    out = tfn(*_torch(args, torch.float32))
    assert out.dtype == torch.float32
    out = float(out)
    if np.isneginf(ref):
        assert np.isneginf(out), out
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-3)


def test_batched_kernel_raises():
    kern = approx(SingleBendingPowerLaw(torch.tensor([0.7, 0.8], dtype=torch.float64),
                                        torch.tensor([0.004, 0.004], dtype=torch.float64),
                                        torch.tensor([2.7, 2.8], dtype=torch.float64)),
                  0.01, 1.0, 4, 1.0)
    t = torch.linspace(0.0, 10.0, 16, dtype=torch.float64)
    with pytest.raises(ValueError, match="one kernel"):
        tk.log_likelihood_kalman(kern, t, torch.zeros(16, dtype=torch.float64),
                                 torch.ones(16, dtype=torch.float64))


def test_follows_the_tensors_device_and_dtype():
    """No device is chosen: the result lives where the inputs do, in
    their dtype, and the building blocks keep JAX's shapes."""
    a, b, c, d, t, y, s2 = _torch(_random_problem(1, N=10, J=3))
    H, Pinf, Phi = tk.build_ssm(a, b, c, d, t)
    Q = tk.build_process_noise(a, b, c, d, t)
    assert H.shape == (6,) and Pinf.shape == (6, 6) and Phi.shape == (9, 6, 6)
    assert Q.shape == (9, 6, 6)
    coefs = _jax(_random_problem(1, N=10, J=3)[:5])
    jH, jPinf, jPhi = jk.build_ssm(*coefs)
    jQ = jk.build_process_noise(*coefs)
    for x, r in ((H, jH), (Pinf, jPinf), (Phi, jPhi), (Q, jQ)):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=1e-14, atol=1e-15)
    out = tk.logl_kalman(a, b, c, d, t, y, s2)
    assert out.device == t.device and out.dtype == torch.float64
