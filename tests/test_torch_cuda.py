"""The port's CUDA kernel on the card, against its plain PyTorch version.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
without one. The file imports neither jax nor pioran_tpu, so it runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from pioran_tpu_torch.ops import cuda_celerite
from pioran_tpu_torch.ops.cuda_celerite import batched_loglike, batched_loglike_plain


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    from pioran_tpu_torch.config import require_cuda

    return require_cuda()


def _problem(B, J, N, seed):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 100, N))
    a = rng.uniform(0.1, 0.6, (B, J))
    b = rng.uniform(0.0, 0.2, (B, J))
    c = rng.uniform(0.05, 0.35, (B, J))
    d = rng.uniform(0.0, 0.4, (B, J))
    y = rng.normal(size=(B, N))
    s2 = rng.uniform(0.05, 0.15, (B, N))
    a[0] = -50.0 * a[0]  # lane 0 is not positive definite
    return a, b, c, d, t, y, s2


# f64: the two differ only in the order of their sums; f32: as chip_smoke.py
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 5e-2)])
@pytest.mark.parametrize("J", [3, 20, 32])
@pytest.mark.parametrize("with_dt", [False, True])
def test_kernel_matches_plain_on_card(card, dtype, tol, J, with_dt):
    """A ragged batch edge (37 chains), J across the kernel's three widths,
    a non-PD lane, with and without host spacings."""
    a, b, c, d, t, y, s2 = _problem(37, J, 300, seed=J)
    args = [torch.as_tensor(x, dtype=dtype, device=card) for x in (a, b, c, d, t, y, s2)]
    dt = torch.as_tensor(np.diff(t), device=card) if with_dt else None
    before = cuda_celerite.LAUNCHES
    k = batched_loglike(*args, dt)
    assert cuda_celerite.LAUNCHES == before + 1
    p = batched_loglike_plain(*args, dt)
    torch.cuda.synchronize()
    assert torch.equal(torch.isneginf(k), torch.isneginf(p)) and bool(k[0] == -math.inf)
    fin = torch.isfinite(p)
    assert int(fin.sum()) == 36
    err = (k[fin] - p[fin]).abs()
    if dtype == torch.float64:
        err = err / p[fin].abs()
    assert float(err.max()) <= tol


@pytest.mark.cuda
def test_wrapper_rejects_mixed_inputs_on_card(card):
    a, b, c, d, t, y, s2 = (torch.as_tensor(x, device=card)
                            for x in _problem(4, 5, 20, seed=1))
    with pytest.raises(ValueError, match="sigma2"):
        batched_loglike(a, b, c, d, t, y, s2.float())
    with pytest.raises(ValueError, match="at most 32"):
        batched_loglike(*(torch.as_tensor(x, device=card) for x in _problem(2, 33, 10, 2)))
