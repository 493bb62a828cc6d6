"""The yardstick's counts: the work of a celerite likelihood call computed
from its shapes alone, and the published peaks it is held against.

A call on B parameter rows of a light curve of N points under J celerite
terms needs, whatever implements it:

- forward (the likelihood): about 20 J^2 operations a chain-step; the
  coefficients a, b, c, d (B, J), the times t (N,), y and sigma^2 (B, N)
  read once, the value (B,) written once;
- value and gradient: 76 J^2 operations a chain-step (the forward's 20
  and the adjoint sweep's 56); the same inputs read once, the value and
  the cotangents of a, b, c, d, y and sigma^2 written once.

No residual or intermediate table is counted: a fused or redesigned
kernel is measured against the same work.
"""

from __future__ import annotations

# NVIDIA H100 SXM, published: float32 outside the tensor cores, HBM3
F32_OPS_S = 67e12
HBM_BYTES_S = 3.35e12

FWD_OPS_PER_STEP = 20.0
GRAD_OPS_PER_STEP = 76.0


def forward_cost(B: int, J: int, N: int, item: int = 4):
    """(bytes, operations) of one likelihood call without a gradient."""
    nbytes = item * (4 * B * J + N + 2 * B * N + B)
    return float(nbytes), FWD_OPS_PER_STEP * J * J * B * N


def grad_cost(B: int, J: int, N: int, item: int = 4):
    """(bytes, operations) of one value-and-gradient call."""
    reads = 4 * B * J + N + 2 * B * N
    writes = B + 4 * B * J + 2 * B * N
    return float(item * (reads + writes)), GRAD_OPS_PER_STEP * J * J * B * N


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes at the
    HBM rate and the operations at the float32 peak."""
    return max(nbytes / HBM_BYTES_S, ops / F32_OPS_S)
