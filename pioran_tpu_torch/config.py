"""Numeric and device configuration for pioran_tpu_torch.

The reference (Pioran.jl) is float64 throughout, and so are the port's
CPU tests and its correctness oracle. Production sampling on the card
runs float32 through the hand-written CUDA likelihood kernel. Every
public function takes its device and dtype from its input tensors or
from explicit ``device``/``dtype`` arguments; nothing picks a device
behind the caller's back.
"""

from __future__ import annotations

import torch

DEFAULT_DTYPE = torch.float64


def require_cuda() -> torch.device:
    """The CUDA device, or ``RuntimeError`` when no card is present.

    There is no CPU fallback: a caller that asked for the card and got
    the CPU would measure PyTorch's CPU kernels under the card's name.

    Also forbids TF32. The nested-sampling path runs float32 matrix
    products on the card (the J x J basis solve in ``ops.approx`` and
    the live-cloud covariance and Cholesky in ``samplers.ns``); TF32
    would keep about ten mantissa bits there, which moves the basis
    amplitudes and with them the likelihood by far more than the
    kernel's own float32 error.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "pioran_tpu_torch: no CUDA device is available "
            "(torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device (default: CPU). A CUDA device goes
    through :func:`require_cuda`, so asking for the card without one
    raises instead of running on the CPU."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        require_cuda()
    return dev
