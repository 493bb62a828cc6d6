"""Numeric and device configuration for pioran_tpu_torch.

The reference (Pioran.jl) is float64 throughout, and so are the port's
CPU tests and its correctness oracle. Production sampling on the card
runs float32 through the hand-written CUDA kernels. Functions on tensors
take their device and dtype from their inputs. The entry points that
build data (``single_bending_model``, ``run_inference`` through its
spec, the ``convert`` helpers) run on the card unless the caller passes
``device="cpu"``, as the CPU tests do; without a card they raise.
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
    """``device`` as a torch.device. ``None`` means the card
    (:func:`require_cuda`), and so does any CUDA device: without a card
    both raise ``RuntimeError`` and nothing falls back to the CPU. The
    CPU is used only when it is asked for."""
    if device is None:
        return require_cuda()
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    return dev
