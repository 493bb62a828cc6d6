"""Sampler-state checkpoint and resume, PyTorch port of ``pioran_tpu.checkpoint``.

The reference has no in-library checkpointing; its resume story is
ultranest's ``resume = true`` (reference examples/ultranest/single_pl.jl:116)
and Turing's ``save_state = true``. Here a sampler's state is written
every few steps and read back to continue the run.

A state is a nest of dicts, lists and tuples whose leaves are tensors,
Python ints, floats, bools or None, and ``torch.Generator`` objects.
A generator is saved as its ``get_state()`` (a CPU ByteTensor, for a
CUDA generator too: its seed and Philox offset), so a resumed run draws
the numbers the uninterrupted one would have drawn. Tensors are saved
on the CPU.

Each checkpoint is one file ``step_%08d`` in the checkpoint directory.
``torch.save`` writes it to a temporary file in the same directory, which
``os.replace`` then moves into place, so a reader never sees half a
checkpoint; :func:`latest_step` ignores the temporary files an
interrupted write leaves. Restoring uses ``torch.load(weights_only=True)``
and casts each tensor to the device and dtype of a template state, as
the JAX package restores onto an abstract state.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Optional, Tuple

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointManager"]

_NAME = re.compile(r"step_(\d{8,})")


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _to_saved(x):
    """The nest with tensors on the CPU and generators as their states."""
    if isinstance(x, torch.Generator):
        return x.get_state()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_saved(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_saved(v) for v in x)
    if x is None or isinstance(x, (bool, int, float)):
        return x
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _onto(tpl, saved, where="state"):
    """``saved`` in the template's structure, devices and dtypes. A
    template generator takes the saved state (``set_state``) and is
    returned itself."""
    if isinstance(tpl, torch.Generator):
        tpl.set_state(saved)
        return tpl
    if isinstance(tpl, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != tpl.shape:
            raise ValueError(f"checkpoint {where}: expected a tensor of shape "
                             f"{tuple(tpl.shape)}, found {saved!r:.80}")
        return saved.to(device=tpl.device, dtype=tpl.dtype)
    if isinstance(tpl, dict):
        if not isinstance(saved, dict) or set(saved) != set(tpl):
            raise ValueError(f"checkpoint {where}: keys differ from the template's")
        return {k: _onto(tpl[k], saved[k], f"{where}[{k!r}]") for k in tpl}
    if isinstance(tpl, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(tpl):
            raise ValueError(f"checkpoint {where}: length differs from the template's")
        return type(tpl)(_onto(t, s, f"{where}[{i}]")
                         for i, (t, s) in enumerate(zip(tpl, saved)))
    if tpl is None:
        return saved
    return type(tpl)(saved)


def save_checkpoint(directory: str, state: Any, step: int) -> str:
    """Atomically write ``state`` as step ``step``; returns its path.
    Earlier steps are kept; :class:`CheckpointManager` prunes them."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    fd, tmp = tempfile.mkstemp(prefix=f".step_{step:08d}.", suffix=".tmp", dir=directory)
    try:
        with os.fdopen(fd, "wb") as fh:
            torch.save(_to_saved(state), fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _NAME.fullmatch(name)
        if m and os.path.isfile(os.path.join(directory, name)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    """Largest step with a finished checkpoint under ``directory``, or
    None. Temporary files of an interrupted write do not count."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, template: Any = None) -> Optional[Tuple[Any, int]]:
    """``(state, step)`` from the latest checkpoint under ``directory``,
    or None when there is none.

    With ``template`` (a state of the same structure, such as the one a
    fresh run starts from) every tensor comes back on the template's
    device in its dtype, ints and floats as the template's types, and
    each template generator takes its saved state and is returned in
    its place. Without one, tensors stay on the CPU and generators are
    their saved ByteTensor states.
    """
    step = latest_step(directory)
    if step is None:
        return None
    saved = torch.load(_path(os.path.abspath(directory), step), map_location="cpu",
                       weights_only=True)
    return (saved if template is None else _onto(template, saved)), step


class CheckpointManager:
    """Keep the last ``max_to_keep`` checkpoints of a run, written every
    ``save_every`` steps.

    ``group``: a ``torch.distributed`` process group whose ranks all run
    the same replicated sampler. Rank 0 of the group writes and prunes;
    every rank then waits at a barrier, so no rank reads a checkpoint
    before it is in place.
    """

    def __init__(self, directory: str, max_to_keep: int = 2, save_every: int = 1,
                 group=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_every = save_every
        self.group = group

    def should_save(self, step: int) -> bool:
        return step % self.save_every == 0

    def save(self, state: Any, step: int) -> Optional[str]:
        if not self.should_save(step):
            return None
        path = None
        if self.group is None or torch.distributed.get_rank(self.group) == 0:
            path = save_checkpoint(self.directory, state, step)
            self._gc()
        if self.group is not None:
            torch.distributed.barrier(group=self.group)
        return path

    def restore(self, template: Any = None):
        return restore_checkpoint(self.directory, template)

    def _gc(self):
        for s in _steps(self.directory)[:-self.max_to_keep]:
            os.unlink(_path(self.directory, s))
