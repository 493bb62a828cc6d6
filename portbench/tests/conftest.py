"""Shared helpers of the benchmark's CPU tests: the cells shrunk to a size
the CPU runs in seconds, with the checks' real limits."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness, parts  # noqa: E402

# a few threads a test process, so that parallel test processes do not
# starve each other's timed windows
torch.set_num_threads(min(4, os.cpu_count() or 1))


def small_cell(workload: str, points: int = 48, batch: int = 4, pool: int = 2):
    """(bench, config, mix, limits) of ``workload`` on the first ``points``
    points of its curve and ``pool`` batches of ``batch`` rows; the limits
    are the cell's own, the check's sample cut to the rows there are."""
    bench = harness.load_benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = parts.load_json("configs", cell["config"])
    config["points"] = points
    mix = parts.load_json("mixes", cell["traffic"])
    limits = parts.load_json("limits", workload)
    if mix["kind"] == "calls":
        mix.update(batch=batch, pool=pool, warm_calls=1)
        limits["check"].update(value_rows=batch * pool, grad_rows=min(4, batch * pool))
    return bench, config, mix, limits


def run_small(workload, seed=2**31 + 77, seconds=0.3, trace=False, fault=None, keep=None,
              **kw):
    bench, config, mix, limits = small_cell(workload, **kw)
    return harness.run_once(bench, workload, seed, seconds, trace, torch.device("cpu"),
                            harness.process_start(), config, mix, limits, fault=fault,
                            keep=keep)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)
