"""PyTorch port: the model builders through ``run_inference(sampler="smc")``
on the CPU, and their refusal to run without a card unless asked for
the CPU.

Short SMC runs (the first 100 points of each committed light curve, 64
particles, 2 MALA moves a temper step; J = 8 for the power-law models)
check finite draws, the ``ncall`` formula and the ultranest layout with
the JAX package's file names, header and result keys.
"""

import json
import os

import numpy as np
import pytest
import torch

from pioran_tpu_torch import inference as tinf

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
RUNS = {
    "double": (("simu_double", "simu_double_subset_time_series.txt"),
               tinf.double_bending_model, dict(n_components=8)),
    "periodic": (("simu_periodic", "simu_periodic_rednoise_subset_time_series.txt"),
                 tinf.periodic_rednoise_model, dict(n_components=8)),
    "carma": (("simu_single", "simu_single_subset_time_series.txt"),
              tinf.carma_model, dict(p=2, q=1)),
}
# the keys of the JAX package's results.json for an SMC run
SMC_KEYS = {"paramnames", "sampler", "elapsed_s", "posterior", "maximum_likelihood",
            "logz", "num_temper_steps", "ncall"}


def _data(name, n=100):
    path = os.path.join(DATA, *RUNS[name][0])
    with open(path) as fh:
        for line in fh:
            if line.startswith("#mean: "):
                left, right = line[len("#mean: "):].split(" va: ")
                xbar, va = float(left), float(right)
                break
    A = np.loadtxt(path)[:n]
    return A[:, 0], A[:, 1], A[:, 2], xbar, va


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_inference_smc_writes_layout(name, tmp_path):
    _, builder, kw = RUNS[name]
    spec = builder(*_data(name), device="cpu", **kw)
    out = tinf.run_inference(spec, sampler="smc", num_particles=64, num_moves=2,
                             log_dir=str(tmp_path))
    assert out["samples"].shape == (64, spec.prior.dim)
    assert np.all(np.isfinite(out["samples"]))
    assert np.isfinite(out["logz"]) and out["num_temper_steps"] >= 1
    assert out["ncall"] == out["num_temper_steps"] * 2 * 64
    assert np.isfinite(out["maximum_likelihood"]["logl"])
    with open(tmp_path / "info" / "results.json") as fh:
        res = json.load(fh)
    assert set(res) == SMC_KEYS and res["paramnames"] == spec.names
    post = tmp_path / "chains" / "equal_weighted_post.txt"
    with open(post) as fh:
        assert fh.readline().split() == spec.names
    assert np.loadtxt(post, skiprows=1).shape == out["samples"].shape


@pytest.mark.parametrize("name", sorted(RUNS))
def test_builder_needs_a_card_or_the_cpu(name):
    """With no ``device`` a builder goes to the card, and so does
    ``device="cuda"``; without a card both raise instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, builder, kw = RUNS[name]
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            builder(*_data(name, 32), device=device, **kw)
    assert builder(*_data(name, 32), device="cpu", **kw).device == torch.device("cpu")
