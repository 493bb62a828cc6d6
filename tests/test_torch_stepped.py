"""PyTorch port parity: the host-stepped samplers and ``run_inference(hmc_stepped=)``.

- ``run_chees_stepped`` and ``run_nuts_stepped`` (``run_chees`` and
  ``run_nuts`` with the JAX stepped signatures; ``block`` is checked and
  changes nothing) against ``run_chees`` and ``run_nuts`` with the same
  generator: bit-equal draws and statistics, for blocks that do not
  divide the iterations and thinned draws (``tests/test_samplers.py``
  holds the JAX pairs so); ``num_samples=0`` and ``block=0``.
- Against the JAX package's stepped drivers on the same Gaussian: the
  same stats keys, the same shapes up to the port's (C, iterations) NUTS
  layout, and means and covariances within 4 Monte-Carlo standard errors
  (the two packages draw from different random streams).
- ``run_inference(hmc_stepped=True)``: the results contract of
  ``tests/test_inference_parity.py``'s stepped NUTS call (with a
  stand-in likelihood), samples,
  ``ncall`` and written files equal to the unstepped run's, and
  ``NotImplementedError`` under a mesh.

float64 on the CPU.
"""

import os
import socket
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu.samplers import chees as jchees
from pioran_tpu.samplers import nuts as jnuts
from pioran_tpu_torch import inference as tinf
from pioran_tpu_torch.samplers import chees as tchees
from pioran_tpu_torch.samplers import nuts as tnuts
from pioran_tpu_torch.utils.mcmc_stats import summarize_chains

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
COV = np.array([[1.5, 0.7], [0.7, 1.0]])  # tests/test_samplers.py's target
PREC = np.linalg.inv(COV)


def _logp(Z):
    return -0.5 * torch.sum((Z @ torch.as_tensor(PREC)) * Z, dim=1)


def _z0(C, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=(C, 2)))


def _gen(seed=1):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# stepped == unstepped, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mass", ["diag", "dense"])
@pytest.mark.parametrize("thin", [1, 3])
@pytest.mark.parametrize("block", [1, 7])
def test_chees_stepped_equals_run_chees(block, thin, mass):
    kw = dict(num_warmup=60, num_samples=40, thin=thin, mass=mass)
    s_ref, st_ref = tchees.run_chees(_logp, _z0(8), _gen(), **kw)
    s, st = tchees.run_chees_stepped(_logp, _z0(8), _gen(), block=block, **kw)
    assert isinstance(s, np.ndarray) and s.shape == (len(range(0, 40, thin)), 8, 2)
    np.testing.assert_array_equal(s, s_ref.numpy())
    assert st.keys() == st_ref.keys()
    for key in ("logp", "accept", "n_leapfrogs", "inv_mass"):
        assert isinstance(st[key], np.ndarray), key
        np.testing.assert_array_equal(st[key], st_ref[key].numpy(), err_msg=key)
    assert st["step_size"] == st_ref["step_size"]
    assert st["traj_length"] == st_ref["traj_length"]
    assert isinstance(st["step_size"], float) and isinstance(st["traj_length"], float)


def test_chees_alias_is_run_chees():
    assert tchees.chees_warmup_and_sample is tchees.run_chees
    assert {"run_chees_stepped", "chees_warmup_and_sample"} <= set(tchees.__all__)
    assert {"run_nuts_stepped", "make_nuts_transition"} <= set(tnuts.__all__)


NUTS_KW = dict(num_warmup=45, num_samples=30)


@pytest.fixture(scope="module")
def nuts_ref():
    return tnuts.run_nuts(_logp, _z0(4), _gen(), **NUTS_KW)


@pytest.mark.parametrize("thin", [1, 3])
def test_nuts_stepped_equals_run_nuts(thin, nuts_ref):
    """block = 7 does not divide the 75 iterations: a ragged final block."""
    s_ref, st_ref = nuts_ref
    s, st = tnuts.run_nuts_stepped(_logp, _z0(4), _gen(), block=7, thin=thin, **NUTS_KW)
    kept = slice(None, None, thin)
    assert isinstance(s, np.ndarray) and s.shape == (len(range(0, 30, thin)), 4, 2)
    np.testing.assert_array_equal(s, s_ref.numpy()[:, kept].transpose(1, 0, 2))
    # the port's one layout, (C, iterations), warmup first
    np.testing.assert_array_equal(st["logp"], st_ref["logp"].numpy()[:, kept])
    for key in ("accept_stat", "diverging", "depth", "num_leaves"):
        full = torch.cat([st_ref[f"warmup_{key}"], st_ref[key]], dim=1).numpy()
        assert st[key].shape == (4, 75)
        np.testing.assert_array_equal(st[key], full, err_msg=key)
    np.testing.assert_array_equal(st["step_size"], st_ref["step_size"].numpy())
    np.testing.assert_array_equal(st["inv_mass"], st_ref["inv_mass"].numpy())
    assert np.all(st["num_leaves"] <= 2 ** st["depth"])
    assert np.all(st["num_leaves"] >= 1)


def test_nuts_transition_drives_run_nuts():
    """make_nuts_transition's out tuple, chains first, and its warmup
    adaptation: the inverse mass moves only at a slow window's end."""
    transition, init = tnuts.make_nuts_transition(_logp, num_warmup=30)
    state = init(_z0(3))
    windows = tnuts.warmup_schedule(30)
    for it in range(32):
        before = state["inv_mass"]
        state, out = transition(state, it, it < 30, _gen(it))
        z, logp, acc, div, depth, leaves = out
        assert z.shape == (3, 2) and logp.shape == acc.shape == div.shape == (3,)
        assert depth.shape == leaves.shape == (3,)
        assert torch.equal(z, state["z"]) and torch.equal(logp, state["logp"])
        moved = not torch.equal(before, state["inv_mass"])
        assert moved == bool(it < 30 and windows[it])


def test_nuts_stepped_without_samples():
    s, st = tnuts.run_nuts_stepped(_logp, _z0(5), _gen(), num_warmup=7, num_samples=0, block=3)
    assert s.shape == (0, 5, 2) and st["logp"].shape == (5, 0)
    assert st["num_leaves"].shape == st["depth"].shape == (5, 7)
    assert st["step_size"].shape == (5,) and st["inv_mass"].shape == (5, 2)


@pytest.mark.parametrize("driver", [tchees.run_chees_stepped, tnuts.run_nuts_stepped])
def test_block_zero_raises(driver):
    with pytest.raises(ValueError, match="block"):
        driver(_logp, _z0(2), _gen(), num_warmup=2, num_samples=2, block=0)


# ---------------------------------------------------------------------------
# against the JAX package's stepped drivers, statistically
# ---------------------------------------------------------------------------


def _within_4_se(chains_a, chains_b):
    """Means and covariances of two (C, S, dim) runs within 4 combined
    Monte-Carlo standard errors (each run's from its smallest bulk ESS)."""
    means, covs, ses_m, ses_c = [], [], [], []
    for ch in (chains_a, chains_b):
        flat = ch.reshape(-1, ch.shape[-1])
        ess = float(np.min(summarize_chains(ch)["ess_bulk"]))
        cov = np.cov(flat.T)
        sd = np.sqrt(np.diag(cov))
        means.append(flat.mean(0))
        covs.append(cov)
        ses_m.append(sd / np.sqrt(ess))
        # var of a sample covariance of a Gaussian: (s_ii s_jj + s_ij^2) / n
        ses_c.append(np.sqrt((np.outer(sd**2, sd**2) + cov**2) / ess))
    assert np.all(np.abs(means[0] - means[1]) <= 4 * np.hypot(*ses_m)), means
    assert np.all(np.abs(covs[0] - covs[1]) <= 4 * np.hypot(*ses_c)), covs


def _jax_logp(z):
    return -0.5 * z @ jnp.asarray(PREC) @ z


def test_chees_stepped_against_jax():
    kw = dict(num_warmup=100, num_samples=250, block=25)
    z0 = np.random.default_rng(2).normal(size=(32, 2))
    js, jst = jchees.run_chees_stepped(_jax_logp, jnp.asarray(z0), jax.random.PRNGKey(3), **kw)
    s, st = tchees.run_chees_stepped(_logp, torch.as_tensor(z0), _gen(3), **kw)
    assert st.keys() == jst.keys()
    assert s.shape == np.asarray(js).shape == (250, 32, 2)
    for key in ("logp", "accept", "n_leapfrogs", "inv_mass"):
        assert st[key].shape == np.asarray(jst[key]).shape, key
    _within_4_se(s.transpose(1, 0, 2), np.asarray(js).transpose(1, 0, 2))


def test_nuts_stepped_against_jax():
    kw = dict(num_warmup=100, num_samples=150, block=10)
    z0 = np.random.default_rng(4).normal(size=(8, 2))
    js, jst = jnuts.run_nuts_stepped(_jax_logp, jnp.asarray(z0), jax.random.PRNGKey(5), **kw)
    s, st = tnuts.run_nuts_stepped(_logp, torch.as_tensor(z0), _gen(5), **kw)
    assert st.keys() == jst.keys()
    assert s.shape == np.asarray(js).shape == (150, 8, 2)
    # the JAX stepped driver's (iterations, C) is the port's (C, iterations)
    for key in ("logp", "accept_stat", "diverging", "depth", "num_leaves"):
        assert st[key].shape == np.asarray(jst[key]).shape[::-1], key
    for key in ("step_size", "inv_mass"):
        assert st[key].shape == np.asarray(jst[key]).shape, key
    _within_4_se(s.transpose(1, 0, 2), np.asarray(js).transpose(1, 0, 2))


# ---------------------------------------------------------------------------
# run_inference(hmc_stepped=True)
# ---------------------------------------------------------------------------


def _subset(n=None):
    path = os.path.join(DATA, "simu_single", "simu_single_subset_time_series.txt")
    A = np.loadtxt(path)[:n]
    with open(path) as fh:
        line = next(ln for ln in fh if ln.startswith("#mean: "))
    xbar, va = (float(x) for x in line[len("#mean: "):].split(" va: "))
    return A[:, 0], A[:, 1], A[:, 2], xbar, va


def _standin(spec):
    """The flagship spec with a quadratic stand-in likelihood, as
    tests/test_torch_smc_nuts.py gives the JAX package's: the results
    contract does not depend on the likelihood, and the plain celerite
    loops on the CPU take 0.7 s a value+gradient of four chains at the
    subset's 485 points."""
    import dataclasses

    mean = torch.tensor([0.761, 2.777, 0.00414, 0.0223, 1.113, 0.247], dtype=torch.float64)
    return dataclasses.replace(
        spec, loglike_batch=lambda TH: -0.5 * torch.sum((TH - mean) ** 2, dim=-1))


def _files(log_dir):
    out = {}
    for rel in (("chains", "equal_weighted_post.txt"), ("info", "results.json")):
        with open(os.path.join(log_dir, *rel)) as fh:
            out[rel] = fh.read()
    return out


def _same_files(a, b):
    """The written files equal but for results.json's wall-clock entries."""
    import json

    fa, fb = _files(a), _files(b)
    assert fa[("chains", "equal_weighted_post.txt")] == fb[("chains", "equal_weighted_post.txt")]
    ra, rb = (json.loads(f[("info", "results.json")]) for f in (fa, fb))
    for r in (ra, rb):
        r.pop("elapsed_s"), r.pop("ess_per_s", None)
    assert ra == rb


def test_run_inference_nuts_stepped_contract_standin_likelihood():
    """tests/test_inference_parity.py's stepped NUTS call (4 chains,
    30 + 20) on the flagship subset's spec with a stand-in likelihood: its
    results contract. The real likelihood is held by the next test."""
    spec = _standin(tinf.single_bending_model(*_subset(), device="cpu"))
    res = tinf.run_inference(spec, sampler="nuts", hmc_stepped=True, seed=3, num_chains=4,
                             num_warmup=30, num_samples=20)
    post = np.asarray(res["samples"])
    assert post.shape == (4 * 20, 6)
    assert np.all(np.isfinite(post))
    assert res["ncall"] > 0
    assert len(res["rhat"]) == 6


@pytest.mark.parametrize("sampler,kw", [
    ("nuts", dict(num_chains=2, num_warmup=2, num_samples=3)),
    ("chees", dict(num_chains=4, num_warmup=3, num_samples=4, mass="dense",
                   hmc_max_leapfrogs=4)),
])
def test_run_inference_stepped_equals_unstepped(sampler, kw, tmp_path):
    """The flagship model itself (a 32-point cut, J = 4): stepped and
    unstepped runs give the same samples, ncall and files."""
    spec = tinf.single_bending_model(*_subset(32), n_components=4, device="cpu")
    res = tinf.run_inference(spec, sampler=sampler, seed=1, hmc_stepped=True,
                             log_dir=str(tmp_path / "s"), **kw)
    ref = tinf.run_inference(spec, sampler=sampler, seed=1, log_dir=str(tmp_path / "u"), **kw)
    assert res.keys() == ref.keys()
    np.testing.assert_array_equal(res["samples"], ref["samples"])
    assert res["ncall"] == ref["ncall"] > 0
    _same_files(str(tmp_path / "s"), str(tmp_path / "u"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_hmc_stepped_under_a_mesh_raises():
    import torch.distributed as dist

    from pioran_tpu_torch import parallel as par

    spec = tinf.single_bending_model(*_subset(32), n_components=4, device="cpu")
    par.initialize_distributed(init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
                               rank=0, timeout=timedelta(seconds=60))
    try:
        mesh = par.make_mesh("chains", device_type="cpu")
        for sampler, name in (("nuts", "NUTS"), ("chees", "ChEES")):
            with pytest.raises(NotImplementedError, match=f"hmc_stepped.*mesh=.*{name}"):
                tinf.run_inference(spec, sampler=sampler, mesh=mesh, hmc_stepped=True,
                                   num_chains=2, num_warmup=1, num_samples=1)
    finally:
        dist.destroy_process_group()
