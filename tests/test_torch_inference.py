"""PyTorch port parity: the flagship model and ``run_inference(sampler="ns")``.

The single-bending model's batched likelihood against the JAX package's
on the reference light curve (float64, CPU), the flagship likelihood
anchor, a tiny nested-sampling run that writes the JAX package's file
layout, and a scan of the port's sources for any import of JAX.
"""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pioran_tpu_torch
from pioran_tpu import inference as jinf
from pioran_tpu_torch import config, inference as tinf
from pioran_tpu_torch.samplers.chees import batch_value_and_grad

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
# the JAX package's value on CPU in float64 at the reference posterior
# mean, in spec order (alpha_1, alpha_2, f_1, variance, nu, mu)
FLAGSHIP_THETA = [0.761, 2.777, 0.00414, 0.0223, 1.113, 0.247]
FLAGSHIP_LL64 = 1533.8193151727223


def _simu(n=None):
    A = np.loadtxt(os.path.join(DATA, "simu.txt"))[:n]
    xbar, va = float(np.mean(np.log(A[:, 1]))), float(np.var(np.log(A[:, 1])))
    return A[:, 0], A[:, 1], A[:, 2], xbar, va


# the DRWCelerite flagship (20 components, two terms each: J = 40) at the
# importance-sampling referee's mean on the reference's 485-point subset:
# the JAX package's value on the CPU in float64
DRW_REFEREE_LL64 = 1021.110678373424


@pytest.mark.parametrize("kwargs,anchor", [
    ({}, None),
    ({"use_c": True, "is_integrated_power": False, "basis_function": "DRWCelerite",
      "n_components": 10}, None),
    ({"basis_function": "DRWCelerite", "n_components": 20}, DRW_REFEREE_LL64),
], ids=["flagship", "use_c-variance-drw", "drw-20"])
def test_loglike_batch_matches_jax(kwargs, anchor):
    """64 prior draws on simu.txt against the JAX package's batch; with an
    anchor (J = 40, past the warp-per-chain kernels' 32 terms), the value
    at the referee mean on the 485-point subset and the gradient of
    logpost_batch there and at two prior draws against jax.grad (1e-8 per
    row)."""
    if anchor is not None:
        sub = _subset()
        jspec = jinf.single_bending_model(*sub, **kwargs)
        tspec = tinf.single_bending_model(*sub, device="cpu", **kwargs)
        with open(os.path.join(DATA, "simu_single", "is_referee.json")) as fh:
            mean = np.asarray(json.load(fh)["is_mean"])
        ll = float(tspec.loglike_batch(torch.as_tensor(mean[None]))[0])
        assert abs(ll / anchor - 1.0) <= 1e-12
        U = np.random.default_rng(0).uniform(0.1, 0.9, (2, jspec.prior.dim))
        th = np.concatenate([mean[None], np.asarray(jax.vmap(jspec.prior.transform)(U))])
        Z = np.array(jax.vmap(jspec.prior.to_unconstrained)(jnp.asarray(th)))
        vg = jax.jit(jax.value_and_grad(jspec.logpost_unconstrained))
        g_ref = np.stack([np.asarray(vg(jnp.asarray(z))[1]) for z in Z])
        _, g = batch_value_and_grad(tspec.logpost_batch, torch.as_tensor(Z))
        rel = np.linalg.norm(g.numpy() - g_ref, axis=1) / np.linalg.norm(g_ref, axis=1)
        assert np.max(rel) <= 1e-8
        return
    data = _simu()
    jspec = jinf.single_bending_model(*data, **kwargs)
    tspec = tinf.single_bending_model(*data, device="cpu", **kwargs)
    assert tspec.names == jspec.names and tspec.prior.dim == jspec.prior.dim
    U = np.random.default_rng(0).uniform(0.02, 0.98, (64, jspec.prior.dim))
    th_ref = jax.vmap(jspec.prior.transform)(jnp.asarray(U))
    th = tspec.prior.transform(torch.as_tensor(U))
    np.testing.assert_allclose(th.numpy(), np.asarray(th_ref), rtol=1e-12)
    ref = np.asarray(jspec.loglike_batch(th_ref))
    out = tspec.loglike_batch(th).numpy()
    assert np.isfinite(ref).sum() > 32
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    fin = np.isfinite(ref)
    rel = np.abs(out[fin] / ref[fin] - 1.0)
    # Most rows agree to round-off. Where alpha_2 is steep and f_1 low,
    # the 490 x 490 covariance has a condition number near 3e10 and any
    # two orderings of the recursion's sums differ by ~1e-10: the JAX
    # package's own fused kernel and scan differ by 7e-11 at such a row.
    assert np.median(rel) <= 1e-13
    assert np.max(rel) <= 5e-10


def _subset():
    """The reference's 485-point light curve and its #mean: header."""
    path = os.path.join(DATA, "simu_single", "simu_single_subset_time_series.txt")
    with open(path) as fh:
        line = next(x for x in fh if x.startswith("#mean: "))
    xbar, va = (float(x) for x in line[len("#mean: "):].split(" va: "))
    A = np.loadtxt(path)
    return A[:, 0], A[:, 1], A[:, 2], xbar, va


def test_flagship_anchor():
    spec = tinf.single_bending_model(*_simu(), device="cpu")
    ll = float(spec.loglike(torch.tensor(FLAGSHIP_THETA, dtype=torch.float64)))
    assert abs(ll / FLAGSHIP_LL64 - 1.0) < 1e-10


def test_run_inference_ns_writes_jax_layout(tmp_path):
    data = _simu(64)
    kw = dict(sampler="ns", num_particles=64, num_samples=100, num_ns_mcmc=2,
              ns_move="rwm", frac_remain=0.5)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    ref = jinf.run_inference(jinf.single_bending_model(*data, n_components=8),
                             key=jax.random.PRNGKey(0), log_dir=jdir, **kw)
    out = tinf.run_inference(tinf.single_bending_model(*data, n_components=8, device="cpu"),
                             seed=0, log_dir=tdir, **kw)
    assert out.keys() == ref.keys()
    assert out["samples"].shape == ref["samples"].shape
    assert np.isfinite(out["logz"]) and out["ncall"] > 64
    for rel in (("chains", "equal_weighted_post.txt"), ("info", "results.json")):
        assert os.path.isfile(os.path.join(tdir, *rel))
    with open(os.path.join(jdir, "info", "results.json")) as fh:
        jres = json.load(fh)
    with open(os.path.join(tdir, "info", "results.json")) as fh:
        tres = json.load(fh)
    assert tres.keys() == jres.keys()
    assert tres["insertion_order_MWW_test"].keys() == jres["insertion_order_MWW_test"].keys()
    assert tres["posterior"].keys() == jres["posterior"].keys()
    with open(os.path.join(jdir, "chains", "equal_weighted_post.txt")) as fh:
        jhead = fh.readline()
    post = os.path.join(tdir, "chains", "equal_weighted_post.txt")
    with open(post) as fh:
        assert fh.readline() == jhead
    assert np.loadtxt(post, skiprows=1).shape == out["samples"].shape


@pytest.mark.parametrize("sampler", ["smc", "nuts"])
def test_unported_samplers_raise(sampler, tmp_path):
    """Every sampler of the JAX package runs, and NS and SMC resume from
    checkpoints. Where the JAX package silently starts a fresh run, the
    port raises: SMC asked to resume without a log_dir to hold the
    checkpoints, and NUTS, which has none, asked to resume at all."""
    spec = tinf.single_bending_model(*_simu(32), n_components=4, device="cpu")
    log_dir = None if sampler == "smc" else str(tmp_path / "run")
    match = "needs a log_dir" if sampler == "smc" else "NS and SMC runs only"
    with pytest.raises(ValueError, match=match):
        tinf.run_inference(spec, sampler=sampler, resume=True, log_dir=log_dir)
    assert not os.path.exists(str(tmp_path / "run"))


def test_cuda_device_without_card_raises():
    """Asking for the card where there is none raises; nothing carries on
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config.require_cuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinf.single_bending_model(*_simu(32), device="cuda")


def test_default_device_is_the_card():
    """With no ``device`` the entry points go to the card; without one
    they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinf.single_bending_model(*_simu(32), n_components=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config.resolve_device(None)
    assert config.resolve_device("cpu") == torch.device("cpu")


def _imported_modules(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_never_imports_jax():
    """An AST scan of every source under pioran_tpu_torch/ and of
    chip_smoke.py: no jax, no pioran_tpu (whose __init__ imports jax)."""
    root = os.path.dirname(pioran_tpu_torch.__file__)
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")]
    files.append(os.path.join(os.path.dirname(root), "chip_smoke.py"))
    assert len(files) > 10
    for new in (("models", "carma.py"), ("models", "gp.py"), ("utils", "roots.py")):
        assert os.path.join(root, *new) in files
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "pioran_tpu"), f"{path} imports {mod}"
