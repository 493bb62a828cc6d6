"""PyTorch port: checkpoint and resume (``pioran_tpu_torch.checkpoint``,
``run_smc_resumable``, ``run_ns_resumable``, ``run_inference(resume=True)``).

The counterparts of ``tests/test_checkpoint.py`` (the round trip with the
generator's state and the dtypes, retention, the SMC resumable run equal
to ``run_smc`` and resumed from its step-1 checkpoint with the analytic
evidence gate), and beyond them: NS resumed mid-run, a child process
killed with SIGKILL after a checkpoint lands and its run resumed, a
leftover temporary file, ``run_inference(resume=True)`` on a small
flagship model, and the refusals. A resumed run must equal the
uninterrupted one exactly. CPU, float64.
"""

import os
import shutil
import signal
import socket
import subprocess
import sys
import time
from datetime import timedelta
from functools import partial

import numpy as np
import pytest
import torch

from pioran_tpu_torch import inference as tinf
from pioran_tpu_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from pioran_tpu_torch.samplers import ns as tns
from pioran_tpu_torch.samplers import smc as tsmc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")


def _toy_problem():
    """A 2-d Gaussian likelihood N(1, 0.5^2 I) and a standard-normal prior,
    batched over particles."""

    def loglike(Z):
        return -0.5 * torch.sum((Z - 1.0) ** 2 / 0.5**2, dim=1) - np.log(2 * np.pi * 0.5**2)

    def logprior(Z):
        return -0.5 * torch.sum(Z**2, dim=1) - np.log(2 * np.pi)

    z0 = torch.as_tensor(np.random.default_rng(1).normal(size=(512, 2)))
    return loglike, logprior, z0


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _assert_smc_equal(a, b):
    assert torch.equal(a.logZ, b.logZ) and a.num_steps == b.num_steps
    for field in ("particles", "log_evidence_path", "lambdas", "acceptance"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


def _assert_ns_equal(a, b):
    assert a.num_dead == b.num_dead and a.ncall == b.ncall and a.num_iters == b.num_iters
    for field in ("dead_u", "dead_logl", "dead_logw", "logZ", "logZ_err", "insert_ranks"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


def _keep_only(src, dst, step):
    """A checkpoint directory ``dst`` holding only ``src``'s checkpoint of
    ``step``: a run interrupted after that step."""
    os.makedirs(dst)
    name = f"step_{step:08d}"
    shutil.copy(os.path.join(src, name), os.path.join(dst, name))


# ---------------------------------------------------------------------------
# the checkpoint files
# ---------------------------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    """Tensors, ints, floats and a generator's state come back exactly, in
    the template's dtypes, and the generator then draws what it would
    have drawn."""
    gen = _gen(7)
    torch.rand(5, generator=gen)  # move it off its seed
    state = {"particles": torch.arange(12.0, dtype=torch.float64).reshape(3, 4),
             "weights": torch.linspace(0, 1, 5, dtype=torch.float32),
             "idx": torch.arange(4), "logZ": torch.tensor(3.25, dtype=torch.float64),
             "step": 5, "scale": 0.125, "nest": (torch.ones(2), [1, 2.5]), "gen": gen}
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, state, 5)
    assert latest_step(d) == 5
    expected = torch.rand(3, generator=gen, dtype=torch.float64)

    template = dict(state, gen=_gen(123))
    restored, step = restore_checkpoint(d, template)
    assert step == 5
    for k in ("particles", "weights", "idx", "logZ"):
        assert restored[k].dtype == state[k].dtype and torch.equal(restored[k], state[k]), k
    assert restored["step"] == 5 and isinstance(restored["step"], int)
    assert restored["scale"] == 0.125 and torch.equal(restored["nest"][0], torch.ones(2))
    assert restored["nest"][1] == [1, 2.5]
    assert restored["gen"] is template["gen"]
    assert torch.equal(torch.rand(3, generator=restored["gen"], dtype=torch.float64), expected)

    # a float32 template casts; without a template the raw saved state
    cast, _ = restore_checkpoint(d, dict(template, particles=torch.zeros(3, 4)))
    assert cast["particles"].dtype == torch.float32
    raw, _ = restore_checkpoint(d)
    assert raw["gen"].dtype == torch.uint8
    with pytest.raises(ValueError, match="keys"):
        restore_checkpoint(d, {"particles": state["particles"]})


def test_manager_retention(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, max_to_keep=2, save_every=1)
    for s in range(1, 5):
        mgr.save({"x": torch.full((2,), float(s))}, s)
    assert latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    every = CheckpointManager(str(tmp_path / "every3"), max_to_keep=5, save_every=3)
    saved = [s for s in range(1, 10) if every.save({"x": torch.zeros(1)}, s)]
    assert saved == [3, 6, 9]


def test_latest_step_ignores_leftover_temporary_file(tmp_path):
    """An interrupted write leaves its temporary file: it does not count,
    and the last finished checkpoint is restored."""
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, {"x": torch.ones(3)}, 4)
    with open(os.path.join(d, ".step_00000009.a1b2c3.tmp"), "wb") as fh:
        fh.write(b"half a checkpoint")
    with open(os.path.join(d, "step_00000011.partial"), "wb") as fh:
        fh.write(b"not a checkpoint")
    assert latest_step(d) == 4
    state, step = restore_checkpoint(d, {"x": torch.zeros(3)})
    assert step == 4 and torch.equal(state["x"], torch.ones(3))
    assert latest_step(str(tmp_path / "missing")) is None
    assert restore_checkpoint(str(tmp_path / "missing")) is None


# ---------------------------------------------------------------------------
# the resumable samplers
# ---------------------------------------------------------------------------


def test_smc_resumable_matches_and_resumes(tmp_path):
    loglike, logprior, z0 = _toy_problem()
    ref = tsmc.run_smc(loglike, logprior, z0, _gen(0), num_moves=3)

    res = tsmc.run_smc_resumable(loglike, logprior, z0, _gen(0), str(tmp_path / "smc"),
                                 num_moves=3)
    _assert_smc_equal(res, ref)

    # an interrupted run: only the step-1 checkpoint is there
    gen = _gen(0)
    step = tsmc._make_step(loglike, logprior, 512, 2, 3, 0.8, "rwm")
    st = step(tsmc.smc_init(loglike, logprior, z0), gen)
    d2 = str(tmp_path / "smc2")
    CheckpointManager(d2, max_to_keep=10).save({"state": st, "generator": gen}, st["i"])
    res2 = tsmc.run_smc_resumable(loglike, logprior, z0, _gen(0), d2, num_moves=3)
    _assert_smc_equal(res2, ref)

    # the analytic evidence: Z = integral of N(z; 1, 0.5^2 I) N(z; 0, I) dz
    exact = 2 * float(-0.5 * np.log(2 * np.pi * 1.25) - 0.5 / 1.25)
    assert abs(float(res2.logZ) - exact) < 0.15


def test_ns_resumable_matches_and_resumes_mid_run(tmp_path):
    def ll_u(U):
        return -0.5 * torch.sum((U - 0.5) ** 2, dim=-1) / 0.05**2

    kw = dict(num_live=64, dim=2, n_delete=8, num_mcmc=2, move="rwm", max_iters=200)
    ref = tns.run_ns(ll_u, _gen(3), **kw)
    full = str(tmp_path / "full")
    res = tns.run_ns_resumable(ll_u, _gen(3), full, save_every=5, max_to_keep=1000, **kw)
    _assert_ns_equal(res, ref)
    steps = sorted(int(n[5:]) for n in os.listdir(full))
    assert steps == list(range(5, ref.num_iters + 1, 5)) and len(steps) >= 4

    mid = steps[len(steps) // 2]
    _keep_only(full, str(tmp_path / "mid"), mid)
    _assert_ns_equal(tns.run_ns_resumable(ll_u, _gen(3), str(tmp_path / "mid"), **kw), ref)


_CHILD = r"""
import sys, time
import numpy as np
import torch
torch.set_num_threads(1)
from pioran_tpu_torch.samplers.smc import run_smc_resumable

def loglike(Z):
    time.sleep(0.05)  # slow enough to be killed mid-run
    return -0.5 * torch.sum((Z - 1.0) ** 2 / 0.5**2, dim=1) - np.log(2 * np.pi * 0.5**2)

def logprior(Z):
    return -0.5 * torch.sum(Z**2, dim=1) - np.log(2 * np.pi)

z0 = torch.as_tensor(np.random.default_rng(1).normal(size=(512, 2)))
run_smc_resumable(loglike, logprior, z0, torch.Generator().manual_seed(0), sys.argv[1],
                  num_moves=3, max_to_keep=1000)
print("finished")
"""


def test_smc_resumes_after_sigkill(tmp_path):
    """A child process running ``run_smc_resumable`` is killed with SIGKILL
    once its second checkpoint lands; the run resumed here from its
    directory equals the uninterrupted one."""
    loglike, logprior, z0 = _toy_problem()
    ref = tsmc.run_smc(loglike, logprior, z0, _gen(0), num_moves=3)
    assert ref.num_steps >= 4
    d = str(tmp_path / "killed")
    child = subprocess.Popen([sys.executable, "-c", _CHILD, d], env=dict(os.environ,
                             PYTHONPATH=ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 60
        while (latest_step(d) or 0) < 2:
            assert child.poll() is None, child.stdout.read().decode()
            assert time.time() < deadline, "no checkpoint within 60 s"
            time.sleep(0.01)
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=30)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == -signal.SIGKILL
    assert 2 <= latest_step(d) < ref.num_steps  # killed mid-run
    res = tsmc.run_smc_resumable(loglike, logprior, z0, _gen(0), d, num_moves=3)
    _assert_smc_equal(res, ref)


# ---------------------------------------------------------------------------
# run_inference(resume=True)
# ---------------------------------------------------------------------------


def _flagship(n=32):
    A = np.loadtxt(os.path.join(DATA, "simu.txt"))[:n]
    xbar, va = float(np.mean(np.log(A[:, 1]))), float(np.var(np.log(A[:, 1])))
    return tinf.single_bending_model(A[:, 0], A[:, 1], A[:, 2], xbar, va, n_components=4,
                                     device="cpu")


@pytest.mark.parametrize("sampler,kw,runner", [
    ("smc", dict(num_particles=32, num_moves=2), "run_smc_resumable"),
    ("ns", dict(num_particles=16, num_ns_mcmc=1, ns_move="rwm", num_samples=100),
     "run_ns_resumable"),
])
def test_run_inference_resumes(sampler, kw, runner, tmp_path, monkeypatch):
    """On the flagship model (N = 32, J = 4): a checkpointed run equals the
    plain one, and a run resumed from a mid-run checkpoint equals both."""
    spec = _flagship()
    monkeypatch.setattr(tinf, runner, partial(getattr(tinf, runner), max_to_keep=10_000))
    plain = tinf.run_inference(spec, sampler=sampler, seed=4, **kw)
    full = tinf.run_inference(spec, sampler=sampler, seed=4, log_dir=str(tmp_path / "full"),
                              resume=True, **kw)
    ckpts = str(tmp_path / "full" / "checkpoints")
    steps = sorted(int(n[5:]) for n in os.listdir(ckpts))
    assert len(steps) >= 3
    _keep_only(ckpts, str(tmp_path / "mid" / "checkpoints"), steps[len(steps) // 2])
    resumed = tinf.run_inference(spec, sampler=sampler, seed=4, log_dir=str(tmp_path / "mid"),
                                 resume=True, **kw)
    for res in (full, resumed):
        assert res["logz"] == plain["logz"] and res["ncall"] == plain["ncall"]
        assert np.array_equal(res["samples"], plain["samples"])
        assert os.path.isfile(str(tmp_path / "mid" / "info" / "results.json"))


@pytest.mark.parametrize("sampler,log_dir,match", [
    ("ns", None, "needs a log_dir"),
    ("chees", "run", "NS and SMC runs only"),
    ("advi", "run", "NS and SMC runs only"),
])
def test_resume_refusals(sampler, log_dir, match, tmp_path):
    """Where the JAX package silently starts a fresh run, the port raises
    (``test_torch_inference.py`` holds the SMC and NUTS cases)."""
    spec = _flagship(16)
    with pytest.raises(ValueError, match=match):
        tinf.run_inference(spec, sampler=sampler, resume=True,
                           log_dir=log_dir and str(tmp_path / log_dir))
    assert not os.path.exists(str(tmp_path / "run"))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def one_rank_mesh():
    """A gloo process group of this one process and its 1-D CPU mesh."""
    import torch.distributed as dist

    from pioran_tpu_torch import parallel as par

    par.initialize_distributed(init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
                               rank=0, timeout=timedelta(seconds=60))
    try:
        yield par.make_mesh("particles", device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_resume_under_a_mesh(one_rank_mesh, tmp_path):
    """NS resumes under a mesh (rank 0 writes the checkpoints); the sharded
    SMC refuses ``resume``, as the JAX package's does."""
    spec = _flagship(16)
    kw = dict(sampler="ns", num_particles=16, num_ns_mcmc=1, ns_move="rwm", num_samples=50,
              seed=2)
    res = tinf.run_inference(spec, mesh=one_rank_mesh, resume=True,
                             log_dir=str(tmp_path / "ns"), **kw)
    assert latest_step(str(tmp_path / "ns" / "checkpoints")) is not None
    assert res["logz"] == tinf.run_inference(spec, **kw)["logz"]
    with pytest.raises(NotImplementedError, match="mesh-sharded SMC"):
        tinf.run_inference(spec, sampler="smc", mesh=one_rank_mesh, resume=True,
                           log_dir=str(tmp_path / "smc"))
