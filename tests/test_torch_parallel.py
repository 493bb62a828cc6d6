"""PyTorch port: the multi-device paths of ``pioran_tpu_torch.parallel`` on
gloo process groups of 2 and 4 CPU processes.

The counterparts of ``tests/test_multichip.py`` (all but the time-sharded
scan, which the port does not have) and of ``tests/test_multihost.py``'s
process group. Each world size is one launch of ``world`` processes of
this file (``python tests/test_torch_parallel.py <rank> <world> <out>``,
with torchrun's environment), each rank running every check in one
process and writing what it found; the test then holds every rank's
numbers to the gates:

- ``sharded_batched_fn`` and ``host_local_to_global`` against the
  unsharded batch;
- ``run_ns_sharded`` equal to ``run_ns`` (every rank evaluates the rows
  an unsharded sweep would);
- ``run_smc_sharded``'s evidence within 0.2 of the analytic value and of
  ``run_smc``'s (the JAX package's gates), and within 0.2 of the JAX
  package's own ``run_smc`` on the same problem;
- ``run_chees_sharded`` against ``run_chees`` to 1e-10 relative in float64
  (the draws for all chains come from one replicated generator);
- ``run_nuts_sharded``'s pooled inverse mass identical on every chain and
  within 0.5 of the target variances and of the JAX package's own
  ``run_nuts_sharded`` on the same problem;
- ``run_inference(mesh=)`` for NS (equal to the unsharded run), SMC,
  ChEES (on the 2-D mesh) and NUTS on a Gaussian toy spec, with the JAX
  tests' gates; ``run_inference_many(mesh=)`` against the unsharded run;
- the divisibility errors.

Every group has a 60 s timeout and every launch 120 s; the port comes
from binding port 0, so parallel test workers never collide. The file
imports JAX only inside the tests, so its ranks start without it.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
SIGMA, TARGET = 0.35, [0.4, -0.3, 0.1]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------


def _rel(x, ref) -> float:
    return float(torch.max(torch.abs(x - ref)) / torch.max(torch.abs(ref)))


def _toy_spec():
    """A GPModelSpec-shaped Gaussian problem, so the mesh plumbing of
    run_inference runs without the GP solve's cost."""
    from pioran_tpu_torch.inference import GPModelSpec
    from pioran_tpu_torch.priors import Normal, PriorSet

    target = torch.tensor(TARGET, dtype=torch.float64)

    def loglike_batch(TH):
        return -0.5 * torch.sum((TH - target) ** 2, dim=-1) / SIGMA**2

    z = np.zeros(8)
    return GPModelSpec(
        prior=PriorSet([(f"p{i}", Normal(0.0, 1.0)) for i in range(3)]),
        loglike=lambda th: loglike_batch(th[None])[0], names=["p0", "p1", "p2"],
        gp_model=None, psd_model=None, paramnames_split={}, t=z, y=z + 1.0, yerr=z + 0.1,
        f_min=0.1, f_max=1.0, loglike_batch=loglike_batch, device=torch.device("cpu"),
        dtype=torch.float64)


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError as err:
        return "divisible" in str(err)
    return False


def _ll_u(X):
    """A 2-d Gaussian in the unit cube, for nested sampling."""
    return -0.5 * torch.sum((X - 0.5) ** 2, dim=-1) / 0.05**2


NS_KW = dict(num_live=128, dim=2, n_delete=16, num_mcmc=2, move="rwm", max_iters=200)
SMC_D, SMC_S0, SMC_S, SMC_Y = 3, 2.0, 0.5, [0.3, -1.2, 0.8]
# the reductions' order makes a drift that the trajectories amplify: 2.0e-9
# relative at 60 + 40 iterations on the diag metric, 1.1e-12 at 40 + 20
CHEES_KW = dict(num_warmup=40, num_samples=20, max_leapfrogs=32)
RI_NS = dict(sampler="ns", seed=3, num_particles=128, num_ns_mcmc=4, ns_move="rwm",
             num_samples=500)
MANY_KW = dict(num_chains=8, num_warmup=6, num_samples=6, max_leapfrogs=4, n_components=2,
               seed=5, device="cpu")


def _smc_problem():
    d, s0, s = SMC_D, SMC_S0, SMC_S
    y = torch.tensor(SMC_Y, dtype=torch.float64)

    def loglike(Z):
        return -0.5 * torch.sum((y - Z) ** 2, 1) / s**2 - d / 2 * np.log(2 * np.pi * s**2)

    def logprior(Z):
        return -0.5 * torch.sum(Z**2, 1) / s0**2 - d / 2 * np.log(2 * np.pi * s0**2)

    p0 = s0 * torch.as_tensor(np.random.default_rng(0).normal(size=(1024, d)))
    return loglike, logprior, p0


def _gauss_logp():
    cov = torch.tensor([[2.0, 1.2], [1.2, 1.5]], dtype=torch.float64)
    prec = torch.linalg.inv(cov)
    z0 = torch.as_tensor(np.random.default_rng(2).normal(size=(16, 2)))
    return (lambda Z: -0.5 * torch.sum((Z @ prec) * Z, dim=1)), z0


def _many_data():
    A = np.loadtxt(os.path.join(DATA, "simu.txt"))
    return [(A[:40, 0], A[:40, 1], A[:40, 2]), (A[100:150, 0], A[100:150, 1], A[100:150, 2])]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _worker(rank: int, world: int, out_dir: str) -> None:
    """One rank: every sharded check, its results saved for the test."""
    from datetime import timedelta

    import torch.distributed as dist

    from pioran_tpu_torch import inference as tinf
    from pioran_tpu_torch import parallel as par

    out = {"joined": par.initialize_distributed(timeout=timedelta(seconds=120))}
    mesh = par.make_mesh("chains", device_type="cpu")
    mesh_p = par.make_mesh("particles", device_type="cpu")
    mesh2 = par.make_mesh_2d(("hosts", "chains"), device_type="cpu")
    out["mesh2"] = [mesh2.size(0), mesh2.size(1)]
    out["local_chain_count"] = par.local_chain_count(16, mesh)

    # batched function, gather
    U = torch.as_tensor(np.random.default_rng(0).normal(size=(8, 3)))
    f = lambda X: torch.sum(X**2, dim=1)  # noqa: E731
    out["batched_equal"] = bool(torch.equal(par.sharded_batched_fn(f, mesh_p, "particles")(U),
                                            f(U)))
    out["batched_2d_equal"] = bool(torch.equal(
        par.sharded_batched_fn(f, mesh2, ("hosts", "chains"))(U), f(U)))
    m = 8 // world
    out["gather_equal"] = bool(torch.equal(
        par.host_local_to_global(mesh, "chains", U[rank * m:(rank + 1) * m]), U))

    a = par.run_ns_sharded(_ll_u, _gen(0), mesh_p, "particles", **NS_KW)
    out["ns"] = {"logZ": a.logZ, "dead_u": a.dead_u, "dead_logl": a.dead_logl,
                 "ncall": a.ncall}

    loglike, logprior, p0 = _smc_problem()
    res = par.run_smc_sharded(loglike, logprior, p0, _gen(1), mesh_p, "particles")
    out["smc_logz"], out["smc_mean"] = float(res.logZ), res.particles.mean(0).tolist()

    logp, z0 = _gauss_logp()
    for mass in ("diag", "dense"):
        samples, stats = par.run_chees_sharded(logp, z0, _gen(3), mesh, "chains", mass=mass,
                                               **CHEES_KW)
        out[f"chees_{mass}"] = {"samples": samples, "logp": stats["logp"],
                                "n_leapfrogs": stats["n_leapfrogs"]}

    samples, stats = par.run_nuts_sharded(logp, z0, _gen(4), mesh, "chains",
                                          num_warmup=60, num_samples=100)
    out["nuts_shape"] = list(samples.shape)
    out["nuts_cov"] = np.cov(samples.reshape(-1, 2).numpy().T).tolist()
    out["nuts_inv_mass"] = stats["inv_mass"].tolist()

    # run_inference on the toy spec
    spec = _toy_spec()
    log_dir = os.path.join(out_dir, f"ns_run_{world}")
    r = tinf.run_inference(spec, mesh=mesh, log_dir=log_dir, **RI_NS)
    out["ri_ns"] = {"logz": r["logz"], "samples": torch.as_tensor(r["samples"]),
                    "mesh": r["mesh"], "mww": "insertion_order_MWW_test" in r,
                    "written": os.path.isfile(os.path.join(log_dir, "info", "results.json"))}
    r = tinf.run_inference(spec, sampler="chees", mesh=mesh2, seed=5, num_chains=16,
                           num_warmup=60, num_samples=60, hmc_max_leapfrogs=8)
    out["ri_chees"] = {"mean": r["posterior"]["mean"], "stdev": r["posterior"]["stdev"],
                       "mesh": r["mesh"]}
    r = tinf.run_inference(spec, sampler="smc", mesh=mesh_p, seed=6, num_particles=512,
                           num_moves=6)
    out["ri_smc_mean"] = r["posterior"]["mean"]
    r = tinf.run_inference(spec, sampler="nuts", mesh=mesh, seed=7, num_chains=8,
                           num_warmup=40, num_samples=40)
    out["ri_nuts"] = {"mean": r["posterior"]["mean"], "rhat": r["rhat"], "ncall": r["ncall"]}
    ds = _many_data()
    out["many_means"] = [x["posterior"]["mean"]
                         for x in tinf.run_inference_many(ds, mesh=mesh, **MANY_KW)]

    # divisibility errors
    out["div_errors"] = [
        _raises(lambda: tinf.run_inference(spec, sampler="ns", mesh=mesh, num_particles=101)),
        _raises(lambda: tinf.run_inference(spec, sampler="chees", mesh=mesh, num_chains=13)),
        _raises(lambda: par.run_ns_sharded(_ll_u, _gen(0), mesh_p, "particles", num_live=128,
                                           dim=2, n_delete=world + 1)),
        _raises(lambda: par.sharded_batched_fn(f, mesh_p, "particles")(U[:world + 1])),
        _raises(lambda: par.local_chain_count(world + 1, mesh)),
        _raises(lambda: tinf.run_inference_many(ds[:1], mesh=mesh, **dict(MANY_KW, num_chains=3))),
    ]
    torch.save(out, os.path.join(out_dir, f"rank{world}_{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the launches and their gates
# ---------------------------------------------------------------------------


def _start(world: int, out_dir: str):
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT)
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                              out_dir], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _finish(procs, world: int, out_dir: str):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{logs[r][-4000:]}"
    return [torch.load(os.path.join(out_dir, f"rank{world}_{r}.pt"), weights_only=True)
            for r in range(world)]


def _jax_smc_logz():
    """The JAX package's run_smc on the SMC check's problem."""
    import jax
    import jax.numpy as jnp

    from pioran_tpu.samplers.smc import run_smc as jrun_smc

    d, s0, s = SMC_D, SMC_S0, SMC_S
    y = jnp.array(SMC_Y)

    def loglike(z):
        return -0.5 * jnp.sum((y - z) ** 2) / s**2 - d / 2 * jnp.log(2 * jnp.pi * s**2)

    def logprior(z):
        return -0.5 * jnp.sum(z**2) / s0**2 - d / 2 * jnp.log(2 * jnp.pi * s0**2)

    p0 = s0 * jax.random.normal(jax.random.PRNGKey(0), (1024, d))
    return float(jrun_smc(loglike, logprior, p0, jax.random.PRNGKey(1)).logZ)


def _jax_nuts_inv_mass():
    """The JAX package's run_nuts_sharded on the NUTS check's problem (its
    8 virtual CPU devices, its own random stream): the pooled inverse
    mass of its chains."""
    import jax
    import jax.numpy as jnp

    from pioran_tpu.parallel import make_mesh as jmake_mesh
    from pioran_tpu.parallel import run_nuts_sharded as jrun_nuts_sharded

    prec = jnp.linalg.inv(jnp.array([[2.0, 1.2], [1.2, 1.5]]))
    z0 = jax.random.normal(jax.random.PRNGKey(0), (16, 2))
    keys = jax.random.split(jax.random.PRNGKey(1), 16)
    _, stats = jrun_nuts_sharded(lambda z: -0.5 * z @ prec @ z, z0, keys, jmake_mesh("chains"),
                                 num_warmup=60, num_samples=100)
    return np.asarray(stats["inv_mass"])[0]


def _references():
    """The unsharded runs on the same problems, with the same seeds."""
    from pioran_tpu_torch import inference as tinf
    from pioran_tpu_torch.samplers.chees import run_chees
    from pioran_tpu_torch.samplers.ns import run_ns
    from pioran_tpu_torch.samplers.smc import run_smc

    ref = {"ns": run_ns(_ll_u, _gen(0), **NS_KW)}
    loglike, logprior, p0 = _smc_problem()
    ref["smc_logz"] = float(run_smc(loglike, logprior, p0, _gen(1)).logZ)
    ref["jax_smc_logz"] = _jax_smc_logz()
    ref["jax_nuts_inv_mass"] = _jax_nuts_inv_mass()
    logp, z0 = _gauss_logp()
    for mass in ("diag", "dense"):
        ref[f"chees_{mass}"] = run_chees(logp, z0, _gen(3), mass=mass, **CHEES_KW)
    ref["ri_ns"] = tinf.run_inference(_toy_spec(), **RI_NS)
    ref["many_means"] = [x["posterior"]["mean"]
                         for x in tinf.run_inference_many(_many_data(), **MANY_KW)]
    return ref


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both world sizes run at once; the references run here meanwhile."""
    out_dir = str(tmp_path_factory.mktemp("gloo"))
    procs = {world: _start(world, out_dir) for world in (2, 4)}
    try:
        ref = _references()
    finally:
        outs = {world: _finish(p, world, out_dir) for world, p in procs.items()}
    return outs, ref


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_paths_on_gloo_groups(world, launched):
    outs, ref = launched[0][world], launched[1]
    o = outs[0]
    # every rank returns the same results
    for other in outs[1:]:
        for k in ("ns", "smc_logz", "smc_mean", "chees_diag", "chees_dense", "nuts_cov",
                  "nuts_inv_mass", "ri_ns", "ri_chees", "ri_smc_mean", "ri_nuts", "many_means"):
            assert str(other[k]) == str(o[k]), k
    for r in outs:
        assert r["joined"] and r["ri_ns"]["written"] and all(r["div_errors"]), r["div_errors"]
    assert o["mesh2"] == [1, world] and o["local_chain_count"] == 16 // world
    assert o["batched_equal"] and o["batched_2d_equal"] and o["gather_equal"]

    # nested sampling: exactly the unsharded run
    ns = ref["ns"]
    assert torch.equal(o["ns"]["logZ"], ns.logZ) and o["ns"]["ncall"] == ns.ncall
    assert torch.equal(o["ns"]["dead_u"], ns.dead_u)
    assert torch.equal(o["ns"]["dead_logl"], ns.dead_logl)

    # SMC: the analytic evidence and the single-device runs of both packages
    yv = np.asarray(SMC_Y)
    v = SMC_S0**2 + SMC_S**2
    logz_true = float(-0.5 * np.sum(yv**2) / v - SMC_D / 2 * np.log(2 * np.pi * v))
    assert abs(o["smc_logz"] - logz_true) < 0.2
    np.testing.assert_allclose(o["smc_mean"], yv * SMC_S0**2 / v, atol=0.12)
    assert abs(o["smc_logz"] - ref["smc_logz"]) < 0.2
    assert abs(o["smc_logz"] - ref["jax_smc_logz"]) < 0.2

    # ChEES: the unsharded run up to the order of the reductions
    for mass in ("diag", "dense"):
        samples, stats = ref[f"chees_{mass}"]
        got = o[f"chees_{mass}"]
        assert torch.equal(got["n_leapfrogs"], stats["n_leapfrogs"]), mass
        assert _rel(got["samples"], samples) < 1e-10, mass
        assert _rel(got["logp"], stats["logp"]) < 1e-10, mass

    # NUTS: one pooled mass on every chain, near the target's variances
    cov = np.array([[2.0, 1.2], [1.2, 1.5]])
    assert o["nuts_shape"] == [16, 100, 2]
    np.testing.assert_allclose(o["nuts_cov"], cov, atol=0.3)
    inv_mass = np.asarray(o["nuts_inv_mass"])
    np.testing.assert_array_equal(inv_mass, np.tile(inv_mass[0], (16, 1)))
    np.testing.assert_allclose(inv_mass[0], np.diag(cov), rtol=0.5)
    np.testing.assert_allclose(inv_mass[0], ref["jax_nuts_inv_mass"], rtol=0.5)

    # run_inference(mesh=): NS equal to the unsharded run, the others on
    # the analytic posterior with the JAX tests' gates
    assert o["ri_ns"]["logz"] == ref["ri_ns"]["logz"] and o["ri_ns"]["mww"]
    assert np.array_equal(o["ri_ns"]["samples"].numpy(), ref["ri_ns"]["samples"])
    assert o["ri_ns"]["mesh"] == {"axes": {"chains": world}, "shard_axes": "chains",
                                  "n_devices_sharded": world}
    post_var = 1.0 / (1.0 + 1.0 / SIGMA**2)
    post_mean = np.asarray(TARGET) * post_var / SIGMA**2
    np.testing.assert_allclose(o["ri_chees"]["mean"], post_mean, atol=0.08)
    np.testing.assert_allclose(o["ri_chees"]["stdev"], np.sqrt(post_var), atol=0.08)
    assert o["ri_chees"]["mesh"] == {"axes": {"hosts": 1, "chains": world},
                                     "shard_axes": ["hosts", "chains"],
                                     "n_devices_sharded": world}
    np.testing.assert_allclose(o["ri_smc_mean"], post_mean, atol=0.1)
    np.testing.assert_allclose(o["ri_nuts"]["mean"], post_mean, atol=0.1)
    assert o["ri_nuts"]["ncall"] > 0 and max(o["ri_nuts"]["rhat"]) < 1.1

    # run_inference_many(mesh=): the unsharded run's means (the JAX test's gate)
    for got, want in zip(o["many_means"], ref["many_means"]):
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# one process, no group
# ---------------------------------------------------------------------------


_LAUNCHERS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "SLURM_JOB_ID", "SLURM_NTASKS",
              "OMPI_COMM_WORLD_SIZE")


def test_initialize_distributed_without_environment(monkeypatch):
    """No launcher in the environment: no group, False, and no mesh from
    the driver helper; a one-task SLURM or Open MPI launch is no group
    either."""
    import torch.distributed as dist

    from pioran_tpu_torch import parallel as par

    for name in _LAUNCHERS:
        monkeypatch.delenv(name, raising=False)
    assert par.initialize_distributed() is False
    assert not dist.is_initialized()
    assert par.driver_mesh() is None and par.driver_mesh(n_devices=1) is None
    monkeypatch.setenv("SLURM_JOB_ID", "7")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "1")
    assert par.initialize_distributed() is False and not dist.is_initialized()


def test_meshes_need_a_group_and_processes(monkeypatch):
    """A mesh is made of processes: without a group make_mesh raises, and
    asking the driver helper for more devices than processes raises."""
    from pioran_tpu_torch import parallel as par

    for name in _LAUNCHERS:
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="not initialized"):
        par.make_mesh("chains", device_type="cpu")
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=4"):
        par.driver_mesh(n_devices=4)


def test_cuda_mesh_refuses_gloo():
    """No fallback: a CUDA mesh on a gloo group raises instead of running
    the card's collectives through the host."""
    from datetime import timedelta

    import torch.distributed as dist

    from pioran_tpu_torch import parallel as par

    par.initialize_distributed(init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
                               rank=0, timeout=timedelta(seconds=60))
    try:
        with pytest.raises(RuntimeError, match="needs the nccl backend"):
            par.make_mesh("chains", device_type="cuda")
        assert par.make_mesh("chains", device_type="cpu").size(0) == 1
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("env,expect", [
    ({"WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "2"}, (2, 4, 2)),
    ({"SLURM_JOB_ID": "1", "SLURM_NTASKS": "8", "SLURM_PROCID": "5", "SLURM_LOCALID": "1"},
     (5, 8, 1)),
    ({"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1",
      "OMPI_COMM_WORLD_LOCAL_RANK": "1"}, (1, 2, 1)),
])
def test_cluster_environments_are_detected(env, expect, monkeypatch):
    """torchrun, SLURM and Open MPI launches of several processes give
    (rank, world size, local rank), as the JAX package detects them."""
    from pioran_tpu_torch.parallel import mesh as pmesh

    for name in _LAUNCHERS:
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert pmesh._cluster_env() == expect


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
