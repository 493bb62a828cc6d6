"""PyTorch port: the time-sharded blockwise scan (``parallel/seq_scan.py``)
and the carry entries of K1, K3 and K4 it runs.

- The plain carry versions (``cuda_celerite._plain``,
  ``cuda_celerite_vjp.fwd_aug_plain`` and ``bwd_plain`` with a carry), the
  CPU side of the carry entries: a series split at 2 and 4 block
  boundaries, each block started from the carry the one before ended
  with, equals one pass in float64 within 1e-12 relative, at J = 3, 20,
  40 and 100 (past the registers).
- The forward carry after block 0 equals the carry of the JAX package's
  ``lax.scan(_uniform_step(suma), neutral, block 0)`` within 1e-12.
- The ring on gloo groups of 2 and 4 CPU processes (each rank a process
  of this file, as ``tests/test_torch_parallel.py`` launches them, with
  its timeouts), against the JAX package's ``logl_seq_sharded`` and
  ``logl_seq_pipelined`` on a ``jax.sharding.Mesh`` of the first 2 and 4
  of the conftest's 8 CPU devices, at B = 16, J = 3, N = 1024 and
  ``n_micro`` = 4: values within 1e-10 relative, gradient rows within
  1e-8, every rank's results bit-identical; the ``ValueError`` for an
  indivisible N and B; ``dt=`` and the padding of B = 5; one all-reduce
  a group, not one a call;
  ``single_bending_model(seq_mesh=)`` (SHO at 4 components, and
  DRWCelerite at 50, J = 100, past the registers) and
  ``carma_model(seq_mesh=)`` against the JAX package's unsharded specs; ``ops.celerite.logl``'s
  routing; and a short SMC fit through ``run_inference`` on a
  ``seq_mesh`` spec at N = 2048, on a group of 2 of its own (the fit's
  sweeps run the plain loops over every step of the series on every
  rank, about 15 s), started beside the others.

The file imports JAX only inside the tests, so its ranks start without it.
"""

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
WORLDS = (2, 4)
PIPE = dict(B=16, J=3, N=1024, n_micro=4)
# the builder past the registers: J = 2 x 50 terms on a series that both
# worlds divide
DRW = dict(N=256, n_components=50, B=3)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rel(x, ref) -> float:
    x, ref = torch.as_tensor(np.array(x)), torch.as_tensor(np.array(ref))
    return float(torch.max(torch.abs(x - ref)) / torch.max(torch.abs(ref)))


def _rel_rows(x, ref) -> float:
    """Largest 2-norm relative error over the leading axis."""
    x = torch.as_tensor(np.array(x), dtype=torch.float64)
    ref = torch.as_tensor(np.array(ref), dtype=torch.float64)
    x, ref = x.reshape(x.shape[0], -1), ref.reshape(ref.shape[0], -1)
    return float(((x - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-300)).max())


def _coefficients(B, J, N, seed, span=200.0):
    """(a, b, c, d, t, Y, S2) as numpy float64, the JAX tests' draws."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, span, N))
    a = np.abs(rng.normal(0.5, 0.2, (B, J)))
    b = 0.1 * np.abs(rng.normal(0.2, 0.1, (B, J)))
    c = np.abs(rng.normal(0.5, 0.2, (B, J)))
    d = np.abs(rng.normal(0.3, 0.1, (B, J)))
    Y = rng.normal(0, 1, (B, N))
    S2 = 0.1 + 0.02 * np.abs(rng.normal(size=(B, N)))
    return a, b, c, d, t, Y, S2


def _tiled_simu(n):
    """The first n points of simu.txt repeated end to end (the JAX test's
    512-point series)."""
    A = np.loadtxt(os.path.join(DATA, "simu.txt"))
    reps = -(-n // len(A))
    t = np.concatenate([A[:, 0] + i * (A[-1, 0] + 1.0) for i in range(reps)])[:n]
    return t, np.tile(A[:, 1], reps)[:n], np.tile(A[:, 2], reps)[:n]


def _long_series(n, seed):
    """Exponential gaps and a log-normal flux (the JAX CARMA test's)."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(0.5 + rng.exponential(0.5, n))
    t -= t[0]
    y = np.exp(0.2 * rng.normal(size=n) + 1.0)
    return t, y, 0.02 * y


SB_TH = [[0.6, 2.5, 0.004, 0.02, 1.1, 0.0], [0.8, 3.0, 0.002, 0.05, 0.9, 0.1],
         [0.4, 2.0, 0.008, 0.01, 1.3, -0.1], [0.7, 2.2, 0.003, 0.03, 1.0, 0.0],
         [0.5, 2.8, 0.005, 0.04, 1.2, 0.0]]  # mu as an offset from xbar


def _sb_theta(yy):
    th = np.asarray(SB_TH)
    th[:, 5] += float(np.mean(np.log(yy)))
    return th


# ---------------------------------------------------------------------------
# the plain carry versions, in this process
# ---------------------------------------------------------------------------


def _split_plain(args, dtg, nb, g, kc=8):
    """The plain carry versions over nb blocks: (ll of K1, ll of K3, the
    per-step residuals W0, W1, pre0, pre1, D, zp, the 7 cotangents)."""
    from pioran_tpu_torch.ops import cuda_celerite as cc, cuda_celerite_vjp as vjp

    a, b, c, d, t, y, s2 = args
    B, J = a.shape
    N = t.shape[0]
    K = N // nb
    blocks = [slice(k * K, (k + 1) * K) for k in range(nb)]
    c1 = c3 = vjp.neutral_carry(B, J, a)
    p1, p3, saved = [], [], []
    for sl in blocks:
        xs = (a, b, c, d, t[sl], y[:, sl], s2[:, sl], dtg[sl])
        p, c1 = cc.loglike_carry(*xs, c1)
        q, c3, res = vjp.fwd_aug_carry(*xs, c3, kc)
        p1.append(p)
        p3.append(q)
        saved.append(res)
    ll = [-0.5 * (sum(p[:, 0] for p in ps) + sum(p[:, 1] for p in ps) + N * np.log(2 * np.pi))
          for ps in (p1, p3)]
    res = [torch.cat([r[i] for r in saved], dim=1) for i in range(6)]
    ain = a.new_zeros(B, vjp.adjoint_width(J))
    outs = [None] * nb
    for k in reversed(range(nb)):
        sl = blocks[k]
        outs[k] = vjp.bwd_carry(a, b, c, d, t[sl], y[:, sl], s2[:, sl], saved[k], g, dtg[sl],
                                ain, kc)
        ain = outs[k][-1]
    coefs = [sum(o[i] for o in outs) for i in range(4)]
    tb, dtb = torch.cat([o[4] for o in outs]), torch.cat([o[5] for o in outs])
    tbar = tb + dtb - torch.cat([dtb[1:], dtb.new_zeros(1)])
    grads = (*coefs, tbar, torch.cat([o[6] for o in outs], 1), torch.cat([o[7] for o in outs], 1))
    return ll[0], ll[1], res, grads


@pytest.mark.parametrize("nb", [2, 4])
@pytest.mark.parametrize("J", [3, 20, 40, 100])
def test_plain_carry_split_equals_one_pass(J, nb):
    """K1's, K3's and K4's plain carry versions over nb blocks (of 12 or
    24 steps, not a whole number of kc = 8 chunks) against one pass of
    the plain versions: values, residual rows and every cotangent, float64
    within 1e-12 relative."""
    from pioran_tpu_torch.ops import cuda_celerite as cc, cuda_celerite_vjp as vjp

    N = 48
    a, b, c, d, t, y, s2 = (torch.as_tensor(x) for x in _coefficients(3, J, N, seed=J, span=40.0))
    a, b = a / J, b / J  # b with a, so the kernel stays positive definite at every J
    args = (a, b, c, d, t, y, s2)
    dt = torch.diff(t)
    dtg = torch.cat([dt.new_zeros(1), dt])
    g = torch.tensor([1.0, -0.5, 2.0], dtype=torch.float64)
    ll1 = cc.batched_loglike_plain(*args, dt)
    ll3, res = vjp.fwd_aug_plain(*args, dt)
    grads = vjp.bwd_plain(*args, res, g, dt)
    assert bool(torch.isfinite(ll1).all())
    s1, s3, sres, sgrads = _split_plain(args, dtg, nb, g)
    assert _rel(s1, ll1) <= 1e-12 and _rel(s3, ll3) <= 1e-12
    for x, r in zip(sres, res[:6]):
        assert _rel(x, r) <= 1e-12
    for x, r in zip(sgrads, grads):
        assert _rel(x, r) <= 1e-12


@pytest.mark.parametrize("J", [3, 20, 100])
def test_carry_out_matches_jax_uniform_scan(J):
    """Block 0's forward carry out, against the carry of the JAX package's
    ``lax.scan(_uniform_step(suma), neutral, block 0)`` on the same
    chain's interleaved tables, within 1e-12."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from pioran_tpu.ops.celerite import exp_neg as jexp_neg
    from pioran_tpu.parallel.seq_scan import _uniform_step
    from pioran_tpu_torch.ops import cuda_celerite as cc, cuda_celerite_vjp as vjp

    B, N, K = 2, 96, 32
    a, b, c, d, t, y, s2 = _coefficients(B, J, N, seed=7 + J, span=60.0)
    a = a / J
    dtg = np.concatenate([[0.0], np.diff(t)])
    tt = [torch.as_tensor(x) for x in (a, b, c, d, t, y, s2)]
    _, carry = cc.loglike_carry(*tt[:4], tt[4][:K], tt[5][:, :K], tt[6][:, :K],
                                torch.as_tensor(dtg[:K]), vjp.neutral_carry(B, J, tt[0]))
    S00, S01, S11, W0, W1, f0, f1, D, zp = vjp.carry_state(carry, J)
    perm = np.concatenate([np.arange(0, 2 * J, 2), np.arange(1, 2 * J, 2)])
    R = 2 * J

    @jax.jit
    def scan(am, bm, cm, dm, tk, dtk, yk, sk):
        td = tk[:, None] * dm[None, :]
        co, si = jnp.cos(td), jnp.sin(td)
        ec = jexp_neg(dtk[:, None] * cm[None, :])
        U = jnp.stack([am * co + bm * si, am * si - bm * co], axis=-1).reshape(K, R)
        V = jnp.stack([co, si], axis=-1).reshape(K, R)
        phi = jnp.stack([ec, ec], axis=-1).reshape(K, R)
        neutral = (jnp.zeros((R, R)), jnp.zeros(R), jnp.zeros(()), jnp.zeros(R), jnp.zeros(()))
        out, _ = lax.scan(_uniform_step(jnp.sum(am)), neutral, (U, V, phi, sk, yk))
        return out

    for i in range(B):
        S, W, Dj, f, zpj = (np.asarray(x) for x in scan(a[i], b[i], c[i], d[i], t[:K], dtg[:K],
                                                       y[i, :K], s2[i, :K]))
        Sb = S[perm][:, perm]
        for x, ref in ((S00[i], Sb[:J, :J]), (S01[i], Sb[:J, J:]), (S11[i], Sb[J:, J:]),
                       (torch.cat([W0[i], W1[i]]), W[perm]), (torch.cat([f0[i], f1[i]]), f[perm]),
                       (D[i:i + 1], [Dj]), (zp[i:i + 1], [zpj])):
            assert _rel(x, ref) <= 1e-12


def test_carry_entries_refuse_bad_inputs():
    """The carry entries' wrappers take a shared grid, dt (N,) and a carry
    of their width, and raise ``ValueError`` otherwise; ``run_block``
    keeps residuals only for a gradient."""
    from pioran_tpu_torch.ops import cuda_celerite as cc, cuda_celerite_vjp as vjp
    from pioran_tpu_torch.parallel.seq_scan import run_block

    a, b, c, d, t, y, s2 = (torch.as_tensor(x) for x in _coefficients(2, 3, 20, seed=1))
    dtg = torch.cat([torch.zeros(1, dtype=t.dtype), torch.diff(t)])
    carry = vjp.neutral_carry(2, 3, a)
    assert carry.shape == (2, vjp.carry_width(3)) == (2, 3 * 9 + 12 + 2)
    with pytest.raises(ValueError, match="dt"):
        cc.loglike_carry(a, b, c, d, t, y, s2, dtg[1:], carry)
    with pytest.raises(ValueError, match="carry"):
        vjp.fwd_aug_carry(a, b, c, d, t, y, s2, dtg, carry[:, 1:])
    with pytest.raises(ValueError, match="shared grid"):
        cc.loglike_carry(a, b, c, d, t.expand(2, -1), y, s2, dtg, carry)
    parts, cout, res = run_block(a, b, c, d, t, y, s2, dtg, carry, grad=False)
    assert res is None and parts.shape == (2, 3) and cout.shape == carry.shape
    parts3, cout3, res3 = run_block(a, b, c, d, t, y, s2, dtg, carry, grad=True)
    assert len(res3) == 7 and torch.equal(cout3, cout)
    assert torch.allclose(parts3, parts, rtol=1e-14, atol=0)
    with pytest.raises(ValueError, match="carry"):
        vjp.bwd_carry(a, b, c, d, t, y, s2, res3, torch.ones(2, dtype=a.dtype), dtg, carry)


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------


def _spy(module, name, calls):
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)

    setattr(module, name, spy)


def _worker(rank: int, world: int, out_dir: str, role: str) -> None:
    """One rank: every seq check (``role`` "checks") or the SMC fit
    ("smc"), its results saved for the test."""
    from datetime import timedelta

    import torch.distributed as dist

    from pioran_tpu_torch import parallel as par

    par.initialize_distributed(timeout=timedelta(seconds=120))
    mesh = par.make_mesh("seq", device_type="cpu")
    out = {"rank_on_axis": mesh.get_local_rank("seq")}
    if role == "smc":
        _smc_fit(mesh, world, out_dir, out)
    else:
        _checks(mesh, out)
    torch.save(out, os.path.join(out_dir, f"{role}{world}_{rank}.pt"))
    dist.destroy_process_group()


def _checks(mesh, out):
    """The seq path's values, gradients, errors, routing and builders."""
    from pioran_tpu_torch import carma_model, single_bending_model
    from pioran_tpu_torch import inference as tinf
    from pioran_tpu_torch import parallel as par
    from pioran_tpu_torch.ops import celerite as ocel
    from pioran_tpu_torch.parallel import seq_scan

    import torch.distributed as dist

    f64 = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    # the pipelined batch: values and the gradient of their sum; the
    # all-reduces the ring makes over these calls counted
    a, b, c, d, t, Y, S2 = (f64(x) for x in _coefficients(PIPE["B"], PIPE["J"], PIPE["N"], 5))
    reduces = []
    _spy(dist, "all_reduce", reduces)
    leaves = [x.clone().requires_grad_(True) for x in (a, b, c, d, t, Y, S2)]
    ll = par.logl_seq_pipelined(*leaves, mesh, n_micro=PIPE["n_micro"])
    (ll.sum()).backward()
    out["pipe_ll"] = ll.detach()
    out["pipe_grads"] = [x.grad for x in leaves]
    with torch.no_grad():
        out["pipe_ll_nograd"] = par.logl_seq_pipelined(a, b, c, d, t, Y, S2, mesh,
                                                       n_micro=PIPE["n_micro"])
    # with host spacings, no gradient
    out["pipe_ll_dt"] = par.logl_seq_pipelined(a, b, c, d, t, Y, S2, mesh, n_micro=2,
                                               dt=np.diff(t.numpy()))

    # one chain: value and gradient
    one = [x.clone().requires_grad_(True) for x in (a[0], b[0], c[0], d[0], Y[0], S2[0])]
    v = par.logl_seq_sharded(*one[:4], t, one[4], one[5], mesh)
    v.backward()
    out["one_ll"], out["one_grads"] = v.detach(), [x.grad for x in one]
    D, zp = par.factor_solve_seq_sharded(a[0], b[0], c[0], d[0], t, Y[0], S2[0], mesh)
    out["factor"] = (D, zp)
    out["all_reduces"] = len(reduces)

    # ops.celerite.logl's routing: from SEQ_SHARD_MIN_N (8192) on by
    # default, from seq_min_n if given, and only where N divides
    calls = []
    _spy(seq_scan, "logl_seq_sharded", calls)
    out["logl_routed"] = ocel.logl(a[:2], b[:2], c[:2], d[:2], t, Y[:2], S2[:2], mesh=mesh,
                                   seq_min_n=0)
    routed = list(calls)
    out["logl_short"] = ocel.logl(a[0], b[0], c[0], d[0], t, Y[0], S2[0], mesh=mesh)
    ocel.logl(a[0], b[0], c[0], d[0], t[:1023], Y[0, :1023], S2[0, :1023], mesh=mesh,
              seq_min_n=0)
    out["routing"] = [routed, list(calls)]

    def raises(fn, what):
        try:
            fn()
        except ValueError as err:
            return what in str(err)
        return False

    n_odd = 1023  # divisible by neither 2 nor 4
    out["errors"] = [
        raises(lambda: par.logl_seq_pipelined(a[:, :n_odd], b, c, d, t[:n_odd], Y[:, :n_odd],
                                              S2[:, :n_odd], mesh), "not divisible"),
        raises(lambda: par.logl_seq_pipelined(a[:6], b[:6], c[:6], d[:6], t, Y[:6], S2[:6],
                                              mesh, n_micro=4), "not divisible"),
        raises(lambda: par.logl_seq_sharded(a[0], b[0], c[0], d[0], t[:n_odd], Y[0, :n_odd],
                                            S2[0, :n_odd], mesh), "not divisible"),
    ]

    # the builders on a seq mesh
    tt, yy, ee = _tiled_simu(512)
    xbar, va = float(np.mean(np.log(yy))), float(np.var(np.log(yy)))
    spec = single_bending_model(tt, yy, ee, xbar, va, n_components=4, device="cpu",
                                dtype=torch.float64, seq_mesh=mesh)
    TH = f64(_sb_theta(yy))
    out["sb_batch"] = spec.loglike_batch(TH)  # B = 5: padded to a multiple of the axis
    out["sb_one"] = torch.stack([spec.loglike(th) for th in TH])
    Z = spec.prior.to_unconstrained(TH).requires_grad_(True)
    lp = spec.logpost_batch(Z)
    out["sb_lp"], out["sb_grad"] = lp.detach(), torch.autograd.grad(lp.sum(), Z)[0]
    # past the registers: DRWCelerite at 50 components (J = 100), B = 3
    td, yd, ed = _tiled_simu(DRW["N"])
    dspec = single_bending_model(td, yd, ed, float(np.mean(np.log(yd))),
                                 float(np.var(np.log(yd))), basis_function="DRWCelerite",
                                 n_components=DRW["n_components"], device="cpu",
                                 dtype=torch.float64, seq_mesh=mesh)
    THd = f64(_sb_theta(yd)[:DRW["B"]])
    out["drw_batch"] = dspec.loglike_batch(THd)
    out["drw_one"] = torch.stack([dspec.loglike(th) for th in THd])
    Zd = dspec.prior.to_unconstrained(THd).requires_grad_(True)
    lpd = dspec.logpost_batch(Zd)
    out["drw_lp"], out["drw_grad"] = lpd.detach(), torch.autograd.grad(lpd.sum(), Zd)[0]
    tc, yc, ec = _long_series(1024, 3)
    xc, vc = float(np.mean(np.log(yc))), float(np.var(np.log(yc)))
    cspec = carma_model(tc, yc, ec, xc, vc, p=2, q=1, device="cpu", dtype=torch.float64,
                        seq_mesh=mesh)
    thc = cspec.prior.sample((2,), generator=torch.Generator().manual_seed(0),
                             dtype=torch.float64)
    out["carma_th"] = thc
    out["carma_one"] = cspec.loglike(thc[0])
    out["carma_batch"] = cspec.loglike_batch(thc)
    out["spec_errors"] = [
        raises(lambda: single_bending_model(tt[:511], yy[:511], ee[:511], xbar, va,
                                            n_components=4, device="cpu", seq_mesh=mesh),
               "not divisible"),
        raises(lambda: tinf.run_inference(spec, sampler="smc", mesh=mesh, num_particles=16),
               "seq_mesh")]


def _smc_fit(mesh, world, out_dir, out):
    """A short SMC fit on a seq_mesh spec at N = 2048 (20 % errors, so that
    the tempering takes few steps)."""
    from pioran_tpu_torch import inference as tinf, single_bending_model

    tl, yl, _ = _long_series(2048, 0)
    lspec = single_bending_model(tl, yl, 0.2 * yl, float(np.mean(np.log(yl))),
                                 float(np.var(np.log(yl))), n_components=4, device="cpu",
                                 dtype=torch.float64, seq_mesh=mesh)
    log_dir = os.path.join(out_dir, f"seq_smc_{world}")
    res = tinf.run_inference(lspec, sampler="smc", seed=0, num_particles=16, num_moves=1,
                             smc_move="rwm", log_dir=log_dir)
    out["smc"] = {"logz": res["logz"], "samples": torch.as_tensor(res["samples"]),
                  "written": os.path.isfile(os.path.join(log_dir, "info", "results.json"))}


# ---------------------------------------------------------------------------
# the launches and their gates
# ---------------------------------------------------------------------------


def _start(world: int, out_dir: str, role: str):
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT)
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                              out_dir, role], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _finish(procs, world: int, out_dir: str, role: str):
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
    return [torch.load(os.path.join(out_dir, f"{role}{world}_{r}.pt"), weights_only=True)
            for r in range(world)]


def _references():
    """The JAX package's seq paths on meshes of its first 2 and 4 CPU
    devices, and its unsharded specs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from pioran_tpu.inference import carma_model as jcarma, single_bending_model as jsb
    from pioran_tpu.parallel.seq_scan import (
        factor_solve_seq_sharded, logl_seq_pipelined, logl_seq_sharded)

    a, b, c, d, t, Y, S2 = (jnp.asarray(x) for x in _coefficients(PIPE["B"], PIPE["J"],
                                                                  PIPE["N"], 5))
    ref = {}
    for world in WORLDS:
        mesh = Mesh(np.array(jax.devices()[:world]), ("seq",))

        def pipe(*args, mesh=mesh):
            ll = logl_seq_pipelined(*args, mesh=mesh, n_micro=PIPE["n_micro"])
            return jnp.sum(ll), ll

        (_, ll), grads = jax.jit(jax.value_and_grad(pipe, argnums=tuple(range(7)),
                                                    has_aux=True))(a, b, c, d, t, Y, S2)
        ll_dt = jax.jit(lambda *args, mesh=mesh: logl_seq_pipelined(
            *args, mesh=mesh, n_micro=2, dt=jnp.diff(t)))(a, b, c, d, t, Y, S2)

        def one(aa, bb, cc, dd, yy, ss, mesh=mesh):
            return logl_seq_sharded(aa, bb, cc, dd, t, yy, ss, mesh)

        v, g1 = jax.jit(jax.value_and_grad(one, argnums=tuple(range(6))))(
            a[0], b[0], c[0], d[0], Y[0], S2[0])
        D, zp = jax.jit(lambda *args, mesh=mesh: factor_solve_seq_sharded(
            *args, mesh=mesh))(a[0], b[0], c[0], d[0], t, Y[0], S2[0])
        ref[world] = {"pipe_ll": np.asarray(ll), "pipe_grads": [np.asarray(x) for x in grads],
                      "pipe_ll_dt": np.asarray(ll_dt), "one_ll": float(v),
                      "one_grads": [np.asarray(x) for x in g1],
                      "factor": (np.asarray(D), np.asarray(zp))}
    tt, yy, ee = _tiled_simu(512)
    spec = jsb(tt, yy, ee, float(np.mean(np.log(yy))), float(np.var(np.log(yy))),
               n_components=4)
    TH = jnp.asarray(_sb_theta(yy))
    ref["sb"] = np.asarray(jax.jit(jax.vmap(spec.loglike))(TH))
    Z = jax.vmap(spec.prior.to_unconstrained)(TH)
    lp_fn = jax.jit(jax.value_and_grad(spec.logpost_unconstrained))
    rows = [lp_fn(z) for z in Z]
    ref["sb_lp"] = np.asarray([float(r[0]) for r in rows])
    ref["sb_grad"] = np.stack([np.asarray(r[1]) for r in rows])
    td, yd, ed = _tiled_simu(DRW["N"])
    dspec = jsb(td, yd, ed, float(np.mean(np.log(yd))), float(np.var(np.log(yd))),
                basis_function="DRWCelerite", n_components=DRW["n_components"])
    THd = jnp.asarray(_sb_theta(yd)[:DRW["B"]])
    ref["drw"] = np.asarray(jax.jit(jax.vmap(dspec.loglike))(THd))
    lp_fn = jax.jit(jax.value_and_grad(dspec.logpost_unconstrained))
    rows = [lp_fn(z) for z in jax.vmap(dspec.prior.to_unconstrained)(THd)]
    ref["drw_lp"] = np.asarray([float(r[0]) for r in rows])
    ref["drw_grad"] = np.stack([np.asarray(r[1]) for r in rows])
    tc, yc, ec = _long_series(1024, 3)
    ref["carma_spec"] = jcarma(tc, yc, ec, float(np.mean(np.log(yc))),
                               float(np.var(np.log(yc))), p=2, q=1)
    return ref


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both world sizes' checks and the SMC fit run at once; the JAX
    references run here meanwhile."""
    out_dir = str(tmp_path_factory.mktemp("seq"))
    groups = [(w, "checks") for w in WORLDS] + [(2, "smc")]
    procs = {g: _start(*g[:1], out_dir, g[1]) for g in groups}
    try:
        ref = _references()
    finally:
        outs = {g: _finish(p, g[0], out_dir, g[1]) for g, p in procs.items()}
    return outs, ref


def _flat(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _flat(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _flat(item)]
    return [x]


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_bits(world, launched):
    outs = launched[0][(world, "checks")]
    assert [o["rank_on_axis"] for o in outs] == list(range(world))
    for other in outs[1:]:
        for k, v in outs[0].items():
            if k == "rank_on_axis":
                continue
            for x, y in zip(_flat(v), _flat(other[k]), strict=True):
                if isinstance(x, torch.Tensor):
                    assert torch.equal(x, y), k
                else:
                    assert x == y, k


@pytest.mark.parametrize("world", WORLDS)
def test_the_ring_sets_up_its_group_once(world, launched):
    """Five seq calls on one group make one all-reduce (the collective
    that sets up the group's communicator), not one a call."""
    for o in launched[0][(world, "checks")]:
        assert o["all_reduces"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_pipelined_values_match_jax(world, launched):
    o, ref = launched[0][(world, "checks")][0], launched[1][world]
    assert _rel(o["pipe_ll"], ref["pipe_ll"]) <= 1e-10
    assert torch.equal(o["pipe_ll"], o["pipe_ll_nograd"])  # K3's value is K1's
    assert _rel(o["pipe_ll_dt"], ref["pipe_ll_dt"]) <= 1e-10


@pytest.mark.parametrize("world", WORLDS)
def test_pipelined_gradient_matches_jax(world, launched):
    """ā, b̄, c̄, d̄, ȳ and σ̄² row by row, and t̄, against jax.grad through
    the JAX package's pipelined scan."""
    o, ref = launched[0][(world, "checks")][0], launched[1][world]
    for i, (x, r) in enumerate(zip(o["pipe_grads"], ref["pipe_grads"])):
        err = _rel_rows(x[None], r[None]) if i == 4 else _rel_rows(x, r)
        assert err <= 1e-8, i


@pytest.mark.parametrize("world", WORLDS)
def test_one_chain_matches_jax(world, launched):
    o, ref = launched[0][(world, "checks")][0], launched[1][world]
    assert abs(float(o["one_ll"]) / ref["one_ll"] - 1.0) <= 1e-10
    for x, r in zip(o["one_grads"], ref["one_grads"]):
        assert _rel_rows(x[None], r[None]) <= 1e-8
    for x, r in zip(o["factor"], ref["factor"]):
        assert _rel(x, r) <= 1e-10


@pytest.mark.parametrize("world", WORLDS)
def test_indivisible_n_and_b_raise_and_logl_routes(world, launched):
    o = launched[0][(world, "checks")][0]
    assert all(o["errors"]) and all(o["spec_errors"]), (o["errors"], o["spec_errors"])
    # seq_min_n=0 routes; N = 1024 < SEQ_SHARD_MIN_N does not; N = 1023 does not divide
    assert o["routing"] == [["logl_seq_sharded"], ["logl_seq_sharded"]]
    assert _rel(o["logl_routed"], o["pipe_ll"][:2]) <= 1e-12
    assert _rel(o["logl_short"], o["pipe_ll"][0]) <= 1e-12


@pytest.mark.parametrize("world", WORLDS)
def test_builders_on_a_seq_mesh_match_jax(world, launched):
    """single_bending_model(seq_mesh=) (B = 5, padded) and
    carma_model(seq_mesh=) against the JAX package's unsharded specs."""
    import jax
    import jax.numpy as jnp

    o, ref = launched[0][(world, "checks")][0], launched[1]
    assert o["sb_batch"].shape == (5,)
    assert _rel(o["sb_batch"], ref["sb"]) <= 1e-10
    assert _rel(o["sb_one"], ref["sb"]) <= 1e-10
    assert _rel(o["sb_lp"], ref["sb_lp"]) <= 1e-10
    assert _rel_rows(o["sb_grad"], ref["sb_grad"]) <= 1e-8
    spec = ref["carma_spec"]
    th = jnp.asarray(o["carma_th"].numpy())
    want = np.asarray(jax.jit(jax.vmap(spec.loglike))(th))
    assert np.isfinite(want).all()
    assert _rel(o["carma_batch"], want) <= 1e-10
    assert abs(float(o["carma_one"]) / want[0] - 1.0) <= 1e-10


@pytest.mark.parametrize("world", WORLDS)
def test_builder_past_64_terms_on_a_seq_mesh_matches_jax(world, launched):
    """single_bending_model(basis_function="DRWCelerite", n_components=50,
    seq_mesh=) (J = 100: the carry entries past the registers on the card,
    their plain versions here) against the JAX package's unsharded spec:
    loglike_batch, loglike and logpost_batch within 1e-10 relative, the
    gradient rows within 1e-8 (jax.grad row by row)."""
    o, ref = launched[0][(world, "checks")][0], launched[1]
    assert o["drw_batch"].shape == (DRW["B"],) and np.isfinite(ref["drw"]).all()
    assert _rel(o["drw_batch"], ref["drw"]) <= 1e-10
    assert _rel(o["drw_one"], ref["drw"]) <= 1e-10
    assert _rel(o["drw_lp"], ref["drw_lp"]) <= 1e-10
    assert _rel_rows(o["drw_grad"], ref["drw_grad"]) <= 1e-8


def test_smc_fit_on_a_seq_mesh(launched):
    outs = launched[0][(2, "smc")]
    for other in outs[1:]:
        assert other["smc"]["logz"] == outs[0]["smc"]["logz"]
        assert torch.equal(other["smc"]["samples"], outs[0]["smc"]["samples"])
    o = outs[0]["smc"]
    assert np.isfinite(o["logz"]) and bool(torch.isfinite(o["samples"]).all())
    assert bool((o["samples"][:, 3] > 0).all())  # the variance
    assert o["written"]  # rank 0 of the axis wrote the files


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
