#!/usr/bin/env python3
"""Drive the JAX package's ChEES transition and the port's with the same
random numbers on the full flagship (the simu.txt subset, J = 20, dense
metric, float64) and report where their leapfrog counts first part and
how their step sizes and trajectory lengths compare per 25-iteration
window.

    JAX_PLATFORMS=cpu python3 tools/chees_lockstep.py [--chains 128]
        [--warmup 500] [--seed 7] [--inits INITS.npy]     # both, on the CPU

Both start from the port's ADVI inits (``advi_seeded_inits``, seeded by
``--seed``, or the first C rows of ``--inits``). Before each iteration the
momentum normals and accept uniforms are derived from the JAX carry's key
as the JAX transition derives them and handed to the port in place of
its ``torch.randn`` / ``torch.rand`` draws (as
``tests/test_torch_chees_lockstep.py`` does). The JAX side runs as
``tests/test_torch_chees.py`` runs the flagship gradient
(``jax.vmap(jax.value_and_grad(logpost_unconstrained))`` inside the
jitted transition). The key is split the same way whatever the state,
so the two sides can also run apart, each recording every iteration to
``--out`` as it goes:

    JAX_PLATFORMS=cpu python3 tools/chees_lockstep.py draws --out D.npz
    JAX_PLATFORMS=cpu python3 tools/chees_lockstep.py jax --inits I.npy --out jax.json
    python3 tools/chees_lockstep.py port --inits I.npy --draws D.npz --device cuda --out port.json
    python3 tools/chees_lockstep.py compare jax.json port.json

(the port's side imports no JAX and runs on the card; at C = 128 and
N = 485 one float64 value and gradient takes about 3 s on a CPU core in
either package).

:func:`bf16_products` is the hypothesis check of a TPU's default matmul
precision: inside it, the port's ChEES velocity and kinetic-energy
products (a (C, dim) batch times the (dim, dim) metric factor) take their
operands rounded to bfloat16, as a float32 ``jnp`` matmul at default
precision does on a TPU. ``tools/chees_seeds.py --bf16`` runs the parity
leg under it on the card. This module imports JAX only in its JAX modes.
"""

import argparse
import contextlib
import json
import math
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@contextlib.contextmanager
def bf16_products(dim):
    """Rounds both operands of every ``(C, dim) @ (dim, dim)`` product to
    bfloat16 (the sum stays in the operands' type): the ChEES metric's
    velocity ``(r @ chol) @ chol.T`` and kinetic energy ``r @ chol``. The
    covariance ``zc.T @ zc`` ((dim, C) @ (C, dim)) and the likelihood's
    (J, J) products keep full precision."""
    orig = torch.Tensor.__matmul__

    def rnd(x):
        return x.to(torch.bfloat16).to(x.dtype)

    def matmul(a, b):
        if a.dim() == 2 and b.dim() == 2 and a.shape[1] == dim and tuple(b.shape) == (dim, dim) \
                and a.shape[0] != dim:
            return orig(rnd(a), rnd(b))
        return orig(a, b)

    torch.Tensor.__matmul__ = matmul
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = orig


class _Draws:
    """Hands out queued arrays in place of ``torch.randn`` / ``torch.rand``."""

    def __init__(self):
        self.queue = []

    def __call__(self, *shape, generator=None, dtype=None, device=None, **_):
        shape = tuple(shape[0]) if len(shape) == 1 and not isinstance(shape[0], int) else shape
        x = self.queue.pop(0)
        assert x.shape == shape, (x.shape, shape)
        return torch.as_tensor(x.copy(), dtype=dtype, device=device)


def _windows(x, w=25):
    return [float(np.exp(np.mean(np.log(x[k:k + w])))) for k in range(0, len(x), w)]


KEYS = ("it", "n", "eps", "tau", "acc")


def _setup(args, jax_side):
    """(the flagship's data, the JAX spec or None, C, dim, W)."""
    import chip_smoke as cs

    sub, xbar, va = cs.load_subset()
    sub = sub[:args.points]
    data = (sub[:, 0], sub[:, 1], sub[:, 2], xbar, va)
    jspec = None
    if jax_side:
        from pioran_tpu import inference as jinf
        jspec = jinf.single_bending_model(*data)
    return data, jspec, args.chains, 6, args.warmup


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def run_draws(args):
    """JAX's momentum normals and accept uniforms for every iteration:
    the carry's key is split the same way whatever the state, so the
    draws of a run do not depend on its trajectory."""
    jax = _jax()
    import jax.numpy as jnp
    C, W = args.chains, args.warmup
    key = jax.random.PRNGKey(args.seed)
    xs, us = [], []
    for _ in range(W):
        key, k_mom, k_acc = jax.random.split(key, 3)
        xs.append(np.asarray(jax.random.normal(k_mom, (C, 6), jnp.float64)))
        us.append(np.asarray(jax.random.uniform(k_acc, (C,), jnp.float64)))
    np.savez(args.out, normals=np.stack(xs), uniforms=np.stack(us))


def _record(path, rec, vals):
    for k, v in zip(KEYS, vals):
        rec[k].append(v)
    with open(path, "w") as fh:
        json.dump(rec, fh)
    print(json.dumps(dict(zip(KEYS, vals))), flush=True)


def run_jax(args, z0):
    """The JAX transition alone, free-running, one jitted iteration a call."""
    jax = _jax()
    import jax.numpy as jnp
    from pioran_tpu.samplers import chees as jchees
    _, jspec, C, dim, W = _setup(args, True)
    jtrans, jinit = jchees.make_chees_transition(
        jspec.logpost_unconstrained, C, dim, jnp.float64, W,
        max_leapfrogs=args.max_leapfrogs, mass="dense")
    jstep = jax.jit(jtrans)
    carry = jax.jit(jinit)(jnp.asarray(z0), jax.random.PRNGKey(args.seed), 0.1, 1.0)
    rec = {k: [] for k in KEYS}
    rec.update(side="jax", chains=C, warmup=W, seed=args.seed)
    t0 = time.time()
    for it in range(W):
        carry, out = jstep(carry, (jnp.asarray(it, jnp.int32), jnp.asarray(True)))
        rec["wall_s"] = time.time() - t0
        _record(args.out, rec, (it, int(out[3]), float(carry[3]), math.exp(float(carry[4])),
                                float(out[2])))


def run_port(args, z0):
    """The port's transition alone, on ``--device``, with JAX's draws from
    ``--draws`` in place of its own."""
    from pioran_tpu_torch import inference as tinf
    from pioran_tpu_torch.samplers import chees as tchees
    data, _, C, dim, W = _setup(args, False)
    dev = torch.device(args.device)
    tspec = tinf.single_bending_model(*data, dtype=torch.float64, device=dev)
    d = np.load(args.draws)
    draws = _Draws()
    for it in range(W):
        draws.queue += [d["normals"][it][:C], d["uniforms"][it][:C]]
    real = torch.randn, torch.rand
    torch.randn = torch.rand = draws
    try:
        ttrans, tinit = tchees.make_chees_transition(
            tspec.logpost_batch, C, dim, torch.float64, dev, W,
            max_leapfrogs=args.max_leapfrogs, mass="dense")
        state = tinit(torch.as_tensor(z0, device=dev), 0.1, 1.0)
        rec = {k: [] for k in KEYS}
        rec.update(side="port", chains=C, warmup=W, seed=args.seed, device=str(dev))
        t0 = time.time()
        for it in range(W):
            state, (_, _, acc, n) = ttrans(state, it, True, None)
            rec["wall_s"] = time.time() - t0
            _record(args.out, rec, (it, n, state["step_size"], math.exp(state["log_tau"]), acc))
    finally:
        torch.randn, torch.rand = real


def compare(a, b, max_leapfrogs=128):
    """Where two runs' leapfrog counts first part, and b's step size and
    trajectory length over a's, geometric means per 25 iterations, over
    the iterations both reached."""
    m = min(len(a["n"]), len(b["n"]))
    na, nb = np.asarray(a["n"][:m]), np.asarray(b["n"][:m])
    part = np.flatnonzero(na != nb)
    ratio = lambda k: _windows(np.asarray(b[k][:m]) / np.asarray(a[k][:m]))  # noqa: E731
    return {
        "iterations": m, "first_part": int(part[0]) if part.size else None,
        "eps_ratio_per_25": ratio("eps"), "tau_ratio_per_25": ratio("tau"),
        "leapfrogs_per_it": [float(na.mean()), float(nb.mean())],
        "n_at_cap": [int((na == max_leapfrogs).sum()), int((nb == max_leapfrogs).sum())],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="both",
                    choices=("both", "draws", "jax", "port", "compare"))
    ap.add_argument("files", nargs="*", help="compare: two records (JAX's, then the port's)")
    ap.add_argument("--chains", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--points", type=int, default=None, help="first points of the subset")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--max-leapfrogs", type=int, default=128)
    ap.add_argument("--inits", default=None,
                    help="a .npy of (C, 6) unconstrained starts (tools/chees_seeds.py "
                    "--save-inits writes the parity leg's from the card) in place of "
                    "running the port's ADVI seeding here")
    ap.add_argument("--draws", default=None, help="port: the draws file of the draws mode")
    ap.add_argument("--device", default="cpu", help="port: the device it runs on")
    ap.add_argument("--threads", type=int, default=2, help="torch CPU threads")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "chees_lockstep.json"))
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if args.mode == "compare":
        recs = []
        for f in args.files:
            with open(f) as fh:
                recs.append(json.load(fh))
        print(json.dumps(compare(*recs, args.max_leapfrogs)))
        return
    if args.mode == "draws":
        run_draws(args)
        return
    z0 = None
    if args.inits:
        z0 = np.load(args.inits)[:args.chains].astype(np.float64)
    if args.mode in ("jax", "port"):
        if z0 is None:
            raise SystemExit(f"{args.mode}: give --inits")
        (run_jax if args.mode == "jax" else run_port)(args, z0)
        return
    jax = _jax()
    import jax.numpy as jnp
    from pioran_tpu.samplers import chees as jchees
    from pioran_tpu_torch import inference as tinf
    from pioran_tpu_torch.samplers import chees as tchees

    data, jspec, C, dim, W = _setup(args, True)
    tspec = tinf.single_bending_model(*data, dtype=torch.float64, device="cpu")
    t0 = time.time()
    if z0 is None:
        z0 = tinf.advi_seeded_inits(tspec, torch.Generator().manual_seed(args.seed), C).numpy()
    advi_s = time.time() - t0

    jtrans, jinit = jchees.make_chees_transition(
        jspec.logpost_unconstrained, C, dim, jnp.float64, W,
        max_leapfrogs=args.max_leapfrogs, mass="dense")
    jstep = jax.jit(jtrans)
    carry = jax.jit(jinit)(jnp.asarray(z0), jax.random.PRNGKey(args.seed), 0.1, 1.0)
    draws = _Draws()
    real = torch.randn, torch.rand
    torch.randn = torch.rand = draws
    try:
        ttrans, tinit = tchees.make_chees_transition(
            tspec.logpost_batch, C, dim, torch.float64, "cpu", W,
            max_leapfrogs=args.max_leapfrogs, mass="dense")
        state = tinit(torch.as_tensor(z0), 0.1, 1.0)
        recs = [{k: [] for k in KEYS} for _ in range(2)]
        for it in range(W):
            _, k_mom, k_acc = jax.random.split(carry[9], 3)
            draws.queue += [np.asarray(jax.random.normal(k_mom, (C, dim), jnp.float64)),
                            np.asarray(jax.random.uniform(k_acc, (C,), jnp.float64))]
            carry, out = jstep(carry, (jnp.asarray(it, jnp.int32), jnp.asarray(True)))
            state, (_, _, acc, n) = ttrans(state, it, True, None)
            for rec, vals in zip(recs, (
                    (it, int(out[3]), float(carry[3]), math.exp(float(carry[4])), float(out[2])),
                    (it, n, state["step_size"], math.exp(state["log_tau"]), acc))):
                for k, v in zip(KEYS, vals):
                    rec[k].append(v)
            print(json.dumps({"it": it, "n_jax": int(out[3]), "n_port": n}), flush=True)
    finally:
        torch.randn, torch.rand = real
    summary = dict(compare(*recs, args.max_leapfrogs), advi_s=advi_s,
                   wall_s=time.time() - t0)
    with open(args.out, "w") as fh:
        json.dump({"jax": recs[0], "port": recs[1], "summary": summary}, fh)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
