"""PyTorch port parity: nested sampling.

The analytic-evidence toy of tests/test_ns.py through the port's
sampler, and the deterministic parts of the sampler (one NS step's
deletion and evidence bookkeeping, the final fold of the live set, the
equal-weight resampling) given the same state as the JAX package, via
``convert.ns_state_from_numpy``. float64 on CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu.samplers import ns as jns
from pioran_tpu.utils.insertion import insertion_order_test as j_insertion_test
from pioran_tpu_torch.convert import ns_state_from_numpy
from pioran_tpu_torch.samplers import ns as tns
from pioran_tpu_torch.utils.insertion import insertion_order_test as t_insertion_test

torch.set_num_threads(1)

DIM, SIGMA = 4, 0.05
LOGZ_TRUE = DIM * np.log(SIGMA * np.sqrt(2 * np.pi))


def _jloglike(U):
    return -0.5 * jnp.sum((U - 0.5) ** 2, axis=-1) / SIGMA**2


def _tloglike(U):
    return -0.5 * torch.sum((U - 0.5) ** 2, dim=-1) / SIGMA**2


@pytest.fixture(scope="module")
def toy_result():
    gen = torch.Generator().manual_seed(0)
    return tns.run_ns(_tloglike, gen, num_live=256, dim=DIM, n_delete=32,
                      num_mcmc=4, max_iters=400, frac_remain=1e-3)


def test_ns_evidence_matches_analytic(toy_result):
    res = toy_result
    err = float(res.logZ_err)
    assert 0.0 < err < 0.3
    assert abs(float(res.logZ) - LOGZ_TRUE) < 3 * err


def test_ns_counts_and_posterior(toy_result):
    res = toy_result
    it = res.num_iters
    assert 0 < it < 400
    assert res.num_dead == it * 32 + 256
    # the initial live set, then 2 n_expand + n_shrink = 16 sweeps per slice update
    assert res.ncall == 256 + it * 32 * 4 * 16
    idx = tns.equal_weight_indices(res.dead_logl, res.dead_logw, res.num_dead, 2000,
                                   generator=torch.Generator().manual_seed(1))
    assert int(idx.max()) < res.num_dead
    U = res.dead_u[idx].numpy()
    assert np.allclose(U.mean(axis=0), 0.5, atol=0.015)
    assert np.allclose(U.std(axis=0), SIGMA, rtol=0.25)
    ranks = res.insert_ranks.numpy()
    assert np.all(ranks[:it * 32] >= 0) and np.all(ranks[it * 32:] < 0)


def test_ns_rwm_move_runs_and_adapts():
    gen = torch.Generator().manual_seed(3)
    res = tns.run_ns(_tloglike, gen, num_live=128, dim=DIM, n_delete=16,
                     num_mcmc=12, move="rwm", max_iters=400, frac_remain=1e-2)
    assert res.ncall == 128 + res.num_iters * 16 * 12
    assert abs(float(res.logZ) - LOGZ_TRUE) < 3 * max(float(res.logZ_err), 0.15)


K, D, MAX_ITERS = 64, 8, 40


@pytest.fixture(scope="module")
def jax_states():
    """A JAX NS state after three steps, and after a fourth."""
    rng = np.random.default_rng(7)
    live_u = jnp.asarray(rng.uniform(size=(K, DIM)))
    st = jns._ns_init_state(live_u, _jloglike(live_u), jax.random.PRNGKey(2), K, D,
                            DIM, jnp.float64, MAX_ITERS, "slice")
    step = jax.jit(jns._make_ns_step(_jloglike, K, D, DIM, jnp.float64, 2, "slice",
                                     4, 8, MAX_ITERS))
    for _ in range(3):
        st = step(st)
    return [np.asarray(x) for x in st], [np.asarray(x) for x in step(st)]


def test_ns_step_bookkeeping_matches_jax(jax_states):
    """From the same state, the port's step deletes the same points and
    books the same weights and evidence as the JAX step; only the random
    replacements differ."""
    s3, s4 = jax_states
    dead_u_before = s3[6].copy()
    state = ns_state_from_numpy(s3, device="cpu")
    step = tns._make_ns_step(_tloglike, K, D, DIM, torch.float64, 2, "slice", 4, 8)
    out = step(state)
    # the step writes its own copy of the dead buffers, not the caller's arrays
    np.testing.assert_array_equal(s3[6], dead_u_before)
    assert out[4] == int(s4[4]) == 4
    assert out[11] == int(s4[11])
    rows = slice(3 * D, 4 * D)
    for i in (6, 7, 8):  # dead_u, dead_logl, dead_logw
        np.testing.assert_allclose(out[i][rows].numpy(), s4[i][rows], rtol=1e-12)
    for i in (2, 3):  # logX, logZ
        np.testing.assert_allclose(out[i].numpy(), s4[i], rtol=1e-12)
    # every replacement sits above the deletion threshold
    assert bool((out[1][-D:] > out[7][4 * D - 1]).all())


def test_ns_finalize_and_resampling_match_jax(jax_states):
    _, s4 = jax_states
    ref = jns._ns_finalize(tuple(jnp.asarray(x) for x in s4), K, D)
    res = tns._ns_finalize(ns_state_from_numpy(s4, device="cpu"), K, D)
    assert res.num_dead == int(ref.num_dead) and res.num_iters == int(ref.num_iters)
    for name in ("logZ", "logZ_err", "H", "logl_max", "dead_logl", "dead_logw", "dead_u"):
        np.testing.assert_allclose(getattr(res, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-12, err_msg=name)
    key = jax.random.PRNGKey(5)
    idx_ref = np.asarray(jns.equal_weight_indices(key, ref.dead_logl, ref.dead_logw,
                                                  ref.num_dead, 500))
    u0 = float(jax.random.uniform(key, ()))
    idx = tns.equal_weight_indices(res.dead_logl, res.dead_logw, res.num_dead, 500, u0=u0)
    np.testing.assert_array_equal(idx.numpy(), idx_ref)


def test_ns_state_from_numpy_layout(jax_states):
    s3, _ = jax_states
    gen = torch.Generator().manual_seed(9)
    st = ns_state_from_numpy(s3, generator=gen, device="cpu")
    assert st[5] is gen and isinstance(st[4], int) and isinstance(st[11], int)
    assert st[6].shape == (MAX_ITERS * D + K, DIM) and st[6].dtype == torch.float64
    with pytest.raises(ValueError, match="13 entries"):
        ns_state_from_numpy(s3[:12], device="cpu")


@pytest.mark.parametrize("kind", ["uniform", "biased", "padded"])
def test_insertion_test_copy_agrees(kind):
    rng = np.random.default_rng(0)
    n_slots = 448
    ranks = {"uniform": rng.integers(0, n_slots + 1, size=4000),
             "biased": rng.integers(0, (2 * n_slots) // 3, size=4000),
             "padded": np.concatenate([rng.integers(0, n_slots + 1, 3000),
                                       np.full(500, -1.0)])}[kind]
    out, ref = t_insertion_test(ranks, n_slots), j_insertion_test(ranks, n_slots)
    assert out.keys() == ref.keys()
    for k in ref:
        a, b = out[k], ref[k]
        assert a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b)), k


def test_run_ns_from_a_given_live_set_matches_jax():
    """Both packages' run_ns from one live set drawn with numpy: the first
    deletion takes the same points, and each evidence meets the toy's
    gate (the replacements' random streams differ). ns_init draws a set
    of that layout from the generator."""
    rng = np.random.default_rng(11)
    live_u = rng.uniform(size=(256, DIM))
    live_logl = np.array(_jloglike(jnp.asarray(live_u)))
    kw = dict(num_live=256, dim=DIM, n_delete=32, num_mcmc=4, max_iters=400, frac_remain=1e-3)
    ref = jns.run_ns(_jloglike, jax.random.PRNGKey(4),
                     live_init=(jnp.asarray(live_u), jnp.asarray(live_logl)), **kw)
    res = tns.run_ns(_tloglike, torch.Generator().manual_seed(4),
                     live_init=(torch.as_tensor(live_u), torch.as_tensor(live_logl)), **kw)
    np.testing.assert_array_equal(res.dead_u[:32].numpy(), np.asarray(ref.dead_u)[:32])
    np.testing.assert_array_equal(res.dead_logl[:32].numpy(), np.asarray(ref.dead_logl)[:32])
    for out in (res, ref):
        err = float(out.logZ_err)
        assert 0.0 < err < 0.3
        assert abs(float(out.logZ) - LOGZ_TRUE) < 3 * err
    assert abs(float(res.logZ) - float(ref.logZ)) < 3 * math.hypot(float(res.logZ_err),
                                                                    float(ref.logZ_err))
    u, logl = tns.ns_init(_tloglike, torch.Generator().manual_seed(4), 64, DIM, n_delete=16)
    assert u.shape == (64, DIM) and u.dtype == torch.float64
    torch.testing.assert_close(logl, _tloglike(u), rtol=0, atol=0)
