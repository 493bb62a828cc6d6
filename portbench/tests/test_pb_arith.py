"""The benchmark's arithmetic against hand-worked windows, and the
yardstick's counts at J = 20 and 40 against hand values."""

import math

import pytest

from portbench import counts, drive, stats
from portbench.harness import Ctx, load_reader


def _ctx(calls=(), fits=(), start=0.0, end=None):
    win = drive.Window(start=start, end=end if end is not None else start)
    win.calls = list(calls)
    win.fits = list(fits)
    return Ctx(workload={}, config={}, mix={}, setup_s=12.5, window=win, trace=None, terms=20,
               points=485, batch=4096)


def _call(t0, t1, t2, rows=4096, kind="grad"):
    return drive.Call(t0, t1, t2, rows, kind)


def test_percentile_interpolates_between_ranks():
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    assert stats.percentile([10, 20], 95) == pytest.approx(19.5)
    assert stats.percentile(list(range(1, 21)), 95) == pytest.approx(19.05)
    assert math.isnan(stats.percentile([], 95))


def test_rate_over_a_window_with_a_stall():
    # ten calls of 10 ms, a 100 ms stall, ten more: 20 calls in 0.3 s
    calls, t = [], 0.0
    for i in range(20):
        if i == 10:
            t += 0.1
        calls.append(_call(t, t + 0.004, t + 0.01))
        t += 0.01
    ctx = _ctx(calls, start=0.0, end=calls[-1].t_done)
    assert ctx.window.seconds == pytest.approx(0.3)
    rate = load_reader("e2e_metrics", "grad_evals_per_s")(ctx)
    assert rate == pytest.approx(20 * 4096 / 0.3)
    # the stall is not a call: the tail is of the calls
    p95 = load_reader("e2e_metrics", "call_ms_p95")(ctx)
    assert p95 == pytest.approx(10.0)
    # one slow call of 50 ms among 19 of 10 ms: p95 at rank 18.05 of 0..19
    calls[7] = _call(calls[7].t0, calls[7].t0 + 0.004, calls[7].t0 + 0.05)
    p95 = load_reader("e2e_metrics", "call_ms_p95")(_ctx(calls, end=calls[-1].t_done))
    assert p95 == pytest.approx(10.0 + 0.05 * 40.0)
    assert load_reader("e2e_metrics", "loglike_evals_per_s")(ctx) is None


def test_fit_s_counts_the_last_fit_to_its_end():
    # window of 10 s: fits of 4, 4 and 3.5 s; the third starts at 8 s
    # (inside) and ends at 11.5 s, so the window closes at 11.5 s
    fits = [drive.Fit(0.0, 4.0, 1, 14, 1014.0, [0.0] * 6, None, None, None),
            drive.Fit(4.0, 8.0, 2, 13, 1014.1, [0.0] * 6, None, None, None),
            drive.Fit(8.0, 11.5, 3, 12, 1013.9, [0.0] * 6, None, None, None)]
    ctx = _ctx(fits=fits, start=0.0, end=11.5)
    assert load_reader("e2e_metrics", "fit_s")(ctx) == pytest.approx(11.5 / 3)
    assert load_reader("layer_metrics", "smc.temper_steps")(ctx) == pytest.approx(13.0)
    assert load_reader("layer_metrics", "smc.temper_step_ms")(ctx) == pytest.approx(
        1e3 * 11.5 / 39)
    assert load_reader("e2e_metrics", "setup_s")(ctx) == 12.5


def test_host_issue_is_the_median_before_the_synchronize():
    calls = [_call(0.0, 0.003, 0.010), _call(0.01, 0.015, 0.02), _call(0.02, 0.024, 0.03)]
    ctx = _ctx(calls, end=0.03)
    assert load_reader("layer_metrics", "host_issue_ms.grad")(ctx) == pytest.approx(4.0)
    assert load_reader("layer_metrics", "host_issue_ms.sweep")(ctx) is None


@pytest.mark.parametrize("J,B,ops,nbytes", [
    # 20 J^2 B N; 4 (4 B J + N + 2 B N + B)
    (20, 4096, 20 * 400 * 4096 * 485, 4 * (4 * 4096 * 20 + 485 + 2 * 4096 * 485 + 4096)),
    (40, 1024, 20 * 1600 * 1024 * 485, 4 * (4 * 1024 * 40 + 485 + 2 * 1024 * 485 + 1024)),
])
def test_forward_cost(J, B, ops, nbytes):
    assert counts.forward_cost(B, J, 485) == (nbytes, ops)


@pytest.mark.parametrize("J,B", [(20, 4096), (40, 1024)])
def test_grad_cost_is_bound_by_operations_at_0_90_ms(J, B):
    nbytes, ops = counts.grad_cost(B, J, 485)
    assert ops == 76 * J * J * B * 485 == 60_391_424_000
    # reads 4BJ + N + 2BN, writes B + 4BJ + 2BN: no residual table
    assert nbytes == 4 * (8 * B * J + 485 + 4 * B * 485 + B)
    assert ops / counts.F32_OPS_S > nbytes / counts.HBM_BYTES_S
    assert counts.least_seconds(nbytes, ops) == pytest.approx(0.9013645e-3, rel=1e-6)
