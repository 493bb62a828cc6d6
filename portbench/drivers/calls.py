"""The ``calls`` kind: a closed loop of one caller, one call in flight and
a synchronize after each, through one entry of the program's model spec.

Mix keys: ``program``, the spec's method (``logpost_batch``,
``loglike_batch``, ...); ``reference``, the reference model's method that
computes the same values; ``grad``, whether a call returns the gradient
with respect to its rows too (the program's ``batch_value_and_grad``, as
every gradient sampler calls it); ``space``, ``unconstrained`` where the
entry takes unconstrained rows (mapped by the program's prior) or
``theta``; ``batch`` rows a call, drawn as a pool of ``pool`` batches at
set-up, ``row_sd`` referee standard deviations around the referee
posterior (the reference module's ``rows``), and cycled; ``warm_calls``
calls of set-up.

The check compares ``value_rows`` rows drawn from the seed over the pool's
last answers, the first ``grad_rows`` of them for the gradients
(``limits/<workload>.json``, ``check``).
"""

from __future__ import annotations

import math
import time
from typing import Callable

import torch

from portbench import check, data, drive
from portbench.reference.celerite import values, values_and_grads


class Driver:
    def __init__(self, spec, model, config, mix, seed, annotate):
        self.spec, self.mix, self.annotate = spec, mix, annotate
        self.kind = "grad" if mix["grad"] else "sweep"
        fn = getattr(spec, mix["program"])
        if mix["grad"]:
            from pioran_tpu_torch.samplers.chees import batch_value_and_grad

            self.fn = lambda X: batch_value_and_grad(fn, X)
        else:
            def sweep(X):
                with torch.no_grad():
                    return fn(X), None
            self.fn = sweep
        referee = data.load_json(config["referee"])
        dev, dt = spec.device, spec.dtype
        gen = torch.Generator(device=dev).manual_seed(data.derived_seed(seed, "rows"))
        B, P = mix["batch"], mix["pool"]
        th = check.reference_module(config).rows(model, referee, B * P, mix["row_sd"], gen,
                                                 dt, dev)
        X = spec.prior.to_unconstrained(th) if mix["space"] == "unconstrained" else th
        self.pool = list(X.reshape(P, B, -1).unbind(0))
        for _ in range(mix.get("warm_calls", 2)):
            self.fn(self.pool[0])
        drive.sync(dev)

    def window(self, win: drive.Window, seconds: float, on_unit: Callable):
        dev = self.spec.device
        P = len(self.pool)
        win.start = time.perf_counter()
        end_at = win.start + seconds
        i = 0
        while True:
            X = self.pool[i % P]
            t0 = time.perf_counter()
            try:
                with self.annotate("pb.call." + self.kind):
                    value, grad = self.fn(X)
                    t1 = time.perf_counter()
                    drive.sync(dev)
            except RuntimeError:
                win.failed += 1
                value = grad = None
                t1 = time.perf_counter()
            t2 = time.perf_counter()
            win.calls.append(drive.Call(t0, t1, t2, X.shape[0], self.kind))
            win.outputs[i % P] = (X, value, grad)
            win.attempted += 1
            i += 1
            on_unit(t2)
            if t2 >= end_at:
                break
        win.end = t2

    def close(self):
        pass


class CallSample:
    """The compared rows of the window's answers: ``value_rows`` rows drawn
    from the seed over the pool's last answers, the first ``grad_rows`` of
    them for the gradients."""

    def __init__(self, outputs: dict, seed: int, plan: dict):
        slots = [outputs[k] for k in sorted(outputs)]
        X = torch.cat([x for x, _, _ in slots])
        self.answered = all(v is not None for _, v, _ in slots)
        gen = torch.Generator().manual_seed(data.derived_seed(seed, "check"))
        idx = torch.randperm(X.shape[0], generator=gen)[:plan["value_rows"]].to(X.device)
        self.X = X[idx].detach()
        self.values = self.grads = None
        if self.answered:
            self.values = torch.cat([v for _, v, _ in slots])[idx].detach()
            if slots[0][2] is not None:
                self.grads = torch.cat([g for _, _, g in slots])[idx].detach()
        self.grad_rows = plan["grad_rows"]


def collect(win: drive.Window, seed: int, limits: dict):
    return CallSample(win.outputs, seed, limits["check"]) if win.outputs else None


def _answers(model, mix: dict, sample: CallSample, plan: dict):
    fn = getattr(model, mix["reference"])
    X = sample.X.to(model.dtype)
    if not mix["grad"]:
        return values(fn, X, plan["value_block"]), None
    v = values(fn, X, plan["value_block"])
    _, g = values_and_grads(fn, X[:sample.grad_rows], plan["grad_block"])
    return v, g


def numbers(sample, model, config, mix, limits):
    """The compared numbers of the window's answers, against the reference."""
    if sample is None:
        return {"value_gap": math.nan}
    v_ref, g_ref = _answers(model, mix, sample, limits["check"])
    if not sample.answered:
        nums = {"value_gap": math.inf, "value_mismatch": float(v_ref.numel())}
        if g_ref is not None:
            nums["grad_gap"] = math.inf
        return nums
    nums = {"value_gap": check.value_gap(sample.values, v_ref),
            "value_mismatch": check.value_mismatch(sample.values, v_ref)}
    if g_ref is not None:
        n = sample.grad_rows
        nums["grad_gap"] = check.grad_gap(sample.grads[:n], g_ref, v_ref[:n])
    return nums


def control_numbers(sample, model, low, config, mix, limits):
    """The same numbers with the reference ``low`` in the program's place."""
    plan = limits["check"]
    v_c, g_c = _answers(low, mix, sample, plan)
    v_ref, g_ref = _answers(model, mix, sample, plan)
    nums = {"value_gap": check.value_gap(v_c, v_ref), "value_mismatch": check.value_mismatch(v_c, v_ref)}
    if g_ref is not None:
        nums["grad_gap"] = check.grad_gap(g_c, g_ref, v_ref[:sample.grad_rows])
    return nums
