"""Timing and profiling of the port (JAX ``utils/timing.py``; the
reference's tic/toc ``comp_time``, ``Ksim.m:205-217``): ``DeviceClock``
(points in time on a device: the trainer's stages, ``models/edmd.py:
StageClock``, each FISTA fit, ``ops/lasso.py``, and the timed runner,
``control/ksim.py:Ksim.run_trial_mpc_timed``), ``step_time`` (a runner's
time a control step), ``phase_breakdown`` (what each phase of a step
costs), ``profile_trace`` (a ``torch.profiler`` trace) and
``comp_time_like`` (the results struct's per-step field from one wall
time).  On the card the times are CUDA events read after a synchronize;
on the CPU the host clock."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from koopman_realizations_torch import resolve_device


class DeviceClock:
    """Points in time on a device: recorded CUDA events on a CUDA device
    (read after a synchronize), the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, start, end) -> float:
        """Milliseconds from mark ``start`` to mark ``end``."""
        if self.cuda:
            torch.cuda.synchronize()
            return start.elapsed_time(end)
        return (end - start) * 1e3


def step_time(fn: Callable, args: tuple, n_steps: int, reps: int = 3,
              device="cuda") -> dict:
    """A runner's time a control step (JAX ``step_time``,
    utils/timing.py:23-38): fn(*args) once to warm up (kernel builds, the
    plant graph's capture), then ``reps`` timed calls on ``device``'s
    clock.  Returns {mean, median, max, total_s}, seconds a step (the
    statistics BASELINE.md gives of ``comp_time``)."""
    clock = DeviceClock(resolve_device(device))
    fn(*args)
    times = []
    for _ in range(reps):
        t0 = clock.mark()
        fn(*args)
        t1 = clock.mark()
        times.append(clock.ms(t0, t1) / 1e3 / n_steps)
    times = np.asarray(times)
    return {"mean": float(times.mean()), "median": float(np.median(times)),
            "max": float(times.max()), "total_s": float(times.sum() * n_steps)}


def phase_breakdown(sim, ref, B: int = 4096, steps: int = 12,
                    reps: int = 10, record_step: int = -1) -> dict:
    """What each phase of a closed-loop step costs (JAX
    ``phase_breakdown``, utils/timing.py:41-138): a short general run at
    batch B records the exact inputs of the solve (``zeta``,
    ``u_prev_sc``, ``U_plan_in``), the plant's state and input and the
    load estimate at ``record_step``; then the lift, the MPC solve, the
    plant step (and the load observer, if wired) are timed on their own
    on the simulator's device, and the whole step from the run.  Returns
    {phase: {"s_per_step", "fraction_of_sum"}, "full_step_s", "batch"}."""
    mpc, plant = sim.mpc, sim.plant
    X0 = np.zeros((B, sim.nx), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    W = np.zeros((B, sim.nw_plant), np.float32)
    rec = ("X", "U", "zeta", "u_prev_sc", "U_plan_in", "what")
    runner = sim.batched_runner(ref, steps=steps, record=rec)
    out = runner(X0, W)
    pick = lambda k: out[k][:, record_step].reshape(B, -1).T.contiguous()
    zeta, u_prev_sc, what = pick("zeta"), pick("u_prev_sc"), pick("what")
    U_plan, X, U = pick("U_plan_in"), pick("X"), pick("U")
    # entry i of the records was made at the 1-based step i + 1, whose
    # horizon starts at reference row i
    i_rec = record_step % (steps - 1)
    window = sim.reference_windows(ref, steps)[i_rec]
    Wt = torch.as_tensor(W, dtype=mpc.dtype, device=sim.device).T
    lift = (lambda zt, wh: zt) if sim.raw_zeta else \
        (lambda zt, wh: mpc.lift(zt, wh if sim.meta.nw else None))
    z = lift(zeta, what)
    phases = {"lift": lambda: lift(zeta, what),
              "mpc_solve": lambda: mpc.solve(z, u_prev_sc, window, U_plan),
              "plant_step": lambda: plant.step(X, U, Wt)}
    if sim.observer is not None:
        ywin = sim.scaler.y_down(plant.get_y(X), axis=0)[None].repeat(
            sim.win, 1, 1)
        uwin = u_prev_sc[None].repeat(sim.win, 1, 1)
        phases["observer"] = lambda: sim.observer.estimate(ywin, uwin,
                                                           what)
    clock = DeviceClock(sim.device)

    def timed(fn):
        fn()
        t0 = clock.mark()
        for _ in range(reps):
            fn()
        t1 = clock.mark()
        return clock.ms(t0, t1) / 1e3 / reps

    times = {name: timed(fn) for name, fn in phases.items()}
    t0 = clock.mark()
    runner(X0, W)
    t1 = clock.mark()
    total = sum(times.values())
    return {**{name: {"s_per_step": t, "fraction_of_sum": t / total}
               for name, t in times.items()},
            "full_step_s": clock.ms(t0, t1) / 1e3 / (steps - 1),
            "batch": B}


@contextlib.contextmanager
def profile_trace(logdir):
    """A ``torch.profiler`` trace of the block (JAX ``profile_trace``,
    utils/timing.py:141-148, over ``jax.profiler``): the CPU and, where
    there is one, the card; written as ``trace.json`` (Chrome trace
    format) into ``logdir``.  Yields the profiler (``key_averages()``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def comp_time_like(total_wall_s: float, n_steps: int) -> np.ndarray:
    """A per-step ``comp_time`` from one loop's wall time, spread
    uniformly over its steps (JAX ``comp_time_like``,
    utils/timing.py:151-157)."""
    return np.full(n_steps, total_wall_s / max(n_steps, 1))
