"""Closed-loop plant-in-the-loop MPC simulation (port of ``control/ksim.py``).

Two runners over a batch of scenario lanes, carries lanes-minor ``(r, B)``,
for the port's controllers (the bilinear lift-fused ``BilinearKmpc``, the
linear ``LinearKmpc``, the SQP ``NonlinearKmpc``), and the reference's
entry points on the general one (JAX ``ksim.py:274-359, 504-577``):
``run_trial_mpc`` (one lane, the results struct of ``_package``),
``run_trial_mpc_timed`` (the same a step at a time, each step timed:
``comp_time``), ``run_batch`` (lanes sharing a reference) and
``run_multi_ref`` (a reference a lane):

- ``batched_runner``: the general path of ``Ksim.make_body`` (:116-230),
  one step of it ``_Loop.step``, recording any of ``RECORDS``
  -- per step the controller's batched solve (bilinear:
  ``solve_qp_bilinear_lifted``, the ``bilin_lift`` kernel on the card; off
  the lift-fused route the basis's lift, then per QP the ``bilin`` or
  ``ipm_factored`` kernel, the host's re-roll between QPs;
  linear: the basis's lift, the condensed gradient and
  ``solve_qp_shared``, the ``ipm_shared`` kernel on the card; nonlinear:
  the SQP of ``NonlinearKmpc.solve`` on its route, the ``nmpc_multipass``
  kernel once a step or the ``nmpc_stage`` / ``nmpc_pass`` kernel, or on
  the 'linear' route ``ipm_factored``'s q0 build, once a pass on the card,
  with the previous plan for the multistart) and the
  plain batched arm step;
- ``fused_runner`` (:439-502): a Python loop over steps that launches the
  controller's fused step kernel once per step (``step_fused`` or
  ``linear_step_fused``; the plain versions on the CPU; the JAX package
  has no fused NMPC step, ``ksim.py:409-437``).  The per-step
  reference operands (sqrt(Q)-scaled windows, or the linear step's
  gradient columns G2 @ Yr) are computed on the device up front and the
  tracked outputs go into a preallocated (steps-1, nproj, B) record.

Loaded models (nw > 0) run on the general runner (``ksim.py:97-160``):
the lifted state is that of the scaled load estimate ``what`` (nw, B),
zero unless a load observer (``control/observer.py``) updates it from the
trailing windows of scaled outputs and inputs, before the lift, every
``load_obs_period`` steps; the estimate freezes with its lane and is
recorded as ``What``.  Each lane's true load is constant (``W`` (B, nw),
as ``run_batch``, :554-577) or a row a step (``W`` (B, K, nw),
``run_trial_mpc``'s (K, nw) load: iteration k applies row k - 1 of the
reference's 1-based count, :285-287).

Delay-embedded models (nd > 0, ``ksim.py:116-190``): the general runner
keeps trailing windows of nd+1 scaled outputs and planned inputs (more
where the load observer needs them), started from the lane's tiled y0 and
u0; zeta is the newest output, the output delays, then the input delays
(``ops/observables.py:zeta_from_window``), the solve's previous input the
newest row of the input window, into which each step puts the plan's
scaled U[1].  The plant is the arm (``models/arm.py``) or the model itself
(``KoopmanPlant``, ``run_model_simulation``; ``ksim.py:34-67``): any object
with ``step(x, u, w)``, ``get_y(x)`` and ``device``, x (nx, B) lanes-minor.

Reference quirks kept (``Ksim.m:199,225,239-246``): the applied input is
the SECOND row of the plan, the plant consumes the PREVIOUS step's input,
and the horizon is anchored at the current reference row.  Lanes freeze on
a failed solve or a non-finite plant state and report alive=False.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from koopman_realizations_torch import resolve_device
from koopman_realizations_torch.control.kmpc import (
    BilinearKmpc,
    LinearKmpc,
    NonlinearKmpc,
)
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.models.koopman import model_step
from koopman_realizations_torch.ops.observables import zeta_from_window
from koopman_realizations_torch.ops.kernels.linear_step_fused import (
    build_linear_step_fused,
)
from koopman_realizations_torch.ops.kernels.step_fused import (
    StepCarry,
    build_step_fused,
)
from koopman_realizations_torch.utils.metrics import tracking_error
from koopman_realizations_torch.utils.timing import (
    DeviceClock,
    comp_time_like,
)


class KoopmanPlant:
    """Model-in-the-loop plant (JAX ``KoopmanPlant``, ksim.py:34-57;
    ``Kmpc.run_simulation:403-512``): the learned model propagates its
    lifted state z (NL, B) lanes-minor in place of a simulator, and
    inputs and outputs cross the scaling as a real plant's do: ``step``
    scales u down and steps the model (``models/koopman.py:model_step``),
    ``get_y`` is y_up(C z)."""

    def __init__(self, model, scaler, device="cuda"):
        self.model, self.scaler = model, scaler
        self.device = resolve_device(device)
        self.nx = model.meta.NL
        self._steps = {}                 # dtype -> the model's step

    def step(self, z, u, w=None):
        if z.dtype not in self._steps:
            self._steps[z.dtype] = model_step(self.model, z)
        return self._steps[z.dtype](z, self.scaler.u_down(u, axis=0), None)

    def get_y(self, z):
        C = torch.as_tensor(np.asarray(self.model.C), dtype=z.dtype,
                            device=z.device)
        return self.scaler.y_up(C @ z, axis=0)


def run_model_simulation(mpc, ref, steps: Optional[int] = None, zeta0=None,
                         device="cuda") -> dict:
    """The closed loop against the controller's own model (JAX
    ``run_model_simulation``, ksim.py:60-67; ``Kmpc.run_simulation``):
    from the lifted zeta0 (nzeta,) (default zeta 0) the results struct of
    ``Ksim.run_trial_mpc``.  A batch of zeta0 rows (B, nzeta) runs a lane
    each and returns ``Ksim.run_batch``'s struct."""
    sim = Ksim(KoopmanPlant(mpc.model, mpc.scaler, device), mpc,
               device=device)
    zeta = np.zeros(mpc.meta.nzeta) if zeta0 is None else np.asarray(zeta0)
    zt = torch.as_tensor(np.atleast_2d(zeta), dtype=mpc.dtype,
                         device=sim.device)
    Z0 = mpc.model.basis.lift(zt.T).T
    if zeta.ndim == 1:
        return sim.run_trial_mpc(ref, x0=Z0[0], steps=steps)
    return sim.run_batch(ref, Z0, steps=steps)


# the records of a closed loop (JAX ``Ksim.RECORD_ALL``, ksim.py:114), the
# tracked outputs alone, and the inputs of the solve phase
# (``utils/timing.py:phase_breakdown``)
RECORD_ALL = ("U", "Y", "X", "R", "Z", "what", "alive")
PHASE_KEYS = ("zeta", "u_prev_sc", "U_plan_in")
RECORDS = RECORD_ALL + ("Yp",) + PHASE_KEYS


class _Loop:
    """One run of the general closed loop (JAX ``Ksim.make_body``,
    ksim.py:116-230) over lanes-minor carries: ``step(k)`` is the body at
    the reference's 1-based step k + 1, writing the requested records'
    row k; ``result()`` stacks them lanes-major, (B, K-1, ...)."""

    def __init__(self, sim: "Ksim", K: int, windows, R, record, X0, W,
                 U0=None):
        mpc, plant, sc = sim.mpc, sim.plant, sim.scaler
        self.sim, self.windows, self.R, self.record = sim, windows, R, record
        m, Np, nw = mpc.m, mpc.Np, sim.meta.nw
        dt, dev = mpc.dtype, sim.device
        x = torch.as_tensor(X0, dtype=dt, device=dev).T.contiguous()
        B = x.shape[1]
        Wt = torch.as_tensor(W, dtype=dt, device=dev)
        # (B, nw) a constant load a lane, or (B, K', nw) a row a step
        self.Wt = Wt.T.contiguous() if Wt.ndim == 2 \
            else Wt.permute(1, 2, 0).contiguous()
        if self.Wt.ndim == 3 and self.Wt.shape[0] < K - 1:
            raise ValueError(f"per-step loads need {K - 1} rows, got "
                             f"{self.Wt.shape[0]}")
        self.x = x
        self.y = plant.get_y(x)
        self.ysc = sc.y_down(self.y, axis=0)
        u0 = x.new_zeros((m, B)) if U0 is None else torch.as_tensor(
            U0, dtype=dt, device=dev).T.contiguous()
        self.u_prev = u0
        self.upsc = sc.u_down(u0, axis=0)
        self.U_plan = self.upsc.repeat(Np, 1)             # (Np*m, B) scaled
        self.lam = x.new_ones((mpc.n_con, B)) if sim._dual_warm else None
        self.alive = torch.ones(B, dtype=torch.bool, device=dev)
        self.what = x.new_zeros((nw, B))
        # trailing windows, oldest row first (ysc / upsc the newest), both
        # from the lane's tiled y0 and u0 (ksim.py:248-249)
        self.windows_on = sim.observer is not None or sim.nd > 0
        if self.windows_on:
            self.ywin = self.ysc[None].repeat(sim.win, 1, 1)
            self.uwin = self.upsc[None].repeat(sim.win, 1, 1)
        nz = mpc.meta.nzeta if sim.raw_zeta else mpc.NL
        dims = {"U": (m,), "Y": (self.y.shape[0],), "X": (x.shape[0],),
                "R": (len(mpc.proj_idx),), "Z": (nz,), "what": (nw,),
                "alive": (), "Yp": (len(mpc.proj_idx),),
                "zeta": (mpc.meta.nzeta,), "u_prev_sc": (m,),
                "U_plan_in": (Np * m,)}
        self.rec = {k: torch.empty((K - 1,) + dims[k] + (B,),
                                   dtype=torch.bool if k == "alive" else dt,
                                   device=dev) for k in record}

    def step(self, k: int):
        sim, mpc, plant, sc = self.sim, self.sim.mpc, self.sim.plant, \
            self.sim.scaler
        m, nd, obs = mpc.m, sim.nd, sim.observer
        what_prev = self.what
        if obs is not None:
            # k + 1 is the reference's 1-based step counter
            self.what = obs(k + 1, self.ywin, self.uwin, self.what)
        zeta = zeta_from_window(self.ywin[-nd - 1:], self.uwin[-nd - 1:],
                                nd) if nd else self.ysc
        z = zeta if sim.raw_zeta else mpc.lift(
            zeta, self.what if sim.meta.nw else None)
        U_plan_in, upsc_in = self.U_plan, self.upsc
        U, sol = mpc.solve(z, self.upsc, self.windows[k], self.U_plan,
                           *(() if self.lam is None else (self.lam,)))
        u_next_sc = U[m:2 * m]
        u_next = sc.u_up(u_next_sc, axis=0)
        w_k = self.Wt if self.Wt.ndim == 2 else self.Wt[k]
        x_new = plant.step(self.x, self.u_prev, w_k)
        y_new = plant.get_y(x_new)
        alive = self.alive & sol.ok & torch.isfinite(x_new).all(0)
        self.alive = alive
        keep = lambda new, old: torch.where(alive, new, old)
        self.x = keep(x_new, self.x)
        self.y = keep(y_new, self.y)
        ysc_new = sc.y_down(y_new, axis=0)
        if self.windows_on:
            # the planned U[1] enters the input window (ksim.py:171,
            # 188-190)
            self.ywin = keep(torch.cat([self.ywin[1:], ysc_new[None]]),
                             self.ywin)
            self.uwin = keep(torch.cat([self.uwin[1:], u_next_sc[None]]),
                             self.uwin)
        self.ysc = keep(ysc_new, self.ysc)
        self.upsc = keep(u_next_sc, self.upsc)
        self.u_prev = keep(u_next, self.u_prev)
        self.U_plan = keep(U, self.U_plan)
        if self.lam is not None:
            self.lam = keep(sol.lam, self.lam)
        # the load estimate freezes with its lane (ksim.py:212-214)
        self.what = keep(self.what, what_prev)
        rec = self.rec
        for key, val in (
                ("U", lambda: keep(u_next, torch.full_like(u_next,
                                                           float("nan")))),
                ("Y", lambda: self.y), ("X", lambda: self.x),
                ("R", lambda: self.R[k]), ("Z", lambda: z),
                ("what", lambda: self.what), ("alive", lambda: alive),
                ("Yp", lambda: self.y[list(mpc.proj_idx)]),
                ("zeta", lambda: zeta), ("u_prev_sc", lambda: upsc_in),
                ("U_plan_in", lambda: U_plan_in)):
            if key in rec:
                v = val()
                rec[key][k] = v if v.ndim == rec[key].ndim - 1 \
                    else v[..., None]

    def result(self) -> dict:
        """The records lanes-major: (B, K-1, ...); ``U_plan_in`` as
        (B, K-1, Np, m), JAX's plan rows."""
        out = {}
        for key, v in self.rec.items():
            v = v.movedim(-1, 0)
            if key == "U_plan_in":
                v = v.reshape(v.shape[0], v.shape[1], self.sim.mpc.Np,
                              self.sim.mpc.m)
            out[key] = v
        return out


class Ksim:
    """Closed-loop harness binding a plant (the arm or ``KoopmanPlant``),
    the controller and, for a loaded model, an optional load observer."""

    RECORD_ALL = RECORD_ALL

    def __init__(self, plant, mpc: BilinearKmpc | LinearKmpc | NonlinearKmpc,
                 observer=None, device="cuda"):
        self.device = resolve_device(device)
        self.plant = plant
        self.mpc = mpc
        self.scaler = mpc.scaler
        self.meta = mpc.meta
        self.observer = observer
        self.nd = self.meta.nd
        if self.nd and self.meta.nw:
            raise NotImplementedError(
                "loaded models with delays are not ported (ROADMAP.md "
                "queue 1, item 7)")
        if observer is not None and (self.meta.nw == 0
                                     or observer.dtype != mpc.dtype):
            raise ValueError("the load observer needs a loaded model and "
                             "the controller's dtype")
        # the trailing windows' rows: zeta needs nd + 1 (ksim.py:75-83),
        # the observer's regression load_obs_horizon + 1 rows of past
        # measurements
        self.win = self.nd + 1 if observer is None \
            else max(self.nd + 1, observer.horizon + 1)
        # the NMPC carries no duals across steps (ksim.py:93-94: it has no
        # n_con in the JAX package)
        self._dual_warm = bool(mpc.cfg.qp_dual_warm) \
            and not isinstance(mpc, NonlinearKmpc)
        # the lift-fused bilinear kernel lifts zeta itself (``wants_zeta``)
        # and the NMPC takes the raw zeta (ksim.py:97-112); the others
        # take the basis's lift (of the load estimate, for a loaded model)
        self.raw_zeta = isinstance(mpc, NonlinearKmpc) \
            or getattr(mpc, "wants_zeta", False)
        # the plant's load width (the arm's [m_ee, r_offset], ksim.py:90)
        self.nw_plant = getattr(getattr(plant, "cfg", None), "nw_plant", 2)
        self.nx = plant.cfg.nx if hasattr(plant, "cfg") else plant.nx
        self._runner_cache = {}
        if plant.device.type != self.device.type \
                or mpc.device.type != self.device.type:
            raise ValueError(f"plant ({plant.device}) and controller "
                             f"({mpc.device}) must live on {device}")

    # ---------------------------------------------------------- host prep

    def prep_ref(self, ref) -> np.ndarray:
        """Scale the reference down and pad Np+1 repeats of the last row."""
        ref_sc = np.asarray(self.scaler.ref_down(np.asarray(ref, float),
                                                 self.mpc.proj_idx), float)
        return np.concatenate(
            [ref_sc, np.tile(ref_sc[-1:], (self.mpc.Np + 1, 1))], axis=0)

    def _windows(self, rp, steps: int) -> torch.Tensor:
        """The solve's reference windows of steps k = 1..steps-1 from
        padded scaled rows ``rp`` (rows, nproj), or one set a lane
        (B, rows, nproj): (steps-1, p) or (steps-1, p, B)."""
        mpc = self.mpc
        rp = torch.as_tensor(rp, device=self.device)
        win = rp.unfold(-2, mpc.Np + 1, 1)[..., : steps - 1, :, :]
        win = win.transpose(-1, -2).reshape(*win.shape[:-2], -1)
        if isinstance(mpc, (BilinearKmpc, NonlinearKmpc)):
            win = torch.as_tensor(mpc.sqq, device=self.device) * win
        if win.ndim == 3:
            win = win.permute(1, 2, 0)
        return win.to(mpc.dtype).contiguous()

    def reference_windows(self, ref, steps: int) -> torch.Tensor:
        """The scaled reference window of every step k = 1..steps-1 as the
        controller's solve takes it -- sqrt(Q) * Yr (bilinear, nonlinear)
        or Yr (linear): (steps-1, p), built on the device (window k starts
        at reference row k-1)."""
        return self._windows(self.prep_ref(ref), steps)

    def _ref_rows(self, rp, steps: int) -> torch.Tensor:
        """The recorded reference R of each step, the horizon's first row
        unscaled (``ksim.py:202``): (steps-1, nproj), or (steps-1, nproj,
        B) from one set of padded rows a lane."""
        R = np.asarray(self.scaler.ref_up(
            np.asarray(rp)[..., : steps - 1, :], self.mpc.proj_idx), float)
        R = torch.as_tensor(R, dtype=self.mpc.dtype, device=self.device)
        return R.permute(1, 2, 0).contiguous() if R.ndim == 3 else R

    def _steps(self, ref, steps: Optional[int]) -> int:
        K = np.asarray(ref).shape[0] if steps is None else int(steps)
        if K < 2:
            raise ValueError(f"need at least 2 steps, got {K}")
        return K

    def _record(self, record):
        """The records to keep: by default the tracked outputs and alive
        flags (and a loaded model's load estimate "what")."""
        if record is None:
            return ("Yp", "alive") + (("what",) if self.meta.nw else ())
        bad = set(record) - set(RECORDS)
        if bad:
            raise ValueError(f"unknown records {sorted(bad)}; choose from "
                             f"{RECORDS}")
        return tuple(record)

    # ------------------------------------------------------- general path

    def batched_runner(self, ref, steps: Optional[int] = None,
                       record=None):
        """fn(X0 (B, nx), W, U0=None) -> the records of the general closed
        loop (JAX ``Ksim.batched_runner``, ksim.py:379-397), each
        (B, steps-1, ...): any of ``RECORDS`` -- U (the applied input,
        NaN once the lane is dead), Y, X, R, Z (the solve's state: zeta
        for the NMPC and the lift-fused bilinear controller, else the
        lifted state), what (the scaled load estimate), alive, Yp (the
        tracked outputs) and the solve phase's inputs zeta, u_prev_sc and
        U_plan_in -- allocated only when asked for.  ``record`` None keeps
        {"Yp", "alive"} and a loaded model's "what".  X0 holds the
        plant's states (the arm's, or ``KoopmanPlant``'s lifted states);
        W (B, nw_plant) a constant load a lane, or (B, K', nw_plant) a
        row a step (iteration k applies row k - 1, ksim.py:285-287); U0
        (B, m) the lanes' previous input (default zero)."""
        K = self._steps(ref, steps)
        rp = self.prep_ref(ref)
        return self._runner(K, self._windows(rp, K), self._ref_rows(rp, K),
                            self._record(record))

    def _runner(self, K, windows, R, record):
        def runner(X0, W, U0=None):
            loop = _Loop(self, K, windows, R, record, X0, W, U0)
            for k in range(K - 1):
                loop.step(k)
            return loop.result()
        return runner

    # ------------------------------------------- the reference's runners

    def _trial_lane(self, x0, u0, load):
        """(X0 (1, nx), W, U0 (1, m)) of one trial: x0 (nx,) and u0 (m,)
        default zero, load None, (nw,) or (K, nw)."""
        dt, dev = self.mpc.dtype, self.device
        X0 = torch.zeros((1, self.nx), dtype=dt, device=dev) if x0 is None \
            else torch.as_tensor(x0, dtype=dt, device=dev).reshape(1, -1)
        U0 = None if u0 is None else torch.as_tensor(
            np.asarray(u0, float), dtype=dt, device=dev).reshape(1, -1)
        W = np.zeros((1, self.nw_plant)) if load is None \
            else np.asarray(load, float)[None]
        return X0, W, U0

    def run_trial_mpc(self, ref, x0=None, u0=None, load=None,
                      steps: Optional[int] = None) -> dict:
        """One closed-loop trial (JAX ``run_trial_mpc``, ksim.py:274-294;
        ``Ksim.run_trial_mpc``): ref (K, nproj) unscaled, x0 (nx,) and u0
        (m,) the plant state and previous input at the start (default
        zero; u0 seeds the input window and the plan, as ``init_carry``
        does, :240-264), load None, (nw,) or (K, nw) the true load.
        Returns the results struct (``_package``)."""
        K = self._steps(ref, steps)
        run = self.batched_runner(ref, K, record=RECORD_ALL)
        clock = DeviceClock(self.device)
        t0 = clock.mark()
        out = run(*self._trial_lane(x0, u0, load))
        t1 = clock.mark()
        return self._package({k: v[0] for k, v in out.items()},
                             wall_s=clock.ms(t0, t1) / 1e3)

    def run_trial_mpc_timed(self, ref, x0=None, u0=None, load=None,
                            steps: Optional[int] = None) -> dict:
        """``run_trial_mpc`` a step at a time with each step timed (JAX
        ``run_trial_mpc_timed``, ksim.py:296-327, the reference's per-solve
        tic/toc, ``Ksim.m:205-217``): on the card a CUDA event pair around
        each step and a synchronize after it, on the CPU the host clock.
        The first step runs once beforehand and is thrown away (kernel
        builds, the plant graph's capture).  ``comp_time`` (K-1,) holds
        the steps' seconds."""
        K = self._steps(ref, steps)
        if K < 2:
            raise ValueError(f"timed run needs >= 2 steps, got {K}")
        rp = self.prep_ref(ref)
        args = (K, self._windows(rp, K), self._ref_rows(rp, K), RECORD_ALL,
                *self._trial_lane(x0, u0, load))
        _Loop(self, *args).step(0)
        loop = _Loop(self, *args)
        clock = DeviceClock(self.device)
        comp = []
        for k in range(K - 1):
            t0 = clock.mark()
            loop.step(k)
            t1 = clock.mark()
            comp.append(clock.ms(t0, t1) / 1e3)
        res = self._package({k: v[0] for k, v in loop.result().items()},
                            wall_s=float(np.sum(comp)))
        res["comp_time"] = np.asarray(comp)
        return res

    def _package(self, out, wall_s: float = 0.0) -> dict:
        """The reference's results struct (JAX ``_package``,
        ksim.py:329-359; ``Ksim.m:129-258``) from one lane's records,
        numpy on the host: comp_time (the wall time spread uniformly over
        the steps, ``comp_time_like``), T, K, U, Y, R, X, Z, What, alive
        and err (``tracking_error``)."""
        h = {k: v.cpu().numpy() for k, v in out.items()}
        K1 = h["Y"].shape[0]
        Ts = self.meta.Ts
        return {
            "comp_time": comp_time_like(wall_s, K1),
            "T": np.arange(1, K1 + 1) * Ts,
            "K": np.arange(1, K1 + 1),
            "U": h["U"], "Y": h["Y"], "R": h["R"], "X": h["X"],
            "Z": h["Z"], "What": h["what"], "alive": h["alive"],
            "err": tracking_error(h["R"], h["Y"], self.mpc.proj_idx),
        }

    def run_batch(self, ref, X0, load=None,
                  steps: Optional[int] = None) -> dict:
        """The closed loop over lanes sharing one reference (JAX
        ``run_batch``, ksim.py:554-577): X0 (B, nx), load None, (B, nw)
        or (B, K, nw).  Runners are cached by the reference's content and
        the steps.  Returns {"Y", "R", "U", "X", "alive", "err"}, numpy,
        (B, steps-1, ...)."""
        record = ("U", "Y", "X", "R", "alive")
        K = self._steps(ref, steps)
        key = (np.asarray(ref, float).tobytes(), K, record)
        fn = self._runner_cache.get(key)
        if fn is None:
            fn = self._runner_cache[key] = self.batched_runner(
                ref, K, record=record)
        B = np.asarray(X0.cpu() if torch.is_tensor(X0) else X0).shape[0]
        W = np.zeros((B, self.nw_plant)) if load is None else load
        return self._lanes_struct(fn(X0, W))

    def run_multi_ref(self, refs, X0, load=None,
                      steps: Optional[int] = None) -> dict:
        """The closed loop with a reference a lane (JAX ``run_multi_ref``,
        ksim.py:504-552) on the general runner: refs a list of (K_i,
        nproj) unscaled trajectories, padded to the longest (or to
        ``steps``) with their last row, or an array (B, K, nproj); each
        lane's reference is cut at ``steps`` rows before the horizon
        padding, as there.  Returns {"Y", "R", "U", "alive", "err"}."""
        if isinstance(refs, (list, tuple)):
            K = max(np.asarray(r).shape[0] for r in refs) if steps is None \
                else steps
            stacked = []
            for r in refs:
                r = np.asarray(r, float)
                if r.shape[0] < K:
                    r = np.concatenate(
                        [r, np.tile(r[-1:], (K - r.shape[0], 1))], axis=0)
                stacked.append(r[:K])
            refs = np.stack(stacked)
        refs = np.asarray(refs, float)
        B = refs.shape[0]
        K = self._steps(refs[0], steps)
        rp = np.stack([self.prep_ref(r[:K]) for r in refs])
        run = self._runner(K, self._windows(rp, K), self._ref_rows(rp, K),
                           ("U", "Y", "R", "alive"))
        W = np.zeros((B, self.nw_plant)) if load is None else load
        out = self._lanes_struct(run(X0, W))
        out.pop("X", None)
        return out

    def _lanes_struct(self, out) -> dict:
        h = {k: v.cpu().numpy() for k, v in out.items()}
        h["err"] = tracking_error(h["R"], h["Y"], self.mpc.proj_idx)
        return h

    # --------------------------------------------------------- fused path

    def fused_step_eligible(self) -> bool:
        """Whether the one-launch step applies (JAX ``_fused_plant_ok`` and
        ``fused_step_eligible``, ksim.py:399-437): the arm with SDIRK2, its
        Jacobian once a period or once a substep, marker or angle outputs,
        f32 throughout (the kernels' type; an f64 model is not silently
        cast), and for the bilinear controller the lift-fused route
        (blocked, ``bilinear_iters=1``) with the dual warm start without
        stage shift; for the linear controller a blocked stack with cold
        duals and no shift.  Neither takes a dictionary other than one
        poly family with PCA, a delay-embedded or loaded model, the load
        observer or a plant other than the arm; the NMPC has no fused step
        (as in the JAX package)."""
        basis = self.mpc.model.basis
        if isinstance(self.mpc, NonlinearKmpc) or self.observer is not None \
                or self.meta.nw or self.nd or not isinstance(self.plant, Arm) \
                or basis.pcs is None or not basis.single_poly \
                or self.mpc.dual_shift is not None:
            return False
        cfg = self.plant.cfg
        common = (cfg.integrator == "sdirk2"
                  and cfg.jac_mode in ("step", "substep")
                  and cfg.output_type in ("markers", "angles")
                  and self.mpc.model.dtype == np.float32
                  and self.mpc.dtype == torch.float32)
        if isinstance(self.mpc, LinearKmpc):
            return common and self.mpc.blocked and not self._dual_warm
        return common and self.mpc.lift_fused and self._dual_warm

    def fused_runner(self, ref, steps: Optional[int] = None):
        """fn(X0 (B, nx), W (B, 2)) -> {"Yp", "alive"} as
        ``batched_runner``, one fused-step launch per closed-loop step."""
        if not self.fused_step_eligible():
            raise ValueError("fused_runner: configuration not eligible "
                             "(see fused_step_eligible); use "
                             "batched_runner")
        K = self._steps(ref, steps)
        windows = self.reference_windows(ref, K)
        if isinstance(self.mpc, LinearKmpc):
            op = build_linear_step_fused(self.mpc, self.plant, self.scaler)
            vecs = op.fYr(windows)                  # (K-1, n) G2 @ Yr
        else:
            op = build_step_fused(self.mpc, self.plant, self.scaler)
            vecs = windows                          # (K-1, p) sqrt(Q) Yr
        nproj = len(self.mpc.proj_idx)

        def runner(X0, W):
            c = op.init_carry(X0, W)
            B = c.ysc.shape[1]
            Yp = c.yp.new_empty((K - 1, nproj, B))
            alive = c.alive.new_empty((K - 1, B))
            for k in range(K - 1):
                # the big carries update in place; yp/alive land in the
                # records, whose previous row is the next step's input
                out = StepCarry(c.ysc, c.upsc, c.xpl, c.w, alive[k], c.x0,
                                c.lamc, Yp[k])
                c = op.step(c, vecs[k], out=out)
            return {"Yp": Yp.permute(2, 0, 1), "alive": alive.T > 0.5}

        return runner
