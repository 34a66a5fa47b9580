"""Closed-loop plant-in-the-loop MPC simulation (port of ``control/ksim.py``).

Two runners over a batch of scenario lanes, carries lanes-minor ``(r, B)``,
for the port's controllers (the bilinear lift-fused ``BilinearKmpc``, the
linear ``LinearKmpc``, the SQP ``NonlinearKmpc``):

- ``batched_runner``: the general path of ``Ksim.make_body`` (:116-230)
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
recorded as ``What``.  Each lane's true load is constant (``W``, as
``run_batch``, :554-577).

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
                         device="cuda"):
    """The closed loop against the controller's own model (JAX
    ``run_model_simulation``, ksim.py:60-67; ``Kmpc.run_simulation``) on
    the general runner, a lane for each row of zeta0 (B, nzeta) (default
    one lane at zeta 0): the lanes start from the lifted zeta0.  Returns
    the runner's {"Yp", "alive"}."""
    sim = Ksim(KoopmanPlant(mpc.model, mpc.scaler, device), mpc,
               device=device)
    dev = sim.device
    if zeta0 is None:
        zeta0 = np.zeros((1, mpc.meta.nzeta))
    zeta = torch.as_tensor(np.asarray(zeta0), dtype=mpc.dtype, device=dev)
    Z0 = mpc.model.basis.lift(zeta.T).T
    return sim.batched_runner(ref, steps)(Z0, torch.zeros(
        (Z0.shape[0], 2), dtype=mpc.dtype, device=dev))


class Ksim:
    """Closed-loop harness binding a plant (the arm or ``KoopmanPlant``),
    the controller and, for a loaded model, an optional load observer."""

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

    def reference_windows(self, ref, steps: int) -> torch.Tensor:
        """The scaled reference window of every step k = 1..steps-1 as the
        controller's solve takes it -- sqrt(Q) * Yr (bilinear, nonlinear)
        or Yr (linear): (steps-1, p), built on the device (window k starts
        at reference row k-1)."""
        mpc = self.mpc
        rp = torch.as_tensor(self.prep_ref(ref), device=self.device)
        win = rp.unfold(0, mpc.Np + 1, 1)[: steps - 1]   # (K-1, nproj, Np+1)
        win = win.transpose(1, 2).reshape(steps - 1, -1)
        if isinstance(mpc, (BilinearKmpc, NonlinearKmpc)):
            win = torch.as_tensor(mpc.sqq, device=self.device) * win
        return win.to(mpc.dtype).contiguous()

    def _steps(self, ref, steps: Optional[int]) -> int:
        K = np.asarray(ref).shape[0] if steps is None else int(steps)
        if K < 2:
            raise ValueError(f"need at least 2 steps, got {K}")
        return K

    def _lanes(self, X0, W):
        dt, dev = self.mpc.dtype, self.device
        X = torch.as_tensor(X0, dtype=dt, device=dev).T
        Wt = torch.as_tensor(W, dtype=dt, device=dev).T
        return X.contiguous(), Wt.contiguous()

    # ------------------------------------------------------- general path

    def batched_runner(self, ref, steps: Optional[int] = None):
        """fn(X0 (B, nx), W (B, 2)) -> {"Yp": (B, steps-1, nproj),
        "alive": (B, steps-1) bool} for the general closed loop, and for a
        loaded model "What": (B, steps-1, nw), the scaled load estimate
        each step used (frozen with its lane).  X0 holds the plant's
        states (the arm's, or ``KoopmanPlant``'s lifted states)."""
        K = self._steps(ref, steps)
        windows = self.reference_windows(ref, K)
        mpc, plant, sc, obs, nd = self.mpc, self.plant, self.scaler, \
            self.observer, self.nd
        m, Np, nw = mpc.m, mpc.Np, self.meta.nw
        proj = list(mpc.proj_idx)
        # the lift-fused bilinear kernel lifts zeta itself (``wants_zeta``);
        # the NMPC takes the raw zeta (ksim.py:97-112); a loaded model's
        # lift takes the load estimate (None without loads)
        lift = (lambda z, what: z) if isinstance(mpc, NonlinearKmpc) \
            or getattr(mpc, "wants_zeta", False) else mpc.lift

        def runner(X0, W):
            x, Wt = self._lanes(X0, W)
            B = x.shape[1]
            y = plant.get_y(x)
            ysc = sc.y_down(y, axis=0)
            u_prev = x.new_zeros((m, B))
            upsc = sc.u_down(u_prev, axis=0)
            U_plan = upsc.repeat(Np, 1)                   # (Np*m, B) scaled
            lam = x.new_ones((mpc.n_con, B)) if self._dual_warm else None
            alive = torch.ones(B, dtype=torch.bool, device=x.device)
            Yp = x.new_empty((K - 1, len(proj), B))
            alive_rec = torch.empty((K - 1, B), dtype=torch.bool,
                                    device=x.device)
            what = x.new_zeros((nw, B)) if nw else None
            What = x.new_empty((K - 1, nw, B)) if nw else None
            # trailing windows, oldest row first (ysc / upsc the newest),
            # both from the lane's tiled y0 and u0 (ksim.py:248-249)
            windows_on = obs is not None or nd > 0
            ywin = ysc[None].repeat(self.win, 1, 1) if windows_on else None
            uwin = upsc[None].repeat(self.win, 1, 1) if windows_on else None
            for k in range(K - 1):
                what_prev = what
                if obs is not None:
                    # k + 1 is the reference's 1-based step counter
                    what = obs(k + 1, ywin, uwin, what)
                zeta = zeta_from_window(ywin[-nd - 1:], uwin[-nd - 1:], nd) \
                    if nd else ysc
                U, sol = mpc.solve(lift(zeta, what), upsc, windows[k],
                                   U_plan, *(() if lam is None else (lam,)))
                u_next_sc = U[m:2 * m]
                x_new = plant.step(x, u_prev, Wt)
                y_new = plant.get_y(x_new)
                alive = alive & sol.ok & torch.isfinite(x_new).all(0)
                keep = lambda new, old: torch.where(alive, new, old)
                x = keep(x_new, x)
                y = keep(y_new, y)
                ysc_new = sc.y_down(y_new, axis=0)
                if windows_on:
                    # the planned U[1] enters the input window
                    # (ksim.py:171, 188-190)
                    ywin = keep(torch.cat([ywin[1:], ysc_new[None]]), ywin)
                    uwin = keep(torch.cat([uwin[1:], u_next_sc[None]]), uwin)
                ysc = keep(ysc_new, ysc)
                upsc = keep(u_next_sc, upsc)
                u_prev = keep(sc.u_up(u_next_sc, axis=0), u_prev)
                U_plan = keep(U, U_plan)
                if lam is not None:
                    lam = keep(sol.lam, lam)
                Yp[k] = y[proj]
                alive_rec[k] = alive
                if nw:
                    what = keep(what, what_prev)
                    What[k] = what
            out = {"Yp": Yp.permute(2, 0, 1), "alive": alive_rec.T}
            if nw:
                out["What"] = What.permute(2, 0, 1)
            return out

        return runner

    # --------------------------------------------------------- fused path

    def fused_step_eligible(self) -> bool:
        """Whether the one-launch step applies: the arm with SDIRK2, its
        Jacobian once per period and marker outputs, f32 throughout (the
        kernels' type; an f64 model is not silently cast), and for the
        bilinear controller the lift-fused route (``ksim.py:423-428``:
        blocked, ``bilinear_iters=1``) with the dual warm start without
        stage shift; the linear controller's (``ksim.py:429-436``:
        blocked, cold duals, no shift) is every blocked ``LinearKmpc``.
        Neither takes a dictionary other than one poly family with PCA, a
        delay-embedded or loaded model, the load observer or a plant other
        than the arm; the NMPC has no fused step (as in the JAX package,
        ``ksim.py:409-437``)."""
        basis = self.mpc.model.basis
        if isinstance(self.mpc, NonlinearKmpc) or self.observer is not None \
                or self.meta.nw or self.nd or not isinstance(self.plant, Arm) \
                or basis.pcs is None or not basis.single_poly:
            return False
        cfg = self.plant.cfg
        common = (cfg.integrator == "sdirk2" and cfg.jac_mode == "step"
                  and cfg.output_type == "markers"
                  and self.mpc.model.dtype == np.float32
                  and self.mpc.dtype == torch.float32)
        if isinstance(self.mpc, LinearKmpc):
            return common
        return common and self.mpc.lift_fused and self._dual_warm \
            and not self.mpc.cfg.qp_dual_shift

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
