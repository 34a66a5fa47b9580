"""Closed-loop plant-in-the-loop MPC simulation (port of ``control/ksim.py``).

Two runners over a batch of scenario lanes, carries lanes-minor ``(r, B)``:

- ``batched_runner``: the general path of ``Ksim.make_body`` (:116-230)
  for the bilinear lift-fused controller -- per step one batched QP
  (``solve_qp_bilinear_lifted``: the ``bilin_lift`` kernel on the card)
  and the plain batched arm step;
- ``fused_runner`` (:439-502): a Python loop over steps that launches the
  ``step_fused`` kernel once per step (its plain version on the CPU).  The
  per-step reference windows are computed on the device up front and the
  tracked outputs go into a preallocated (steps-1, nproj, B) record.

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
from koopman_realizations_torch.control.kmpc import BilinearKmpc
from koopman_realizations_torch.ops.kernels.bilin_lift import (
    solve_qp_bilinear_lifted,
)
from koopman_realizations_torch.ops.kernels.step_fused import (
    StepCarry,
    build_step_fused,
)


class Ksim:
    """Closed-loop harness binding the arm plant and the controller."""

    def __init__(self, plant, mpc: BilinearKmpc, device="cuda"):
        self.device = resolve_device(device)
        self.plant = plant
        self.mpc = mpc
        self.scaler = mpc.scaler
        self.meta = mpc.meta
        if self.meta.nd != 0 or self.meta.nw != 0:
            raise NotImplementedError("delays and loads are not ported")
        self._dual_warm = bool(mpc.cfg.qp_dual_warm)
        if plant.G.device.type != self.device.type \
                or mpc.gens.device.type != self.device.type:
            raise ValueError(f"plant ({plant.G.device}) and controller "
                             f"({mpc.gens.device}) must live on {device}")

    # ---------------------------------------------------------- host prep

    def prep_ref(self, ref) -> np.ndarray:
        """Scale the reference down and pad Np+1 repeats of the last row."""
        ref_sc = np.asarray(self.scaler.ref_down(np.asarray(ref, float),
                                                 self.mpc.proj_idx), float)
        return np.concatenate(
            [ref_sc, np.tile(ref_sc[-1:], (self.mpc.Np + 1, 1))], axis=0)

    def reference_windows(self, ref, steps: int) -> torch.Tensor:
        """sqrt(Q) * Yr for every step k = 1..steps-1: (steps-1, p), built
        on the device (window k starts at reference row k-1)."""
        mpc = self.mpc
        rp = torch.as_tensor(self.prep_ref(ref), device=self.device)
        win = rp.unfold(0, mpc.Np + 1, 1)[: steps - 1]   # (K-1, nproj, Np+1)
        win = win.transpose(1, 2).reshape(steps - 1, -1)
        sq = torch.as_tensor(mpc.sqq, device=self.device)
        return (sq * win).to(mpc.dtype).contiguous()

    def _steps(self, ref, steps: Optional[int]) -> int:
        K = np.asarray(ref).shape[0] if steps is None else int(steps)
        if K < 2:
            raise ValueError(f"need at least 2 steps, got {K}")
        return K

    def _lanes(self, X0, W):
        dt, dev = self.mpc.dtype, self.device
        X = torch.as_tensor(np.asarray(X0), dtype=dt, device=dev).T
        Wt = torch.as_tensor(np.asarray(W), dtype=dt, device=dev).T
        return X.contiguous(), Wt.contiguous()

    # ------------------------------------------------------- general path

    def batched_runner(self, ref, steps: Optional[int] = None):
        """fn(X0 (B, nx), W (B, 2)) -> {"Yp": (B, steps-1, nproj),
        "alive": (B, steps-1) bool} for the general closed loop."""
        K = self._steps(ref, steps)
        windows = self.reference_windows(ref, K)
        mpc, plant, sc = self.mpc, self.plant, self.scaler
        m, Np = mpc.m, mpc.Np
        proj = list(mpc.proj_idx)
        qp = mpc.lift_qp()

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
            for k in range(K - 1):
                shifted = torch.cat([U_plan[2 * m:], U_plan[-m:]])
                sol = solve_qp_bilinear_lifted(
                    qp, ysc, upsc, windows[k],
                    x0=mpc.Sel_t @ shifted, lam0=lam,
                    iters=mpc.cfg.qp_iters)
                U = torch.cat([upsc, mpc.Tb_t @ sol.x])
                u_next_sc = U[m:2 * m]
                x_new = plant.step(x, u_prev, Wt)
                y_new = plant.get_y(x_new)
                alive = alive & sol.ok & torch.isfinite(x_new).all(0)
                keep = lambda new, old: torch.where(alive, new, old)
                x = keep(x_new, x)
                y = keep(y_new, y)
                ysc = keep(sc.y_down(y_new, axis=0), ysc)
                upsc = keep(u_next_sc, upsc)
                u_prev = keep(sc.u_up(u_next_sc, axis=0), u_prev)
                U_plan = keep(U, U_plan)
                if lam is not None:
                    lam = keep(sol.lam, lam)
                Yp[k] = y[proj]
                alive_rec[k] = alive
            return {"Yp": Yp.permute(2, 0, 1), "alive": alive_rec.T}

        return runner

    # --------------------------------------------------------- fused path

    def fused_step_eligible(self) -> bool:
        """Whether the one-launch step applies: the arm with SDIRK2, its
        Jacobian once per period and marker outputs, the dual warm start
        without stage shift, and f32 throughout (the kernel's type; an f64
        model is not silently cast)."""
        cfg = self.plant.cfg
        return (cfg.integrator == "sdirk2" and cfg.jac_mode == "step"
                and cfg.output_type == "markers"
                and self._dual_warm and not self.mpc.cfg.qp_dual_shift
                and self.mpc.model.dtype == np.float32
                and self.mpc.dtype == torch.float32)

    def fused_runner(self, ref, steps: Optional[int] = None):
        """fn(X0 (B, nx), W (B, 2)) -> {"Yp", "alive"} as
        ``batched_runner``, one fused-step launch per closed-loop step."""
        if not self.fused_step_eligible():
            raise ValueError("fused_runner: configuration not eligible "
                             "(see fused_step_eligible); use "
                             "batched_runner")
        K = self._steps(ref, steps)
        windows = self.reference_windows(ref, K)
        op = build_step_fused(self.mpc, self.plant, self.scaler)
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
                c = op.step(c, windows[k], out=out)
            return {"Yp": Yp.permute(2, 0, 1), "alive": alive.T > 0.5}

        return runner
