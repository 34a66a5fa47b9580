"""One closed-loop step of the LINEAR controller per launch: the CUDA
kernel ``csrc/linear_step_fused.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``_linear_step_kernel``
(``koopman_realizations_tpu/ops/pallas/step_fused.py:185``, with
``_plant_freeze_epilogue`` :150; built by ``build_linear_step_fused``
:393): per lane, the reduced gradient of the static condensed QP from the
raw zeta, the Mehrotra loop from cold duals against the lane-shared,
host-equilibrated Hessian, the ok mask, then the plant/freeze/carry tail
of the bilinear fused step.  The kernel is compute-bound on the card
(~3.5e4 operations per lane-step on ~0.6 KB of carry); it runs in two
launches, the plant a thread per lane, then the gradient and the QP a
group of threads per lane against one copy of the Hessian a block
(``csrc/step_group.cuh``, planned by ``ipm_group.py:step_plan``); see the
note in the source.

Host fold (step_fused.py:420-478 of the JAX package, f64, then f32): with
P = 2 H the full blocked Hessian and obj = max |P| over all of it (the u0
block included -- not the general path's max |P22|, so the two routes
scale alike only when the largest entry lies in P22),
  Psh = P22 / obj,  P21 = P[m:, :m] / obj,
  G1 = 2 CBr^T Q CA / obj,  G2 = -2 CBr^T Q / obj,
so that the reduced gradient of ``LinearKmpc.solve`` over obj is
G1 z + G2 Yr + P21 u_prev.  z = [zeta; pcs^T g(zeta); 1] is linear in
[zeta; monomials; 1], so G1 folds into one generator block over those
features (``[G1z | G1m | G1b]``); fYr = G2 Yr is lane-shared and is
computed for every step up front (``fYr``).  The JAX package's bf16 hi/lo
splits of G1z and G1m are not carried over: the port's G1 is f32.

Carry semantics: those of ``StepFused``, except that the duals start cold
every step, so the dual carry starts at 1 and carries the equilibrated
multipliers, which no step reads (step_fused.py:244, :518).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from koopman_realizations_torch.ops.kernels import _build
from koopman_realizations_torch.ops.kernels.ipm_group import GroupPlan
from koopman_realizations_torch.ops.kernels.ipm_shared import (
    ConsStruct,
    check_cuda_f32,
    cons_config,
    symmetric_f32,
)
from koopman_realizations_torch.ops.kernels.step_fused import (
    FusedStepBase,
    StepCarry,
    StepIOStruct,
)
from koopman_realizations_torch.ops.observables import poly_features
from koopman_realizations_torch.ops.qp import (
    generator_block,
    mehrotra_loop,
    ok_mask,
    qp_constants,
)

SOURCE = "linear_step_fused.cu"


class LinearStepArgs(ctypes.Structure):
    _fields_ = ([("con", ConsStruct)]
                + [(k, ctypes.c_void_p) for k in
                   ("Psh", "G1", "P21", "cFr", "F0r", "Pwarm", "fYr")]
                + [("io", StepIOStruct), ("scratch", ctypes.c_void_p),
                   ("B", ctypes.c_longlong), ("iters", ctypes.c_int)])


def linear_fold(mpc) -> dict:
    """The fused step's lane-shared operands of a ``LinearKmpc``, f64
    numpy (step_fused.py:420-440): obj, Psh, P21, G1 (z-section,
    monomial section and bias folded through the PCA basis), G2."""
    m = mpc.m
    P = 2.0 * np.asarray(mpc.H, np.float64)
    obj = max(float(np.max(np.abs(P))), 1e-8)
    CBr = np.asarray(mpc.CB, np.float64)[:, m:]
    Qd = np.asarray(mpc.q_diag, np.float64)
    CA = np.asarray(mpc.CA, np.float64)
    G1 = (2.0 * CBr.T @ (Qd[:, None] * CA)) / obj
    G2 = (-2.0 * CBr.T * Qd[None, :]) / obj
    basis = mpc.model.basis
    nzq = basis.nzeta_aug
    P_T = np.asarray(basis.pcs, np.float64).T
    G1p = G1[:, nzq:nzq + P_T.shape[0]]
    return dict(obj=obj, Psh=P[m:, m:] / obj, P21=P[m:, :m] / obj,
                G1z=G1[:, :nzq] + G1p @ P_T[:, :nzq],
                G1m=G1p @ P_T[:, nzq:-1],
                G1b=G1[:, -1] + G1p @ P_T[:, -1], G2=G2)


class LinearStepFused(FusedStepBase):
    """The fused step of the linear controller
    (``build_linear_step_fused``): device operands, the initial carry,
    the per-step reference columns ``fYr`` and ``step``, whose reference
    operand is this step's fYr (n,)."""

    SHARED_HESSIAN = True

    def __init__(self, mpc, arm, scaler):
        super().__init__(mpc, arm, scaler)
        fold = linear_fold(mpc)
        self.obj = fold["obj"]
        self.tables = mpc.poly_tables()
        self.tables_host = mpc.tables_host
        self.nz, self.nmono = fold["G1z"].shape[1], fold["G1m"].shape[1]
        ncp = -(-(self.nz + self.nmono + 1) // 4) * 4
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                      dtype=self.dtype, device=self.device)
        self.Psh, self.P21, self.G2 = t(fold["Psh"]), t(fold["P21"]), \
            t(fold["G2"])
        self.G1 = t(generator_block(fold["G1z"], fold["G1m"], fold["G1b"],
                                    ncp))
        self.cFr, self.F0r = mpc.cFr, mpc.F0r
        # the kernel's block copy of Psh is its lower triangle, the plain
        # version reads both (the f64 products leave Psh a rounding off
        # symmetric; on the committed models its f32 cast is symmetric)
        if self.dtype == torch.float32 and not symmetric_f32(self.Psh):
            raise ValueError("linear_step_fused: Psh is not symmetric in "
                             "f32")

    def lam_init(self, B: int) -> torch.Tensor:
        return torch.ones((self.cons.mc, B), dtype=self.dtype,
                          device=self.device)

    def fYr(self, windows) -> torch.Tensor:
        """The lane-shared gradient column G2 @ Yr of every step: windows
        (K, p) scaled references -> (K, n), a plain matmul as the JAX
        package's XLA-side ``fYr_fn``."""
        return (windows.to(self.dtype) @ self.G2.T).contiguous()

    def _plan_spec(self, plan: GroupPlan) -> _build.KernelSpec:
        cons = self.cons
        return _build.KernelSpec(
            SOURCE, cons_config(cons) + _build.defines(KM_M=self.mpc.m)
            + _build.lift_config(self.tables_host, self.nz, self.nmono,
                                 self.G1.shape[1])
            + self.plant_config() + plan.config(cons.cols))

    def launch(self, c, fYr, out=None):
        return linear_step_fused_cuda(self, c, fYr, out)

    def step_plain(self, c: StepCarry, fYr) -> StepCarry:
        """Plain PyTorch version of the kernel (step_fused.py:185-258)."""
        cons = self.cons
        const = qp_constants(c.ysc.dtype)
        nf = self.nz + self.nmono
        f = torch.cat([c.ysc, poly_features(c.ysc, self.tables)])
        q = self.G1[:, :nf] @ f + self.G1[:, nf:nf + 1] + fYr[:, None] \
            + self.P21 @ c.upsc
        b = self.cFr[:, None] - self.F0r @ c.upsc
        Pr = self.Psh + const.reg * torch.eye(cons.n, dtype=self.dtype,
                                              device=self.device)
        x, s, lam = mehrotra_loop(cons, self.iters, 1e-2, Pr, q, b, c.x0,
                                  torch.ones_like(b), const.mu_floor)
        ok, _ = ok_mask(cons, b, x, s, lam, const.tol, const.gap_sane)
        return self.finish_plain(c, ok, x, lam)


def linear_step_fused_cuda(op: LinearStepFused, c: StepCarry, fYr,
                           out: Optional[StepCarry] = None) -> StepCarry:
    """Launch ``linear_step_front`` and ``linear_step_fused_kernel`` on
    the current stream; counts its calls in
    ``linear_step_fused_cuda.launches``: one a step, each two device
    launches (the front, then the solve)."""
    return _launch(op.launch_plan(), op, c, fYr, out)


def _launch(plan: GroupPlan, op: LinearStepFused, c: StepCarry, fYr,
            out: Optional[StepCarry] = None) -> StepCarry:
    """``linear_step_fused_cuda`` built with ``plan``."""
    cons = op.cons
    B = c.ysc.shape[1]
    out = op.checked_out(c, out, "linear_step_fused")
    check_cuda_f32(c.ysc, cons.A, cons.Wd, cons.Wo, op.Psh, op.G1, op.P21,
                   op.cFr, op.F0r, op.Pwarm, fYr, *c, *out)
    if fYr.shape != (cons.n,):
        raise ValueError("linear_step_fused: fYr must be one (n,) column")
    if op.G1.data_ptr() % 16:
        raise ValueError("gradient generators must be 16-byte aligned")
    lib = _build.load(op.kernel_spec() if plan is op.launch_plan()
                      else op._plan_spec(plan))
    scratch = op.scratch(plan, B)
    args = LinearStepArgs(
        ConsStruct.of(cons),
        *(t.data_ptr() for t in (op.Psh, op.G1, op.P21, op.cFr, op.F0r,
                                 op.Pwarm, fYr)),
        StepIOStruct.of(c, out), scratch.data_ptr(), B, op.iters)
    fn = lib.km_linear_step_fused
    fn.argtypes = [ctypes.POINTER(LinearStepArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ctypes.byref(args),
            torch.cuda.current_stream(c.ysc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"linear_step_fused kernel launch failed: CUDA "
                           f"error {rc}")
    linear_step_fused_cuda.launches += 1
    return StepCarry(out.ysc, out.upsc, out.xpl, c.w, out.alive, out.x0,
                     out.lamc, out.yp)


linear_step_fused_cuda.launches = 0


def build_linear_step_fused(mpc, arm, scaler) -> LinearStepFused:
    """Device operands and step function of the fused linear closed
    loop."""
    return LinearStepFused(mpc, arm, scaler)
