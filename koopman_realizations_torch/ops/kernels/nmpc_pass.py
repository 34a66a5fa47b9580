"""One SQP pass from shipped stage Jacobians (the chord passes): the CUDA
kernel ``csrc/nmpc_pass.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``_nmpc_kernel``
(``koopman_realizations_tpu/ops/pallas/qp_ipm.py:1144``, called at :1340
by ``solve_qp_nmpc_batched`` :1233, reached from ``ops/qp.py:
solve_qp_nmpc`` :567 when ``NonlinearKmpc._solve_from``,
``control/kmpc.py:1451-1457`` and :1520-1525, runs with
``sqp_jac_period > 1`` over a batch of lanes): the sensitivity
condensation of the stage Jacobians Jt and defects cv the controller
forms (``ops/nmpc.py:stage_lin``, fresh or frozen), the factored Gram with
the pass's rdiag and optional per-lane q0, and the Mehrotra loop from x0
with cold duals or a warm lam0: the stage sweep a thread per lane, the
QP a group of threads per lane (``csrc/nmpc_group.cuh``, planned by
``launch_plan``), the Hessian handed over through a device scratch row
the wrapper allocates.  See the note in the source for its bound.

``nmpc_pass`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  ``solve_qp_nmpc_pass``
adds the JAX wrapper's prologue and epilogue (qp_ipm.py:1284-1293,
:1368-1382).

The unblocked stack's builds (n=27, mc=108) hand each pass's
projected rows over instead of the Hessian, and a warp a lane forms
the Gram (``ipm_group.py:_wide_nmpc_plan``).
"""

from __future__ import annotations

import ctypes

import torch

from koopman_realizations_torch.ops.kernels import _build
from koopman_realizations_torch.ops.kernels.ipm_group import (
    GroupPlan,
    onepass_plan,
)
from koopman_realizations_torch.ops.kernels.ipm_shared import check_cuda_f32
from koopman_realizations_torch.ops.kernels.nmpc_multipass import (
    NmpcStruct,
    nmpc_config,
)
from koopman_realizations_torch.ops.kernels.nmpc_stage import (
    check_lane_operands,
    lane_starts,
    optional_ptr,
    outputs,
)
# the kernel's plain version is the Jacobian pass of ops/nmpc.py
from koopman_realizations_torch.ops.nmpc import (
    NmpcQP,
    jacobian_pass as nmpc_pass_plain,
    solution,
)
from koopman_realizations_torch.ops.qp import QPSolution

SOURCE = "nmpc_pass.cu"


def launch_plan(qp: NmpcQP) -> GroupPlan:
    """The build's group plan (``ipm_group.py``)."""
    return onepass_plan(qp.cons, qp.m, qp.p)


def kernel_spec(qp: NmpcQP) -> _build.KernelSpec:
    return _spec(qp, launch_plan(qp))


def _spec(qp: NmpcQP, plan: GroupPlan) -> _build.KernelSpec:
    return _build.KernelSpec(SOURCE, nmpc_config(qp)
                             + plan.config(qp.cons.cols))


class PassArgs(ctypes.Structure):
    _fields_ = ([("op", NmpcStruct)]
                + [(k, ctypes.c_void_p) for k in
                   ("Jt", "cv", "zeta", "up", "sqRef", "x0", "q0", "lam0",
                    "x", "s", "lam", "obj", "scratch")]
                + [("B", ctypes.c_longlong), ("sqRef_lanes", ctypes.c_int),
                   ("iters", ctypes.c_int), ("slack_floor", ctypes.c_float)])


# ---------------------------------------------------------------- kernel


def nmpc_pass_cuda(qp: NmpcQP, Jt, cv, zeta, up, sqRef, x0, q0, lam0_row,
                   iters: int, slack_floor: float):
    """Launch ``nmpc_pass_sweep`` and ``nmpc_pass_kernel`` on the current
    stream with Jt (Np, nza, nz, B) and cv (Np, nz, B); returns (x, s,
    lam, obj).  Counts its calls in ``nmpc_pass_cuda.launches``: one a
    pass, each two device launches (the sweep, then the solve)."""
    return _launch(launch_plan(qp), qp, Jt, cv, zeta, up, sqRef, x0, q0,
                   lam0_row, iters, slack_floor)


def _launch(plan: GroupPlan, qp: NmpcQP, Jt, cv, zeta, up, sqRef, x0, q0,
            lam0_row, iters: int, slack_floor: float):
    """``nmpc_pass_cuda`` built with ``plan``."""
    B = zeta.shape[1]
    opt = [t for t in (q0, lam0_row) if t is not None]
    check_cuda_f32(Jt, cv, zeta, up, sqRef, x0, *opt, qp.A1, qp.A2, qp.a0,
                   qp.G, qp.CzS, qp.rdiag, qp.cFr, qp.F0r, qp.A, qp.Wd, qp.Wo)
    check_lane_operands(qp, zeta, up, sqRef, x0, q0, lam0_row, "nmpc_pass")
    if Jt.shape != (qp.Np, qp.nza, qp.nz, B) or cv.shape != (qp.Np, qp.nz, B):
        raise ValueError("nmpc_pass: Jacobian shapes do not match the QP")
    lib = _build.load(_spec(qp, plan))
    x, s, lam, obj, scratch = outputs(qp, plan, zeta)
    args = PassArgs(
        NmpcStruct.of(qp), Jt.data_ptr(), cv.data_ptr(), zeta.data_ptr(),
        up.data_ptr(), sqRef.data_ptr(), x0.data_ptr(), optional_ptr(q0),
        optional_ptr(lam0_row), x.data_ptr(), s.data_ptr(), lam.data_ptr(),
        obj.data_ptr(), scratch.data_ptr(), B, int(sqRef.ndim == 2),
        int(iters), float(slack_floor))
    fn = lib.km_nmpc_pass
    fn.argtypes = [ctypes.POINTER(PassArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ctypes.byref(args),
            torch.cuda.current_stream(zeta.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nmpc_pass kernel launch failed: CUDA error "
                           f"{rc}")
    nmpc_pass_cuda.launches += 1
    return x, s, lam, obj


nmpc_pass_cuda.launches = 0


def nmpc_pass(qp: NmpcQP, Jt, cv, zeta, up, sqRef, x0, q0, lam0_row,
              iters: int, slack_floor: float):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = nmpc_pass_cuda if zeta.is_cuda else nmpc_pass_plain
    return fn(qp, Jt, cv, zeta, up, sqRef, x0, q0, lam0_row, iters,
              slack_floor)


def solve_qp_nmpc_pass(qp: NmpcQP, Jt, cv, zeta, u_prev, sqRef, x0=None,
                       q0=None, lam0=None, iters: int = 10) -> QPSolution:
    """Batched one-pass NMPC solve from stage Jacobians (lanes-minor):
    Jt (Np, nza, nz, B) with Jt[k, i, o] = dF_o/dx_i, cv (Np, nz, B),
    zeta (nz, B) and u_prev (m, B) scaled, sqRef (p,) or (p, B);
    ``qp.rdiag`` the pass's input cost + rho bsizes; x0 / q0 (n, B), lam0
    (mc, B) in original units, each optional."""
    x0, lam0_row, floor = lane_starts(qp, zeta, x0, lam0)
    x, s, lam, obj = nmpc_pass(
        qp, Jt.contiguous(), cv.contiguous(), zeta.contiguous(),
        u_prev.contiguous(), sqRef.contiguous(), x0,
        None if q0 is None else q0.contiguous(), lam0_row, iters, floor)
    return solution(qp, u_prev, x, s, lam, obj)
