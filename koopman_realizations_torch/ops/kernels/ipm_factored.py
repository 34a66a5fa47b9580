"""Interior-point QP in least-squares form: the CUDA kernel
``csrc/ipm_factored.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``_ipm_kernel``
(``koopman_realizations_tpu/ops/pallas/qp_ipm.py:299``) in its factored
mode, reached through ``solve_qp_factored_batched`` (:566, pallas_call
:648) from ``ops/qp.py:solve_qp_factored`` (:164-266) when the bilinear
controller leaves the lift-fused route (``control/kmpc.py:725-742``):
min ||W x + v||^2 + x' diag(r) x (+ q0' x) s.t. A x <= b with per-lane
W (p, n), v (p), b and starts, lane-shared r and row-equilibrated A with
the banded or dense A^T D A, cold or warm duals, and the optional
per-lane linear term q0 of the NMPC's 'linear' between-pass update
(``control/kmpc.py:1545-1564``), a build of its own (``KM_Q0``).  The
kernel solves each lane with a group of threads, the factor in shared
memory (``csrc/ipm_group.cuh``); ``launch_plan`` (``ipm_group.py``) sets
the group size, lanes per block and shared memory from (n, mc).

``ipm_factored`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  ``solve_qp_factored`` adds
the JAX wrapper's work (row equilibration of b, the row-scaled dual
start, the slack floor, ok mask, non-finite x to NaN, multipliers in
original units).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from koopman_realizations_torch.ops.kernels import _build
from koopman_realizations_torch.ops.kernels.ipm_group import (
    GroupPlan,
    factored_plan,
)
from koopman_realizations_torch.ops.kernels.ipm_shared import (
    ConsStruct,
    check_cuda_f32,
    cons_config,
)
from koopman_realizations_torch.ops.qp import (
    Constraints,
    QPSolution,
    factored_core,
    ok_mask,
    qp_constants,
)

SOURCE = "ipm_factored.cu"


def _args_fields(q0: bool):
    return ([("con", ConsStruct)]
            + [(k, ctypes.c_void_p) for k in
               ("rdiag", "W", "v", "b", "x0", "lam0", "x", "s", "lam", "obj")
               + (("q0",) if q0 else ())]
            + [("B", ctypes.c_longlong), ("iters", ctypes.c_int),
               ("slack_floor", ctypes.c_float)])


class IpmFactoredArgs(ctypes.Structure):
    _fields_ = _args_fields(False)


class IpmFactoredQ0Args(ctypes.Structure):
    """The arguments of a ``KM_Q0`` build: q0 after obj."""

    _fields_ = _args_fields(True)


def launch_plan(cons: Constraints, p: int) -> GroupPlan:
    """The build's group plan (``ipm_group.py``): the group size follows
    from (n, mc)."""
    return factored_plan(cons, p)


def kernel_spec(cons: Constraints, p: int,
                q0: bool = False) -> _build.KernelSpec:
    """One build per (n, mc, band, p) and q0 or not: the interior point's
    dimensions, the number of W rows, the additive linear term (the
    builds without it keep their arguments) and the group plan."""
    return _spec(cons, p, q0, launch_plan(cons, p))


def _spec(cons: Constraints, p: int, q0: bool,
          plan: GroupPlan) -> _build.KernelSpec:
    return _build.KernelSpec(SOURCE, cons_config(cons)
                             + _build.defines(KM_P=p)
                             + (_build.defines(KM_Q0=1) if q0 else "")
                             + plan.config(cons.cols))


# ---------------------------------------------------------------- kernel


def ipm_factored_cuda(cons: Constraints, rdiag, W, v, b, x0, lam0_row,
                      iters: int, slack_floor: float, q0=None):
    """Launch ``ipm_factored_kernel`` on the current stream: W (p, n, B),
    v (p, B), b (mc, B) equilibrated, x0 (n, B), lam0_row (mc, B) or None,
    q0 (n, B) in original units or None (the ``KM_Q0`` build); returns
    (x, s, lam, obj).  Counts its launches in
    ``ipm_factored_cuda.launches``."""
    return _launch(launch_plan(cons, v.shape[0]), cons, rdiag, W, v, b, x0,
                   lam0_row, iters, slack_floor, q0)


def _launch(plan: GroupPlan, cons: Constraints, rdiag, W, v, b, x0,
            lam0_row, iters: int, slack_floor: float, q0=None):
    """``ipm_factored_cuda`` built with ``plan``."""
    n, mc = cons.n, cons.mc
    p, B = v.shape
    ins = [W, v, b, x0, rdiag, cons.A, cons.Wd, cons.Wo] \
        + [t for t in (lam0_row, q0) if t is not None]
    check_cuda_f32(*ins)
    if W.shape != (p, n, B) or b.shape != (mc, B) or x0.shape != (n, B) \
            or rdiag.shape != (n,) \
            or (lam0_row is not None and lam0_row.shape != (mc, B)) \
            or (q0 is not None and q0.shape != (n, B)):
        raise ValueError("ipm_factored: operand shapes do not match the QP")
    lib = _build.load(_spec(cons, p, q0 is not None, plan))
    x = torch.empty((n, B), dtype=v.dtype, device=v.device)
    s = torch.empty((mc, B), dtype=v.dtype, device=v.device)
    lam = torch.empty_like(s)
    obj = torch.empty((B,), dtype=v.dtype, device=v.device)
    ptrs = (rdiag.data_ptr(), W.data_ptr(), v.data_ptr(), b.data_ptr(),
            x0.data_ptr(),
            None if lam0_row is None else lam0_row.data_ptr(), x.data_ptr(),
            s.data_ptr(), lam.data_ptr(), obj.data_ptr())
    Args = IpmFactoredArgs if q0 is None else IpmFactoredQ0Args
    if q0 is not None:
        ptrs += (q0.data_ptr(),)
    args = Args(ConsStruct.of(cons), *ptrs, B, int(iters),
                float(slack_floor))
    fn = lib.km_ipm_factored
    fn.argtypes = [ctypes.POINTER(Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ctypes.byref(args),
            torch.cuda.current_stream(v.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ipm_factored kernel launch failed: CUDA error "
                           f"{rc}")
    ipm_factored_cuda.launches += 1
    return x, s, lam, obj


ipm_factored_cuda.launches = 0


def ipm_factored_plain(cons: Constraints, rdiag, W, v, b, x0, lam0_row,
                       iters: int, slack_floor: float, q0=None):
    """Plain PyTorch version of the kernel: (x, s, lam, obj)."""
    p, n, B = W.shape
    return factored_core(cons, W.reshape(p * n, B), v, rdiag, b, x0,
                         lam0_row, iters, slack_floor, q0)


def ipm_factored(cons: Constraints, rdiag, W, v, b, x0, lam0_row,
                 iters: int, slack_floor: float, q0=None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = ipm_factored_cuda if v.is_cuda else ipm_factored_plain
    return fn(cons, rdiag, W, v, b, x0, lam0_row, iters, slack_floor, q0)


def solve_qp_factored(W, v, rdiag, cons: Constraints, b,
                      x0: Optional[torch.Tensor] = None,
                      lam0: Optional[torch.Tensor] = None,
                      iters: int = 10,
                      q0: Optional[torch.Tensor] = None) -> QPSolution:
    """Batched least-squares-form QP min ||W x + v||^2 + x' diag(r) x
    (+ q0' x) s.t. A x <= b (``solve_qp_factored_batched``,
    qp_ipm.py:566-683), lanes-minor: W (p, n, B), v (p, B), b (mc, B) in
    original units, ``cons`` the row-equilibrated A, x0 (n, B) the primal
    start (None: zeros with the cold slack floor 1), lam0 (mc, B)
    multipliers in original units (None: cold lam = 1), q0 (n, B) the
    additive linear term in original units (None: none)."""
    slack_floor = 1.0 if x0 is None else 1e-2
    if x0 is None:
        x0 = v.new_zeros((cons.n, v.shape[1]))
    row = cons.row[:, None]
    b_eq = (b / row).contiguous()
    lam0_row = None if lam0 is None else (lam0 * row).contiguous()
    x, s, lam, obj = ipm_factored(
        cons, rdiag, W.contiguous(), v.contiguous(), b_eq, x0.contiguous(),
        lam0_row, iters, slack_floor,
        None if q0 is None else q0.contiguous())
    c = qp_constants(v.dtype)
    ok, gap = ok_mask(cons, b_eq, x, s, lam, c.tol, c.gap_sane)
    finite = torch.isfinite(x).all(0)
    x = torch.where(finite, x, torch.full_like(x, float("nan")))
    return QPSolution(x=x, lam=lam * obj / row, ok=ok, gap=gap)
