"""Assembly-fused bilinear QP from the lifted state: the CUDA kernel
``csrc/bilin.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``_bilin_kernel``
(``koopman_realizations_tpu/ops/pallas/qp_ipm.py:998``, reached through
``solve_qp_bilinear_batched`` :2010, pallas_call :2089, from
``ops/qp.py:solve_qp_bilinear``): the first pass of the blocked bilinear
controller with iterated relinearization (``control/kmpc.py:701-712``) --
W, v and b assembled from the lane's lifted state z and previous input
against the lane-shared generators, then the factored Gram, objective
scale, banded A^T D A and Mehrotra.  The kernel is compute-bound on the
card; it runs in two launches, the assembly and Gram a thread per lane,
then the QP a group of threads per lane (``csrc/lane_group.cuh``, planned
by ``ipm_group.py:bilin_lift_plan``, as ``bilin_lift``), the hand-over
through a device scratch row the wrapper allocates; see the note in the
source.

``bilin`` takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``solve_qp_bilinear`` adds the
epilogue of the JAX wrapper (ok mask, non-finite x to NaN, multipliers
back to original units).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from koopman_realizations_torch.ops.kernels import _build
from koopman_realizations_torch.ops.kernels.bilin_lift import (
    QPStruct,
    check_operands,
    live_config,
)
from koopman_realizations_torch.ops.kernels.ipm_group import (
    GroupPlan,
    bilin_lift_plan,
)
from koopman_realizations_torch.ops.kernels.ipm_shared import cons_config
from koopman_realizations_torch.ops.qp import (
    BilinQP,
    QPSolution,
    bilin_assemble,
    factored_core,
    ok_mask,
    qp_constants,
)

SOURCE = "bilin.cu"


class BilinArgs(ctypes.Structure):
    _fields_ = ([("qp", QPStruct)]
                + [(k, ctypes.c_void_p) for k in
                   ("z", "up", "x0", "lam0", "sqYr", "x", "s", "lam",
                    "obj", "scratch")]
                + [("B", ctypes.c_longlong), ("sqYr_lanes", ctypes.c_int),
                   ("iters", ctypes.c_int), ("slack_floor", ctypes.c_float)])


def launch_plan(qp: BilinQP) -> GroupPlan:
    """The build's group plan: ``bilin_lift``'s
    (``ipm_group.py:bilin_lift_plan``), the same QP after the front."""
    return bilin_lift_plan(qp.cons, qp.m)


def kernel_spec(qp: BilinQP) -> _build.KernelSpec:
    """The QP's dimensions, the assembly's live-row table
    (``bilin_lift.py:live_config``) and the plan."""
    return _spec(qp, launch_plan(qp))


def _spec(qp: BilinQP, plan: GroupPlan) -> _build.KernelSpec:
    return _build.KernelSpec(SOURCE, cons_config(qp.cons) + _build.defines(
        KM_P=qp.p, KM_M=qp.m, KM_NZL=qp.nzl, KM_NCP=qp.gens.shape[1])
        + live_config(qp.live, qp.n, qp.m) + plan.config(qp.cons.cols))


# ---------------------------------------------------------------- kernel


def bilin_cuda(qp: BilinQP, z, up, x0, lam0_row, sqYr, iters: int,
               slack_floor: float):
    """Launch ``bilin_front`` and ``bilin_kernel`` on the current stream;
    returns (x, s, lam, obj), fresh tensors.  Counts its calls in
    ``bilin_cuda.launches``: each two device launches (the front, then the
    solve)."""
    return _launch(launch_plan(qp), qp, z, up, x0, lam0_row, sqYr, iters,
                   slack_floor)


def _launch(plan: GroupPlan, qp: BilinQP, z, up, x0, lam0_row, sqYr,
            iters: int, slack_floor: float):
    """``bilin_cuda`` built with ``plan``."""
    B = z.shape[1]
    ins = [z, up, x0, sqYr] + ([] if lam0_row is None else [lam0_row])
    check_operands(qp, *ins)
    if z.shape[0] != qp.nzl or up.shape != (qp.m, B) \
            or x0.shape != (qp.n, B) or sqYr.shape[0] != qp.p \
            or (lam0_row is not None and lam0_row.shape != (qp.mc, B)) \
            or (sqYr.ndim == 2 and sqYr.shape[1] != B):
        raise ValueError("bilin: operand shapes do not match the QP")
    lib = _build.load(_spec(qp, plan))
    new = lambda *shape: torch.empty(shape, dtype=z.dtype, device=z.device)
    x, s, lam, obj = new(qp.n, B), new(qp.mc, B), new(qp.mc, B), new(B)
    scratch = new(plan.grid(B) * plan.lanes * plan.scratch_floats)
    args = BilinArgs(
        QPStruct.of(qp), z.data_ptr(), up.data_ptr(), x0.data_ptr(),
        None if lam0_row is None else lam0_row.data_ptr(), sqYr.data_ptr(),
        x.data_ptr(), s.data_ptr(), lam.data_ptr(), obj.data_ptr(),
        scratch.data_ptr(), B, int(sqYr.ndim == 2), int(iters),
        float(slack_floor))
    fn = lib.km_bilin
    fn.argtypes = [ctypes.POINTER(BilinArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ctypes.byref(args),
            torch.cuda.current_stream(z.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bilin kernel launch failed: CUDA error {rc}")
    bilin_cuda.launches += 1
    return x, s, lam, obj


bilin_cuda.launches = 0


def bilin_plain(qp: BilinQP, z, up, x0, lam0_row, sqYr, iters: int,
                slack_floor: float):
    """Plain PyTorch version of the kernel: (x, s, lam, obj)."""
    Wf, v, b = bilin_assemble(qp, z, up, sqYr)
    return factored_core(qp.cons, Wf, v, qp.rdiag, b, x0, lam0_row, iters,
                         slack_floor)


def bilin(qp: BilinQP, z, up, x0, lam0_row, sqYr, iters: int,
          slack_floor: float):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = bilin_cuda if z.is_cuda else bilin_plain
    return fn(qp, z, up, x0, lam0_row, sqYr, iters, slack_floor)


def solve_qp_bilinear(qp: BilinQP, z, u_prev, sqYr,
                      x0: Optional[torch.Tensor] = None,
                      lam0: Optional[torch.Tensor] = None,
                      iters: int = 10) -> QPSolution:
    """Batched assembly-fused bilinear solve (lanes-minor): z (nzl, B)
    lifted states, u_prev (m, B) scaled; sqYr (p,) or (p, B); x0 (n, B)
    primal start (None: zeros with the cold slack floor 1); lam0 (mc, B)
    multipliers in original units (None: cold lam = 1)."""
    B = z.shape[1]
    slack_floor = 1.0 if x0 is None else 1e-2
    if x0 is None:
        x0 = z.new_zeros((qp.n, B))
    lam0_row = None if lam0 is None else \
        (lam0 * qp.row[:, None]).contiguous()
    x, s, lam, obj = bilin(qp, z.contiguous(), u_prev.contiguous(),
                           x0.contiguous(), lam0_row, sqYr.contiguous(),
                           iters, slack_floor)
    b = qp.cFr[:, None] - qp.F0r @ u_prev
    c = qp_constants(z.dtype)
    ok, gap = ok_mask(qp.cons, b, x, s, lam, c.tol, c.gap_sane)
    finite = torch.isfinite(x).all(0)
    x = torch.where(finite, x, torch.full_like(x, float("nan")))
    return QPSolution(x=x, lam=lam * obj / qp.row[:, None], ok=ok, gap=gap)
