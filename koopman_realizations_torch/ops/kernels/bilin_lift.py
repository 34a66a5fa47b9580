"""Lift-fused bilinear QP: the CUDA kernel ``csrc/bilin_lift.cu`` and its
plain PyTorch version.

Replaces the TPU kernel ``_bilin_lift_kernel``
(``koopman_realizations_tpu/ops/pallas/qp_ipm.py:772``, reached through
``solve_qp_bilinear_lifted_batched`` :850 from ``ops/qp.py:423-532``):
one batched solve of the bench controller's QP from the raw measurement
zeta -- poly lift, assembly, factored Gram, objective scale, banded
A^T D A, Mehrotra.  The kernel is compute-bound on the card (~6.6e4
operations per lane on ~0.5 KB of lane data); it runs in two launches,
the lift, assembly and Gram a thread per lane, then the QP a group of
threads per lane (``csrc/lane_group.cuh``, planned by
``ipm_group.py:bilin_lift_plan``), the hand-over through a device
scratch row the wrapper allocates; see the note in the source.

``bilin_lift`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  ``solve_qp_bilinear_lifted``
adds the epilogue of the JAX wrapper (ok mask, non-finite x to NaN,
multipliers back to original units).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from koopman_realizations_torch.ops.kernels import _build
from koopman_realizations_torch.ops.kernels.ipm_group import (
    GroupPlan,
    bilin_lift_plan,
)
from koopman_realizations_torch.ops.kernels.ipm_shared import (
    ConsStruct,
    cons_config,
)
from koopman_realizations_torch.ops.qp import (
    LiftQP,
    QPSolution,
    ok_mask,
    qp_constants,
    qp_core_plain,
)

SOURCE = "bilin_lift.cu"


# ------------------------------------------------------------ build config


def live_config(live: tuple, n: int, m: int) -> str:
    """``#define`` lines of the assembly's live-row table
    (``csrc/kmpc_device.cuh:assemble``) from ``live``
    (``ops/qp.py:generator_live``, a word a stage row): for the W, CB0 and
    v generators the runs of consecutive stage rows with one mask of live
    rows, {first, end, mask} -- W: bit i for W[r, i]; CB0: bit j for
    CB0[r, j]; v: 1 -- and their counts."""
    out = ""
    for part, shift, width in (("W", 0, n), ("H", n, m), ("P", n + m, 1)):
        runs = []
        for r, word in enumerate(live):
            mask = (word >> shift) & ((1 << width) - 1)
            if runs and runs[-1][2] == mask:
                runs[-1][1] = r + 1
            else:
                runs.append([r, r + 1, mask])
        out += (_build.defines(**{"KM_NLIVE_" + part: len(runs)})
                + f"#define KM_LIVE_{part} "
                + _build.c_array(runs, fmt=lambda v: f"{int(v)}u") + "\n")
    return out


def qp_config(qp: LiftQP) -> str:
    """``#define`` lines of the QP half of a kernel configuration: the
    interior point's dimensions, the bilinear assembly's with its live-row
    table (``live_config``) and the poly lift (``_build.lift_config``)."""
    return (cons_config(qp.cons) + _build.defines(KM_P=qp.p, KM_M=qp.m)
            + live_config(qp.live, qp.n, qp.m)
            + _build.lift_config(qp.tables_host, qp.nz, qp.nmono,
                                 qp.gens.shape[1]))


class QPStruct(ctypes.Structure):
    """``km::QP`` of csrc/kmpc_device.cuh."""

    _fields_ = ([(k, ctypes.c_void_p) for k in
                 ("gens", "rdiag", "cFr", "F0r")]
                + [("con", ConsStruct)])

    @classmethod
    def of(cls, qp: LiftQP) -> "QPStruct":
        return cls(qp.gens.data_ptr(), qp.rdiag.data_ptr(),
                   qp.cFr.data_ptr(), qp.F0r.data_ptr(),
                   ConsStruct.of(qp.cons))


class BilinLiftArgs(ctypes.Structure):
    _fields_ = ([("qp", QPStruct)]
                + [(k, ctypes.c_void_p) for k in
                   ("zeta", "up", "x0", "lam0", "sqYr", "x", "s", "lam",
                    "obj", "scratch")]
                + [("B", ctypes.c_longlong), ("sqYr_lanes", ctypes.c_int),
                   ("iters", ctypes.c_int), ("slack_floor", ctypes.c_float)])


def launch_plan(qp: LiftQP) -> GroupPlan:
    """The build's group plan (``ipm_group.py:bilin_lift_plan``)."""
    return bilin_lift_plan(qp.cons, qp.m)


def kernel_spec(qp: LiftQP) -> _build.KernelSpec:
    return _spec(qp, launch_plan(qp))


def _spec(qp: LiftQP, plan: GroupPlan) -> _build.KernelSpec:
    return _build.KernelSpec(SOURCE, qp_config(qp)
                             + plan.config(qp.cons.cols))


def check_operands(qp: LiftQP, *tensors):
    """The kernels take contiguous f32 tensors on one CUDA device."""
    dev = qp.gens.device
    for t in (qp.gens, qp.rdiag, qp.A, qp.cFr, qp.F0r, qp.Wd, qp.Wo,
              *tensors):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(
                "CUDA kernels take contiguous float32 tensors on one device "
                f"(got {t.dtype} {t.device} contiguous={t.is_contiguous()})")
    if qp.gens.data_ptr() % 16:
        raise ValueError("generator stack must be 16-byte aligned")


# ---------------------------------------------------------------- kernel


def bilin_lift_cuda(qp: LiftQP, zeta, up, x0, lam0_row, sqYr, iters: int,
                    slack_floor: float):
    """Launch ``bilin_lift_front`` and ``bilin_lift_kernel`` on the
    current stream; returns (x, s, lam, obj), fresh tensors.  Counts its
    calls in ``bilin_lift_cuda.launches``: each two device launches (the
    front, then the solve)."""
    return _launch(launch_plan(qp), qp, zeta, up, x0, lam0_row, sqYr, iters,
                   slack_floor)


def _launch(plan: GroupPlan, qp: LiftQP, zeta, up, x0, lam0_row, sqYr,
            iters: int, slack_floor: float):
    """``bilin_lift_cuda`` built with ``plan``."""
    B = zeta.shape[1]
    ins = [zeta, up, x0, sqYr] + ([] if lam0_row is None else [lam0_row])
    check_operands(qp, *ins)
    if zeta.shape[0] != qp.nz or up.shape != (qp.m, B) \
            or x0.shape != (qp.n, B) or sqYr.shape[0] != qp.p \
            or (lam0_row is not None and lam0_row.shape != (qp.mc, B)) \
            or (sqYr.ndim == 2 and sqYr.shape[1] != B):
        raise ValueError("bilin_lift: operand shapes do not match the QP")
    lib = _build.load(_spec(qp, plan))
    new = lambda *shape: torch.empty(shape, dtype=zeta.dtype,
                                     device=zeta.device)
    x, s, lam, obj = new(qp.n, B), new(qp.mc, B), new(qp.mc, B), new(B)
    scratch = new(plan.grid(B) * plan.lanes * plan.scratch_floats)
    args = BilinLiftArgs(
        QPStruct.of(qp), zeta.data_ptr(), up.data_ptr(), x0.data_ptr(),
        None if lam0_row is None else lam0_row.data_ptr(), sqYr.data_ptr(),
        x.data_ptr(), s.data_ptr(), lam.data_ptr(), obj.data_ptr(),
        scratch.data_ptr(), B, int(sqYr.ndim == 2), int(iters),
        float(slack_floor))
    fn = lib.km_bilin_lift
    fn.argtypes = [ctypes.POINTER(BilinLiftArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ctypes.byref(args),
            torch.cuda.current_stream(zeta.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bilin_lift kernel launch failed: CUDA error "
                           f"{rc}")
    bilin_lift_cuda.launches += 1
    return x, s, lam, obj


bilin_lift_cuda.launches = 0


def bilin_lift_plain(qp: LiftQP, zeta, up, x0, lam0_row, sqYr, iters: int,
                     slack_floor: float):
    """Plain PyTorch version of the kernel: (x, s, lam, obj)."""
    x, s, lam, obj, _ = qp_core_plain(qp, zeta, up, sqYr, x0, lam0_row,
                                      iters, slack_floor)
    return x, s, lam, obj


def bilin_lift(qp: LiftQP, zeta, up, x0, lam0_row, sqYr, iters: int,
               slack_floor: float):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if zeta.is_cuda:
        return bilin_lift_cuda(qp, zeta, up, x0, lam0_row, sqYr, iters,
                               slack_floor)
    return bilin_lift_plain(qp, zeta, up, x0, lam0_row, sqYr, iters,
                            slack_floor)


def solve_qp_bilinear_lifted(qp: LiftQP, zeta, u_prev, sqYr,
                             x0: Optional[torch.Tensor] = None,
                             lam0: Optional[torch.Tensor] = None,
                             iters: int = 10) -> QPSolution:
    """Batched lift-fused bilinear solve (lanes-minor).

    zeta (nz, B), u_prev (m, B) scaled; sqYr (p,) or (p, B); x0 (n, B)
    primal warm start (None: zeros with the cold slack floor 1);
    lam0 (mc, B) multipliers in original units (None: cold lam = 1).
    """
    B = zeta.shape[1]
    slack_floor = 1.0 if x0 is None else 1e-2
    if x0 is None:
        x0 = zeta.new_zeros((qp.n, B))
    lam0_row = None if lam0 is None else \
        (lam0 * qp.row[:, None]).contiguous()
    x, s, lam, obj = bilin_lift(qp, zeta.contiguous(), u_prev.contiguous(),
                                x0.contiguous(), lam0_row,
                                sqYr.contiguous(), iters, slack_floor)
    b = qp.cFr[:, None] - qp.F0r @ u_prev
    c = qp_constants(zeta.dtype)
    ok, gap = ok_mask(qp.cons, b, x, s, lam, c.tol, c.gap_sane)
    finite = torch.isfinite(x).all(0)
    x = torch.where(finite, x, torch.full_like(x, float("nan")))
    return QPSolution(x=x, lam=lam * obj / qp.row[:, None], ok=ok, gap=gap)
