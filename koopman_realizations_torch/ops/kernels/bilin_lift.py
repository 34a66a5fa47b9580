"""Lift-fused bilinear QP: the CUDA kernel ``csrc/bilin_lift.cu`` and its
plain PyTorch version.

Replaces the TPU kernel ``_bilin_lift_kernel``
(``koopman_realizations_tpu/ops/pallas/qp_ipm.py:772``, reached through
``solve_qp_bilinear_lifted_batched`` :850 from ``ops/qp.py:423-532``):
one batched solve of the bench controller's QP from the raw measurement
zeta -- poly lift, assembly, factored Gram, objective scale, banded
A^T D A, Mehrotra.  The kernel is compute-bound on the card (~6.6e4
operations per lane on ~0.5 KB of lane data); see the note in the source.

``bilin_lift`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  ``solve_qp_bilinear_lifted``
adds the epilogue of the JAX wrapper (ok mask, non-finite x to NaN,
multipliers back to original units).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from koopman_realizations_torch.ops.kernels import _build
from koopman_realizations_torch.ops.qp import (
    LiftQP,
    ok_mask,
    qp_constants,
    qp_core_plain,
)

SOURCE = "bilin_lift.cu"
THREADS = 128


class QPSolution(NamedTuple):
    x: torch.Tensor      # (n, B) primal solution, NaN where not finite
    lam: torch.Tensor    # (mc, B) multipliers in original units
    ok: torch.Tensor     # (B,) bool
    gap: torch.Tensor    # (B,) final complementarity gap


# ------------------------------------------------------------ build config


def qp_config(qp: LiftQP) -> str:
    """``#define`` lines of the QP half of a kernel configuration: the
    dimensions and the monomial recurrence as straight-line statements
    (static indices, so the features stay in registers).  The kernels
    form A^T D A from the banded tables only."""
    if qp.band is None:
        raise NotImplementedError(
            "the CUDA kernels need a banded A^T D A (band offset is None)")
    return _qp_config(qp.tables_host, qp.nz, qp.nmono, qp.gens.shape[1],
                      qp.n, qp.mc, qp.p, qp.m, qp.band)


@functools.lru_cache(maxsize=None)
def _qp_config(tables, nz, nmono, ncp, n, mc, p, m, band) -> str:
    stmts = []
    base_prev, base = 0, nz
    for par, dim in tables:
        for r in range(len(par)):
            stmts.append(f"f[{base + r}] = f[{base_prev + par[r]}] * "
                         f"f[{dim[r]}];")
        base_prev, base = base, base + len(par)
    lines = [
        f"#define KM_NZ {nz}", f"#define KM_NMONO {nmono}",
        f"#define KM_NCP {ncp}", f"#define KM_N {n}", f"#define KM_MC {mc}",
        f"#define KM_P {p}", f"#define KM_M {m}", f"#define KM_BAND {band}",
        f"#define KM_THREADS {THREADS}",
        "#define KM_LIFT_FEATURES(f) do { " + " ".join(stmts) + " } while (0)",
    ]
    return "\n".join(lines) + "\n"


class QPStruct(ctypes.Structure):
    """``km::QP`` of csrc/kmpc_device.cuh."""

    _fields_ = [(k, ctypes.c_void_p) for k in
                ("gens", "rdiag", "A", "cFr", "F0r", "Wd", "Wo")]

    @classmethod
    def of(cls, qp: LiftQP) -> "QPStruct":
        return cls(*(getattr(qp, k).data_ptr() for k, _ in cls._fields_))


class BilinLiftArgs(ctypes.Structure):
    _fields_ = ([("qp", QPStruct)]
                + [(k, ctypes.c_void_p) for k in
                   ("zeta", "up", "x0", "lam0", "sqYr", "x", "s", "lam",
                    "obj")]
                + [("B", ctypes.c_longlong), ("sqYr_lanes", ctypes.c_int),
                   ("iters", ctypes.c_int), ("slack_floor", ctypes.c_float)])


def kernel_spec(qp: LiftQP) -> _build.KernelSpec:
    return _build.KernelSpec(SOURCE, qp_config(qp))


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
    """Launch ``bilin_lift_kernel`` on the current stream; returns
    (x, s, lam, obj).  Counts its launches in ``bilin_lift_cuda.launches``."""
    B = zeta.shape[1]
    ins = [zeta, up, x0, sqYr] + ([] if lam0_row is None else [lam0_row])
    check_operands(qp, *ins)
    if zeta.shape[0] != qp.nz or up.shape != (qp.m, B) \
            or x0.shape != (qp.n, B) or sqYr.shape[0] != qp.p \
            or (lam0_row is not None and lam0_row.shape != (qp.mc, B)):
        raise ValueError("bilin_lift: operand shapes do not match the QP")
    lib = _build.load(kernel_spec(qp))
    x = torch.empty((qp.n, B), dtype=zeta.dtype, device=zeta.device)
    s = torch.empty((qp.mc, B), dtype=zeta.dtype, device=zeta.device)
    lam = torch.empty_like(s)
    obj = torch.empty((B,), dtype=zeta.dtype, device=zeta.device)
    args = BilinLiftArgs(
        QPStruct.of(qp), zeta.data_ptr(), up.data_ptr(), x0.data_ptr(),
        None if lam0_row is None else lam0_row.data_ptr(), sqYr.data_ptr(),
        x.data_ptr(), s.data_ptr(), lam.data_ptr(), obj.data_ptr(), B,
        int(sqYr.ndim == 2), int(iters), float(slack_floor))
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
    ok, gap = ok_mask(qp, b, x, s, lam, c.tol, c.gap_sane)
    finite = torch.isfinite(x).all(0)
    x = torch.where(finite, x, torch.full_like(x, float("nan")))
    return QPSolution(x=x, lam=lam * obj / qp.row[:, None], ok=ok, gap=gap)
