"""Interior-point QP with a lane-shared or per-lane Hessian: the CUDA
kernel ``csrc/ipm_shared.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``_ipm_kernel``
(``koopman_realizations_tpu/ops/pallas/qp_ipm.py:299``) in its two
dense-objective modes, reached through ``solve_qp_shared_batched``
(:411) from ``ops/qp.py:_pallas_routed_solver`` (:1204), one build each:

- lane-shared P (``shared_P=True``), when ``LinearKmpc.solve``
  (``control/kmpc.py:492-522``) runs over a batch of lanes: the Mehrotra
  loop against a host-equilibrated Hessian P / obj shared by every lane,
  the banded or (with state-bound rows) dense A^T D A, cold duals, or
  with ``qp_dual_warm`` the previous step's multipliers (the
  ``KM_WARM_DUAL`` build: JAX ``LinearKmpc.solve`` passes ``lam0`` to
  ``solve_qp``, kmpc.py:515-518, which reaches the kernel with
  ``warm_dual=True``, ops/qp.py:139-146);
- per-lane P (``shared_P=False``, the ``KM_LANE_P`` build), when the
  Hessian is batched with the rows lane-shared (the port's entry is
  ``ops/qp.py:solve_qp``, which the closed-loop lasso sweep calls,
  ``workflows/lasso_sweep.py``): each lane's P (n, n) scaled in-kernel
  by its objective scale 1 / max |P|, the banded or dense A^T D A, cold
  or warm duals.

Both take lane-shared row-equilibrated constraints and per-lane gradient,
right-hand side and primal start.  The kernel is compute-bound on the card
(~3e4 operations per lane on ~0.7 KB of lane data at n=12, plus the
per-lane P); it solves each lane with a group of threads in one launch
(``csrc/lane_group.cuh``; ``launch_plan`` from ``ipm_group.py``), the
lane-shared Hessian one copy a block -- its lower triangle, so
``solve_qp_shared`` refuses a Psh that is not symmetric in f32 -- and a
per-lane P staged by the block into each group's work region, both
triangles; see the note in the source.  The TPU kernel's factored mode
is ``ops/kernels/ipm_factored.py``.

``ipm_shared`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  ``solve_qp_shared`` adds
the JAX wrapper's equilibration and epilogue (objective scale, row scale,
slack floor, dual start, ok mask, non-finite x to NaN, multipliers in
original units); ``shared_operands`` gives the kernel's arguments
alone.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from koopman_realizations_torch.ops.kernels import _build
from koopman_realizations_torch.ops.kernels.ipm_group import (
    GroupPlan,
    lane_p_plan,
    shared_plan,
)
from koopman_realizations_torch.ops.qp import (
    Constraints,
    QPSolution,
    mehrotra_loop,
    ok_mask,
    qp_constants,
)

SOURCE = "ipm_shared.cu"


class ConsStruct(ctypes.Structure):
    """``km::Cons`` of csrc/kmpc_device.cuh."""

    _fields_ = [(k, ctypes.c_void_p) for k in ("A", "Wd", "Wo")]

    @classmethod
    def of(cls, cons: Constraints) -> "ConsStruct":
        return cls(*(getattr(cons, k).data_ptr() for k, _ in cls._fields_))


def symmetric_f32(P) -> bool:
    """P (numpy or a tensor) is symmetric bitwise once cast to f32."""
    P32 = np.asarray(P.cpu() if torch.is_tensor(P) else P, np.float32)
    return bool(np.array_equal(P32, P32.T))


def _args_fields(lane_p: bool):
    return ([("con", ConsStruct)]
            + [(k, ctypes.c_void_p) for k in
               ("Psh", "q", "b", "x0", "x", "s", "lam")
               + (("iobj", "lam0") if lane_p else ())]
            + [("B", ctypes.c_longlong), ("iters", ctypes.c_int),
               ("slack_floor", ctypes.c_float)])


class IpmSharedArgs(ctypes.Structure):
    _fields_ = _args_fields(False)


class IpmLanePArgs(ctypes.Structure):
    """The arguments of a ``KM_LANE_P`` build: iobj and lam0 after lam."""

    _fields_ = _args_fields(True)


class IpmWarmArgs(ctypes.Structure):
    """The arguments of a lane-shared ``KM_WARM_DUAL`` build: lam0 after
    lam."""

    _fields_ = ([("con", ConsStruct)]
                + [(k, ctypes.c_void_p) for k in
                   ("Psh", "q", "b", "x0", "x", "s", "lam", "lam0")]
                + [("B", ctypes.c_longlong), ("iters", ctypes.c_int),
                   ("slack_floor", ctypes.c_float)])


def cons_config(cons: Constraints) -> str:
    """``#define`` lines of the interior point's dimensions: the band
    offset, or -1 with the rows' nonzero count for the dense A^T D A (its
    entry table is the plan's, ``GroupPlan.config``)."""
    cfg = _build.defines(KM_N=cons.n, KM_MC=cons.mc,
                         KM_BAND=-1 if cons.band is None else cons.band)
    if cons.band is None:
        if len(cons.cols) != cons.mc:
            raise ValueError("a dense A^T D A needs each row's nonzero "
                             "columns (Constraints.cols)")
        cfg += _build.defines(KM_RNZ=len(cons.cols[0]))
    return cfg


def launch_plan(cons: Constraints, lane_p: bool = False) -> GroupPlan:
    """The build's group plan (``ipm_group.py``: ``shared_plan``, or
    ``lane_p_plan`` for the per-lane P)."""
    return lane_p_plan(cons) if lane_p else shared_plan(cons)


def kernel_spec(cons: Constraints, lane_p: bool = False,
                warm: bool = False) -> _build.KernelSpec:
    """One build per constraint shape and Hessian mode (lane-shared, or
    per lane with ``lane_p``); the lane-shared mode has a second build
    for warm duals (``warm``; the per-lane build takes both)."""
    return _spec(cons, lane_p, launch_plan(cons, lane_p), warm)


def _spec(cons: Constraints, lane_p: bool, plan: GroupPlan,
          warm: bool = False) -> _build.KernelSpec:
    mode = _build.defines(KM_LANE_P=1) if lane_p else \
        _build.defines(KM_WARM_DUAL=1) if warm else ""
    return _build.KernelSpec(SOURCE, cons_config(cons) + mode
                             + plan.config(cons.cols))


def check_cuda_f32(*tensors):
    """The kernels take contiguous float32 tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda" \
                or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "CUDA kernels take contiguous float32 tensors on one CUDA "
                f"device (got {t.dtype} {t.device} "
                f"contiguous={t.is_contiguous()})")


# ---------------------------------------------------------------- kernel


def ipm_shared_cuda(cons: Constraints, Psh, q, b, x0, iters: int,
                    slack_floor: float, iobj=None, lam0=None):
    """Launch ``ipm_shared_kernel`` on the current stream; returns
    (x, s, lam).  Psh (n, n) is the equilibrated lane-shared Hessian,
    symmetric in f32 (the kernel reads its lower triangle;
    ``solve_qp_shared`` checks it), or (n, n, B) the per-lane P with its
    objective scale iobj (B,) (the ``KM_LANE_P`` build, which reads all
    of each P).  lam0 (mc, B), the equilibrated dual start, or None
    (cold): the per-lane build takes both, the lane-shared P a build of
    each (``KM_WARM_DUAL``).  Counts its launches in
    ``ipm_shared_cuda.launches``."""
    return _launch(launch_plan(cons, Psh.ndim == 3), cons, Psh, q, b, x0,
                   iters, slack_floor, iobj, lam0)


def _launch(plan: GroupPlan, cons: Constraints, Psh, q, b, x0, iters: int,
            slack_floor: float, iobj=None, lam0=None):
    """``ipm_shared_cuda`` built with ``plan``."""
    n, mc = cons.n, cons.mc
    B = q.shape[1]
    lane_p = Psh.ndim == 3
    check_cuda_f32(q, Psh, b, x0, cons.A, cons.Wd, cons.Wo,
                   *[t for t in (iobj, lam0) if t is not None])
    if Psh.shape != ((n, n, B) if lane_p else (n, n)) \
            or q.shape != (n, B) or b.shape != (mc, B) \
            or x0.shape != (n, B) \
            or (iobj is None) == lane_p \
            or (lane_p and iobj.shape != (B,)) \
            or (lam0 is not None and lam0.shape != (mc, B)):
        raise ValueError("ipm_shared: operand shapes do not match the QP")
    warm = lam0 is not None and not lane_p
    lib = _build.load(_spec(cons, lane_p, plan, warm))
    x = torch.empty((n, B), dtype=q.dtype, device=q.device)
    s = torch.empty((mc, B), dtype=q.dtype, device=q.device)
    lam = torch.empty_like(s)
    ptrs = (Psh.data_ptr(), q.data_ptr(), b.data_ptr(), x0.data_ptr(),
            x.data_ptr(), s.data_ptr(), lam.data_ptr())
    Args = IpmLanePArgs if lane_p else IpmWarmArgs if warm \
        else IpmSharedArgs
    if lane_p:
        ptrs += (iobj.data_ptr(), None if lam0 is None else lam0.data_ptr())
    elif warm:
        ptrs += (lam0.data_ptr(),)
    args = Args(ConsStruct.of(cons), *ptrs, B, int(iters),
                float(slack_floor))
    fn = lib.km_ipm_shared
    fn.argtypes = [ctypes.POINTER(Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ctypes.byref(args),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ipm_shared kernel launch failed: CUDA error "
                           f"{rc}")
    ipm_shared_cuda.launches += 1
    return x, s, lam


ipm_shared_cuda.launches = 0


def ipm_shared_plain(cons: Constraints, Psh, q, b, x0, iters: int,
                     slack_floor: float, iobj=None, lam0=None):
    """Plain PyTorch version of the kernel: (x, s, lam)."""
    c = qp_constants(q.dtype)
    eye = torch.eye(cons.n, dtype=q.dtype, device=q.device)
    if Psh.ndim == 2:
        Pr = Psh + c.reg * eye
    else:
        Pr = Psh * iobj + c.reg * eye[..., None]
    lam = torch.ones_like(b) if lam0 is None \
        else torch.sqrt(torch.clamp(lam0, 1e-4, 1e4))
    return mehrotra_loop(cons, iters, slack_floor, Pr, q, b, x0, lam,
                         c.mu_floor)


def ipm_shared(cons: Constraints, Psh, q, b, x0, iters: int,
               slack_floor: float, iobj=None, lam0=None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = ipm_shared_cuda if q.is_cuda else ipm_shared_plain
    return fn(cons, Psh, q, b, x0, iters, slack_floor, iobj, lam0)


def shared_operands(P, q, cons: Constraints, b,
                    x0: Optional[torch.Tensor] = None,
                    iters: int = 10,
                    lam0: Optional[torch.Tensor] = None) -> tuple:
    """The equilibrated arguments that ``solve_qp_shared`` hands
    ``ipm_shared`` for the same QP (the JAX wrapper's equilibration,
    qp_ipm.py:411-560): (cons, P / obj or the per-lane P, q / obj,
    b / row, x0, iters, slack_floor, iobj or None, lam0 in row units / obj
    or None), and obj (B,)."""
    lane_p = P.ndim == 3
    obj = torch.clamp(P.abs().amax((0, 1)), min=1e-8)
    iobj = 1.0 / obj
    slack_floor = 1.0 if x0 is None else 1e-2
    if x0 is None:
        x0 = torch.zeros_like(q)
    row = cons.row[:, None]
    lam0_eq = None if lam0 is None else (lam0 * row * iobj).contiguous()
    if lane_p:
        Pk, ik = P.contiguous(), iobj.contiguous()
    else:
        Pk, ik = (P * iobj).contiguous(), None
        # the kernel keeps one copy of Psh's lower triangle a block, the
        # plain version reads all of it
        if Pk.dtype == torch.float32 and not symmetric_f32(Pk):
            raise ValueError("solve_qp_shared: the lane-shared P is not "
                             "symmetric in f32")
    return (cons, Pk, (q * iobj).contiguous(), (b / row).contiguous(),
            x0.contiguous(), iters, slack_floor, ik, lam0_eq), obj


def solve_shared_operands(args: tuple, obj) -> QPSolution:
    """``ipm_shared`` on ``shared_operands``' arguments, with the JAX
    wrapper's epilogue: the ok mask, non-finite x to NaN, multipliers in
    original units."""
    cons, b_eq = args[0], args[3]
    x, s, lam = ipm_shared(*args)
    c = qp_constants(b_eq.dtype)
    ok, gap = ok_mask(cons, b_eq, x, s, lam, c.tol, c.gap_sane)
    finite = torch.isfinite(x).all(0)
    x = torch.where(finite, x, torch.full_like(x, float("nan")))
    return QPSolution(x=x, lam=lam * obj / cons.row[:, None], ok=ok,
                      gap=gap)


def solve_qp_shared(P, q, cons: Constraints, b,
                    x0: Optional[torch.Tensor] = None,
                    iters: int = 10,
                    lam0: Optional[torch.Tensor] = None) -> QPSolution:
    """Batched QP min 1/2 x'Px + q'x s.t. A x <= b with A shared by every
    lane (``solve_qp_shared_batched``, qp_ipm.py:411-560), lanes-minor:
    P (n, n) shared by every lane (``shared_P=True``) or (n, n, B) per
    lane (``shared_P=False``), q (n, B) and b (mc, B) in original units,
    ``cons`` the row-equilibrated A, x0 (n, B) the primal start (None:
    zeros with the cold slack floor 1), lam0 (mc, B) multipliers in
    original units (None: cold lam = 1)."""
    return solve_shared_operands(*shared_operands(P, q, cons, b, x0, iters,
                                                  lam0))
