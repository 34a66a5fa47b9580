"""One SQP pass with the stage Jacobians formed in the kernel: the CUDA
kernel ``csrc/nmpc_stage.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``_nmpc_stage_kernel``
(``koopman_realizations_tpu/ops/pallas/qp_ipm.py:1560``, called at :1961
by ``solve_qp_nmpc_stages_batched`` :1848, reached from
``ops/qp.py:solve_qp_nmpc_stages`` :879 when ``NonlinearKmpc._solve_from``,
``control/kmpc.py:1439-1568``, runs an SQP regime off the whole-SQP route
over a batch of lanes): the linearization trajectory shipped (Zl, Ul, Fv),
held at (zeta, u_prev) or rolled from the plan Ul, the stage Jacobians and
defects along it, the sensitivity condensation, the factored Gram with the
pass's rdiag and optional per-lane q0, and the Mehrotra loop from x0 with
cold duals or a warm lam0.  The kernel is compute-bound on the card; its
stage sweep runs a thread per lane, the pass's QP a group of threads per
lane (``csrc/nmpc_group.cuh``, planned by ``launch_plan``), the Hessian
handed over through a device scratch row the wrapper allocates; see the
note in the source.

``nmpc_stage`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  ``solve_qp_nmpc_stages``
adds the JAX wrapper's prologue and epilogue (qp_ipm.py:1903-1912,
:1990-2003: the slack floor, lam0 into row units, the ok mask, non-finite
x to NaN, multipliers back to original units).

The unblocked stack's builds (n=27, mc=108) hand each pass's
projected rows over instead of the Hessian, and a warp a lane forms
the Gram (``ipm_group.py:_wide_nmpc_plan``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

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
# the kernel's plain version is the stage pass of ops/nmpc.py
from koopman_realizations_torch.ops.nmpc import (
    STAGE_MODES,
    NmpcQP,
    solution,
    stage_pass as nmpc_stage_plain,
)
from koopman_realizations_torch.ops.qp import QPSolution

SOURCE = "nmpc_stage.cu"


def launch_plan(qp: NmpcQP) -> GroupPlan:
    """The builds' group plan (``ipm_group.py``)."""
    return onepass_plan(qp.cons, qp.m, qp.p)


def kernel_spec(qp: NmpcQP, mode: str) -> _build.KernelSpec:
    """One build per trajectory source (``STAGE_MODES``)."""
    return _spec(qp, mode, launch_plan(qp))


def _spec(qp: NmpcQP, mode: str, plan: GroupPlan) -> _build.KernelSpec:
    return _build.KernelSpec(SOURCE, nmpc_config(qp) + _build.defines(
        KN_STAGE_MODE=STAGE_MODES.index(mode))
        + plan.config(qp.cons.cols))


class StageArgs(ctypes.Structure):
    _fields_ = ([("op", NmpcStruct)]
                + [(k, ctypes.c_void_p) for k in
                   ("Zl", "Ul", "Fv", "zeta", "up", "sqRef", "x0", "q0",
                    "lam0", "x", "s", "lam", "obj", "scratch")]
                + [("B", ctypes.c_longlong), ("sqRef_lanes", ctypes.c_int),
                   ("iters", ctypes.c_int), ("slack_floor", ctypes.c_float)])


def optional_ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's data pointer, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def check_lane_operands(qp: NmpcQP, zeta, up, sqRef, x0, q0, lam0_row,
                        name: str):
    """Shapes of the per-lane operands every NMPC pass kernel takes."""
    B = zeta.shape[1]
    if zeta.shape[0] != qp.nz or up.shape != (qp.m, B) \
            or sqRef.shape[0] != qp.p \
            or (sqRef.ndim == 2 and sqRef.shape[1] != B) \
            or x0.shape != (qp.n, B) \
            or (q0 is not None and q0.shape != (qp.n, B)) \
            or (lam0_row is not None and lam0_row.shape != (qp.mc, B)):
        raise ValueError(f"{name}: operand shapes do not match the QP")
    if qp.G.data_ptr() % 16:
        raise ValueError("the Jacobian generator must be 16-byte aligned")


def outputs(qp: NmpcQP, plan: GroupPlan, zeta) -> tuple:
    """A one-pass kernel's outputs x, s, lam, obj and its hand-over
    scratch (``plan.scratch_floats`` a lane of the grid), uninitialized."""
    B = zeta.shape[1]
    new = lambda *shape: torch.empty(shape, dtype=zeta.dtype,
                                     device=zeta.device)
    return (new(qp.n, B), new(qp.mc, B), new(qp.mc, B), new(B),
            new(plan.grid(B) * plan.lanes * plan.scratch_floats))


# ---------------------------------------------------------------- kernel


def nmpc_stage_cuda(qp: NmpcQP, mode: str, zeta, up, sqRef, x0, q0,
                    lam0_row, iters: int, slack_floor: float, Zl=None,
                    Ul=None, Fv=None):
    """Launch ``nmpc_stage_sweep`` and ``nmpc_stage_kernel`` (the build of
    ``mode``) on the current stream; returns (x, s, lam, obj).  Counts
    its calls in ``nmpc_stage_cuda.launches``: one a pass, each two
    device launches (the sweep, then the solve)."""
    return _launch(launch_plan(qp), qp, mode, zeta, up, sqRef, x0, q0,
                   lam0_row, iters, slack_floor, Zl=Zl, Ul=Ul, Fv=Fv)


def _launch(plan: GroupPlan, qp: NmpcQP, mode: str, zeta, up, sqRef, x0,
            q0, lam0_row, iters: int, slack_floor: float, Zl=None, Ul=None,
            Fv=None):
    """``nmpc_stage_cuda`` built with ``plan``."""
    B = zeta.shape[1]
    shipped = {"ship": (Zl, Ul, Fv), "hold": (), "roll": (Ul,)}[mode]
    if any(t is None for t in shipped):
        raise ValueError(f"nmpc_stage: mode {mode!r} needs its trajectory")
    opt = [t for t in (q0, lam0_row) if t is not None]
    check_cuda_f32(zeta, up, sqRef, x0, *opt, *shipped, qp.A1, qp.A2, qp.a0,
                   qp.G, qp.CzS, qp.rdiag, qp.cFr, qp.F0r, qp.A, qp.Wd, qp.Wo)
    check_lane_operands(qp, zeta, up, sqRef, x0, q0, lam0_row, "nmpc_stage")
    traj, moves = (qp.Np, qp.nz, B), (qp.Np * qp.m, B)
    shapes = {"ship": (traj, moves, traj), "hold": (), "roll": (moves,)}[mode]
    if any(t.shape != r for t, r in zip(shipped, shapes)):
        raise ValueError("nmpc_stage: trajectory shapes do not match the QP")
    if mode == "roll":
        Zl = Fv = None
    elif mode == "hold":
        Zl = Ul = Fv = None
    lib = _build.load(_spec(qp, mode, plan))
    x, s, lam, obj, scratch = outputs(qp, plan, zeta)
    args = StageArgs(
        NmpcStruct.of(qp), optional_ptr(Zl), optional_ptr(Ul),
        optional_ptr(Fv), zeta.data_ptr(), up.data_ptr(), sqRef.data_ptr(),
        x0.data_ptr(), optional_ptr(q0), optional_ptr(lam0_row),
        x.data_ptr(), s.data_ptr(), lam.data_ptr(), obj.data_ptr(),
        scratch.data_ptr(), B, int(sqRef.ndim == 2), int(iters),
        float(slack_floor))
    fn = lib.km_nmpc_stage
    fn.argtypes = [ctypes.POINTER(StageArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ctypes.byref(args),
            torch.cuda.current_stream(zeta.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nmpc_stage kernel launch failed: CUDA error "
                           f"{rc}")
    nmpc_stage_cuda.launches += 1
    return x, s, lam, obj


nmpc_stage_cuda.launches = 0


def nmpc_stage(qp: NmpcQP, mode: str, zeta, up, sqRef, x0, q0, lam0_row,
               iters: int, slack_floor: float, Zl=None, Ul=None, Fv=None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = nmpc_stage_cuda if zeta.is_cuda else nmpc_stage_plain
    return fn(qp, mode, zeta, up, sqRef, x0, q0, lam0_row, iters,
              slack_floor, Zl=Zl, Ul=Ul, Fv=Fv)


def lane_starts(qp: NmpcQP, zeta, x0, lam0):
    """The JAX wrappers' starts: x0 (None: zeros with the cold slack
    floor 1, else the warm floor 1e-2) and lam0 in original units into row
    units (``lam0 * row``, qp_ipm.py:1910-1912); all contiguous."""
    slack_floor = 1.0 if x0 is None else 1e-2
    if x0 is None:
        x0 = zeta.new_zeros((qp.n, zeta.shape[1]))
    lam0_row = None if lam0 is None \
        else (lam0 * qp.row[:, None]).contiguous()
    return x0.contiguous(), lam0_row, slack_floor


def solve_qp_nmpc_stages(qp: NmpcQP, mode: str, zeta, u_prev, sqRef,
                         x0=None, q0=None, lam0=None, iters: int = 10,
                         Zl=None, Ul=None, Fv=None) -> QPSolution:
    """Batched one-pass NMPC solve with in-kernel Jacobians
    (lanes-minor): zeta (nz, B) and u_prev (m, B) scaled, sqRef (p,) or
    (p, B) the sqrt(Q)-scaled reference window; the trajectory by ``mode``
    -- 'ship': Zl (Np, nz, B), Ul (Np*m, B), Fv (Np, nz, B); 'roll': Ul;
    'hold': none; ``qp.rdiag`` the pass's input cost + rho bsizes; x0 / q0
    (n, B), lam0 (mc, B) in original units, each optional."""
    x0, lam0_row, floor = lane_starts(qp, zeta, x0, lam0)
    c = lambda t: None if t is None else t.contiguous()
    x, s, lam, obj = nmpc_stage(
        qp, mode, zeta.contiguous(), u_prev.contiguous(), sqRef.contiguous(),
        x0, c(q0), lam0_row, iters, floor, Zl=c(Zl), Ul=c(Ul), Fv=c(Fv))
    return solution(qp, u_prev, x, s, lam, obj)
