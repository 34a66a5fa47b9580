"""Whole-SQP NMPC solve: the CUDA kernel ``csrc/nmpc_multipass.cu`` and its
plain PyTorch version.

Replaces the TPU kernel ``_nmpc_multipass_kernel``
(``koopman_realizations_tpu/ops/pallas/qp_ipm.py:1422``, called at :1801
by ``solve_qp_nmpc_multipass_batched`` :1726, reached from
``ops/qp.py:solve_qp_nmpc_multipass`` :1064 when
``NonlinearKmpc._solve_from``, ``control/kmpc.py:1373-1401``, runs its
default SQP regime over a batch of lanes): every SQP pass in one launch --
the rollout of the composed F, the analytic stage Jacobians, the defects,
the sensitivity condensation, the factored Gram with the Levenberg term
and the Mehrotra loop from the previous pass's primal with cold duals.
The kernel is compute-bound on the card (~0.7 M operations per lane on
~0.4 KB of lane data); its stage sweep runs a thread per lane, each pass's
QP a group of threads per lane (``csrc/ipm_group.cuh``, planned by
``launch_plan``), the Hessian handed over through a device scratch row
the wrapper allocates; see the note in the source.

``nmpc_multipass`` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.
``solve_qp_nmpc_multipass`` adds the epilogue of the JAX wrapper (ok mask,
non-finite x to NaN, multipliers back to original units).

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
    nmpc_plan,
)
from koopman_realizations_torch.ops.kernels.ipm_shared import (
    ConsStruct,
    check_cuda_f32,
    cons_config,
)
# the kernel's plain version is the pass loop of ops/nmpc.py
from koopman_realizations_torch.ops.nmpc import (
    NmpcQP,
    multipass_plain as nmpc_multipass_plain,
    solution,
)
from koopman_realizations_torch.ops.qp import QPSolution

SOURCE = "nmpc_multipass.cu"


# ------------------------------------------------------------ build config


def nmpc_config(qp: NmpcQP) -> str:
    """``#define`` lines of one NMPC configuration: the interior point's
    dimensions, the model's and the horizon's, the stage column table and
    the monomial recurrence as straight-line statements (g_low's blocks
    into ``g``; the top-degree monomials as terms handed to a consumer
    macro, never stored)."""
    nza = qp.nza
    stmts, terms = [], []
    if qp.tables_host:      # none where F is not formed in the kernel
        lows, top = qp.tables_host[:-1], qp.tables_host[-1]
        base_prev, base = 0, nza
        for par, dim in lows:
            for r in range(len(par)):
                stmts.append(f"g[{base + r}] = g[{base_prev + par[r]}] * "
                             f"g[{dim[r]}];")
            base_prev, base = base, base + len(par)
        col0 = qp.nmono - len(top[0])
        terms = [f"T(g[{base_prev + p}] * g[{d}], {col0 + r});"
                 for r, (p, d) in enumerate(zip(*top))]
    return (cons_config(qp.cons)
            + _build.defines(KM_M=qp.m, KN_NZ=qp.nz, KN_NZA=nza,
                             KN_NS=qp.ns, KN_NPROJ=qp.nproj, KN_NP=qp.Np,
                             KN_NLOW=qp.nlow, KN_NLOWP=qp.G.shape[1],
                             KN_NMONO=qp.nmono)
            + "#define KN_COLS {" + ", ".join(map(str, qp.cols)) + "}\n"
            + "#define KN_GLOW(g) do { " + " ".join(stmts) + " } while (0)\n"
            + "#define KN_F_TOP(g, T) do { " + " ".join(terms)
            + " } while (0)\n")


def launch_plan(qp: NmpcQP) -> GroupPlan:
    """The build's group plan (``ipm_group.py``)."""
    return nmpc_plan(qp.cons, qp.m, qp.p)


def kernel_spec(qp: NmpcQP) -> _build.KernelSpec:
    return _spec(qp, launch_plan(qp))


def _spec(qp: NmpcQP, plan: GroupPlan) -> _build.KernelSpec:
    return _build.KernelSpec(SOURCE, nmpc_config(qp)
                             + plan.config(qp.cons.cols))


class NmpcStruct(ctypes.Structure):
    """``km::Nmpc`` of csrc/nmpc_device.cuh."""

    _fields_ = ([(k, ctypes.c_void_p) for k in
                 ("A1", "A2", "a0", "G", "Gup", "q0c", "CzS", "rdiag", "cFr",
                  "F0r")]
                + [("con", ConsStruct)])

    @classmethod
    def of(cls, qp: NmpcQP) -> "NmpcStruct":
        return cls(*(getattr(qp, k).data_ptr() for k, _ in cls._fields_[:-1]),
                   ConsStruct.of(qp.cons))


class NmpcArgs(ctypes.Structure):
    _fields_ = ([("op", NmpcStruct)]
                + [(k, ctypes.c_void_p) for k in
                   ("zeta", "up", "sqRef", "x", "s", "lam", "obj", "scratch")]
                + [("B", ctypes.c_longlong), ("sqRef_lanes", ctypes.c_int),
                   ("iters", ctypes.c_int), ("passes", ctypes.c_int),
                   ("hold0", ctypes.c_int)])


# ---------------------------------------------------------------- kernel


def nmpc_multipass_cuda(qp: NmpcQP, zeta, up, sqRef, passes: int,
                        hold0: bool, iters: int):
    """Launch ``nmpc_multipass_kernel`` on the current stream; returns
    (x, s, lam, obj).  Counts its launches in
    ``nmpc_multipass_cuda.launches``."""
    return _launch(launch_plan(qp), qp, zeta, up, sqRef, passes, hold0,
                   iters)


def _launch(plan: GroupPlan, qp: NmpcQP, zeta, up, sqRef, passes: int,
            hold0: bool, iters: int):
    """``nmpc_multipass_cuda`` built with ``plan``."""
    B = zeta.shape[1]
    check_cuda_f32(zeta, up, sqRef, qp.A1, qp.A2, qp.a0, qp.G, qp.Gup,
                   qp.q0c, qp.CzS, qp.rdiag, qp.cFr, qp.F0r, qp.A, qp.Wd,
                   qp.Wo)
    if zeta.shape[0] != qp.nz or up.shape != (qp.m, B) \
            or sqRef.shape[0] != qp.p \
            or (sqRef.ndim == 2 and sqRef.shape[1] != B):
        raise ValueError("nmpc_multipass: operand shapes do not match the QP")
    if passes < 1:
        raise ValueError("nmpc_multipass: at least one SQP pass")
    if qp.G.data_ptr() % 16:
        raise ValueError("the Jacobian generator must be 16-byte aligned")
    lib = _build.load(_spec(qp, plan))
    x = torch.empty((qp.n, B), dtype=zeta.dtype, device=zeta.device)
    s = torch.empty((qp.mc, B), dtype=zeta.dtype, device=zeta.device)
    lam = torch.empty_like(s)
    obj = torch.empty((B,), dtype=zeta.dtype, device=zeta.device)
    scratch = torch.empty((plan.grid(B) * plan.lanes * plan.scratch_floats,),
                          dtype=zeta.dtype, device=zeta.device)
    args = NmpcArgs(
        NmpcStruct.of(qp), zeta.data_ptr(), up.data_ptr(), sqRef.data_ptr(),
        x.data_ptr(), s.data_ptr(), lam.data_ptr(), obj.data_ptr(),
        scratch.data_ptr(), B,
        int(sqRef.ndim == 2), int(iters), int(passes), int(bool(hold0)))
    fn = lib.km_nmpc_multipass
    fn.argtypes = [ctypes.POINTER(NmpcArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ctypes.byref(args),
            torch.cuda.current_stream(zeta.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nmpc_multipass kernel launch failed: CUDA "
                           f"error {rc}")
    nmpc_multipass_cuda.launches += 1
    return x, s, lam, obj


nmpc_multipass_cuda.launches = 0


def nmpc_multipass(qp: NmpcQP, zeta, up, sqRef, passes: int, hold0: bool,
                   iters: int):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if zeta.is_cuda:
        return nmpc_multipass_cuda(qp, zeta, up, sqRef, passes, hold0, iters)
    return nmpc_multipass_plain(qp, zeta, up, sqRef, passes, hold0, iters)


def solve_qp_nmpc_multipass(qp: NmpcQP, zeta, u_prev, sqRef, passes: int,
                            hold0: bool, iters: int) -> QPSolution:
    """Batched whole-SQP NMPC solve (lanes-minor): zeta (nz, B) and
    u_prev (m, B) scaled, sqRef (p,) or (p, B) the sqrt(Q)-scaled
    reference window.  Returns the last pass's solution."""
    x, s, lam, obj = nmpc_multipass(qp, zeta.contiguous(),
                                    u_prev.contiguous(), sqRef.contiguous(),
                                    passes, hold0, iters)
    return solution(qp, u_prev, x, s, lam, obj)
