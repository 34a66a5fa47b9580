"""Batched small-SPD solve by Cholesky: the CUDA kernel
``csrc/batch_chol.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``_chol_solve_kernel``
(``koopman_realizations_tpu/ops/pallas/batch_chol.py:28``), reached
through ``solve_spd_pallas`` (:68, pallas_call :83), the ops layer's
public batched SPD solve: x = M^-1 b for M (B, n, n) and b (B, n).  The
factor takes per column an exact square root and one IEEE reciprocal
(never an approximate reciprocal square root), adds no regularization,
and the two triangular solves divide by the diagonal.  The kernel is
f32, one build per n; see the note in the source for its bound.

``solve_spd`` takes the plain version only for tensors on the CPU (any
float dtype: the JAX kernel runs in f64 too); for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from koopman_realizations_torch.ops.kernels import _build
from koopman_realizations_torch.ops.kernels.ipm_shared import check_cuda_f32
from koopman_realizations_torch.ops.qp import chol_lanes

SOURCE = "batch_chol.cu"
THREADS = 128


class BatchCholArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in ("M", "b", "x")]
                + [("B", ctypes.c_longlong)])


def kernel_spec(n: int) -> _build.KernelSpec:
    """One build per system size n."""
    return _build.KernelSpec(SOURCE, _build.defines(KM_N=n,
                                                    KM_THREADS=THREADS))


def _check(M, b):
    B, n = b.shape
    if M.shape != (B, n, n):
        raise ValueError(f"solve_spd: M {tuple(M.shape)} does not match "
                         f"b {tuple(b.shape)}")
    return B, n


def solve_spd_cuda(M, b):
    """Launch ``batch_chol_kernel`` on the current stream: M (B, n, n) and
    b (B, n), float32 on the card; returns x (B, n).  Counts its launches
    in ``solve_spd_cuda.launches``."""
    check_cuda_f32(M, b)
    B, n = _check(M, b)
    lib = _build.load(kernel_spec(n))
    x = torch.empty_like(b)
    args = BatchCholArgs(M.data_ptr(), b.data_ptr(), x.data_ptr(), B)
    fn = lib.km_batch_chol
    fn.argtypes = [ctypes.POINTER(BatchCholArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ctypes.byref(args),
            torch.cuda.current_stream(b.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"batch_chol kernel launch failed: CUDA error "
                           f"{rc}")
    solve_spd_cuda.launches += 1
    return x


solve_spd_cuda.launches = 0


def solve_spd_plain(M, b):
    """Plain PyTorch version of the kernel, lanes-minor as the TPU kernel
    (the factor of ``ops/qp.py:chol_lanes``; row-oriented substitutions,
    each row's sum subtracted in ascending column order): x (B, n)."""
    B, n = _check(M, b)
    L = chol_lanes(M.permute(1, 2, 0))               # (n, n, B)
    bt = b.T
    ys = []
    for i in range(n):
        acc = bt[i]
        for k in range(i):
            acc = acc - L[i, k] * ys[k]
        ys.append(acc / L[i, i])
    xs = [None] * n
    for i in reversed(range(n)):
        acc = ys[i]
        for k in range(i + 1, n):
            acc = acc - L[k, i] * xs[k]
        xs[i] = acc / L[i, i]
    return torch.stack(xs, dim=1)


def solve_spd(M, b):
    """x = M^-1 b for a batch of SPD systems, M (B, n, n) and b (B, n)
    (``solve_spd_pallas``): the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if b.is_cuda:
        return solve_spd_cuda(M.contiguous(), b.contiguous())
    return solve_spd_plain(M, b)
