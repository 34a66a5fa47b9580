"""Batched small-SPD solve by Cholesky: the CUDA kernel
``csrc/batch_chol.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``_chol_solve_kernel``
(``koopman_realizations_tpu/ops/pallas/batch_chol.py:28``), reached
through ``solve_spd_pallas`` (:68, pallas_call :83), the ops layer's
public batched SPD solve: x = M^-1 b for M (B, n, n) and b (B, n).  The
factor takes per column an exact square root and one IEEE reciprocal
(never an approximate reciprocal square root), adds no regularization,
and the two triangular solves divide by the diagonal.  The kernel is
f32, one build per n, bound by its bytes; its design is the build's
``CholPlan`` (``launch_plan``): at n=27 a block's systems are a
contiguous span of M staged through shared memory with coalesced
copies, each system factored by a group of 4 threads with its rows in
registers while the next span's copies land; at every other n (n=12 on
the main path) a thread a system straight from device memory; see the
note in the source.

``solve_spd`` takes the plain version only for tensors on the CPU (any
float dtype: the JAX kernel runs in f64 too); for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from koopman_realizations_torch.ops.kernels import _build
from koopman_realizations_torch.ops.kernels.ipm_group import SMEM_LIMIT
from koopman_realizations_torch.ops.kernels.ipm_shared import check_cuda_f32
from koopman_realizations_torch.ops.qp import chol_lanes

SOURCE = "batch_chol.cu"
# an SM's shared memory (228 KB); each resident block also takes 1 KB
SM_SMEM = 233472
# the sizes that take the staged design, each measured faster than the
# direct one on the card (PERF.md §6); every other n takes the direct
# design, which holds any n
STAGED_N = (27,)


class BatchCholArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in ("M", "b", "x")]
                + [("B", ctypes.c_longlong), ("grid", ctypes.c_int)])


@dataclass(frozen=True)
class CholPlan:
    """One build's launch (``csrc/batch_chol.cu``).  ``group`` 0: the
    direct design, a thread a system read straight from device memory,
    ``threads`` a block; a power of two 1 < G <= 32: the staged design,
    G threads a system with its rows of L in registers, ``span`` systems
    (and their b) at a time copied into shared memory, one round of the
    block's groups (``threads`` == G ``span``), in a persistent grid of
    ``blocks`` blocks an SM (0: as many as the shared memory fits)."""

    n: int
    group: int
    threads: int
    span: int = 0
    blocks: int = 0

    @property
    def staged(self) -> bool:
        return self.group > 0

    @property
    def stride(self) -> int:
        """Floats from one system to the next in shared memory: n^2 where
        it is odd (a warp's systems in 32 banks); else n^2 padded to 4
        mod 8, a multiple of 4 for the 16-byte copies (4-way conflicts at
        worst)."""
        nn = self.n * self.n
        return nn if nn % 2 or nn % 8 == 4 else nn + 4

    @property
    def smem_bytes(self) -> int:
        """A block's shared memory: the span's systems, b and x."""
        if not self.staged:
            return 0
        return 4 * self.span * (self.stride + 2 * self.n)

    @property
    def blocks_per_sm(self) -> int:
        return self.blocks or max(1, SM_SMEM // (self.smem_bytes + 1024))

    def spans(self, B: int) -> int:
        return -(-B // self.span)

    def grid(self, B: int, sms: int) -> int:
        """Blocks of the launch: the staged design's persistent grid (at
        most a block a span), else a block per ``threads`` systems, the
        last one ragged."""
        if self.staged:
            return min(self.spans(B), sms * self.blocks_per_sm)
        return -(-B // self.threads)

    def check(self) -> "CholPlan":
        ok = self.threads % 32 == 0
        if self.staged:
            ok &= (1 < self.group <= 32
                   and not self.group & (self.group - 1)
                   and self.span == self.threads // self.group
                   and self.span % 4 == 0
                   and self.smem_bytes <= SMEM_LIMIT
                   and self.blocks_per_sm * (self.smem_bytes + 1024)
                   <= SM_SMEM)
        if not ok:
            raise ValueError(f"bad batch_chol plan {self}")
        return self

    def describe(self) -> str:
        if not self.staged:
            return (f"direct, a thread a system, {self.threads} threads a "
                    f"block")
        return (f"a group of {self.group} threads a system, {self.threads} "
                f"threads a block, spans of {self.span} systems in shared "
                f"memory, {self.blocks_per_sm} block(s) an SM, "
                f"{self.smem_bytes} bytes")

    def config(self) -> str:
        cfg = _build.defines(KM_N=self.n, KC_GROUP=self.group,
                             KC_THREADS=self.threads)
        if self.staged:
            cfg += _build.defines(KC_SPAN=self.span, KC_STRIDE=self.stride,
                                  KC_SMEM_BYTES=self.smem_bytes)
        return cfg


@functools.lru_cache(maxsize=None)
def launch_plan(n: int) -> CholPlan:
    """The build's plan, the fastest measured (PERF.md §6, H100): for n in
    ``STAGED_N`` 4 threads a system on spans of 32 systems in shared
    memory, 128 threads a block, two blocks an SM (n=27: 98 KB of shared
    memory a block); else the direct design, 128 threads a block."""
    if n in STAGED_N:
        return CholPlan(n, 4, 128, span=32, blocks=2).check()
    return CholPlan(n, 0, 128).check()


@functools.lru_cache(maxsize=None)
def kernel_spec(n: int) -> _build.KernelSpec:
    """One build per system size n, its plan's defines."""
    return _spec(launch_plan(n))


@functools.lru_cache(maxsize=None)
def _spec(plan: CholPlan) -> _build.KernelSpec:
    return _build.KernelSpec(SOURCE, plan.config())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    return _launch(launch_plan(b.shape[-1]), M, b)


def _launch(plan: CholPlan, M, b):
    """``solve_spd_cuda`` built with ``plan``.  The staged design's copies
    are 16-byte: there an operand that does not start on 16 bytes is
    copied to one that does."""
    check_cuda_f32(M, b)
    B, n = _check(M, b)
    if plan.staged:
        M, b = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (M, b))
    lib = _build.load(_spec(plan))
    x = torch.empty_like(b)
    dev = b.device
    args = BatchCholArgs(M.data_ptr(), b.data_ptr(), x.data_ptr(), B,
                         plan.grid(B, _sm_count(dev.index or 0))
                         if plan.staged else 0)
    fn = lib.km_batch_chol
    fn.argtypes = [ctypes.POINTER(BatchCholArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
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
