"""One closed-loop MPC step per launch: the CUDA kernel
``csrc/step_fused.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``_step_kernel``
(``koopman_realizations_tpu/ops/pallas/step_fused.py:90``, with
``_plant_freeze_epilogue`` :150 and ``_markers_rows`` :61, built by
``build_step_fused`` :527): per lane, the lift-fused QP of the bilinear
controller, the ok mask, SDIRK2 of the arm on the PREVIOUS input, the
marker outputs, the alive freeze and the carry advance.  The kernel is
compute-bound on the card (~7e4 operations per lane-step on ~0.6 KB of
carry); see the note in the source.

Carry semantics (step_fused.py:23-31 of the JAX package): zeta IS the
scaled output (no delays); the next primal start is the static one-hot
map ``Pwarm @ x`` (the previous plan shifted by one stage, one move per
group); the dual carry rides in row-equilibrated * obj units and starts
at ``row`` (step_fused.py:647), which the kernel damps to
sqrt(clip(row / obj)) -- the general runner's start from lam = 1 in
original units reaches the same value.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from koopman_realizations_torch.ops.kernels import _build
from koopman_realizations_torch.ops.kernels.bilin_lift import (
    QPStruct,
    check_operands,
    qp_config,
)
from koopman_realizations_torch.ops.qp import (
    ok_mask,
    qp_constants,
    qp_core_plain,
)

SOURCE = "step_fused.cu"


class StepCarry(NamedTuple):
    """Lanes-minor closed-loop carry of the fused step."""

    ysc: torch.Tensor     # (ny, B) scaled outputs == zeta
    upsc: torch.Tensor    # (m, B) previous input, scaled
    xpl: torch.Tensor     # (nx, B) plant state
    w: torch.Tensor       # (2, B) loads (constant)
    alive: torch.Tensor   # (B,) 1.0 alive / 0.0 frozen
    x0: torch.Tensor      # (n, B) next primal start
    lamc: torch.Tensor    # (mc, B) dual carry, row-equilibrated * obj
    yp: torch.Tensor      # (nproj, B) tracked outputs


class StepArgs(ctypes.Structure):
    _fields_ = ([("qp", QPStruct)]
                + [(k, ctypes.c_void_p) for k in
                   ("Pwarm", "ysc", "upsc", "xpl", "w", "alive", "x0",
                    "lamc", "yp", "sqYr", "ysc_o", "upsc_o", "xpl_o",
                    "alive_o", "x0_o", "lamc_o", "yp_o")]
                + [("B", ctypes.c_longlong), ("sqYr_lanes", ctypes.c_int),
                   ("iters", ctypes.c_int)])


def pwarm_matrix(Sel, Tb, Np: int, m: int) -> np.ndarray:
    """Sel @ shift-rows @ Tb (step_fused.py:600-607): the receding-horizon
    primal start as a one-hot map of the previous solution's moves."""
    S_rows = np.zeros(((Np - 1) * m, (Np - 1) * m))
    for k in range(Np - 1):
        src = min(k + 1, Np - 2)
        S_rows[k * m:(k + 1) * m, src * m:(src + 1) * m] = np.eye(m)
    return np.asarray(Sel) @ S_rows @ np.asarray(Tb)


class StepFused:
    """The fused step of one controller/plant pair (``build_step_fused``):
    device operands, the initial carry and ``step``."""

    def __init__(self, mpc, arm, scaler):
        cfg = arm.cfg
        if cfg.output_type != "markers" or cfg.jac_mode != "step":
            raise NotImplementedError(
                "the fused step takes marker outputs and jac_mode 'step'")
        self.mpc, self.arm, self.scaler = mpc, arm, scaler
        self.qp = mpc.lift_qp()
        self.iters = int(mpc.cfg.qp_iters)
        self.proj_idx = tuple(mpc.proj_idx)
        dev, dt = self.qp.gens.device, self.qp.gens.dtype
        self.Pwarm = torch.as_tensor(
            pwarm_matrix(mpc.Sel, mpc.Tb, mpc.Np, mpc.m), dtype=dt,
            device=dev)
        self._spec = None

    # ------------------------------------------------------------ carry

    def init_carry(self, X0, W) -> StepCarry:
        """Carry at step 0 from initial plant states X0 (B, nx) and loads
        W (B, 2), row-major as the JAX runner takes them; the previous
        input is zero."""
        qp, sc = self.qp, self.scaler
        dev, dt = qp.gens.device, qp.gens.dtype
        X0 = torch.as_tensor(np.asarray(X0), dtype=dt, device=dev).T
        B = X0.shape[1]
        y0 = self.arm.get_y(X0)
        ysc0 = sc.y_down(y0.double(), axis=0).to(dt)
        u0_sc = torch.as_tensor(sc.u_down(np.zeros(qp.m)), dtype=dt,
                                device=dev)
        nf = qp.n // qp.m
        ones = torch.ones(B, dtype=dt, device=dev)
        return StepCarry(
            ysc=ysc0.contiguous(),
            upsc=(u0_sc[:, None] * ones).contiguous(),
            xpl=X0.contiguous(),
            w=torch.as_tensor(np.asarray(W), dtype=dt,
                              device=dev).T.contiguous(),
            alive=ones.clone(),
            x0=(u0_sc.repeat(nf)[:, None] * ones).contiguous(),
            lamc=(qp.row[:, None] * ones).contiguous(),
            yp=y0[list(self.proj_idx)].contiguous())

    # ------------------------------------------------------------ config

    def kernel_spec(self) -> _build.KernelSpec:
        if self._spec is None:
            self._spec = self._make_spec()
        return self._spec

    def _make_spec(self) -> _build.KernelSpec:
        cfg = self.arm.cfg
        G, b = self.arm.G_host, self.arm.b_host
        sc, hexf, arr = self.scaler, _build.hexf, _build.c_array
        l2 = cfg.l ** 2
        c0 = [[l2 * (cfg.m * float(G[p, q])) for q in range(cfg.Nlinks)]
              for p in range(cfg.Nlinks)]
        plant = [
            f"#define KM_NL {cfg.Nlinks}", f"#define KM_NLPM {cfg.nlinks}",
            f"#define KM_NY {cfg.ny}",
            f"#define KM_NPROJ {len(self.proj_idx)}",
            f"#define KM_PROJ {arr(self.proj_idx, str)}",
            f"#define KM_ARM_C0 {arr(c0)}",
            f"#define KM_ARM_C1 {arr([cfg.m * float(v) for v in b])}",
            f"#define KM_ARM_L2 {hexf(l2)}",
            f"#define KM_ARM_IROT {hexf(cfg.i)}",
            f"#define KM_ARM_GL {hexf(cfg.g * cfg.l)}",
            f"#define KM_ARM_KSPR {hexf(cfg.k)}",
            f"#define KM_ARM_DAMP {hexf(cfg.d)}",
            f"#define KM_ARM_NEG_KU {hexf(-cfg.ku)}",
            f"#define KM_ARM_L {hexf(cfg.l)}",
            f"#define KM_ARM_NEG_L {hexf(-cfg.l)}",
            f"#define KM_DT {hexf(cfg.Ts / cfg.substeps)}",
            f"#define KM_SUBSTEPS {cfg.substeps}",
            f"#define KM_NEWTON {cfg.newton_iters}",
            f"#define KM_UF {arr(np.asarray(sc.u_factor).ravel())}",
            f"#define KM_UO {arr(np.asarray(sc.u_offset).ravel())}",
            f"#define KM_YF {arr(np.asarray(sc.y_factor).ravel())}",
            f"#define KM_YO {arr(np.asarray(sc.y_offset).ravel())}",
        ]
        return _build.KernelSpec(SOURCE,
                                 qp_config(self.qp) + "\n".join(plant) + "\n")

    # -------------------------------------------------------------- step

    def step(self, c: StepCarry, sqYr, out: Optional[StepCarry] = None):
        """One closed-loop step.  CUDA carries launch the kernel (writing
        into ``out``, which may be the input carry itself); CPU carries run
        the plain version.  Returns the new carry."""
        if c.ysc.is_cuda:
            return step_fused_cuda(self, c, sqYr, out)
        new = self.step_plain(c, sqYr)
        if out is None:
            return new
        for dst, src in zip(out, new):
            if dst is not src:
                dst.copy_(src)
        return out

    def step_plain(self, c: StepCarry, sqYr) -> StepCarry:
        """Plain PyTorch version of the kernel (step_fused.py:90-182)."""
        qp, sc, arm = self.qp, self.scaler, self.arm
        const = qp_constants(c.ysc.dtype)
        x, s, lam, obj, b = qp_core_plain(qp, c.ysc, c.upsc, sqYr, c.x0,
                                          c.lamc, self.iters, 1e-2)
        ok, _ = ok_mask(qp, b, x, s, lam, const.tol, const.gap_sane)
        xs = arm.step(c.xpl, sc.u_up(c.upsc, axis=0), c.w)
        fin = torch.isfinite(xs).all(0)
        y = arm.get_y(xs)
        keep = (c.alive > 0.5) & ok & fin
        sel = lambda new, old: torch.where(keep, new, old)
        return StepCarry(
            ysc=sel(sc.y_down(y, axis=0), c.ysc),
            upsc=sel(x[:qp.m], c.upsc),
            xpl=sel(xs, c.xpl),
            w=c.w,
            alive=keep.to(c.alive.dtype),
            x0=sel(self.Pwarm @ x, c.x0),
            lamc=sel(lam * obj, c.lamc),
            yp=sel(y[list(self.proj_idx)], c.yp))


def step_fused_cuda(op: StepFused, c: StepCarry, sqYr,
                    out: Optional[StepCarry] = None) -> StepCarry:
    """Launch ``step_fused_kernel`` on the current stream; counts its
    launches in ``step_fused_cuda.launches``."""
    qp = op.qp
    B = c.ysc.shape[1]
    if out is None:
        out = StepCarry(*(torch.empty_like(t) for t in c))
    check_operands(qp, op.Pwarm, sqYr, *c, *out)
    cfg = op.arm.cfg
    shapes = [(cfg.ny, B), (qp.m, B), (cfg.nx, B), (2, B), (B,),
              (qp.n, B), (qp.mc, B), (len(op.proj_idx), B)]
    for t, o, shp in zip(c, out, shapes):
        if tuple(t.shape) != shp or tuple(o.shape) != shp:
            raise ValueError(f"step_fused: carry shape {tuple(t.shape)}, "
                             f"expected {shp}")
    if sqYr.shape[0] != qp.p:
        raise ValueError("step_fused: sqYr must have p rows")
    lib = _build.load(op.kernel_spec())
    args = StepArgs(
        QPStruct.of(qp), op.Pwarm.data_ptr(),
        *(t.data_ptr() for t in (c.ysc, c.upsc, c.xpl, c.w, c.alive, c.x0,
                                 c.lamc, c.yp)),
        sqYr.data_ptr(),
        *(t.data_ptr() for t in (out.ysc, out.upsc, out.xpl, out.alive,
                                 out.x0, out.lamc, out.yp)),
        B, int(sqYr.ndim == 2), op.iters)
    fn = lib.km_step_fused
    fn.argtypes = [ctypes.POINTER(StepArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ctypes.byref(args),
            torch.cuda.current_stream(c.ysc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"step_fused kernel launch failed: CUDA error {rc}")
    step_fused_cuda.launches += 1
    return StepCarry(out.ysc, out.upsc, out.xpl, c.w, out.alive, out.x0,
                     out.lamc, out.yp)


step_fused_cuda.launches = 0


def build_step_fused(mpc, arm, scaler) -> StepFused:
    """Device operands and step function of the fused closed loop."""
    return StepFused(mpc, arm, scaler)
