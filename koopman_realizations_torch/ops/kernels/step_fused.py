"""One closed-loop MPC step per launch: the CUDA kernel
``csrc/step_fused.cu`` and its plain PyTorch version, and what the fused
steps of both controllers share (``FusedStepBase``; the linear one is in
``linear_step_fused.py``).

Replaces the TPU kernel ``_step_kernel``
(``koopman_realizations_tpu/ops/pallas/step_fused.py:90``, with
``_plant_freeze_epilogue`` :150 and ``_markers_rows`` :61, built by
``build_step_fused`` :527): per lane, the lift-fused QP of the bilinear
controller, the ok mask, SDIRK2 of the arm on the PREVIOUS input, the
marker outputs, the alive freeze and the carry advance.  The kernel is
compute-bound on the card (~7e4 operations per lane-step on ~0.6 KB of
carry); it runs in two launches, the lift, assembly, Gram and plant a
thread per lane, then the QP a group of threads per lane
(``csrc/step_group.cuh``, planned by ``ipm_group.py:step_plan``), the
hand-over through a device scratch row the wrapper allocates; see the
note in the source.

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
from koopman_realizations_torch.ops.kernels.ipm_group import (
    GroupPlan,
    step_plan,
)
from koopman_realizations_torch.ops.qp import (
    ok_mask,
    qp_constants,
    qp_core_plain,
)

SOURCE = "step_fused.cu"


class StepCarry(NamedTuple):
    """Lanes-minor closed-loop carry of the fused steps."""

    ysc: torch.Tensor     # (ny, B) scaled outputs == zeta
    upsc: torch.Tensor    # (m, B) previous input, scaled
    xpl: torch.Tensor     # (nx, B) plant state
    w: torch.Tensor       # (2, B) loads (constant)
    alive: torch.Tensor   # (B,) 1.0 alive / 0.0 frozen
    x0: torch.Tensor      # (n, B) next primal start
    lamc: torch.Tensor    # (mc, B) dual carry
    yp: torch.Tensor      # (nproj, B) tracked outputs


OUT_FIELDS = ("ysc", "upsc", "xpl", "alive", "x0", "lamc", "yp")


class StepIOStruct(ctypes.Structure):
    """``km::StepIO`` of csrc/kmpc_device.cuh: the carry's inputs, then
    its outputs (``w`` is not written)."""

    _fields_ = [(k, ctypes.c_void_p) for k in
                StepCarry._fields + tuple(f + "_o" for f in OUT_FIELDS)]

    @classmethod
    def of(cls, c: StepCarry, out: StepCarry) -> "StepIOStruct":
        return cls(*(t.data_ptr() for t in c),
                   *(getattr(out, f).data_ptr() for f in OUT_FIELDS))


class StepArgs(ctypes.Structure):
    _fields_ = [("qp", QPStruct), ("Pwarm", ctypes.c_void_p),
                ("sqYr", ctypes.c_void_p), ("io", StepIOStruct),
                ("scratch", ctypes.c_void_p), ("B", ctypes.c_longlong),
                ("sqYr_lanes", ctypes.c_int), ("iters", ctypes.c_int)]


def pwarm_matrix(Sel, Tb, Np: int, m: int) -> np.ndarray:
    """Sel @ shift-rows @ Tb (step_fused.py:600-607): the receding-horizon
    primal start as a one-hot map of the previous solution's moves."""
    S_rows = np.zeros(((Np - 1) * m, (Np - 1) * m))
    for k in range(Np - 1):
        src = min(k + 1, Np - 2)
        S_rows[k * m:(k + 1) * m, src * m:(src + 1) * m] = np.eye(m)
    return np.asarray(Sel) @ S_rows @ np.asarray(Tb)


class FusedStepBase:
    """What the fused steps of both controllers share (the JAX
    ``build_step_fused`` / ``build_linear_step_fused`` pair): the plant
    and the scaler, the carry, the plant half of the kernel
    configuration, the group plan and the scratch, the plain
    plant/freeze/carry tail (``_plant_freeze_epilogue``) and the
    launch-side carry checks."""

    # the lane-shared Hessian one copy a block (the linear step), else
    # each lane's from its scratch row
    SHARED_HESSIAN = False

    def __init__(self, mpc, arm, scaler):
        cfg = arm.cfg
        if cfg.output_type != "markers" or cfg.jac_mode != "step":
            raise NotImplementedError(
                "the fused step takes marker outputs and jac_mode 'step'")
        self.mpc, self.arm, self.scaler = mpc, arm, scaler
        self.cons = mpc.constraints()
        self.iters = int(mpc.cfg.qp_iters)
        self.proj_idx = tuple(mpc.proj_idx)
        self.dtype, self.device = mpc.dtype, mpc.device
        self.Pwarm = torch.as_tensor(
            pwarm_matrix(mpc.Sel, mpc.Tb, mpc.Np, mpc.m), dtype=self.dtype,
            device=self.device)
        self._plan = self._spec = None

    # ------------------------------------------------------------ carry

    def lam_init(self, B: int) -> torch.Tensor:
        """The dual carry at step 0, (mc, B)."""
        raise NotImplementedError

    def init_carry(self, X0, W) -> StepCarry:
        """Carry at step 0 from initial plant states X0 (B, nx) and loads
        W (B, 2), row-major as the JAX runner takes them; the previous
        input is zero."""
        sc, dev, dt = self.scaler, self.device, self.dtype
        m, n = self.mpc.m, self.cons.n
        X0 = torch.as_tensor(np.asarray(X0), dtype=dt, device=dev).T
        B = X0.shape[1]
        y0 = self.arm.get_y(X0)
        ysc0 = sc.y_down(y0.double(), axis=0).to(dt)
        u0_sc = torch.as_tensor(sc.u_down(np.zeros(m)), dtype=dt,
                                device=dev)
        ones = torch.ones(B, dtype=dt, device=dev)
        return StepCarry(
            ysc=ysc0.contiguous(),
            upsc=(u0_sc[:, None] * ones).contiguous(),
            xpl=X0.contiguous(),
            w=torch.as_tensor(np.asarray(W), dtype=dt,
                              device=dev).T.contiguous(),
            alive=ones.clone(),
            x0=(u0_sc.repeat(n // m)[:, None] * ones).contiguous(),
            lamc=self.lam_init(B).contiguous(),
            yp=y0[list(self.proj_idx)].contiguous())

    # ------------------------------------------------------------ config

    def launch_plan(self) -> GroupPlan:
        """The build's group plan (``ipm_group.py:step_plan``; the plant's
        scratch: its state, outputs and finite flag), made once."""
        if self._plan is None:
            cfg = self.arm.cfg
            self._plan = step_plan(self.cons, self.mpc.m,
                                   cfg.nx + cfg.ny + 1, self.SHARED_HESSIAN)
        return self._plan

    def kernel_spec(self) -> _build.KernelSpec:
        if self._spec is None:
            self._spec = self._plan_spec(self.launch_plan())
        return self._spec

    def _plan_spec(self, plan: GroupPlan) -> _build.KernelSpec:
        """The build with ``plan``."""
        raise NotImplementedError

    def scratch(self, plan: GroupPlan, B: int) -> torch.Tensor:
        """The hand-over scratch of a launch over B lanes
        (``plan.scratch_floats`` a lane of the grid), uninitialized."""
        return torch.empty(plan.grid(B) * plan.lanes * plan.scratch_floats,
                           dtype=self.dtype, device=self.device)

    def plant_config(self) -> str:
        """``#define`` lines of the plant half of a step kernel: the arm's
        constants as exact f32 literals, the scaler and the outputs."""
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
        return "\n".join(plant) + "\n"

    # -------------------------------------------------------------- step

    def step(self, c: StepCarry, v, out: Optional[StepCarry] = None):
        """One closed-loop step with this step's reference operand ``v``.
        CUDA carries launch the kernel (writing into ``out``, which may be
        the input carry itself); CPU carries run the plain version.
        Returns the new carry."""
        if c.ysc.is_cuda:
            return self.launch(c, v, out)
        new = self.step_plain(c, v)
        if out is None:
            return new
        for dst, src in zip(out, new):
            if dst is not src:
                dst.copy_(src)
        return out

    def launch(self, c: StepCarry, v, out: Optional[StepCarry]):
        raise NotImplementedError

    def step_plain(self, c: StepCarry, v) -> StepCarry:
        raise NotImplementedError

    def finish_plain(self, c: StepCarry, ok, x, lam_carry) -> StepCarry:
        """The plain plant/freeze/carry tail (step_fused.py:150-182)."""
        sc, arm = self.scaler, self.arm
        xs = arm.step(c.xpl, sc.u_up(c.upsc, axis=0), c.w)
        fin = torch.isfinite(xs).all(0)
        y = arm.get_y(xs)
        keep = (c.alive > 0.5) & ok & fin
        sel = lambda new, old: torch.where(keep, new, old)
        return StepCarry(
            ysc=sel(sc.y_down(y, axis=0), c.ysc),
            upsc=sel(x[:self.mpc.m], c.upsc),
            xpl=sel(xs, c.xpl),
            w=c.w,
            alive=keep.to(c.alive.dtype),
            x0=sel(self.Pwarm @ x, c.x0),
            lamc=sel(lam_carry, c.lamc),
            yp=sel(y[list(self.proj_idx)], c.yp))

    def checked_out(self, c: StepCarry, out: Optional[StepCarry],
                    name: str) -> StepCarry:
        """The output carry of a launch (new tensors when ``out`` is
        None), with both carries' shapes checked."""
        if out is None:
            out = StepCarry(*(torch.empty_like(t) for t in c))
        B = c.ysc.shape[1]
        cfg = self.arm.cfg
        shapes = [(cfg.ny, B), (self.mpc.m, B), (cfg.nx, B), (2, B), (B,),
                  (self.cons.n, B), (self.cons.mc, B),
                  (len(self.proj_idx), B)]
        for t, o, shp in zip(c, out, shapes):
            if tuple(t.shape) != shp or tuple(o.shape) != shp:
                raise ValueError(f"{name}: carry shape {tuple(t.shape)}, "
                                 f"expected {shp}")
        return out


class StepFused(FusedStepBase):
    """The fused step of the bilinear controller (``build_step_fused``):
    device operands, the initial carry and ``step``, whose reference
    operand is sqrt(Q) * Yr, (p,) shared or (p, B) per lane."""

    def __init__(self, mpc, arm, scaler):
        if not mpc.lift_fused:
            raise NotImplementedError(
                "the fused step is the lift-fused route's (input_blocks, "
                "bilinear_iters=1)")
        super().__init__(mpc, arm, scaler)
        self.qp = mpc.lift_qp()

    def lam_init(self, B: int) -> torch.Tensor:
        return self.qp.row[:, None].expand(self.qp.mc, B)

    def _plan_spec(self, plan: GroupPlan) -> _build.KernelSpec:
        return _build.KernelSpec(SOURCE, qp_config(self.qp)
                                 + self.plant_config()
                                 + plan.config(self.cons.cols))

    def launch(self, c, sqYr, out=None):
        return step_fused_cuda(self, c, sqYr, out)

    def step_plain(self, c: StepCarry, sqYr) -> StepCarry:
        """Plain PyTorch version of the kernel (step_fused.py:90-182)."""
        qp = self.qp
        const = qp_constants(c.ysc.dtype)
        x, s, lam, obj, b = qp_core_plain(qp, c.ysc, c.upsc, sqYr, c.x0,
                                          c.lamc, self.iters, 1e-2)
        ok, _ = ok_mask(qp.cons, b, x, s, lam, const.tol, const.gap_sane)
        return self.finish_plain(c, ok, x, lam * obj)


def step_fused_cuda(op: StepFused, c: StepCarry, sqYr,
                    out: Optional[StepCarry] = None) -> StepCarry:
    """Launch ``step_fused_front`` and ``step_fused_kernel`` on the current
    stream; counts its calls in ``step_fused_cuda.launches``: one a step,
    each two device launches (the front, then the solve)."""
    return _launch(op.launch_plan(), op, c, sqYr, out)


def _launch(plan: GroupPlan, op: StepFused, c: StepCarry, sqYr,
            out: Optional[StepCarry] = None) -> StepCarry:
    """``step_fused_cuda`` built with ``plan``."""
    qp = op.qp
    B = c.ysc.shape[1]
    out = op.checked_out(c, out, "step_fused")
    check_operands(qp, op.Pwarm, sqYr, *c, *out)
    if sqYr.shape[0] != qp.p:
        raise ValueError("step_fused: sqYr must have p rows")
    lib = _build.load(op.kernel_spec() if plan is op.launch_plan()
                      else op._plan_spec(plan))
    scratch = op.scratch(plan, B)
    args = StepArgs(QPStruct.of(qp), op.Pwarm.data_ptr(), sqYr.data_ptr(),
                    StepIOStruct.of(c, out), scratch.data_ptr(), B,
                    int(sqYr.ndim == 2), op.iters)
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
