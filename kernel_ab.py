"""Kernel times of two trees of the port on one card, in turns.

    python kernel_ab.py --parent DIR [--out F]

DIR is another tree of the repository (for example the parent commit,
unpacked with ``git archive`` into a git-ignored directory).  The script
makes every kernel's inputs once, in this tree, on closed-loop lanes of
each kernel's main path at its full width (B=65536; the fused steps
B=262144 from the bench's initial states), saves them, and then times
every kernel in four processes -- DIR, this tree, this tree, DIR -- each
building its kernels from its own sources.  Each process also prints the
``ptxas -v`` lines of its builds.  In this tree it times the
cooperative interior point's builds (``ipm_factored``'s four,
``nmpc_multipass``, ``nmpc_stage``'s three, ``nmpc_pass``, the fused
steps ``step_fused`` and ``linear_step_fused``, ``bilin_lift``, ``bilin``,
``ipm_shared``'s lane-shared and per-lane-P builds) at other group
sizes, lanes a block and launch bounds than their plans'
(``ops/kernels/ipm_group.py``), and ``batch_chol``'s designs and spans
(``ops/kernels/batch_chol.py:CholPlan``) at both n; in both
trees it times the redesigned kernels and ``bilin`` without their
interior-point iterations (``iters=0``: the sweep or front
launch, or the staging and Gram, alone) and with one.  Two more
processes, DIR and this tree, build those kernels with ``-fmad=false``
(no contraction of a multiply and an add into an FMA) and compare their
outputs: every ``nmpc_stage`` mode cold and warm, ``nmpc_pass`` fresh
and frozen, the fused steps' seven carry fields at B=262144 and at a
ragged B, ``bilin_lift`` warm and cold, ``ipm_shared``'s three builds,
``bilin`` (each also after 0 and 1 iterations), and ``batch_chol`` at
n=12 and n=27, every design of this tree's against the other tree's
build.  For each ``ipm_factored`` build and ``ipm_shared``'s
per-lane-P builds it then holds both trees'
kernels and plain f32 against plain f64 on the same lanes: the median
and p99 per-lane distances, the lanes beyond 1e-4 / 1e-3 / 1e-2, how
often a 1024-lane subset fails the p99 gate of the card tests (within
twice plain f32's plus 1e-5), and how degenerate the farthest lanes are
(the f64 solution's smallest max(s, lam) over the rows).  Times are
CUDA-event means over repeated launches (ms), printed as one JSON line
per process and as a table; every line carries the card's name and
power limit.  Needs one CUDA card; imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

# the bench configuration, the three controllers, the plant, the
# bilinear routes and the 'linear' update (chip_smoke.py); this tree's
# chip_smoke.py also in the other tree's processes
from chip_smoke import (
    ARM,
    LINEAR_MPC,
    LINEAR_REGIME,
    MPC,
    NMPC_MPC,
    ROUTE_REFS,
    cuda_ms,
    regime_configs,
    smi_line,
)

HERE = Path(__file__).resolve().parent
B_FULL, B_STEP, SEED_STEPS = 65536, 262144, 3
# the fused steps' ragged width (the first lanes of the B_STEP carry)
B_RAGGED = 100003
# the interior point's alternatives: (build, group sizes, blocks an SM)
FACTORED_VARIANTS = (("iters2", (8, 16, 32), (0,)),
                     ("q0", (8, 16, 32), (0,)),
                     ("unblocked", (16, 32), (0, 2, 3)),
                     ("unblocked_smooth", (16, 32), (0, 2, 3)))
NMPC_VARIANTS = ((4, (4,)), (8, (0, 3, 4, 5)), (16, (4,)))
# the one-pass kernels' alternatives: (group sizes, blocks an SM)
ONEPASS_VARIANTS = (((2, 4, 8, 16), (4,)), ((4, 8), (0, 3, 5, 6)))
# the fused steps' alternatives: (group sizes, blocks an SM)
STEP_VARIANTS = (((2, 4, 8, 16), (4,)), ((4,), (0, 3, 5)))
# bilin_lift's and the lane-shared ipm_shared's alternatives: group sizes
# and blocks an SM at 128 lanes a block; and ipm_shared's at one round a
# block (threads, group, blocks an SM)
LIFT_VARIANTS = ((2, 4, 8), (3, 4, 5))
ONE_ROUND = ((128, 8, 4), (256, 4, 4), (256, 8, 0), (256, 8, 2),
             (256, 8, 3), (256, 16, 4))
# bilin's alternatives: group sizes and blocks an SM (0: no bound)
BILIN_VARIANTS = ((2, 4, 8), (0, 3, 4, 5))
# batch_chol's designs and spans (CholPlan fields after n: group,
# threads, span, blocks an SM; group 0 the direct design, else a group a
# system, its rows in registers, on spans staged in shared memory)
CHOL_VARIANTS = {27: ((0, 128), (4, 128, 32, 2), (4, 256, 64, 1),
                      (8, 256, 32, 2), (16, 256, 16, 2), (32, 128, 4, 0)),
                 12: ((0, 128), (0, 256), (2, 64, 32, 0), (4, 128, 32, 0),
                      (8, 256, 32, 0))}
CHOLS = ("batch_chol n=12", "batch_chol n=27")
# the per-lane-P builds' alternatives: (n, threads, group sizes, blocks
# an SM) of one round a block, and 128 lanes a block (group, blocks)
LANE_P_VARIANTS = (("n=12", 256, (8, 16, 32), (0, 2, 4)),
                   ("n=27", 256, (16, 32), (0, 2, 3)),
                   ("n=27", 192, (32,), (0, 3)))
LANE_P_ROUNDS = (("n=12", 16, 0), ("n=27", 32, 3))
STEPS = ("step_fused", "linear_step_fused")
# the card tests' p99 gate is taken over ~1000 lanes
SUBSET = 1024


class Setup:
    """Models, controllers and plant on the card (the same in either
    tree: made from the committed assets, no kernel involved)."""

    def __init__(self):
        import torch

        from koopman_realizations_torch.config import ArmConfig, MpcConfig
        from koopman_realizations_torch.control.kmpc import (
            BilinearKmpc,
            LinearKmpc,
            NonlinearKmpc,
        )
        from koopman_realizations_torch.control.ksim import Ksim
        from koopman_realizations_torch.models.arm import Arm
        from koopman_realizations_torch.utils.checkpoint import (
            LINEAR_MODEL,
            NONLINEAR_MODEL,
            load_model,
        )
        from koopman_realizations_torch.utils.trajectories import (
            blockM_reference,
        )
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = self.dev = torch.device("cuda")
        model, self.scaler, _ = load_model()
        lmodel, self.lscaler, _ = load_model(LINEAR_MODEL)
        nmodel, self.nscaler, _ = load_model(NONLINEAR_MODEL)
        self.arm = Arm(ArmConfig(**ARM), device=dev)
        self.mpc = BilinearKmpc(model, self.scaler, MpcConfig(**MPC),
                                device=dev)
        self.lmpc = LinearKmpc(lmodel, self.lscaler,
                               MpcConfig(**LINEAR_MPC), device=dev)
        self.nmpc = NonlinearKmpc(nmodel, self.nscaler,
                                  MpcConfig(**NMPC_MPC), device=dev)
        qcfg = MpcConfig(**regime_configs()[LINEAR_REGIME])
        self.qmpc = NonlinearKmpc(nmodel, self.nscaler, qcfg, device=dev)
        routes = json.loads(ROUTE_REFS.read_text())["regimes"]
        self.routes = {name: BilinearKmpc(model, self.scaler, MpcConfig(
            **{**MPC, **entry["knobs"]}), device=dev)
            for name, entry in routes.items()}
        self.ref = blockM_reference()
        self.sim = Ksim(self.arm, self.mpc)
        self.lsim = Ksim(self.arm, self.lmpc)
        self.nsim = Ksim(self.arm, self.nmpc)
        self.wins = self.sim.reference_windows(self.ref, 8)
        self.nwins = self.nsim.reference_windows(self.ref, 8)

    def spread(self, B):
        import numpy as np
        X0 = np.zeros((B, 6), np.float32)
        X0[:, 0] = np.linspace(-0.2, 0.2, B)
        return X0, np.zeros((B, 2), np.float32)

    def steps(self) -> dict:
        """The fused steps' operators, with the reference column of every
        step (bilinear: the sqrt(Q)-scaled windows; linear: G2 Yr)."""
        from koopman_realizations_torch.ops.kernels import (
            linear_step_fused as LS,
        )
        from koopman_realizations_torch.ops.kernels import step_fused as SF
        if not hasattr(self, "_steps"):
            lop = LS.build_linear_step_fused(self.lmpc, self.arm, self.lscaler)
            self._steps = {
                "step_fused": (SF.build_step_fused(self.mpc, self.arm,
                                                   self.scaler), self.wins),
                "linear_step_fused": (lop, lop.fYr(
                    self.lsim.reference_windows(self.ref, 8)))}
        return self._steps


_SETUP = []


def setup() -> Setup:
    """The process's one Setup."""
    if not _SETUP:
        _SETUP.append(Setup())
    return _SETUP[0]


# ------------------------------------------------------------------ inputs


def make_inputs(S: Setup) -> dict:
    """Every kernel's saved arguments on closed-loop lanes (B_FULL)."""
    import torch

    from koopman_realizations_torch.ops import nmpc as N
    dev, B = S.dev, B_FULL
    out = {}

    def start(ctl, scaler, B):
        x = torch.as_tensor(S.spread(B)[0], device=dev).T.contiguous()
        u_prev = x.new_zeros((ctl.m, B))
        return x, x.new_zeros((2, B)), u_prev, \
            scaler.y_down(S.arm.get_y(x), axis=0), \
            scaler.u_down(u_prev, axis=0)

    # the bilinear routes: 3 closed-loop steps, then each route's kernel
    # arguments as its controller forms them (carried duals, warm)
    for name, m in S.routes.items():
        x, W, u_prev, ysc, upsc = start(m, S.scaler, B)
        U, lam = upsc.repeat(m.Np, 1), x.new_ones((m.n_con, B))
        for k in range(SEED_STEPS):
            U, sol = m.solve(m.lift(ysc), upsc, S.wins[k], U, lam)
            lam = sol.lam
            x = S.arm.step(x, u_prev, W)
            ysc = S.scaler.y_down(S.arm.get_y(x), axis=0)
            upsc = U[m.m:2 * m.m].contiguous()
            u_prev = S.scaler.u_up(upsc, axis=0)
        z = m.lift(ysc).contiguous()
        x0 = m.warm_start(U).contiguous()
        l0 = (lam * m.row[:, None]).contiguous()
        betas = m.roll(z, U)[1] if m.blocked else None
        Wt, v = m.factored_data(z, upsc, S.wins[3], betas)
        b = ((m.cF_t[:, None] - m.F0_t @ upsc) / m.row[:, None])
        out["ipm_factored " + name] = (
            m.constraints(), m.rdiag, Wt.contiguous(), v.contiguous(),
            b.contiguous(), x0, l0, m.cfg.qp_iters, 1e-2)
        if m.blocked:
            # the route's name for its lane-shared operands (each process
            # makes its own: the trees' QP types may differ)
            out["bilin"] = (name, z, upsc, x0, l0, S.wins[3].contiguous(),
                            m.cfg.qp_iters, 1e-2)

    # bilin_lift and the lane-shared ipm_shared at B_FULL: the QPs of the
    # fused steps' lanes after 3 plain closed-loop steps from the bench's
    # initial states (bilin_lift: the carried duals; ipm_shared: the
    # linear general path's QP, chip_smoke.py:linear_qp)
    (op, vecs), (lop, fY) = S.steps().values()
    c, lc = op.init_carry(*S.spread(B)), lop.init_carry(*S.spread(B))
    for k in range(SEED_STEPS):
        c, lc = op.step_plain(c, vecs[k]), lop.step_plain(lc, fY[k])
    out["bilin_lift"] = (c.ysc, c.upsc, c.x0, c.lamc,
                         vecs[SEED_STEPS].contiguous(), op.iters, 1e-2)
    lm, lcons = S.lmpc, S.lmpc.constraints()
    zl = lm.lift(lc.ysc)
    Yr = S.lsim.reference_windows(S.ref, SEED_STEPS + 2)[SEED_STEPS]
    f = 2.0 * lm.CB_t.T @ (lm.Qd_t[:, None] * (lm.CA_t @ zl - Yr[:, None]))
    P, q, bz = lm.eliminate_u0(2.0 * lm.H_t, f,
                               lm.c_t[:, None] - lm.Mc_t @ zl, lc.upsc)
    obj = P.abs().amax()
    out["ipm_shared"] = (lcons, (P / obj).contiguous(),
                         (q / obj).contiguous(),
                         (bz / lcons.row[:, None]).contiguous(),
                         lc.x0.contiguous(), lm.cfg.qp_iters, 1e-2)

    # the fused steps at B_STEP: 3 plain closed-loop steps from the bench's
    # initial states, then the carry and the next step's reference column
    for name, (op, vecs) in S.steps().items():
        c = op.init_carry(*S.spread(B_STEP))
        for k in range(SEED_STEPS):
            c = op.step_plain(c, vecs[k])
        out[name] = (tuple(t.contiguous() for t in c),
                     vecs[SEED_STEPS].contiguous())

    # the NMPC: 3 closed-loop steps of the multipass path
    nm = S.nmpc
    x, W, u_prev, ysc, upsc = start(nm, S.nscaler, B)
    for k in range(SEED_STEPS):
        U, _ = nm.solve(ysc, upsc, S.nwins[k])
        x = S.arm.step(x, u_prev, W)
        ysc = S.nscaler.y_down(S.arm.get_y(x), axis=0)
        upsc = U[nm.m:2 * nm.m].contiguous()
        u_prev = S.nscaler.u_up(upsc, axis=0)
    zeta, sq = ysc.contiguous(), S.nwins[3].contiguous()
    out["nmpc_multipass"] = (nm.nmpc_qp(), zeta, upsc, sq,
                             nm.cfg.sqp_iters, nm.hold0, nm.cfg.qp_iters)
    # one SQP pass along the multipass plan (rho = 0.1), cold duals and
    # warm (the plan's multipliers in row units); the chord pass from
    # fresh Jacobians and from Jacobians frozen at the held state
    U, sol = nm.solve(zeta, upsc, sq)
    q_ = nm.nmpc_qp(nm.RdT_t + 0.1 * nm.bsizes_t)
    Z = N.rollout(q_, zeta, U)
    tail = U[3:]
    x0 = (nm.Sel_t @ tail).contiguous()
    q0 = (-0.2 * (nm.Tb_t.T @ tail)).contiguous()
    lam0 = (sol.lam * q_.row[:, None]).contiguous()
    Zl, Fv = Z[:-1].contiguous(), Z[1:].contiguous()
    Jh = N.stage_lin(q_, zeta.expand((nm.Np,) + zeta.shape),
                     upsc.repeat(nm.Np, 1))[0]
    for warm in (False, True):
        one = (zeta, upsc, sq, x0, q0, lam0 if warm else None, 8, 1e-2)
        w = " warm" if warm else ""
        out["nmpc_stage hold" + w] = ((q_, "hold") + one, {})
        out["nmpc_stage roll" + w] = ((q_, "roll") + one, dict(Ul=U))
        out["nmpc_stage ship" + w] = ((q_, "ship") + one,
                                      dict(Zl=Zl, Ul=U, Fv=Fv))
        if not warm:
            out["nmpc_pass"] = ((q_,) + N.stage_lin(q_, Zl, U, Fv=Fv)
                                + one, {})
            out["nmpc_pass frozen"] = ((q_,) + N.stage_lin(
                q_, Zl, U, frozen=Jh, Fv=Fv) + one, {})

    # the 'linear' update's second-pass QP (the q0 build) and its dense P
    qm = S.qmpc
    rho = qm.cfg.sqp_damping
    x, W, u_prev, ysc, upsc = start(qm, S.nscaler, B)
    for k in range(SEED_STEPS):
        U, _ = qm.solve(ysc, upsc, S.nwins[k])
        x = S.arm.step(x, u_prev, W)
        ysc = S.nscaler.y_down(S.arm.get_y(x), axis=0)
        upsc = U[qm.m:2 * qm.m].contiguous()
        u_prev = S.nscaler.u_up(upsc, axis=0)
    zeta = ysc.contiguous()
    qq = qm.nmpc_qp(qm.RdT_t + rho * qm.bsizes_t)
    cons = qm.constraints()
    b = qm.cF_t[:, None] - qm.F0_t @ upsc
    Ul, Zl = upsc.repeat(qm.Np, 1), zeta.expand((qm.Np,) + zeta.shape)
    from koopman_realizations_torch.ops.kernels import ipm_factored as IF
    for it in range(2):
        Jt, cv = N.stage_lin(qq, Zl, Ul)
        Wq, vq = N.condense(qq, Jt, cv, zeta, upsc, sq)
        x0 = qm.Sel_t @ Ul[qm.m:]
        q0 = -2.0 * rho * (qm.Tb_t.T @ Ul[qm.m:])
        if it == 0:
            sol = IF.solve_qp_factored(Wq, vq, qq.rdiag, cons, b, x0=x0,
                                       iters=qm.cfg.qp_iters, q0=q0)
            Ul = qm.plan(upsc, sol.x)
            Zl = N.linear_rollout(qq, Jt, cv, zeta, Ul, qm.Sel_t)
    row = cons.row[:, None]
    a = (cons, qq.rdiag.contiguous(), Wq.contiguous(), vq.contiguous(),
         (b / row).contiguous(), x0.contiguous(),
         (sol.lam * row).contiguous(), qm.cfg.qp_iters, 1e-2,
         q0.contiguous())
    out["ipm_factored q0"] = a
    for key, args in (("n=12", a), ("n=27", out["ipm_factored unblocked"])):
        rd, Wd, vd = args[1:4]
        P = 2.0 * (torch.einsum("rib,rjb->ijb", Wd, Wd)
                   + torch.diag(rd)[..., None])
        q = 2.0 * torch.einsum("rib,rb->ib", Wd, vd)
        if len(args) > 9:
            q = q + args[9]
        iobj = 1.0 / P.abs().amax((0, 1))
        out["ipm_shared lane-P " + key] = (
            args[0], P.contiguous(), (q * iobj).contiguous(), args[4],
            args[5], args[7], 1e-2, iobj.contiguous(),
            (args[6] * iobj).contiguous())
        out["batch_chol " + key] = (P.permute(2, 0, 1).contiguous(),
                                    q.T.contiguous())
    return out


# ------------------------------------------------------------------ timing


FACTORED = ("iters2", "q0", "unblocked", "unblocked_smooth")
STAGE_MODES = ("hold", "roll", "ship")
ONEPASS = tuple("nmpc_stage " + m for m in STAGE_MODES) + ("nmpc_pass",)
# the one-pass kernels' launches: each mode cold and warm, nmpc_pass
# fresh and frozen
ONEPASS_RUNS = ONEPASS + tuple(f"nmpc_stage {m} warm" for m in STAGE_MODES) \
    + ("nmpc_pass frozen",)
LANE_P = ("ipm_shared lane-P n=12", "ipm_shared lane-P n=27")
# the kernels whose outputs the two trees' -fmad=false builds compare:
# every redesigned one
SOLVES = ("bilin_lift", "ipm_shared") + LANE_P + ("bilin",)
REDESIGNED = tuple("ipm_factored " + name for name in FACTORED) \
    + ("nmpc_multipass",) + ONEPASS_RUNS + STEPS \
    + tuple(f"{k} B={B_RAGGED}" for k in STEPS) + SOLVES \
    + ("bilin_lift cold", "bilin_lift per-lane windows", "bilin cold",
       "bilin per-lane windows") + CHOLS
# the factored, one-pass, step and solve builds' outputs after 0 and 1
# iterations, for the comparison of parent and change
FIRST_ITERATIONS = tuple(f"{k} iters={it}" for k in
                         tuple("ipm_factored " + name for name in FACTORED)
                         + ONEPASS + STEPS + SOLVES for it in (0, 1))


def step_call(ins: dict, key: str, iters=None, B=None, launch=None):
    """A call of fused step ``key`` on its saved carry into fresh output
    tensors (``iters``: another iteration count; ``B``: the carry's
    first B lanes; ``launch``: another entry point taking the wrapper's
    arguments, as the plan-taking ``_launch``)."""
    import copy

    import torch

    from koopman_realizations_torch.ops.kernels import step_fused as SF
    op, _ = setup().steps()[key]
    carry, v = ins[key]
    if B is not None:
        carry = tuple(t[..., :B].contiguous() for t in carry)
        v = v[..., :B].contiguous() if v.ndim == 2 else v
    c = SF.StepCarry(*carry)
    out = SF.StepCarry(*(torch.empty_like(t) for t in c))
    if iters is not None:
        op = copy.copy(op)
        op.iters = iters
    fn = launch or (lambda o, c, v, out: o.launch(c, v, out))
    return lambda: fn(op, c, v, out)


def onepass_call(ins: dict, key: str, iters=None, launch=None):
    """A launch of one-pass kernel ``key``'s saved arguments (``iters``:
    another iteration count; ``launch``: another entry point taking the
    same arguments, as the plan-taking ``_launch``)."""
    from koopman_realizations_torch.ops.kernels import nmpc_pass as NP
    from koopman_realizations_torch.ops.kernels import nmpc_stage as NS
    a, kw = ins[key]
    if iters is not None:
        at = 8 if key.startswith("nmpc_stage") else 9
        a = a[:at] + (iters,) + a[at + 1:]
    fn = launch or (NS.nmpc_stage_cuda if key.startswith("nmpc_stage")
                    else NP.nmpc_pass_cuda)
    return lambda: fn(*a, **kw)


def solve_args(ins: dict, key: str, iters=None) -> tuple:
    """The saved arguments of ``bilin_lift``, ``ipm_shared`` (each build)
    or ``bilin`` with the process's own lane-shared QP operands
    (``iters``: another iteration count)."""
    S = setup()
    a = ins[key]
    if key == "bilin_lift":
        a = (S.steps()["step_fused"][0].qp,) + a
    elif key == "bilin":
        a = (S.routes[a[0]].bilin_qp(),) + a[1:]
    if iters is not None:
        at = 5 if key.startswith("ipm_shared") else 6
        a = a[:at] + (iters,) + a[at + 1:]
    return a


def solve_runs(ins: dict) -> tuple:
    """``bilin_lift`` and ``bilin`` (warm, cold, per-lane windows) and
    ``ipm_shared``'s three builds, each also after 0 and 1 iterations."""
    import torch

    from koopman_realizations_torch.ops.kernels import bilin as BI
    from koopman_realizations_torch.ops.kernels import bilin_lift as BL
    from koopman_realizations_torch.ops.kernels import ipm_shared as IS
    fns = {"bilin_lift": BL.bilin_lift_cuda, "bilin": BI.bilin_cuda,
           **{k: IS.ipm_shared_cuda for k in ("ipm_shared",) + LANE_P}}
    a = solve_args(ins, "bilin_lift")
    specs = {"bilin_lift": BL.kernel_spec(a[0]),
             "ipm_shared": IS.kernel_spec(ins["ipm_shared"][0]),
             "bilin": BI.kernel_spec(solve_args(ins, "bilin")[0]),
             **{k: IS.kernel_spec(ins[k][0], lane_p=True) for k in LANE_P}}
    runs = {}
    for key, fn in fns.items():
        reps = 5 if key in LANE_P else 10
        runs[key] = (lambda fn=fn, a=solve_args(ins, key): fn(*a), reps)
        for it in (0, 1):
            runs[f"{key} iters={it}"] = (
                lambda fn=fn, a=solve_args(ins, key, it): fn(*a), reps)
    wins = setup().wins
    B = a[1].shape[1]
    # lane b the window of step 3 + b % 4 (the setup makes 7)
    per_lane = wins[3 + torch.arange(B, device="cuda") % 4].T.contiguous()
    runs["bilin_lift cold"] = (lambda: BL.bilin_lift_cuda(
        a[0], a[1], a[2], a[3].new_zeros(a[3].shape), None, a[5], a[6],
        1.0), 10)
    runs["bilin_lift per-lane windows"] = (lambda: BL.bilin_lift_cuda(
        *a[:5], per_lane, *a[6:]), 10)
    ab = solve_args(ins, "bilin")
    runs["bilin cold"] = (lambda: BI.bilin_cuda(
        ab[0], ab[1], ab[2], ab[3].new_zeros(ab[3].shape), None, ab[5],
        ab[6], 1.0), 10)
    runs["bilin per-lane windows"] = (lambda: BI.bilin_cuda(
        *ab[:5], per_lane, *ab[6:]), 10)
    return specs, runs


def redesigned_runs(ins: dict) -> tuple:
    """Specs and launches of the redesigned kernels, public entry points
    only (the other tree has no more)."""
    from koopman_realizations_torch.ops.kernels import ipm_factored as IF
    from koopman_realizations_torch.ops.kernels import nmpc_multipass as NM
    specs, runs = {}, {}
    nmp = ins["nmpc_multipass"]
    specs["nmpc_multipass"] = NM.kernel_spec(nmp[0])
    runs["nmpc_multipass"] = (lambda: NM.nmpc_multipass_cuda(*nmp), 5)
    for name in FACTORED:
        a = ins["ipm_factored " + name]
        specs["ipm_factored " + name] = IF.kernel_spec(
            a[0], a[2].shape[0], q0=name == "q0")
        runs["ipm_factored " + name] = (
            lambda a=a: IF.ipm_factored_cuda(*a), 5)
        # where the time goes: without the interior-point iterations
        # (staging, Gram and prelude alone) and with one
        for it in (0, 1):
            ai = a[:7] + (it,) + a[8:]
            runs[f"ipm_factored {name} iters={it}"] = (
                lambda ai=ai: IF.ipm_factored_cuda(*ai), 5)
    # the whole SQP without its QP iterations (the sweeps alone) and
    # its single pass
    runs["nmpc_multipass iters=0"] = (
        lambda: NM.nmpc_multipass_cuda(*nmp[:6], 0), 5)
    runs["nmpc_multipass passes=1"] = (
        lambda: NM.nmpc_multipass_cuda(*nmp[:4], 1, *nmp[5:]), 5)
    for more in (onepass_runs, solve_runs, chol_runs):
        sp, ru = more(ins)
        specs.update(sp)
        runs.update(ru)
    # the fused steps: the front launch and the solve's set-up alone
    # (iters=0) and one iteration; the seven carry fields at a ragged B
    for key in STEPS:
        specs[key] = setup().steps()[key][0].kernel_spec()
        runs[key] = (step_call(ins, key), 10)
        runs[f"{key} B={B_RAGGED}"] = (step_call(ins, key, B=B_RAGGED), 10)
        for it in (0, 1):
            runs[f"{key} iters={it}"] = (step_call(ins, key, it), 10)
    return specs, runs


def onepass_runs(ins: dict) -> tuple:
    """The one-pass kernels, each mode cold and warm, fresh and frozen
    Jacobians; the sweep alone (iters=0) and one iteration."""
    from koopman_realizations_torch.ops.kernels import nmpc_pass as NP
    from koopman_realizations_torch.ops.kernels import nmpc_stage as NS
    specs, runs = {}, {}
    qp1 = ins["nmpc_pass"][0][0]
    for mode in STAGE_MODES:
        specs["nmpc_stage " + mode] = NS.kernel_spec(qp1, mode)
    specs["nmpc_pass"] = NP.kernel_spec(qp1)
    for key in ONEPASS_RUNS:
        runs[key] = (onepass_call(ins, key), 10)
    for key in ONEPASS:
        for it in (0, 1):
            runs[f"{key} iters={it}"] = (onepass_call(ins, key, it), 10)
    return specs, runs


def variant_runs(ins: dict) -> tuple:
    """Specs and launches of the group interior point at other group
    sizes and launch bounds than its plans' (this tree's private
    ``_spec`` and ``_launch``, which take a plan)."""
    import dataclasses

    from koopman_realizations_torch.ops.kernels import ipm_factored as IF
    from koopman_realizations_torch.ops.kernels import ipm_group as IG
    from koopman_realizations_torch.ops.kernels import nmpc_multipass as NM
    specs, runs = {}, {}
    for name, groups, mbs in FACTORED_VARIANTS:
        a = ins["ipm_factored " + name]
        base = IF.launch_plan(a[0], a[2].shape[0])
        for g in groups:
            for mb in mbs:
                plan = dataclasses.replace(
                    base, group=g, lanes=IG.FACTORED_THREADS // g,
                    min_blocks=mb).check()
                key = f"ipm_factored {name} G={g} min_blocks={mb}"
                specs[key] = IF._spec(a[0], a[2].shape[0], name == "q0",
                                      plan)
                runs[key] = (lambda a=a, plan=plan: IF._launch(plan, *a), 5)
    nmp = ins["nmpc_multipass"]
    base = NM.launch_plan(nmp[0])
    for g, mbs in NMPC_VARIANTS:
        for mb in mbs:
            plan = dataclasses.replace(base, group=g, min_blocks=mb).check()
            key = f"nmpc_multipass G={g} min_blocks={mb}"
            specs[key] = NM._spec(nmp[0], plan)
            runs[key] = (lambda plan=plan: NM._launch(plan, *nmp), 5)
    for more in (onepass_variant_runs, step_variant_runs,
                 solve_variant_runs, chol_variant_runs):
        sp, ru = more(ins)
        specs.update(sp)
        runs.update(ru)
    return specs, runs


def solve_variant_runs(ins: dict) -> tuple:
    """``bilin`` at the plans of ``BILIN_VARIANTS`` (each also at
    iters=0: the front and the solve's set-up); ``bilin_lift`` and the
    lane-shared ``ipm_shared`` at the plans of ``LIFT_VARIANTS`` (and
    ``ipm_shared`` at ``ONE_ROUND``); the per-lane-P builds at
    ``LANE_P_VARIANTS`` and ``LANE_P_ROUNDS``."""
    import dataclasses

    from koopman_realizations_torch.ops.kernels import bilin_lift as BL
    from koopman_realizations_torch.ops.kernels import ipm_shared as IS
    from koopman_realizations_torch.ops.kernels import bilin as BI
    specs, runs = {}, {}
    ab = solve_args(ins, "bilin")
    base = BI.launch_plan(ab[0])
    for g in BILIN_VARIANTS[0]:
        for mb in BILIN_VARIANTS[1]:
            plan = dataclasses.replace(base, group=g, min_blocks=mb).check()
            key = f"bilin G={g} min_blocks={mb}"
            specs[key] = BI._spec(ab[0], plan)
            runs[key] = (lambda plan=plan: BI._launch(plan, *ab), 10)
            runs[key + " iters=0"] = (
                lambda plan=plan, a0=solve_args(ins, "bilin", 0):
                BI._launch(plan, *a0), 10)
    a = solve_args(ins, "bilin_lift")
    base = BL.launch_plan(a[0])
    groups, mbs = LIFT_VARIANTS
    for g in groups:
        for mb in mbs:
            plan = dataclasses.replace(base, group=g, min_blocks=mb).check()
            key = f"bilin_lift G={g} min_blocks={mb}"
            specs[key] = BL._spec(a[0], plan)
            runs[key] = (lambda plan=plan: BL._launch(plan, *a), 10)
    s = ins["ipm_shared"]
    base = IS.launch_plan(s[0])
    plans = {f"ipm_shared 128 lanes G={g} min_blocks={mb}":
             dataclasses.replace(base, group=g, threads=128, lanes=128,
                                 min_blocks=mb)
             for g in groups for mb in mbs}
    plans.update({f"ipm_shared one round {t} threads G={g} min_blocks={mb}":
                  dataclasses.replace(base, group=g, threads=t,
                                      lanes=t // g, min_blocks=mb)
                  for t, g, mb in ONE_ROUND})
    for key, plan in plans.items():
        specs[key] = IS._spec(s[0], False, plan.check())
        runs[key] = (lambda plan=plan: IS._launch(plan, *s), 10)
    for n, threads, groups, mbs in LANE_P_VARIANTS:
        la = ins["ipm_shared lane-P " + n]
        base = IS.launch_plan(la[0], True)
        plans = {f"ipm_shared lane-P {n} {threads} threads G={g} "
                 f"min_blocks={mb}": dataclasses.replace(
                     base, group=g, threads=threads, lanes=threads // g,
                     min_blocks=mb)
                 for g in groups for mb in mbs}
        for rn, g, mb in LANE_P_ROUNDS:
            if rn == n and threads == 256:
                plans[f"ipm_shared lane-P {n} 128 lanes G={g} "
                      f"min_blocks={mb}"] = dataclasses.replace(
                    base, group=g, threads=128, lanes=128, min_blocks=mb)
        for key, plan in plans.items():
            specs[key] = IS._spec(la[0], True, plan.check())
            runs[key] = (lambda plan=plan, la=la: IS._launch(plan, *la), 5)
    return specs, runs


def step_variant_runs(ins: dict) -> tuple:
    """The fused steps at the plans of ``STEP_VARIANTS``, each also at
    iters=0."""
    import dataclasses

    from koopman_realizations_torch.ops.kernels import (
        linear_step_fused as LS,
    )
    from koopman_realizations_torch.ops.kernels import step_fused as SF
    specs, runs = {}, {}
    for key, mod in (("step_fused", SF), ("linear_step_fused", LS)):
        op = setup().steps()[key][0]
        base = op.launch_plan()
        plans = {f"{key} G={g} min_blocks={mb}": dataclasses.replace(
            base, group=g, min_blocks=mb).check()
            for groups, mbs in STEP_VARIANTS for g in groups for mb in mbs}
        for name, plan in plans.items():
            specs[name] = op._plan_spec(plan)
            fn = lambda o, c, v, out, plan=plan, mod=mod: mod._launch(
                plan, o, c, v, out)
            runs[name] = (step_call(ins, key, launch=fn), 10)
            runs[name + " iters=0"] = (step_call(ins, key, 0, launch=fn), 10)
    return specs, runs


def onepass_variant_runs(ins: dict) -> tuple:
    """The one-pass kernels at the plans of ``ONEPASS_VARIANTS``."""
    import dataclasses

    from koopman_realizations_torch.ops.kernels import nmpc_pass as NP
    from koopman_realizations_torch.ops.kernels import nmpc_stage as NS
    specs, runs = {}, {}
    for key in ONEPASS:
        qp1 = ins[key][0][0]
        mode = key.split()[1] if key.startswith("nmpc_stage") else None
        base = (NP if mode is None else NS).launch_plan(qp1)
        for groups, mbs in ONEPASS_VARIANTS:
            for g in groups:
                for mb in mbs:
                    plan = dataclasses.replace(base, group=g,
                                               min_blocks=mb).check()
                    name = f"{key} G={g} min_blocks={mb}"
                    if mode is None:
                        specs[name] = NP._spec(qp1, plan)
                        fn = lambda *a, plan=plan: NP._launch(plan, *a)
                    else:
                        specs[name] = NS._spec(qp1, mode, plan)
                        fn = lambda *a, plan=plan, **kw: NS._launch(
                            plan, *a, **kw)
                    runs[name] = (onepass_call(ins, key, launch=fn), 10)
                    # the sweep launch and an empty solve
                    runs[name + " iters=0"] = (
                        onepass_call(ins, key, 0, launch=fn), 10)
    return specs, runs


def chol_runs(ins: dict) -> tuple:
    """``batch_chol`` at n=12 and n=27 through its public entry."""
    from koopman_realizations_torch.ops.kernels import batch_chol as BC
    specs, runs = {}, {}
    for key in CHOLS:
        M, rhs = ins[key]
        specs[key] = BC.kernel_spec(M.shape[1])
        runs[key] = (lambda M=M, rhs=rhs: BC.solve_spd_cuda(M, rhs), 10)
    return specs, runs


def chol_variant_runs(ins: dict) -> tuple:
    """``batch_chol`` at the designs and spans of ``CHOL_VARIANTS`` (this
    tree's ``CholPlan``, ``_spec`` and ``_launch``)."""
    from koopman_realizations_torch.ops.kernels import batch_chol as BC
    specs, runs = {}, {}
    for key in CHOLS:
        M, rhs = ins[key]
        n = M.shape[1]
        for fields in CHOL_VARIANTS[n]:
            plan = BC.CholPlan(n, *fields).check()
            name = f"{key} {plan.describe()}"
            specs[name] = BC._spec(plan)
            runs[name] = (lambda plan=plan, M=M, rhs=rhs:
                          BC._launch(plan, M, rhs), 10)
    return specs, runs


def time_tree(inputs_path: str, mode: str, x_out: str, nvcc=()) -> dict:
    """Build this process's tree's kernels (with the extra nvcc flags
    ``nvcc``) and save the redesigned kernels' outputs on the saved
    inputs to ``x_out``; unless ``mode`` is 'outputs', time every kernel
    ('variants': also the group interior point's alternatives)."""
    import torch

    from koopman_realizations_torch.ops.kernels import _build
    _build.NVCC_FLAGS = tuple(_build.NVCC_FLAGS) + tuple(nvcc)
    from koopman_realizations_torch.ops.kernels import batch_chol as BC
    ins = torch.load(inputs_path, weights_only=False)
    specs, runs = redesigned_runs(ins)
    extra = (variant_runs,) if mode == "variants" else \
        (chol_variant_runs,) if mode == "outputs" \
        and hasattr(BC, "CholPlan") else ()
    for more in extra:
        sp, ru = more(ins)
        specs.update(sp)
        runs.update(ru)
    # a variant equal to a plan is built once
    uniq = list(dict.fromkeys(specs.values()))
    built = dict(zip(uniq, _build.build_all(uniq)))
    ptxas = {k: [ln.strip() for ln in built[spec].ptxas
                 if "Compile time" not in ln]
             for k, spec in specs.items()}
    # the batch_chol designs' outputs too, where this tree has them
    saved = REDESIGNED + FIRST_ITERATIONS + tuple(
        k for k in runs if k.startswith(CHOLS) and k not in CHOLS)
    torch.save({k: [t.cpu() for t in as_tuple(runs[k][0]())]
                for k in saved}, x_out)
    times = {} if mode == "outputs" else \
        {k: cuda_ms(fn, reps) for k, (fn, reps) in runs.items()}
    return {"times": times, "ptxas": ptxas}


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


# ------------------------------------------------- distances to plain f64


def to_f64(args) -> tuple:
    """A kernel's argument tuple with every floating tensor, those of the
    constraints too, in f64."""
    import torch

    def cast(t):
        if torch.is_tensor(t) and t.is_floating_point():
            return t.double()
        if hasattr(t, "_replace"):
            return t._replace(**{k: cast(v) for k, v in t._asdict().items()})
        return t
    return tuple(cast(t) for t in args)


# the builds whose tails against plain f64 the script reads
TAILED = tuple("ipm_factored " + name for name in FACTORED) + LANE_P


def tails(ins: dict, xs: dict) -> dict:
    """For each build of ``TAILED``: every labelled solution of ``xs``
    (key -> label -> (x, s, lam, ...)) and plain f32 against plain f64
    on the same lanes."""
    import torch

    from koopman_realizations_torch.ops.kernels import ipm_factored as IF
    from koopman_realizations_torch.ops.kernels import ipm_shared as IS
    out = {}
    for name in TAILED:
        plain = IF.ipm_factored_plain if name.startswith("ipm_factored") \
            else IS.ipm_shared_plain
        a32 = ins[name]
        x64, s64, l64 = plain(*to_f64(a32))[:3]
        dev = x64.device
        lv = torch.tensor([0.5, 0.99], dtype=torch.float64, device=dev)
        sol = dict(xs[name], **{"plain f32": plain(*a32)})
        d = {k: (r[0].to(dev).double() - x64).abs().amax(0)
             for k, r in sol.items()}
        # an ordering's complementarity gap (mean s lam) per lane: where
        # it stalls, a large one
        gap = {k: (r[1].to(dev).double() * r[2].to(dev).double()).mean(0)
               for k, r in sol.items()}
        # a lane's degeneracy: the smallest max(s, lam) over its rows in
        # the f64 solution (both near 0: a weakly active row)
        deg = torch.maximum(s64, l64).amin(0)
        top = max(1, d["plain f32"].numel() // 100)
        sub = lambda t: torch.quantile(t.view(-1, SUBSET), lv[1:], dim=1)[0]
        qp = sub(d["plain f32"])
        rows = {}
        for k, dk in d.items():
            far = dk.topk(top).indices
            stall = 100 * gap[k].median()
            rows[k] = {
                "median": torch.quantile(dk, lv)[0].item(),
                "p99": torch.quantile(dk, lv)[1].item(),
                "beyond 1e-4/1e-3/1e-2": [int((dk > t).sum())
                                          for t in (1e-4, 1e-3, 1e-2)],
                f"{SUBSET}-lane subsets failing the p99 gate":
                    int((sub(dk) > 2 * qp + 1e-5).sum()),
                "lanes with gap > 100x its median": int(
                    (gap[k] > stall).sum()),
                "farthest 1%: gap > 100x median, degeneracy < 1e-6/1e-4": [
                    int((gap[k][far] > stall).sum())] + [
                    int((deg[far] < t).sum()) for t in (1e-6, 1e-4)]}
        rows["all lanes with degeneracy < 1e-6/1e-4"] = [
            int((deg < t).sum()) for t in (1e-6, 1e-4)]
        rows["lanes, subsets"] = [d["plain f32"].numel(),
                                  d["plain f32"].numel() // SUBSET]
        out[name] = rows
    return out


# -------------------------------------------------------------------- main


def worker(tree: Path, label: str, path: str, x_out: str, mode: str,
           nvcc=()) -> dict:
    """One process building and timing ``tree``'s kernels (this file
    runs there under that tree's package)."""
    cmd = [sys.executable, __file__, "--tree", str(tree), "--time", path,
           "--x-out", x_out, "--mode", mode] \
        + [f"--nvcc={f}" for f in nvcc]
    res = subprocess.run(cmd, cwd=tree, capture_output=True, text=True)
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
        raise SystemExit(1)
    run = json.loads(res.stdout.strip().splitlines()[-1])
    run["tree"] = label
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the other tree's root")
    ap.add_argument("--out", help="write the runs and tails as JSON here")
    # a worker process's arguments
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--time", help=argparse.SUPPRESS)
    ap.add_argument("--x-out", help=argparse.SUPPRESS)
    ap.add_argument("--mode", default="time", help=argparse.SUPPRESS)
    ap.add_argument("--nvcc", action="append", default=[],
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.tree:
        # the worker's tree's package before this file's directory
        sys.path.insert(0, args.tree)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    if args.time:
        print(json.dumps(time_tree(args.time, args.mode, args.x_out,
                                   args.nvcc)))
        return 0
    if not args.parent:
        ap.error("--parent is required")
    parent = Path(args.parent).resolve()
    smi = smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    nofma = ("-fmad=false",)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "inputs.pt")
        torch.save(make_inputs(Setup()), path)
        torch.cuda.empty_cache()
        plan = [("parent", parent, "time", ()),
                ("change", HERE, "variants", ()),
                ("change", HERE, "variants", ()),
                ("parent", parent, "time", ()),
                ("parent -fmad=false", parent, "outputs", nofma),
                ("change -fmad=false", HERE, "outputs", nofma)]
        runs = []
        for i, (label, tree, mode, nvcc) in enumerate(plan):
            runs.append(worker(tree, label, path, str(Path(tmp) / f"x{i}.pt"),
                               mode, nvcc))
            if runs[-1]["times"]:
                print(f"{label}: " + json.dumps(runs[-1]["times"])
                      + f" | {smi}", flush=True)
        # the redesigned kernels' outputs (x, s, lam, obj), parent against
        # change: bitwise equal, else the largest difference of each
        xs = [torch.load(Path(tmp) / f"x{i}.pt") for i in range(len(plan))]
        same = lambda a, b: all(torch.equal(u, v) for u, v in zip(a, b))

        def maxdiff(a, b):
            out = []
            for u, v in zip(a, b):
                d = (u - v).abs()
                d = d[torch.isfinite(d)]
                out.append(d.max().item() if d.numel() else 0.0)
            return " ".join(f"{d:.3e}" for d in out)
        outputs = {}
        for k in REDESIGNED + FIRST_ITERATIONS:
            outputs[k] = {
                "bitwise": same(xs[0][k], xs[1][k]),
                "max |d|": maxdiff(xs[0][k], xs[1][k]),
                "deterministic": [same(xs[0][k], xs[3][k]),
                                  same(xs[1][k], xs[2][k])],
                "-fmad=false bitwise": same(xs[4][k], xs[5][k]),
                "-fmad=false max |d|": maxdiff(xs[4][k], xs[5][k])}
            print(f"{k}: outputs of parent and change bitwise equal "
                  f"{same(xs[0][k], xs[1][k])}, max |d| "
                  f"{maxdiff(xs[0][k], xs[1][k])}; each tree deterministic "
                  f"{same(xs[0][k], xs[3][k])} {same(xs[1][k], xs[2][k])}; "
                  f"with -fmad=false bitwise equal "
                  f"{same(xs[4][k], xs[5][k])}, max |d| "
                  f"{maxdiff(xs[4][k], xs[5][k])}", flush=True)
        # every batch_chol design of this tree against the other tree's
        # build of its n
        for k in xs[5]:
            if k.startswith(CHOLS) and k not in CHOLS:
                base = k[:len(CHOLS[0])]
                outputs[k] = {
                    "-fmad=false bitwise": same(xs[4][base], xs[5][k]),
                    "-fmad=false max |d|": maxdiff(xs[4][base], xs[5][k])}
                print(f"{k}: with -fmad=false bitwise equal to the parent's "
                      f"{base} {outputs[k]['-fmad=false bitwise']}, max |d| "
                      f"{outputs[k]['-fmad=false max |d|']}", flush=True)
        ins = torch.load(path, weights_only=False)
        tl = tails(ins, {key: {plan[i][0]: xs[i][key] for i in (0, 1, 4, 5)}
                         for key in TAILED})
        print(f"ipm_factored and per-lane-P ipm_shared at B={B_FULL}, "
              f"distances to plain f64 | {smi}")
        for name, rows in tl.items():
            for k, v in rows.items():
                print(f"{name} | {k} | {json.dumps(v)}", flush=True)
    names = list(runs[1]["times"])
    print(f"kernel ms at B={B_FULL} (fused steps B={B_STEP}) | {smi}")
    print("kernel | parent | change | change | parent | change / parent")
    for k in names:
        t = [r["times"].get(k) for r in runs[:4]]
        par = [x for x in (t[0], t[3]) if x is not None]
        ratio = (sum(t[1:3]) / 2) / (sum(par) / len(par)) if par else None
        print(f"{k} | " + " | ".join("-" if x is None else f"{x:.4f}"
                                     for x in t)
              + (f" | {ratio:.3f}" if ratio else " | -"))
    print("ptxas -v of each build, parent then change:")
    for k in runs[1]["ptxas"]:
        pa, ch = runs[0]["ptxas"].get(k), runs[1]["ptxas"][k]
        print(f"{k}: {'same' if pa == ch else 'differs'}")
        for ln in (pa or []) if pa != ch else []:
            print("  parent " + ln)
        for ln in ch:
            print("  change " + ln)
    print("ptxas -v of the redesigned builds with -fmad=false:")
    for r in runs[4:]:
        for k, lines in r["ptxas"].items():
            for ln in lines:
                print(f"  {r['tree']} {k}: {ln}")
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"runs": runs, "tails": tl, "outputs": outputs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
