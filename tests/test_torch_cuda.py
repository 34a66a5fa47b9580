"""The CUDA kernels against their plain PyTorch versions on the card.

CUDA kernels have no CPU mode, so these tests need an NVIDIA GPU with the
CUDA toolkit and skip elsewhere.  They import no JAX; on a machine without
it run them past the repository's JAX-configuring conftest:

    python -m pytest --noconftest -o addopts="" -m cuda \\
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import (
    BilinearKmpc,
    LinearKmpc,
    NonlinearKmpc,
)
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.ops.kernels import _build
from koopman_realizations_torch.ops.kernels import batch_chol as BC
from koopman_realizations_torch.ops.kernels import bilin as BI
from koopman_realizations_torch.ops.kernels import ipm_factored as IF
from koopman_realizations_torch.ops.kernels import ipm_shared as IS
from koopman_realizations_torch.ops.kernels import nmpc_multipass as NM
from koopman_realizations_torch.ops.kernels import nmpc_pass as NP
from koopman_realizations_torch.ops.kernels import nmpc_stage as NS
from koopman_realizations_torch.ops.kernels.bilin_lift import (
    bilin_lift_cuda,
    bilin_lift_plain,
    kernel_spec,
    solve_qp_bilinear_lifted,
)
from koopman_realizations_torch.ops.kernels.linear_step_fused import (
    build_linear_step_fused,
)
from koopman_realizations_torch.ops.kernels.step_fused import (
    FusedStepBase,
    StepCarry,
    build_step_fused,
)
from koopman_realizations_torch.ops import nmpc as N
from koopman_realizations_torch.ops.qp import ok_mask
from koopman_realizations_torch.utils.checkpoint import (
    LINEAR_MODEL,
    NONLINEAR_MODEL,
    load_model,
)
from koopman_realizations_torch.utils.metrics import lane_tracking_error
from koopman_realizations_torch.utils.trajectories import blockM_reference

pytestmark = pytest.mark.cuda

# the bench configuration (bench.py:95-122)
MPC = dict(horizon=10, qp_iters=4, qp_dual_warm=True,
           input_blocks=(1, 1, 2, 5),
           input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8),
           input_slopeConst=1e-1, cost_running=10.0, cost_terminal=100.0,
           cost_input=(0.1 * 3e-2, 0.1 * 2e-2, 0.1 * 1e-2), proj_idx=(4, 5))
ARM = dict(Nmods=3, nlinks=1, L=1.0, m=0.1, output_type="markers",
           substeps=3, newton_iters=1, jac_mode="step")
# the linear controller (tests/test_torch_oracle.py:LINEAR_MPC)
LINEAR = dict(MPC, qp_iters=6, qp_dual_warm=False)
# the SQP NMPC controller (tests/test_torch_oracle.py:NMPC_MPC)
NMPC = dict(MPC, qp_iters=8, qp_dual_warm=False)
# the bilinear controller off the lift-fused route
# (tests/test_torch_oracle.py:BILINEAR_ROUTES)
ROUTES = {"iters2": dict(bilinear_iters=2),
          "unblocked": dict(input_blocks=None, qp_iters=8),
          "unblocked_smooth": dict(input_blocks=None, input_smoothConst=0.1,
                                   qp_iters=12)}


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    model, scaler, _ = load_model()
    mpc = BilinearKmpc(model, scaler, MpcConfig(**MPC), device="cuda")
    sim = Ksim(Arm(ArmConfig(**ARM), device="cuda"), mpc)
    op = build_step_fused(mpc, sim.plant, scaler)
    for r in _build.build_all([kernel_spec(mpc.lift_qp()),
                               op.kernel_spec()]):
        print(r.path.name, f"{r.seconds:.1f}s", *r.ptxas, sep="\n  ")
    return sim, op


def _carry(op, B, steps, seed=0):
    """A carry after a few plain closed-loop steps from spread states."""
    rng = np.random.default_rng(seed)
    X0 = np.zeros((B, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    X0[:, 3:] = rng.normal(0, 0.2, (B, 3))
    c = op.init_carry(X0, np.zeros((B, 2), np.float32))
    win = Ksim(op.arm, op.mpc).reference_windows(blockM_reference(), 40)
    for k in range(steps):
        c = op.step_plain(c, win[k])
    return c, win


@pytest.mark.parametrize("warm", [True, False])
def test_bilin_lift_kernel_matches_plain(gpu, warm):
    sim, op = gpu
    c, win = _carry(op, 1000, 3)            # 1000: not a block multiple
    qp = op.qp
    x0 = c.x0 if warm else torch.zeros_like(c.x0)
    lam0 = c.lamc if warm else None
    floor = 1e-2 if warm else 1.0
    args = (qp, c.ysc, c.upsc, x0, lam0, win[3], 4, floor)
    xk, sk, lk, objk = bilin_lift_cuda(*args)
    torch.cuda.synchronize()
    xp, sp, lp, objp = bilin_lift_plain(*args)
    assert torch.isfinite(xk).all()
    assert (xk - xp).abs().max().item() < 1e-3
    assert (lk - lp).abs().max().item() < 1e-3 * lp.abs().max().item()
    assert torch.allclose(objk, objp, rtol=1e-5)


def test_step_fused_kernel_matches_plain(gpu):
    sim, op = gpu
    c, win = _carry(op, 1000, 2)
    out = StepCarry(*(torch.empty_like(t) for t in c))
    k = op.step(c, win[2], out=out)
    torch.cuda.synchronize()
    p = op.step_plain(c, win[2])
    assert torch.equal(k.alive, p.alive) and bool(k.alive.all())
    for f in ("upsc", "x0", "lamc"):
        scale = max(1.0, getattr(p, f).abs().max().item())
        d = (getattr(k, f) - getattr(p, f)).abs().max().item()
        assert d < 1e-3 * scale, (f, d)
    for f in ("ysc", "xpl", "yp"):
        assert (getattr(k, f) - getattr(p, f)).abs().max().item() < 2e-2


def test_kernels_take_per_lane_windows(gpu):
    """Both kernels with a different reference window in every lane
    (sqYr of shape (p, B)) against their plain versions."""
    sim, op = gpu
    c, win = _carry(op, 1000, 3)
    sq = win[3 + torch.arange(1000, device=win.device) % 8].T.contiguous()
    args = (op.qp, c.ysc, c.upsc, c.x0, c.lamc, sq, 4, 1e-2)
    xk, _, lk, objk = bilin_lift_cuda(*args)
    torch.cuda.synchronize()
    xp, _, lp, objp = bilin_lift_plain(*args)
    assert (xk - xp).abs().max().item() < 1e-3
    assert (lk - lp).abs().max().item() < 1e-3 * lp.abs().max().item()
    assert torch.allclose(objk, objp, rtol=1e-5)
    out = StepCarry(*(torch.empty_like(t) for t in c))
    k = op.step(c, sq, out=out)
    torch.cuda.synchronize()
    p = op.step_plain(c, sq)
    assert torch.equal(k.alive, p.alive) and bool(k.alive.all())
    for f in ("upsc", "x0", "lamc"):
        scale = max(1.0, getattr(p, f).abs().max().item())
        d = (getattr(k, f) - getattr(p, f)).abs().max().item()
        assert d < 1e-3 * scale, (f, d)


def test_fused_runner_on_card_tracks(gpu):
    sim, _ = gpu
    B = 16
    X0 = np.zeros((B, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    out = sim.fused_runner(blockM_reference(), steps=301)(
        X0, np.zeros((B, 2), np.float32))
    assert out["alive"].all()
    err = lane_tracking_error(out["Yp"], blockM_reference())
    header = load_model()[2]
    assert abs(err.mean().item() - header["jax_reference"]["err_mean"]) < 1e-3


@pytest.fixture(scope="module")
def gpu_linear():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    model, scaler, _ = load_model(LINEAR_MODEL)
    mpc = LinearKmpc(model, scaler, MpcConfig(**LINEAR), device="cuda")
    sim = Ksim(Arm(ArmConfig(**ARM), device="cuda"), mpc)
    op = build_linear_step_fused(mpc, sim.plant, scaler)
    for r in _build.build_all([IS.kernel_spec(mpc.constraints()),
                               op.kernel_spec()]):
        print(r.path.name, f"{r.seconds:.1f}s", *r.ptxas, sep="\n  ")
    return sim, op


def _linear_carry(op, sim, B, steps, seed=0):
    """A linear carry after a few plain steps, and the fYr columns."""
    rng = np.random.default_rng(seed)
    X0 = np.zeros((B, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    X0[:, 3:] = rng.normal(0, 0.2, (B, 3))
    c = op.init_carry(X0, np.zeros((B, 2), np.float32))
    win = sim.reference_windows(blockM_reference(), 40)
    fY = op.fYr(win)
    for k in range(steps):
        c = op.step_plain(c, fY[k])
    return c, win, fY


def test_ipm_shared_kernel_matches_plain(gpu_linear):
    """The shared-Hessian QP of the linear general path at closed-loop
    states, kernel against plain; 1000 lanes: not a block multiple."""
    sim, op = gpu_linear
    mpc = sim.mpc
    c, win, _ = _linear_carry(op, sim, 1000, 3)
    z = mpc.lift(c.ysc)
    f = 2.0 * mpc.CB_t.T @ (mpc.Qd_t[:, None]
                            * (mpc.CA_t @ z - win[3][:, None]))
    b = mpc.c_t[:, None] - mpc.Mc_t @ z
    P, q, bz = mpc.eliminate_u0(2.0 * mpc.H_t, f, b, c.upsc)
    cons = mpc.constraints()
    obj = P.abs().amax()
    b_eq = (bz / cons.row[:, None]).contiguous()
    args = (cons, (P / obj).contiguous(), (q / obj).contiguous(), b_eq,
            c.x0, 6, 1e-2)
    xk, sk, lk = IS.ipm_shared_cuda(*args)
    torch.cuda.synchronize()
    xp, sp, lp = IS.ipm_shared_plain(*args)
    assert torch.isfinite(xk).all()
    assert (xk - xp).abs().max().item() < 1e-3
    assert (lk - lp).abs().max().item() < 1e-3 * lp.abs().max().item()
    okk = ok_mask(cons, b_eq, xk, sk, lk, 3e-3, 5e-2)[0]
    okp = ok_mask(cons, b_eq, xp, sp, lp, 3e-3, 5e-2)[0]
    assert torch.equal(okk, okp) and bool(okk.all())


def test_linear_step_fused_kernel_matches_plain(gpu_linear):
    sim, op = gpu_linear
    c, _, fY = _linear_carry(op, sim, 1000, 2)
    out = StepCarry(*(torch.empty_like(t) for t in c))
    k = op.step(c, fY[2], out=out)
    torch.cuda.synchronize()
    p = op.step_plain(c, fY[2])
    assert torch.equal(k.alive, p.alive) and bool(k.alive.all())
    for f in ("upsc", "x0", "lamc"):
        scale = max(1.0, getattr(p, f).abs().max().item())
        d = (getattr(k, f) - getattr(p, f)).abs().max().item()
        assert d < 1e-3 * scale, (f, d)
    for f in ("ysc", "xpl", "yp"):
        assert (getattr(k, f) - getattr(p, f)).abs().max().item() < 2e-2


def test_linear_runners_on_card_track(gpu_linear):
    """Both linear runners through their kernels, B=16 over 301 steps,
    against the JAX general runner's err_mean in the asset header."""
    sim, _ = gpu_linear
    B = 16
    X0 = np.zeros((B, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    ref = load_model(LINEAR_MODEL)[2]["jax_reference"]["err_mean"]
    for name in ("fused_runner", "batched_runner"):
        out = getattr(sim, name)(blockM_reference(), steps=301)(
            X0, np.zeros((B, 2), np.float32))
        assert out["alive"].all()
        err = lane_tracking_error(out["Yp"], blockM_reference())
        assert abs(err.mean().item() - ref) < 1e-3, (name, err.mean())


@pytest.fixture(scope="module")
def gpu_nmpc():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    mpc = NonlinearKmpc(model, scaler, MpcConfig(**NMPC), device="cuda")
    mpc64 = NonlinearKmpc(model, scaler, MpcConfig(**NMPC), device="cuda",
                          dtype=torch.float64)
    sim = Ksim(Arm(ArmConfig(**ARM), device="cuda"), mpc)
    qp = mpc.nmpc_qp()
    specs = [NM.kernel_spec(qp), NP.kernel_spec(qp)] + [
        NS.kernel_spec(qp, mode) for mode in N.STAGE_MODES]
    for r in _build.build_all(specs):
        print(r.path.name, f"{r.seconds:.1f}s", *r.ptxas, sep="\n  ")
    return sim, mpc64


def _nmpc_lanes(sim, B, steps, seed=0):
    """Scaled outputs and previous inputs after a few closed-loop steps of
    the NMPC general path from spread states, and the windows."""
    rng = np.random.default_rng(seed)
    mpc, arm, sc = sim.mpc, sim.plant, sim.scaler
    X0 = np.zeros((B, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    X0[:, 3:] = rng.normal(0, 0.2, (B, 3))
    x = torch.as_tensor(X0, device="cuda").T.contiguous()
    W = x.new_zeros((2, B))
    u_prev = x.new_zeros((3, B))
    ysc, upsc = sc.y_down(arm.get_y(x), axis=0), sc.u_down(u_prev, axis=0)
    win = sim.reference_windows(blockM_reference(), 40)
    for k in range(steps):
        U, _ = mpc.solve(ysc, upsc, win[k])
        x = arm.step(x, u_prev, W)
        ysc = sc.y_down(arm.get_y(x), axis=0)
        upsc = U[3:6].contiguous()
        u_prev = sc.u_up(upsc, axis=0)
    return ysc.contiguous(), upsc, win


@pytest.mark.parametrize("per_lane", [False, True])
def test_nmpc_multipass_kernel_matches_plain(gpu_nmpc, per_lane):
    """The whole SQP, kernel against plain f32, both against plain f64, on
    1000 closed-loop lanes (not a block multiple): equal, all-true ok
    masks; the kernel's per-lane distance to f64 (median and 99th
    percentile) within twice the plain f32 version's plus 1e-5."""
    sim, mpc64 = gpu_nmpc
    mpc = sim.mpc
    zeta, up, win = _nmpc_lanes(sim, 1000, 3)
    sq = win[3 + torch.arange(1000, device="cuda") % 8].T.contiguous() \
        if per_lane else win[3]
    qp, sqp = mpc.nmpc_qp(), (5, True, 8)
    xk, sk, lk, objk = NM.nmpc_multipass_cuda(qp, zeta, up, sq, *sqp)
    torch.cuda.synchronize()
    xp, sp, lp, objp = NM.nmpc_multipass_plain(qp, zeta, up, sq, *sqp)
    x64 = NM.nmpc_multipass_plain(mpc64.nmpc_qp(), zeta.double(),
                                  up.double(), sq.double(), *sqp)[0]
    b = qp.cFr[:, None] - qp.F0r @ up
    okk = ok_mask(qp.cons, b, xk, sk, lk, 3e-3, 5e-2)[0]
    okp = ok_mask(qp.cons, b, xp, sp, lp, 3e-3, 5e-2)[0]
    assert torch.equal(okk, okp) and bool(okk.all())
    lv = torch.tensor([0.5, 0.99], dtype=torch.float64, device="cuda")
    ek = torch.quantile((xk.double() - x64).abs().amax(0), lv)
    ep = torch.quantile((xp.double() - x64).abs().amax(0), lv)
    assert bool((ek <= 2 * ep + 1e-5).all()), (ek, ep)
    assert torch.allclose(objk, objp, rtol=1e-2)


def test_nmpc_runner_on_card_tracks(gpu_nmpc):
    """The NMPC general runner through the kernel, B=16 over 301 steps,
    one launch per step, against the JAX general runner's err_mean."""
    sim, _ = gpu_nmpc
    B = 16
    X0 = np.zeros((B, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    ref = load_model(NONLINEAR_MODEL)[2]["jax_reference"]["err_mean"]
    NM.nmpc_multipass_cuda.launches = 0
    out = sim.batched_runner(blockM_reference(), steps=301)(
        X0, np.zeros((B, 2), np.float32))
    assert NM.nmpc_multipass_cuda.launches == 300
    assert out["alive"].all()
    err = lane_tracking_error(out["Yp"], blockM_reference())
    assert abs(err.mean().item() - ref) < 1e-3, err.mean()


def _pass_inputs(mpc, mpc64, zeta, up, sq, rho=0.1):
    """One SQP pass's operands on closed-loop lanes, in f32 and f64: the
    multipass plan U as the linearization plan, its rollout, x0 = Sel U,
    the per-lane Levenberg term q0 = -2 rho Tb^T U and the plan's
    multipliers (row units) as the warm dual start."""
    U, sol = mpc.solve(zeta, up, sq)
    out = {}
    for dt, c in ((torch.float32, mpc), (torch.float64, mpc64)):
        qp = c.nmpc_qp(c.RdT_t + rho * c.bsizes_t)
        Ud, z, u, s = (t.to(dt) for t in (U, zeta, up, sq))
        Z = N.rollout(qp, z, Ud)
        tail = Ud[3:]
        out[dt] = dict(qp=qp, zeta=z, up=u, sq=s.contiguous(), Ul=Ud,
                       Zl=Z[:-1].contiguous(), Fv=Z[1:].contiguous(),
                       x0=(c.Sel_t @ tail).contiguous(),
                       q0=(-2.0 * rho * (c.Tb_t.T @ tail)).contiguous(),
                       lam0=(sol.lam.to(dt) * qp.row[:, None]).contiguous())
    return out


def _hold_to_f64(xk, xp, x64, okk, okp):
    """Equal, all-true ok masks; the kernel's per-lane distance to the f64
    solution (median and 99th percentile) within twice the plain f32
    version's plus 1e-5."""
    assert torch.equal(okk, okp) and bool(okk.all())
    _near_f64(xk, xp, x64)


def _near_f64(xk, xp, x64):
    """The kernel's per-lane distance to the f64 result (median and 99th
    percentile) within twice the plain f32 version's plus 1e-5."""
    lv = torch.tensor([0.5, 0.99], dtype=torch.float64, device=xk.device)
    ek = torch.quantile((xk.double() - x64).abs().amax(0), lv)
    ep = torch.quantile((xp.double() - x64).abs().amax(0), lv)
    assert bool((ek <= 2 * ep + 1e-5).all()), (ek, ep)


@pytest.mark.parametrize("mode", ["hold", "roll", "ship"])
@pytest.mark.parametrize("warm", [False, True])
def test_nmpc_stage_kernel_matches_plain(gpu_nmpc, mode, warm):
    """One stage pass in each trajectory mode, cold or with a warm lam0,
    with a per-lane q0 and per-lane reference windows, kernel against
    plain f32, both against plain f64, on 1000 closed-loop lanes."""
    sim, mpc64 = gpu_nmpc
    zeta, up, win = _nmpc_lanes(sim, 1000, 3)
    sq = win[3 + torch.arange(1000, device="cuda") % 8].T.contiguous()
    ins = _pass_inputs(sim.mpc, mpc64, zeta, up, sq)
    res = {}
    for dt, fn in ((torch.float32, NS.nmpc_stage_cuda),
                   (torch.float32, NS.nmpc_stage_plain),
                   (torch.float64, NS.nmpc_stage_plain)):
        d = ins[dt]
        traj = {"ship": dict(Zl=d["Zl"], Ul=d["Ul"], Fv=d["Fv"]),
                "roll": dict(Ul=d["Ul"]), "hold": {}}[mode]
        res[fn, dt] = fn(d["qp"], mode, d["zeta"], d["up"], d["sq"],
                         d["x0"], d["q0"], d["lam0"] if warm else None, 8,
                         1e-2, **traj)
        torch.cuda.synchronize()
    xk, sk, lk, _ = res[NS.nmpc_stage_cuda, torch.float32]
    xp, sp, lp, _ = res[NS.nmpc_stage_plain, torch.float32]
    qp = ins[torch.float32]["qp"]
    b = N.rhs(qp, up)
    _hold_to_f64(xk, xp, res[NS.nmpc_stage_plain, torch.float64][0],
                 ok_mask(qp.cons, b, xk, sk, lk, 3e-3, 5e-2)[0],
                 ok_mask(qp.cons, b, xp, sp, lp, 3e-3, 5e-2)[0])


@pytest.mark.parametrize("frozen", [False, True])
def test_nmpc_pass_kernel_matches_plain(gpu_nmpc, frozen):
    """One chord pass from fresh stage Jacobians, or from Jacobians frozen
    at the held state with fresh defects, kernel against plain f32, both
    against plain f64, on 1000 closed-loop lanes."""
    sim, mpc64 = gpu_nmpc
    zeta, up, win = _nmpc_lanes(sim, 1000, 3)
    ins = _pass_inputs(sim.mpc, mpc64, zeta, up, win[3])
    res = {}
    for dt, fn in ((torch.float32, NP.nmpc_pass_cuda),
                   (torch.float32, NP.nmpc_pass_plain),
                   (torch.float64, NP.nmpc_pass_plain)):
        d = ins[dt]
        Zl = d["zeta"].expand((10,) + d["zeta"].shape) if frozen else d["Zl"]
        Jf = N.stage_lin(d["qp"], Zl, d["up"].repeat(10, 1))[0] \
            if frozen else None
        Jt, cv = N.stage_lin(d["qp"], d["Zl"], d["Ul"], frozen=Jf,
                             Fv=d["Fv"])
        res[fn, dt] = fn(d["qp"], Jt, cv, d["zeta"], d["up"], d["sq"],
                         d["x0"], d["q0"], d["lam0"], 8, 1e-2)
        torch.cuda.synchronize()
    xk, sk, lk, _ = res[NP.nmpc_pass_cuda, torch.float32]
    xp, sp, lp, _ = res[NP.nmpc_pass_plain, torch.float32]
    qp = ins[torch.float32]["qp"]
    b = N.rhs(qp, up)
    _hold_to_f64(xk, xp, res[NP.nmpc_pass_plain, torch.float64][0],
                 ok_mask(qp.cons, b, xk, sk, lk, 3e-3, 5e-2)[0],
                 ok_mask(qp.cons, b, xp, sp, lp, 3e-3, 5e-2)[0])


@pytest.mark.parametrize("regime,kernel", [
    ("damping_decay", "nmpc_stage"), ("jac_period", "nmpc_pass")])
def test_nmpc_regime_runners_on_card_track(gpu_nmpc, regime, kernel):
    """The general runner on the stage and chord routes through their
    kernels, B=16 over 301 steps, five launches per step, against the JAX
    general runner's err_mean in that regime
    (assets/nmpc_regime_refs.json)."""
    import json

    from koopman_realizations_torch.utils.checkpoint import ASSETS
    sim, _ = gpu_nmpc
    ref = json.loads((ASSETS / "nmpc_regime_refs.json").read_text())[
        "regimes"][regime]
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    mpc = NonlinearKmpc(model, scaler, MpcConfig(**NMPC, **ref["knobs"]),
                        device="cuda")
    rsim = Ksim(sim.plant, mpc)
    B = 16
    X0 = np.zeros((B, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    wrapper = {"nmpc_stage": NS.nmpc_stage_cuda,
               "nmpc_pass": NP.nmpc_pass_cuda}[kernel]
    wrapper.launches = 0
    out = rsim.batched_runner(blockM_reference(), steps=301)(
        X0, np.zeros((B, 2), np.float32))
    assert wrapper.launches == 300 * 5
    assert out["alive"].all() and ref["alive"] == 1.0
    err = lane_tracking_error(out["Yp"], blockM_reference())
    assert abs(err.mean().item() - ref["err_mean"]) < 1e-3, err.mean()


@pytest.fixture(scope="module")
def gpu_routes():
    """The bilinear controller in each configuration off the lift-fused
    route, f32 and f64, and the bilin and three ipm_factored builds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    model, scaler, _ = load_model()
    arm = Arm(ArmConfig(**ARM), device="cuda")
    out = {}
    for name, knobs in ROUTES.items():
        cfg = MpcConfig(**{**MPC, **knobs})
        mpc = BilinearKmpc(model, scaler, cfg, device="cuda")
        out[name] = (Ksim(arm, mpc), BilinearKmpc(
            model, scaler, cfg, device="cuda", dtype=torch.float64))
    specs = [BI.kernel_spec(out["iters2"][0].mpc.bilin_qp())] + [
        IF.kernel_spec(s.mpc.constraints(), s.mpc.p) for s, _ in out.values()]
    for r in _build.build_all(specs):
        print(r.path.name, f"{r.seconds:.1f}s", *r.ptxas, sep="\n  ")
    return out


def _route_lanes(sim, B, steps, seed=0):
    """Lanes after a few closed-loop steps of a bilinear route's general
    path from spread states: (z, u_prev, U_plan, lam, windows) with z the
    lifted state and lam the carried multipliers (original units)."""
    rng = np.random.default_rng(seed)
    mpc, arm, sc = sim.mpc, sim.plant, sim.scaler
    X0 = np.zeros((B, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    X0[:, 3:] = rng.normal(0, 0.2, (B, 3))
    x = torch.as_tensor(X0, device="cuda").T.contiguous()
    W = x.new_zeros((2, B))
    u_prev = x.new_zeros((3, B))
    ysc, upsc = sc.y_down(arm.get_y(x), axis=0), sc.u_down(u_prev, axis=0)
    U, lam = upsc.repeat(mpc.Np, 1), x.new_ones((mpc.n_con, B))
    win = sim.reference_windows(blockM_reference(), 40)
    for k in range(steps):
        U, sol = mpc.solve(mpc.lift(ysc), upsc, win[k], U, lam)
        lam = sol.lam
        x = arm.step(x, u_prev, W)
        ysc = sc.y_down(arm.get_y(x), axis=0)
        upsc = U[3:6].contiguous()
        u_prev = sc.u_up(upsc, axis=0)
    return mpc.lift(ysc).contiguous(), upsc, U, lam, win


# (warm, per-lane windows, iterations, lanes): the four starts and
# windows after the path's 4 iterations on 1000 lanes; the front and the
# solve's set-up alone (0) and one iteration; the last 128-lane block
# ragged by 1 lane (129) and a single lane
BILIN_CASES = ([(w, pl, 4, 1000) for w in (False, True)
                for pl in (False, True)]
               + [(w, w, it, 1000) for w in (False, True) for it in (0, 1)]
               + [(True, True, 4, 129), (False, False, 4, 1)])


@pytest.mark.parametrize("warm,per_lane,iters,B", BILIN_CASES)
def test_bilin_kernel_matches_plain(gpu_routes, warm, per_lane, iters, B):
    """The assembly-fused first pass of iterated relinearization, kernel
    (the front a thread a lane, then the group solve: two device launches
    a call) against plain f32, both against plain f64, on B closed-loop
    lanes, cold or with the carried duals, a shared or a per-lane
    reference window: after the path's 4 iterations equal, all-true ok
    masks and x's distances to f64 within twice plain f32's plus 1e-5;
    after 0 or 1 iterations the distances of x, s and lam so."""
    sim, mpc64 = gpu_routes["iters2"]
    mpc = sim.mpc
    z, up, U, lam, win = _route_lanes(sim, B, 3)
    sq = win[3 + torch.arange(B, device="cuda") % 8].T.contiguous() \
        if per_lane else win[3]
    x0 = mpc.warm_start(U).contiguous()
    lam0 = (lam * mpc.row[:, None]).contiguous() if warm else None
    qp, qp64 = mpc.bilin_qp(), mpc64.bilin_qp()
    before = BI.bilin_cuda.launches
    out = BI.bilin_cuda(qp, z, up, x0, lam0, sq, iters, 1e-2)
    torch.cuda.synchronize()
    assert BI.bilin_cuda.launches == before + 1
    ref = BI.bilin_plain(qp, z, up, x0, lam0, sq, iters, 1e-2)
    r64 = BI.bilin_plain(qp64, z.double(), up.double(), x0.double(),
                         None if lam0 is None else lam0.double(),
                         sq.double(), iters, 1e-2)
    xk, sk, lk, objk = out
    if iters == 4:
        b = qp.cFr[:, None] - qp.F0r @ up
        _hold_to_f64(xk, ref[0], r64[0],
                     ok_mask(qp.cons, b, xk, sk, lk, 3e-3, 5e-2)[0],
                     ok_mask(qp.cons, b, ref[0], ref[1], ref[2], 3e-3,
                             5e-2)[0])
    else:
        for k, p, e in zip(out[:3], ref[:3], r64[:3]):
            _near_f64(k, p, e)
    assert torch.allclose(objk, ref[3], rtol=1e-5)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("route", list(ROUTES))
def test_ipm_factored_kernel_matches_plain(gpu_routes, route, warm):
    """The factored interior point in each build (blocked 12/48 banded,
    unblocked 27/108 banded, unblocked smooth 27/156 dense) on the W and v
    the controller assembles on 1000 closed-loop lanes -- the re-rolled
    second pass for iters2 -- kernel against plain f32, both against
    plain f64."""
    sim, mpc64 = gpu_routes[route]
    mpc = sim.mpc
    iters = mpc.cfg.qp_iters
    z, up, U, lam, win = _route_lanes(sim, 1000, 3)
    betas = betas64 = None
    if mpc.blocked:
        betas = mpc.roll(z, U)[1]
        betas64 = mpc64.roll(z.double(), U.double())[1]
    cons, cons64 = mpc.constraints(), mpc64.constraints()
    ins = {}
    for dt, c, bt in ((torch.float32, mpc, betas),
                      (torch.float64, mpc64, betas64)):
        zd, ud = z.to(dt), up.to(dt)
        W, v = c.factored_data(zd, ud, win[3].to(dt), bt)
        b = (c.cF_t[:, None] - c.F0_t @ ud) / c.row[:, None]
        ins[dt] = (c.constraints(), c.rdiag, W.contiguous(), v.contiguous(),
                   b.contiguous(), c.warm_start(U.to(dt)).contiguous(),
                   (lam.to(dt) * c.row[:, None]).contiguous() if warm
                   else None, iters, 1e-2)
    xk, sk, lk, objk = IF.ipm_factored_cuda(*ins[torch.float32])
    torch.cuda.synchronize()
    xp, sp, lp, objp = IF.ipm_factored_plain(*ins[torch.float32])
    x64 = IF.ipm_factored_plain(*ins[torch.float64])[0]
    b = ins[torch.float32][4]
    _hold_to_f64(xk, xp, x64, ok_mask(cons, b, xk, sk, lk, 3e-3, 5e-2)[0],
                 ok_mask(cons, b, xp, sp, lp, 3e-3, 5e-2)[0])
    assert torch.allclose(objk, objp, rtol=1e-5)
    assert cons64.band == cons.band


@pytest.mark.parametrize("route", list(ROUTES))
def test_bilinear_route_runners_on_card_track(gpu_routes, route):
    """The general runner of each route through its kernels, B=16 over
    301 steps -- iters2: one bilin and one ipm_factored launch a step;
    the unblocked stacks: one ipm_factored launch a step; no bilin_lift --
    against the JAX general runner's err_mean and alive
    (assets/bilinear_route_refs.json)."""
    import json

    from koopman_realizations_torch.ops.kernels.bilin_lift import (
        bilin_lift_cuda,
    )
    from koopman_realizations_torch.utils.checkpoint import ASSETS
    ref = json.loads((ASSETS / "bilinear_route_refs.json").read_text())[
        "regimes"][route]
    sim, _ = gpu_routes[route]
    B = 16
    X0 = np.zeros((B, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    for w in (BI.bilin_cuda, IF.ipm_factored_cuda, bilin_lift_cuda):
        w.launches = 0
    out = sim.batched_runner(blockM_reference(), steps=301)(
        X0, np.zeros((B, 2), np.float32))
    assert BI.bilin_cuda.launches == (300 if sim.mpc.blocked else 0)
    assert IF.ipm_factored_cuda.launches == 300
    assert bilin_lift_cuda.launches == 0
    assert out["alive"][:, -1].float().mean().item() == ref["alive"]
    err = lane_tracking_error(out["Yp"], blockM_reference())
    assert abs(err.mean().item() - ref["err_mean"]) < 1e-3, err.mean()


@pytest.fixture(scope="module")
def gpu_sqp_linear():
    """The SQP NMPC with the 'linear' between-pass update, f32 and f64,
    the q0 build of ipm_factored, the per-lane-P builds of ipm_shared
    (n=12 banded; n=27 banded, the unblocked route's constraints) and the
    batch_chol builds (n=12, n=27)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    cfg = MpcConfig(**NMPC, sqp_update="linear")
    mpc = NonlinearKmpc(model, scaler, cfg, device="cuda")
    mpc64 = NonlinearKmpc(model, scaler, cfg, device="cuda",
                          dtype=torch.float64)
    sim = Ksim(Arm(ArmConfig(**ARM), device="cuda"), mpc)
    bmodel, bscaler, _ = load_model()
    ucfg = MpcConfig(**{**MPC, **ROUTES["unblocked"]})
    unb = BilinearKmpc(bmodel, bscaler, ucfg, device="cuda")
    unb64 = BilinearKmpc(bmodel, bscaler, ucfg, device="cuda",
                         dtype=torch.float64)
    cons = mpc.constraints()
    specs = [IF.kernel_spec(cons, mpc.nmpc_qp().p, q0=True),
             IS.kernel_spec(cons, lane_p=True),
             IS.kernel_spec(unb.constraints(), lane_p=True),
             BC.kernel_spec(12), BC.kernel_spec(27)]
    for r in _build.build_all(specs):
        print(r.path.name, f"{r.seconds:.1f}s", *r.ptxas, sep="\n  ")
    return sim, mpc64, unb, unb64


def _linear_pass_qp(mpc, zeta, up, sq):
    """The second pass's factored QP of the 'linear' update at these lanes
    (the first pass from the held plan, its plan's linearized state
    sequence as the second pass's trajectory): the ``ipm_factored``
    arguments (cons, rdiag, W, v, b / row, x0) and q0, the first pass's
    multipliers in row units, and b in original units."""
    m, Np = mpc.m, mpc.Np
    rho = mpc.cfg.sqp_damping
    qp = mpc.nmpc_qp(mpc.RdT_t + rho * mpc.bsizes_t)
    cons = mpc.constraints()
    b = mpc.cF_t[:, None] - mpc.F0_t @ up
    Ul = up.repeat(Np, 1)
    Zl = zeta.expand((Np,) + zeta.shape)
    for it in range(2):
        Jt, cv = N.stage_lin(qp, Zl, Ul)
        W, v = N.condense(qp, Jt, cv, zeta, up, sq)
        x0 = mpc.Sel_t @ Ul[m:]
        q0 = -2.0 * rho * (mpc.Tb_t.T @ Ul[m:])
        if it == 1:
            row = cons.row[:, None]
            return dict(args=(cons, qp.rdiag, W.contiguous(),
                              v.contiguous(), (b / row).contiguous(),
                              x0.contiguous()),
                        q0=q0.contiguous(), b=b,
                        lam0=(sol.lam * row).contiguous())
        sol = IF.solve_qp_factored(W, v, qp.rdiag, cons, b, x0=x0,
                                   iters=mpc.cfg.qp_iters, q0=q0)
        U = mpc.plan(up, sol.x)
        Zl = N.linear_rollout(qp, Jt, cv, zeta, U, mpc.Sel_t)
        Ul = U


def _linear_lanes(gpu_sqp_linear, B):
    """The 'linear' update's second-pass QPs (``_linear_pass_qp``) of B
    closed-loop lanes with per-lane windows, as the f32 controller forms
    them on the card, and the same data in f64 with the f64 controller's
    constraints and costs."""
    sim, mpc64 = gpu_sqp_linear[:2]
    zeta, up, win = _nmpc_lanes(sim, B, 3)
    sq = win[3 + torch.arange(B, device="cuda") % 8].T.contiguous()
    d = _linear_pass_qp(sim.mpc, zeta, up, sq)
    cons64 = mpc64.constraints()
    rd64 = mpc64.RdT_t + mpc64.cfg.sqp_damping * mpc64.bsizes_t
    d64 = {k: d[k].double() for k in ("q0", "b", "lam0")}
    d64["args"] = (cons64, rd64) + tuple(t.double()
                                         for t in d["args"][2:])
    return {torch.float32: d, torch.float64: d64}


@pytest.mark.parametrize("warm", [False, True])
def test_ipm_factored_q0_kernel_matches_plain(gpu_sqp_linear, warm):
    """The q0 build on the 'linear' update's second-pass QPs of 1000
    closed-loop lanes (per-lane windows), cold or with the first pass's
    multipliers: kernel against plain f32, both against plain f64."""
    sim = gpu_sqp_linear[0]
    ins = {dt: d["args"] + (d["lam0"] if warm else None,
                            sim.mpc.cfg.qp_iters, 1e-2, d["q0"])
           for dt, d in _linear_lanes(gpu_sqp_linear, 1000).items()}
    xk, sk, lk, objk = IF.ipm_factored_cuda(*ins[torch.float32])
    torch.cuda.synchronize()
    xp, sp, lp, objp = IF.ipm_factored_plain(*ins[torch.float32])
    x64 = IF.ipm_factored_plain(*ins[torch.float64])[0]
    cons, b = ins[torch.float32][0], ins[torch.float32][4]
    _hold_to_f64(xk, xp, x64, ok_mask(cons, b, xk, sk, lk, 3e-3, 5e-2)[0],
                 ok_mask(cons, b, xp, sp, lp, 3e-3, 5e-2)[0])
    assert torch.allclose(objk, objp, rtol=1e-5)


def _dense_qp(W, v, rdiag, q0):
    """P = 2 (W^T W + diag r) (n, n, B) and q = 2 W^T v + q0 (n, B)."""
    P = 2.0 * (torch.einsum("rib,rjb->ijb", W, W)
               + torch.diag(rdiag)[..., None])
    return P.contiguous(), (2.0 * torch.einsum("rib,rb->ib", W, v)
                            + q0).contiguous()


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("shape", ["linear", "unblocked"])
def test_ipm_shared_lane_p_kernel_matches_plain(gpu_sqp_linear, shape,
                                                warm):
    """The per-lane-P build on dense P = 2 (W^T W + diag r) and
    q = 2 W^T v + q0 of the 'linear' update's QPs (n=12, mc=48) or of the
    unblocked bilinear route's (n=27, mc=108; q0 = 0), 1000 closed-loop
    lanes: kernel against plain f32, both against plain f64, through the
    wrapper's equilibration; cold or with warm duals."""
    sim, mpc64, unb, unb64 = gpu_sqp_linear
    out = {}
    if shape == "linear":
        for dt, d in _linear_lanes(gpu_sqp_linear, 1000).items():
            cons, rd, W, v, b, x0 = d["args"]
            out[dt] = (cons, rd, W, v, b, x0, d["q0"], d["lam0"])
    else:
        z, up, U, lam, win = _route_lanes(Ksim(sim.plant, unb), 1000, 3)
        for m in (unb, unb64):
            dt, c = m.dtype, m.constraints()
            W, v = m.factored_data(z.to(dt), up.to(dt), win[3].to(dt),
                                   None)
            b = (m.cF_t[:, None] - m.F0_t @ up.to(dt)) / c.row[:, None]
            x0 = m.warm_start(U.to(dt))
            out[dt] = (c, m.rdiag, W, v, b, x0, torch.zeros_like(x0),
                       lam.to(dt) * c.row[:, None])
    for dt, (c, rd, W, v, b, x0, q0, lam_row) in out.items():
        P, q = _dense_qp(W, v, rd, q0)
        iobj = 1.0 / P.abs().amax((0, 1))
        out[dt] = (c, P, (q * iobj).contiguous(), b, x0.contiguous(), 8,
                   1e-2, iobj.contiguous(),
                   (lam_row * iobj).contiguous() if warm else None)
    a32 = out[torch.float32]
    xk, sk, lk = IS.ipm_shared_cuda(*a32)
    torch.cuda.synchronize()
    xp, sp, lp = IS.ipm_shared_plain(*a32)
    x64 = IS.ipm_shared_plain(*out[torch.float64])[0]
    b = a32[3]
    _hold_to_f64(xk, xp, x64, ok_mask(a32[0], b, xk, sk, lk, 3e-3, 5e-2)[0],
                 ok_mask(a32[0], b, xp, sp, lp, 3e-3, 5e-2)[0])


# (n, B): 1000 systems (n=12: 8 blocks of the direct build, the last
# ragged; n=27: 32 spans of 32 systems on 32 blocks, one span a block);
# 1003 at n=27 (the last span 11 systems, its copies not whole 16-byte
# pieces); 65539 at both (n=27: 2049 spans on the persistent grid of two
# blocks an SM, ~8 spans a block, the last span 3 systems)
CHOL_CASES = [(12, 1000), (27, 1000), (27, 1003), (12, 65539), (27, 65539)]


@pytest.mark.parametrize("n,B", CHOL_CASES)
def test_batch_chol_kernel_matches_plain(gpu_sqp_linear, n, B):
    """The batched SPD solve on the dense Hessians P = 2 (W^T W + diag r)
    of closed-loop QPs (n=12 at B=1000: the 'linear' update's) or on
    random SPD systems of the JAX test's recipe: kernel against plain
    f32, both against plain f64, relative to the solution's scale; one
    launch a call."""
    if n == 12 and B == 1000:
        d = _linear_lanes(gpu_sqp_linear, 1000)[torch.float64]
        _, rd, W, v = d["args"][:4]
        P, q = _dense_qp(W, v, rd, d["q0"])
        M, b = P.permute(2, 0, 1), q.T
    else:
        rng = np.random.default_rng(0 if B == 1000 else n + B)
        G = rng.standard_normal((B, n, n))
        M = torch.as_tensor(G @ G.transpose(0, 2, 1) + n * np.eye(n),
                            device="cuda")
        b = torch.as_tensor(rng.standard_normal((B, n)), device="cuda")
    M32, b32 = M.float().contiguous(), b.float().contiguous()
    before = BC.solve_spd_cuda.launches
    xk = BC.solve_spd(M32, b32)
    torch.cuda.synchronize()
    assert BC.solve_spd_cuda.launches == before + 1
    xp = BC.solve_spd_plain(M32, b32)
    x64 = BC.solve_spd_plain(M.double(), b.double())
    scale = x64.abs().amax(1)
    ek = ((xk.double() - x64).abs().amax(1) / scale).max()
    ep = ((xp.double() - x64).abs().amax(1) / scale).max()
    assert ek <= 2 * ep + 1e-6, (ek, ep)
    torch.testing.assert_close(xk, xp, rtol=0,
                               atol=1e-3 * x64.abs().max().item())


def test_batch_chol_designs_agree(gpu_sqp_linear):
    """Both designs of ``batch_chol.py:CholPlan`` -- direct, and a group
    of 4, 8 threads or a warp a system on staged spans -- give the default
    build's solution on 1003 random SPD systems at n=27 (and the staged
    design at n=12), to the plain f32 tolerance above: the same operations
    on every entry, in one order (bitwise with -fmad=false,
    kernel_ab.py)."""
    P = BC.CholPlan
    for n, plans in ((27, [P(27, 0, 128), P(27, 4, 256, 64, 1),
                           P(27, 8, 256, 32, 2), P(27, 32, 128, 4, 0)]),
                     (12, [P(12, 2, 64, 32, 0), P(12, 4, 128, 32, 0)])):
        rng = np.random.default_rng(n)
        G = rng.standard_normal((1003, n, n))
        M = torch.as_tensor(G @ G.transpose(0, 2, 1) + n * np.eye(n),
                            device="cuda", dtype=torch.float32)
        b = torch.as_tensor(rng.standard_normal((1003, n)), device="cuda",
                            dtype=torch.float32)
        ref = BC.solve_spd(M, b)
        for plan in plans:
            x = BC._launch(plan.check(), M, b)
            torch.cuda.synchronize()
            torch.testing.assert_close(x, ref, rtol=0,
                                       atol=1e-3 * ref.abs().max().item())


def test_linear_update_runner_on_card_tracks(gpu_sqp_linear):
    """The general runner on the 'linear' route through the q0 build,
    B=16 over 301 steps, five ipm_factored launches a step and no other
    NMPC kernel, against the JAX general runner's err_mean and alive
    (assets/nmpc_regime_refs.json)."""
    import json

    from koopman_realizations_torch.utils.checkpoint import ASSETS
    sim = gpu_sqp_linear[0]
    ref = json.loads((ASSETS / "nmpc_regime_refs.json").read_text())[
        "regimes"]["linear_update"]
    B = 16
    X0 = np.zeros((B, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    ws = (IF.ipm_factored_cuda, NM.nmpc_multipass_cuda, NS.nmpc_stage_cuda,
          NP.nmpc_pass_cuda)
    for w in ws:
        w.launches = 0
    out = sim.batched_runner(blockM_reference(), steps=301)(
        X0, np.zeros((B, 2), np.float32))
    assert [w.launches for w in ws] == [300 * 5, 0, 0, 0]
    assert out["alive"][:, -1].float().mean().item() == ref["alive"]
    err = lane_tracking_error(out["Yp"], blockM_reference())
    assert abs(err.mean().item() - ref["err_mean"]) < 1e-3, err.mean()


# ------------------------------------------------ the group interior point
# The sixteen builds of the cooperative interior point
# (csrc/ipm_group.cuh): ipm_factored's four, nmpc_multipass, nmpc_stage's
# three trajectory modes, nmpc_pass, the fused steps, bilin_lift, bilin
# and ipm_shared's three, each on 1007 closed-loop lanes of its own path
# (a ragged last block for every plan), made once; the one-pass kernels
# with the per-lane q0, per-lane windows and warm duals, as the stage and
# chord routes pass them; the bilinear step, bilin_lift and bilin with
# per-lane windows; the per-lane P warm.
STEP_BUILDS = ["step_fused", "linear_step_fused"]
SHARED_BUILDS = ["ipm_shared", "ipm_shared lane-P n=12",
                 "ipm_shared lane-P n=27"]
SOLVE_BUILDS = ["bilin_lift", "bilin"] + SHARED_BUILDS
GROUP_BUILDS = ["iters2", "unblocked", "unblocked_smooth", "q0",
                "nmpc_multipass", "nmpc_stage hold", "nmpc_stage roll",
                "nmpc_stage ship", "nmpc_pass"] + STEP_BUILDS + SOLVE_BUILDS
_GROUP_LANES = {}


def _step_outputs(c):
    """A step's new carry as the group tests read it: the primal start
    Pwarm @ x first, the alive mask last."""
    return (c.x0, c.upsc, c.lamc, c.ysc, c.xpl, c.yp, c.alive)


def _step_carry(args):
    """The carry of a step case's arguments (op, ysc, upsc, xpl, w,
    alive (1, B), x0, lamc, yp, v)."""
    ysc, upsc, xpl, w, alive, x0, lamc, yp = args[1:9]
    return StepCarry(ysc, upsc, xpl, w, alive.reshape(-1), x0, lamc, yp)


def _step_kernel(*args):
    return _step_outputs(args[0].launch(_step_carry(args), args[9], None))


def _step_plain(*args):
    return _step_outputs(args[0].step_plain(_step_carry(args), args[9]))


def _step_case(request, build, B):
    """(kernel, plain, f32 and f64 arguments, zeta's index) of a fused
    step on B closed-loop lanes after 3 plain steps; the bilinear step
    with per-lane windows."""
    if build == "step_fused":
        sim, op = request.getfixturevalue("gpu")
        c, win = _carry(op, B, 3)
        v = win[3 + torch.arange(B, device="cuda") % 8].T.contiguous()
        model, scaler, _ = load_model()
        op64 = build_step_fused(BilinearKmpc(
            model, scaler, MpcConfig(**MPC), device="cuda",
            dtype=torch.float64), sim.plant, scaler)
    else:
        sim, op = request.getfixturevalue("gpu_linear")
        c, _, fY = _linear_carry(op, sim, B, 3)
        v = fY[3].contiguous()
        model, scaler, _ = load_model(LINEAR_MODEL)
        op64 = build_linear_step_fused(LinearKmpc(
            model, scaler, MpcConfig(**LINEAR), device="cuda",
            dtype=torch.float64), sim.plant, scaler)
    c = c._replace(alive=c.alive[None])
    ins = {torch.float32: (op,) + tuple(t.contiguous() for t in c) + (v,),
           torch.float64: (op64,) + tuple(t.double().contiguous()
                                          for t in c) + (v.double(),)}
    return _step_kernel, _step_plain, ins, 1


def _onepass_case(request, build, B):
    """(kernel, plain, f32 and f64 arguments, zeta's index) of a one-pass
    build on B closed-loop lanes: one SQP pass along the multipass plan
    (tests' _pass_inputs), warm, with q0 and per-lane windows; nmpc_pass
    from fresh Jacobians."""
    if "onepass" not in _GROUP_LANES:
        sim, mpc64 = request.getfixturevalue("gpu_nmpc")
        zeta, up, win = _nmpc_lanes(sim, B, 3)
        sq = win[3 + torch.arange(B, device="cuda") % 8].T.contiguous()
        _GROUP_LANES["onepass"] = _pass_inputs(sim.mpc, mpc64, zeta, up, sq)
    ins = {}
    for dt, d in _GROUP_LANES["onepass"].items():
        tail = (d["zeta"], d["up"], d["sq"], d["x0"], d["q0"], d["lam0"], 8,
                1e-2)
        if build == "nmpc_pass":
            Jt, cv = N.stage_lin(d["qp"], d["Zl"], d["Ul"], Fv=d["Fv"])
            ins[dt] = (d["qp"], Jt.contiguous(), cv.contiguous()) + tail
        else:
            mode = build.split()[1]
            traj = {"ship": (d["Zl"], d["Ul"], d["Fv"]),
                    "roll": (None, d["Ul"], None), "hold": ()}[mode]
            ins[dt] = (d["qp"], mode) + tail + traj
    if build == "nmpc_pass":
        return NP.nmpc_pass_cuda, NP.nmpc_pass_plain, ins, 3
    return NS.nmpc_stage_cuda, NS.nmpc_stage_plain, ins, 2


def _shared_kernel(cons, P, q, x0, b, iters, floor, iobj=None, lam0=None):
    """``ipm_shared_cuda`` in the group cases' argument order: the lanes'
    q third (the poisoned operand), b fifth (``_ok``), iobj (1, B)."""
    return IS.ipm_shared_cuda(cons, P, q, b, x0, iters, floor,
                              None if iobj is None else iobj.reshape(-1),
                              lam0)


def _shared_plain(cons, P, q, x0, b, iters, floor, iobj=None, lam0=None):
    return IS.ipm_shared_plain(cons, P, q, b, x0, iters, floor,
                               None if iobj is None else iobj.reshape(-1),
                               lam0)


def _lane_p_args(cons, W, v, rdiag, q0, b, x0, lam_row, iters):
    """The per-lane-P build's group-case arguments of the factored QP
    (W, v, rdiag, q0): P = 2 (W^T W + diag r), q scaled by the lane's
    iobj = 1 / max |P|, the warm duals (row units) by iobj."""
    P, q = _dense_qp(W, v, rdiag, q0)
    iobj = 1.0 / P.abs().amax((0, 1))
    return (cons, P, (q * iobj).contiguous(), x0.contiguous(),
            b.contiguous(), iters, 1e-2, iobj[None].contiguous(),
            (lam_row * iobj).contiguous())


def _solve_case(request, build, B):
    """(kernel, plain, f32 and f64 arguments, poisoned operand's index) of
    bilin_lift, bilin or one of ipm_shared's builds on B closed-loop lanes:
    bilin_lift warm with per-lane windows (zeta poisoned); bilin on the
    iters2 route's lanes, warm with per-lane windows (z poisoned); the
    lane-shared
    Hessian of the linear general path, cold; the per-lane P of the
    'linear' update's second-pass QPs (n=12) or of the unblocked route's
    (n=27), warm (q poisoned).  ipm_shared's f64 arguments are the f32
    ones in f64, with the f64 controller's constraints."""
    if build == "bilin_lift":
        sim, op = request.getfixturevalue("gpu")
        c, win = _carry(op, B, 3)
        sq = win[3 + torch.arange(B, device="cuda") % 8].T.contiguous()
        model, scaler, _ = load_model()
        qp64 = BilinearKmpc(model, scaler, MpcConfig(**MPC), device="cuda",
                            dtype=torch.float64).lift_qp()
        lanes = (c.ysc, c.upsc, c.x0, c.lamc, sq)
        ins = {torch.float32: (op.qp,) + tuple(t.contiguous()
                                               for t in lanes) + (4, 1e-2),
               torch.float64: (qp64,) + tuple(t.double().contiguous()
                                              for t in lanes) + (4, 1e-2)}
        return bilin_lift_cuda, bilin_lift_plain, ins, 1
    if build == "bilin":
        sim, mpc64 = request.getfixturevalue("gpu_routes")["iters2"]
        mpc = sim.mpc
        z, up, U, lam, win = _route_lanes(sim, B, 3)
        sq = win[3 + torch.arange(B, device="cuda") % 8].T.contiguous()
        lanes = (z, up, mpc.warm_start(U), lam * mpc.row[:, None], sq)
        ins = {torch.float32: (mpc.bilin_qp(),) + tuple(
                   t.contiguous() for t in lanes) + (4, 1e-2),
               torch.float64: (mpc64.bilin_qp(),) + tuple(
                   t.double().contiguous() for t in lanes) + (4, 1e-2)}
        return BI.bilin_cuda, BI.bilin_plain, ins, 1
    if build == "ipm_shared":
        sim, op = request.getfixturevalue("gpu_linear")
        mpc = sim.mpc
        c, win, _ = _linear_carry(op, sim, B, 3)
        z = mpc.lift(c.ysc)
        f = 2.0 * mpc.CB_t.T @ (mpc.Qd_t[:, None]
                                * (mpc.CA_t @ z - win[3][:, None]))
        P, q, bz = mpc.eliminate_u0(2.0 * mpc.H_t, f,
                                    mpc.c_t[:, None] - mpc.Mc_t @ z, c.upsc)
        cons, obj = mpc.constraints(), P.abs().amax()
        a32 = (cons, (P / obj).contiguous(), (q / obj).contiguous(),
               c.x0.contiguous(), (bz / cons.row[:, None]).contiguous(),
               6, 1e-2)
        model, scaler, _ = load_model(LINEAR_MODEL)
        cons64 = LinearKmpc(model, scaler, MpcConfig(**LINEAR),
                            device="cuda", dtype=torch.float64).constraints()
    else:
        gl = request.getfixturevalue("gpu_sqp_linear")
        if build.endswith("n=12"):
            d, d64 = _linear_lanes(gl, B).values()
            cons, rd, W, v, b, x0 = d["args"]
            a32 = _lane_p_args(cons, W, v, rd, d["q0"], b, x0, d["lam0"], 8)
            cons64 = d64["args"][0]
        else:
            sim, _, unb, unb64 = gl
            z, up, U, lam, win = _route_lanes(Ksim(sim.plant, unb), B, 3)
            cons = unb.constraints()
            W, v = unb.factored_data(z, up, win[3], None)
            b = (unb.cF_t[:, None] - unb.F0_t @ up) / cons.row[:, None]
            x0 = unb.warm_start(U)
            a32 = _lane_p_args(cons, W, v, unb.rdiag, torch.zeros_like(x0),
                               b, x0, lam * cons.row[:, None], 8)
            cons64 = unb64.constraints()
    a64 = (cons64,) + tuple(t.double() if torch.is_tensor(t) else t
                            for t in a32[1:])
    return (_shared_kernel, _shared_plain,
            {torch.float32: a32, torch.float64: a64}, 2)


def _group_case(request, build):
    """(kernel, plain, f32 arguments, f64 arguments, poisoned operand's
    index) of one build on 1007 closed-loop lanes, warm where the path
    passes duals."""
    if build in _GROUP_LANES:
        return _GROUP_LANES[build]
    B = 1007
    if build in ROUTES:
        sim, mpc64 = request.getfixturevalue("gpu_routes")[build]
        z, up, U, lam, win = _route_lanes(sim, B, 3)
        ins = {}
        for dt, c in ((torch.float32, sim.mpc), (torch.float64, mpc64)):
            zd, ud, Ud = z.to(dt), up.to(dt), U.to(dt)
            betas = c.roll(zd, Ud)[1] if c.blocked else None
            W, v = c.factored_data(zd, ud, win[3].to(dt), betas)
            b = (c.cF_t[:, None] - c.F0_t @ ud) / c.row[:, None]
            ins[dt] = (c.constraints(), c.rdiag, W.contiguous(),
                       v.contiguous(), b.contiguous(),
                       c.warm_start(Ud).contiguous(),
                       (lam.to(dt) * c.row[:, None]).contiguous(),
                       c.cfg.qp_iters, 1e-2)
        case = (IF.ipm_factored_cuda, IF.ipm_factored_plain, ins, 3)
    elif build.startswith(("nmpc_stage", "nmpc_pass")):
        case = _onepass_case(request, build, B)
    elif build in STEP_BUILDS:
        case = _step_case(request, build, B)
    elif build in SOLVE_BUILDS:
        case = _solve_case(request, build, B)
    elif build == "q0":
        gl = request.getfixturevalue("gpu_sqp_linear")
        ins = {dt: d["args"] + (d["lam0"], 8, 1e-2, d["q0"])
               for dt, d in _linear_lanes(gl, B).items()}
        case = (IF.ipm_factored_cuda, IF.ipm_factored_plain, ins, 3)
    else:
        sim, mpc64 = request.getfixturevalue("gpu_nmpc")
        zeta, up, win = _nmpc_lanes(sim, B, 3)
        sq = win[3 + torch.arange(B, device="cuda") % 8].T.contiguous()
        ins = {dt: (c.nmpc_qp(), zeta.to(dt), up.to(dt),
                    sq.to(dt).contiguous(), 5, True, 8)
               for dt, c in ((torch.float32, sim.mpc),
                             (torch.float64, mpc64))}
        case = (NM.nmpc_multipass_cuda, NM.nmpc_multipass_plain, ins, 1)
    _GROUP_LANES[build] = case
    return case


def _lanes(args, idx):
    """The argument tuple with every per-lane operand (lanes last) cut to
    the lanes ``idx``."""
    B = args[2].shape[-1]
    return tuple(t[..., idx].contiguous()
                 if torch.is_tensor(t) and t.ndim > 1 and t.shape[-1] == B
                 else t for t in args)


def _ok(args, out):
    """The ok mask of a solution of a kernel's arguments (an NMPC
    kernel's u_prev: its first (m, B) operand; a fused step: the lanes it
    keeps alive)."""
    if isinstance(args[0], FusedStepBase):
        return out[-1] > 0.5
    if hasattr(args[0], "cons"):
        up = next(t for t in args[1:] if torch.is_tensor(t) and t.ndim == 2
                  and t.shape[0] == args[0].m)
        cons, b = args[0].cons, N.rhs(args[0], up)
    else:
        cons, b = args[0], args[4]
    return ok_mask(cons, b, out[0], out[1], out[2], 3e-3, 5e-2)[0]


def _tail_reading(build, out, ref, r64, top=12):
    """One line on the farthest lanes from plain f64 of the kernel's
    solution ``out`` and plain f32's ``ref``: each lane's two distances,
    two complementarity gaps (mean s lam: a lane where an ordering stalls
    keeps a large one) and its degeneracy, the f64 solution's smallest
    max(s, lam) over the rows (both near 0: a weakly active row)."""
    dist = lambda r: (r[0].double() - r64[0]).abs().amax(0)
    dk, dp = dist(out), dist(ref)
    q = lambda d: f"{torch.quantile(d, 0.99).item():.3e}"
    if build in STEP_BUILDS:
        # the primal start Pwarm @ x; no multipliers to read a gap from
        return (f"{build} B={dk.numel()}: Pwarm x, p99 kernel {q(dk)}, "
                f"plain f32 {q(dp)}; farthest lanes kernel "
                f"{dk.topk(top).indices.tolist()}, plain f32 "
                f"{dp.topk(top).indices.tolist()}")
    gap = lambda r: (r[1].double() * r[2].double()).mean(0)
    gk, gp = gap(out), gap(ref)
    deg = torch.maximum(r64[1], r64[2]).amin(0)
    lanes = lambda d: ", ".join(
        f"{i} {dk[i]:.1e}/{dp[i]:.1e} {gk[i]:.1e}/{gp[i]:.1e} {deg[i]:.1e}"
        for i in d.topk(top).indices.tolist())
    return (f"{build} B={dk.numel()}: p99 kernel {q(dk)}, plain f32 {q(dp)};"
            f" median gap {gk.median():.1e}/{gp.median():.1e}; lanes with "
            f"degeneracy < 1e-6 / 1e-4 {int((deg < 1e-6).sum())} / "
            f"{int((deg < 1e-4).sum())}; farthest (lane, distance and gap "
            f"kernel/plain, degeneracy): kernel {lanes(dk)}; plain f32 "
            f"{lanes(dp)}")


@pytest.mark.parametrize("B", [1, 33, 1007])
@pytest.mark.parametrize("build", GROUP_BUILDS)
def test_group_kernel_ragged_sizes(request, build, B):
    """Each group build at B = 1, 33 and 1007 lanes (the first B of the
    closed-loop set; every plan's last block ragged): kernel against
    plain f32 (equal ok masks) and against its own full launch, bitwise
    (a lane's result does not depend on its place in the tile); at 1007
    the median per-lane distance to plain f64 within twice plain f32's
    plus 1e-5, and (with ``-s``) a line on the farthest lanes.  No p99
    gate at 1007: on these lanes about 1 % of the dense build's lanes lie
    in either f32 ordering's tail beyond 1e-4 (11 of the kernel's, 8 of
    plain's), each ordering with lanes of its own, so the 99th percentile
    (the 10th-11th farthest lane) lands in one ordering's tail and the
    other's body by a lane or two.  The p99 gate is that of the 1000-lane
    tests above and of chip_smoke.py at 8192 and 65536 lanes; PERF.md
    section 6 has the reading."""
    kern, plain, ins, _ = _group_case(request, build)
    idx = torch.arange(B, device="cuda")
    a32 = _lanes(ins[torch.float32], idx)
    full = kern(*ins[torch.float32])
    out = kern(*a32)
    torch.cuda.synchronize()
    ref = plain(*a32)
    for o, f in zip(out, full):
        assert torch.equal(o, f[..., :B])
    assert torch.equal(_ok(a32, out), _ok(a32, ref))
    if B == 1007:
        r64 = plain(*ins[torch.float64])
        dk = (out[0].double() - r64[0]).abs().amax(0)
        dp = (ref[0].double() - r64[0]).abs().amax(0)
        print(_tail_reading(build, out, ref, r64))
        assert bool(_ok(a32, out).all()), build
        assert dk.median() <= 2 * dp.median() + 1e-5, (dk.median(),
                                                        dp.median())


@pytest.mark.parametrize("build", GROUP_BUILDS)
def test_group_kernel_lane_permutation(request, build):
    """A permutation of the lanes permutes the outputs bitwise."""
    kern, _, ins, _ = _group_case(request, build)
    a32 = ins[torch.float32]
    perm = torch.randperm(1007, generator=torch.Generator().manual_seed(0))
    perm = perm.to("cuda")
    out, outp = kern(*a32), kern(*_lanes(a32, perm))
    for o, op in zip(out, outp):
        assert torch.equal(o[..., perm], op)


@pytest.mark.parametrize("build", GROUP_BUILDS)
def test_group_kernel_deterministic(request, build):
    """Two launches on the same lanes give bitwise-equal outputs."""
    kern, _, ins, _ = _group_case(request, build)
    one, two = kern(*ins[torch.float32]), kern(*ins[torch.float32])
    for a, b in zip(one, two):
        assert torch.equal(a, b)


@pytest.mark.parametrize("build", GROUP_BUILDS)
def test_group_kernel_poisoned_lane_confined(request, build):
    """One lane's v (the NMPC kernels: its zeta) set to NaN leaves every
    other lane bitwise equal to the unpoisoned run and gives that lane
    the plain version's pattern of non-finite outputs."""
    kern, plain, ins, at = _group_case(request, build)
    a32 = ins[torch.float32]
    bad = 500
    t = a32[at].clone()
    t[..., bad] = float("nan")
    p32 = a32[:at] + (t,) + a32[at + 1:]
    out, outp = kern(*a32), kern(*p32)
    ref = plain(*p32)
    keep = torch.ones(1007, dtype=torch.bool, device="cuda")
    keep[bad] = False
    for o, op, r in zip(out, outp, ref):
        assert torch.equal(o[..., keep], op[..., keep])
        assert torch.equal(torch.isfinite(op[..., bad]),
                           torch.isfinite(r[..., bad]))


@pytest.mark.parametrize("build", STEP_BUILDS)
def test_step_kernel_in_place(request, build):
    """One step with ``out`` aliasing the input carry, as
    Ksim.fused_runner passes it (the front launch writes only the
    scratch, and the solve launch reads each element before it writes
    it), equals a step into fresh tensors, bitwise, and writes into the
    input carry's own tensors."""
    _, _, ins, _ = _group_case(request, build)
    args = ins[torch.float32]
    op, v, c = args[0], args[9], _step_carry(args)
    fresh = op.launch(c, v, None)
    cin = StepCarry(*(t.clone() for t in c))
    new = op.launch(cin, v, cin)
    torch.cuda.synchronize()
    for f in StepCarry._fields:
        assert torch.equal(getattr(new, f), getattr(fresh, f)), f
        assert getattr(new, f).data_ptr() == getattr(cin, f).data_ptr(), f


@pytest.mark.parametrize("build", SOLVE_BUILDS)
def test_solve_kernel_wide_ragged(request, build):
    """bilin_lift, bilin and ipm_shared's builds at B=100003 closed-loop
    lanes (every plan's last block ragged; 782 blocks of 128 lanes for
    bilin_lift, bilin and the lane-shared build): kernel against plain
    f32 with equal, all-true ok masks, both against plain f64."""
    kern, plain, ins, _ = _solve_case(request, build, 100003)
    a32 = ins[torch.float32]
    out = kern(*a32)
    torch.cuda.synchronize()
    ref = plain(*a32)
    x64 = plain(*ins[torch.float64])[0]
    _hold_to_f64(out[0], ref[0], x64, _ok(a32, out), _ok(a32, ref))


@pytest.mark.parametrize("n", [12, 27])
def test_ipm_shared_lane_p_asymmetric(request, n):
    """A per-lane f32 P that is not symmetric bit for bit (the dense P of
    the 'linear' update and of the unblocked route come from batched
    products): here each lane's strict upper triangle 1 % above its
    mirror.  The build reads all of P for r_d = Pr x and its lower
    triangle for the Newton matrix, as the plain version does: kernel
    against plain f32, both against plain f64 on the same P; and its
    solution moves with the upper triangle (the lower alone would not)."""
    kern, plain, ins, _ = _group_case(request, f"ipm_shared lane-P n={n}")
    up = torch.ones((n, n), device="cuda").triu(1)[..., None]
    asym = {dt: a[:1] + ((a[1] * (1 + 1e-2 * up.to(dt))).contiguous(),)
            + a[2:] for dt, a in ins.items()}
    a32 = asym[torch.float32]
    out, sym = kern(*a32), kern(*ins[torch.float32])
    torch.cuda.synchronize()
    ref = plain(*a32)
    x64 = plain(*asym[torch.float64])[0]
    _hold_to_f64(out[0], ref[0], x64, _ok(a32, out), _ok(a32, ref))
    assert (out[0] - sym[0]).abs().max().item() > 1e-4


@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
def test_nonfinite_zeta_lane_not_ok(gpu, bad):
    """A lane whose zeta holds a non-finite value: the assembly no longer
    makes 0 * inf = NaN in the generator stack's zero rows, but the live
    rows carry it, so bilin_lift's wrapper reports the lane not ok (as
    its plain version does) and step_fused freezes it; every other lane
    is bitwise what it is without the bad lane."""
    sim, op = gpu
    c, win = _carry(op, 1000, 3)
    bad_c = c._replace(ysc=c.ysc.clone())
    bad_c.ysc[2, 500] = bad
    keep = torch.ones(1000, dtype=torch.bool, device="cuda")
    keep[500] = False
    lam0 = c.lamc / op.qp.row[:, None]
    sols = [solve_qp_bilinear_lifted(op.qp, cc.ysc, cc.upsc, win[3],
                                     x0=cc.x0, lam0=lam0, iters=4)
            for cc in (c, bad_c)]
    plain = solve_qp_bilinear_lifted(
        op.qp._replace(**{k: v.cpu() if torch.is_tensor(v) else v
                          for k, v in op.qp._asdict().items()
                          if k != "tables"},
                       tables=tuple((a.cpu(), b.cpu())
                                    for a, b in op.qp.tables)),
        bad_c.ysc.cpu(), c.upsc.cpu(), win[3].cpu(), x0=c.x0.cpu(),
        lam0=lam0.cpu(), iters=4)
    assert bool(sols[0].ok.all()) and not bool(sols[1].ok[500])
    assert not bool(plain.ok[500])
    assert torch.equal(sols[1].ok.cpu(), plain.ok)
    for a, b in zip(sols[0], sols[1]):
        assert torch.equal(a[..., keep], b[..., keep])
    steps = [op.step(cc, win[3]) for cc in (c, bad_c)]
    torch.cuda.synchronize()
    assert bool(steps[0].alive.all()) and steps[1].alive[500].item() == 0.0
    for f in ("upsc", "xpl", "x0", "lamc", "yp"):
        assert torch.equal(getattr(steps[1], f)[..., 500],
                           getattr(c, f)[..., 500]), f
        assert torch.equal(getattr(steps[0], f)[..., keep],
                           getattr(steps[1], f)[..., keep]), f


# ---- the trainer (models/edmd.py) on the card against the CPU


@pytest.fixture(scope="module")
def corpus():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from koopman_realizations_torch.utils.data import load_corpus
    return load_corpus()


@pytest.mark.parametrize("kind", ["bilinear", "linear", "nonlinear"])
def test_ksysid_card_matches_cpu(corpus, kind):
    """The assets' recipe trained on the card and on the CPU, the caller's
    TF32 on: the lift stays on the card and the caller's setting is
    restored; the full f32 lift within f32 rtol (the same IEEE products),
    the PC subspaces within 1e-6 rad, the one-step predictions within 1e-5
    (the asset retrain's bound)."""
    from koopman_realizations_torch.config import SysidConfig
    from koopman_realizations_torch.models.edmd import Ksysid
    from koopman_realizations_torch.utils.metrics import (
        one_step_predictions,
        subspace_angle,
    )
    cfg = SysidConfig(model_type=kind, obs_type=("poly",), obs_degree=(3,),
                      dim_red=True, dtype="float32",
                      pca_explained=99.99 if kind == "nonlinear" else 99.0)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        card = Ksysid(corpus, cfg, device="cuda").train_models()
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    cpu = Ksysid(corpus, cfg, device="cpu").train_models()
    assert all(t.is_cuda for t in card.lift_snapshot_matrices())
    torch.testing.assert_close(card.full_lift().cpu(), cpu.full_lift(),
                               rtol=2.4e-7, atol=0)
    assert card.N == cpu.N
    assert subspace_angle(card.basis.pcs, cpu.basis.pcs) < 1e-6
    p_card = one_step_predictions(card.model, card.valdata, "cuda")
    p_cpu = one_step_predictions(cpu.model, cpu.valdata, "cpu")
    assert np.abs(p_card - p_cpu).max() < 1e-5
    e = [float(v["error"]["euclid_mean"]) for v in card.validate()]
    assert sum(map(np.isfinite, e)) == (3 if kind == "nonlinear" else 5)


# ---- the LASSO path, the random-system sweep and the lasso sweep on the
# card against the CPU


def _fista_obj(Px, Py, K):
    return float(((Px.double() @ K.double() - Py.double()) ** 2).sum())


def test_batched_fista_card_matches_cpu(gpu):
    """The fixed-iteration FISTA batched over 20 systems (the random
    sweep's nonlinear family at degree 4: 15 columns) and the trainer's
    f64 route with ``tol`` on one 40-column system: each system's
    objective on the card within 1e-9 relative of the CPU's."""
    from koopman_realizations_torch.ops.lasso import (
        lasso_constrained_lstsq,
        lasso_fista_f64,
    )
    g = torch.Generator().manual_seed(0)
    Px = torch.randn(20, 2000, 15, generator=g, dtype=torch.float64)
    Py = Px @ torch.randn(20, 15, 15, generator=g, dtype=torch.float64) \
        + 0.1 * torch.randn(20, 2000, 15, generator=g, dtype=torch.float64)
    t = torch.full((20,), 60.0, dtype=torch.float64)
    kc = lasso_constrained_lstsq(Px.cuda(), Py.cuda(), t.cuda(),
                                 iters=500).cpu()
    kh = lasso_constrained_lstsq(Px, Py, t, iters=500)
    for s in range(20):
        oc, oh = _fista_obj(Px[s], Py[s], kc[s]), _fista_obj(Px[s], Py[s],
                                                             kh[s])
        assert abs(oc - oh) <= 1e-9 * oh, (s, oc, oh)
    A = torch.randn(3000, 40, generator=g, dtype=torch.float64)
    B = torch.randn(3000, 40, generator=g, dtype=torch.float64)
    rc = lasso_fista_f64(A.cuda(), B.cuda(), 5.0, iters=20000, tol=1e-12)
    rh = lasso_fista_f64(A, B, 5.0, iters=20000, tol=1e-12)
    assert abs(rc.objective - rh.objective) <= 1e-9 * rh.objective
    assert abs(rc.iters - rh.iters) <= 100


def test_rsys_card_matches_cpu(gpu):
    """A small ensemble simulated on the card and on the CPU (f64):
    trajectories within rtol 1e-10; ``_fit_and_val`` of each family at
    degrees 1-3 within rtol 1e-6, atol 1e-9."""
    from koopman_realizations_torch.models.rsys import (
        construct_systems,
        simulate_systems,
    )
    from koopman_realizations_torch.workflows import rand_models as RM
    runs = {}
    for d in ("cuda", "cpu"):
        rng = np.random.default_rng(3)
        ens = construct_systems(4, 5, 3, 1, rng)
        runs[d] = simulate_systems(ens, 25.0, 0.05, 4, rng, device=d)
    for dc, dh in zip(runs["cuda"], runs["cpu"]):
        for tc, th in zip(dc.train + dc.val, dh.train + dh.val):
            np.testing.assert_allclose(tc.y, th.y, rtol=1e-10, atol=1e-13)
    Ytr, Utr, Yval, Uval = RM._stack_ensemble(runs["cpu"])
    yf, yo, uf, uo = RM._scale_params(Ytr, Utr)
    host = [torch.from_numpy(a) for a in (
        (Ytr - yo[:, None, None]) / yf[:, None, None],
        (Utr - uo[:, None, None]) / uf[:, None, None],
        (Yval - yo[:, None]) / yf[:, None], (Uval - uo[:, None]) / uf[:, None])]
    for family in ("linear", "bilinear", "nonlinear"):
        lasso = 4.0 if family == "nonlinear" else np.inf
        for degree in (1, 2, 3):
            ec = RM._fit_and_val(*[a.cuda() for a in host], degree=degree,
                                 family=family, lasso=lasso,
                                 lasso_iters=300).cpu().numpy()
            eh = RM._fit_and_val(*host, degree=degree, family=family,
                                 lasso=lasso, lasso_iters=300).numpy()
            np.testing.assert_allclose(ec, eh, rtol=1e-6, atol=1e-9)


# tests/test_torch_lasso_sweep.py: JAX tests/test_lasso_sweep.py:17-25
SWEEP_ARM = dict(Nmods=3, nlinks=1, L=1.0, m=0.1, output_type="markers",
                 substeps=5)
SWEEP_MPC = dict(horizon=10, input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8),
                 input_slopeConst=1e-1, cost_running=10.0,
                 cost_terminal=100.0, cost_input=(3e-3, 2e-3, 1e-3),
                 proj_idx=(4, 5))


@pytest.fixture(scope="module")
def sweep_ks(corpus):
    """The bilinear asset recipe at lasso (8, inf), 300 FISTA iterations,
    trained on the card."""
    from koopman_realizations_torch.config import SysidConfig
    from koopman_realizations_torch.models.edmd import Ksysid
    return Ksysid(corpus, SysidConfig(
        model_type="bilinear", obs_type=("poly",), obs_degree=(3,),
        dim_red=True, dtype="float32", lasso=(8.0, float("inf")),
        lasso_iters=300), device="cuda").train_models()


def _sweep(ks, device, dtype, steps=30, hook=None):
    from koopman_realizations_torch.workflows.lasso_sweep import (
        lasso_sweep_closed_loop,
    )
    return lasso_sweep_closed_loop(
        ks, Arm(ArmConfig(**SWEEP_ARM), device=device),
        MpcConfig(**SWEEP_MPC), blockM_reference(), steps=steps,
        device=device, dtype=dtype, qp_hook=hook)


def test_lasso_sweep_card_matches_cpu(sweep_ks):
    """2 candidates x 30 steps: the card's f32 loop through the per-lane-P
    kernel (one launch a step) against the CPU's f64 loop: alive equal,
    each candidate's err_mean within gate 2's 1e-3."""
    IS.ipm_shared_cuda.launches = 0
    card = _sweep(sweep_ks, "cuda", torch.float32)
    assert IS.ipm_shared_cuda.launches == 29
    cpu = _sweep(sweep_ks, "cpu", torch.float64)
    np.testing.assert_array_equal(card["alive"], cpu["alive"])
    assert card["alive"][:, -1].all()
    assert np.abs(card["err"].mean(1) - cpu["err"].mean(1)).max() < 1e-3


def test_lasso_sweep_qps_kernel_matches_plain(sweep_ks):
    """The sweep's own per-lane QPs (n=27, mc=108, 12 iterations, warm
    primal, cold duals; 30 steps of both candidates): the per-lane-P
    kernel against plain f32, both against plain f64, through
    ``solve_qp_shared``'s equilibration."""
    rec = []
    _sweep(sweep_ks, "cuda", torch.float32,
           hook=lambda qp, sol, alive: rec.append(qp))
    cons = rec[0][2]
    cons64 = BilinearKmpc(sweep_ks.candidates[0], sweep_ks.scaler,
                          MpcConfig(**SWEEP_MPC), device="cuda",
                          dtype=torch.float64).constraints()
    P, q, b, x0 = (torch.cat([r[i] for r in rec], dim=-1)
                   for i in (0, 1, 3, 5))
    out = {}
    for dt, c in ((torch.float32, cons), (torch.float64, cons64)):
        P_, q_, b_, x_ = (t.to(dt) for t in (P, q, b, x0))
        iobj = 1.0 / P_.abs().amax((0, 1))
        out[dt] = (c, P_.contiguous(), (q_ * iobj).contiguous(),
                   (b_ / c.row[:, None]).contiguous(), x_.contiguous(), 12,
                   1e-2, iobj.contiguous(), None)
    a32 = out[torch.float32]
    xk, sk, lk = IS.ipm_shared_cuda(*a32)
    torch.cuda.synchronize()
    xp, sp, lp = IS.ipm_shared_plain(*a32)
    x64 = IS.ipm_shared_plain(*out[torch.float64])[0]
    b = a32[3]
    _hold_to_f64(xk, xp, x64, ok_mask(cons, b, xk, sk, lk, 3e-3, 5e-2)[0],
                 ok_mask(cons, b, xp, sp, lp, 3e-3, 5e-2)[0])


# ------------------------------------------------------------ loaded arm


@pytest.fixture(scope="module")
def gpu_loaded():
    """The loaded-arm experiment on the card (``chip_smoke.loaded_setup``:
    the JAX-trained loaded assets, the controllers in f32 and f64, the
    observers, the 2-link plant) with its four builds made."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    import chip_smoke as CS
    torch.backends.cuda.matmul.allow_tf32 = False
    L = CS.loaded_setup(torch.device("cuda"))
    for r in _build.build_all(list(L.specs.values())):
        print(r.path.name, f"{r.seconds:.1f}s", *r.ptxas, sep="\n  ")
    return CS, L


def _loaded_state(gpu_loaded, kind, B, k_end=14):
    CS, L = gpu_loaded
    X0, W = CS.loaded_lanes(B, L.r)
    return CS.loaded_state(L, kind, X0, W, k_end)


def _held(kern, plain, a32, a64, cons, b):
    out = kern(*a32)
    torch.cuda.synchronize()
    ref = plain(*a32)
    x64 = plain(*a64)[0]
    _hold_to_f64(out[0], ref[0], x64,
                 ok_mask(cons, b, out[0], out[1], out[2], 3e-3, 5e-2)[0],
                 ok_mask(cons, b, ref[0], ref[1], ref[2], 3e-3, 5e-2)[0])
    return out


@pytest.mark.parametrize("B", [1000, 129, 1])
def test_loaded_bilin_kernel_matches_plain(gpu_loaded, B):
    """``bilin`` at the loaded shape (NL=42, m=2, n=8, mc=32, p=22, cold
    duals, 10 iterations) on the experiment's lanes after 14 steps, ragged
    batches: kernel against plain f32, both against plain f64."""
    CS, L = gpu_loaded
    a = CS.loaded_bilin_args(L, _loaded_state(gpu_loaded, "bilinear", B))
    m = L.ctl["bilinear"]
    a32 = a[torch.float32]
    assert (a32[0].nzl, a32[0].n, a32[0].mc) == (42, 8, 32)
    BI.bilin_cuda.launches = 0
    _held(BI.bilin_cuda, BI.bilin_plain, a32, a[torch.float64],
          m.constraints(), m.cFr[:, None] - m.F0r @ a32[2])
    assert BI.bilin_cuda.launches == 1


def test_loaded_lane_shared_kernel_matches_plain(gpu_loaded):
    """``ipm_shared``'s lane-shared build at the loaded linear QP (n=8,
    mc=32) on 1000 of the experiment's lanes after 14 steps."""
    CS, L = gpu_loaded
    a = CS.loaded_linear_args(L, _loaded_state(gpu_loaded, "linear", 1000))
    a32 = a[torch.float32]
    assert (a32[0].n, a32[0].mc) == (8, 32)
    _held(IS.ipm_shared_cuda, IS.ipm_shared_plain, a32, a[torch.float64],
          a32[0], a32[3])


@pytest.mark.parametrize("slope", [None, 0.05])
@pytest.mark.parametrize("kind", ["bilinear", "linear"])
def test_loaded_observer_kernels_match_plain(gpu_loaded, kind, slope):
    """The observers' box QPs on ``ipm_shared``'s per-lane-P builds (n=2
    bilinear, n=1 linear; mc = 2 n, with the slope rows 4 n) on 1000 of
    the experiment's lanes after 14 steps, kernel against plain f32, both
    against plain f64; and the estimate through ``solve_qp`` on the card
    held to the f64 estimate as the plain f32 one on the CPU is."""
    import dataclasses

    from koopman_realizations_torch.control.observer import (
        make_load_observer,
    )
    CS, L = gpu_loaded
    st = _loaded_state(gpu_loaded, kind, 1000)
    model = L.models[kind][0]
    cfg = dataclasses.replace(L.cfg, load_obs_slope=slope)
    obs = {dt: make_load_observer(model, cfg, device="cuda", dtype=dt)
           for dt in (torch.float32, torch.float64)}
    a = CS.loaded_observer_args(obs[torch.float32], obs[torch.float64], st)
    a32 = a[torch.float32]
    n = 2 if kind == "bilinear" else 1
    assert (a32[0].n, a32[0].mc) == (n, (4 if slope else 2) * n)
    _held(IS.ipm_shared_cuda, IS.ipm_shared_plain, a32, a[torch.float64],
          a32[0], a32[3])
    card = obs[torch.float32].estimate(st.ywin, st.uwin, st.what)
    cpu = {dt: make_load_observer(model, cfg, device="cpu",
                                  dtype=dt).estimate(
        st.ywin.cpu(), st.uwin.cpu(), st.what.cpu()).to(dt)
        for dt in (torch.float32, torch.float64)}
    for name, w in (("card f32", card.cpu()),
                    ("plain f32 on the CPU", cpu[torch.float32])):
        d = (w.double() - cpu[torch.float64]).abs().amax(0)
        print(f"observer {kind} slope {slope}: {name} estimate to f64 p50 "
              f"{d.median():.3e} p99 {d.quantile(0.99):.3e} max "
              f"{d.max():.3e} (lane {int(d.argmax())})")
    _near_f64(card.cpu(), cpu[torch.float32], cpu[torch.float64])
    if kind == "linear":
        assert (card[-1] == 0).all()


@pytest.mark.parametrize("case", ["3-link step B=65536",
                                  "loaded 2-link substep B=2048",
                                  "3-link step B=65536 wide"])
def test_plant_graph_bitwise_eager(gpu_loaded, case):
    """``Arm.step`` on the card replays one control period captured in a
    CUDA graph: bitwise the eager step over three periods, the bench's
    3-link arm (jac_mode 'step') at B=65536 and the loaded 2-link arm
    ('substep', 5 substeps, 3 Newton iterations) at B=2048 on the closed
    loops' range of states (``plant_lanes``: every lane finite); a second
    width gets a graph of its own.  The 'wide' case starts from 0.3 randn
    states and 0.5 randn inputs, where the SDIRK2 Newton iteration of some
    lanes leaves the reals: the bits agree there too, NaN included."""
    CS, L = gpu_loaded
    arm = Arm(ArmConfig(**ARM), device="cuda") if case.startswith("3") \
        else L.arm
    B = int(case.split("B=")[1].split()[0])
    if case.endswith("wide"):
        g = torch.Generator().manual_seed(1)
        X = (0.3 * torch.randn((arm.cfg.nx, B), generator=g)).cuda()
        U = (0.5 * torch.randn((arm.cfg.Nmods, B), generator=g)).cuda()
        W = torch.rand((2, B), generator=g).cuda()
    else:
        X, U, W = CS.plant_lanes(arm, B)
    bits = lambda t: t.view(torch.int32)
    xg, xe = X, X
    for k in range(3):
        xg, xe = arm.step(xg, U, W), arm.step_eager(xe, U, W)
        bad = int((~torch.isfinite(xe)).any(0).sum())
        print(f"{case}: period {k + 1}, {bad} of {B} lanes not finite; "
              f"torch.equal {torch.equal(xg, xe)}, bits equal "
              f"{torch.equal(bits(xg), bits(xe))}")
        assert torch.equal(bits(xg), bits(xe))
    if not case.endswith("wide"):
        assert bool(torch.isfinite(xg).all())
    assert (B, torch.float32, X.device) in arm._graphs
    assert torch.equal(bits(arm.step(X[:, :7], U[:, :7], W[:, :7])),
                       bits(arm.step_eager(X[:, :7], U[:, :7], W[:, :7])))
    assert (7, torch.float32, X.device) in arm._graphs


def test_plant_graph_cache_keeps_recent_widths(gpu_loaded):
    """An arm keeps the graphs of its ``GRAPH_WIDTHS`` most recently
    stepped widths: a new width beyond them drops the least recent one, a
    width stepped again moves to the front, ``clear_graphs`` drops all;
    a replay after an eviction is still the eager step."""
    from koopman_realizations_torch.models.arm import GRAPH_WIDTHS
    CS, L = gpu_loaded
    arm = Arm(ArmConfig(**L.r["arm"]), device="cuda")
    X, U, W = CS.plant_lanes(arm, 64)
    widths = [8 + k for k in range(GRAPH_WIDTHS)]
    for b in widths + [widths[0]]:
        arm.step(X[:, :b], U[:, :b], W[:, :b])
    arm.step(X, U, W)
    assert [k[0] for k in arm._graphs] == widths[2:] + [widths[0], 64]
    assert torch.equal(arm.step(X[:, :9], U[:, :9], W[:, :9]).view(
        torch.int32), arm.step_eager(X[:, :9], U[:, :9], W[:, :9]).view(
        torch.int32))
    assert len(arm._graphs) == GRAPH_WIDTHS
    arm.clear_graphs()
    assert not arm._graphs


def test_loaded_training_card_matches_assets(gpu_loaded):
    """Loaded training on the card (the committed loaded corpus): NL=42,
    one-step predictions within 1.2e-7 of the JAX-trained assets (the
    linear model within twice its extraction's one-ulp floor, where that
    is more)."""
    from koopman_realizations_torch.config import SysidConfig
    from koopman_realizations_torch.models.edmd import Ksysid
    from koopman_realizations_torch.utils.data import (
        LOADED_CORPUS,
        load_corpus,
    )
    from koopman_realizations_torch.utils.metrics import (
        one_step_predictions,
    )
    CS, L = gpu_loaded
    sysid = {k: tuple(v) if isinstance(v, list) else v
             for k, v in L.refs["sysid"].items()}
    ds = load_corpus(LOADED_CORPUS)
    for kind in ("bilinear", "linear"):
        cfg = SysidConfig(model_type=kind, **sysid)
        ks = Ksysid(ds, cfg, device="cuda").train_models()
        asset = L.models[kind][0]
        d = np.abs(one_step_predictions(ks.model, ks.valdata, "cuda")
                   - one_step_predictions(asset, ks.valdata, "cuda")).max()
        lim = 1.2e-7
        if kind == "linear":
            lim = max(lim, 2.0 * CS.one_ulp_floor(
                Ksysid(ds, cfg, device="cpu").train_models(), asset))
        assert ks.NL == 42 and d <= lim, (kind, d, lim)


def test_loaded_loops_on_card_track(gpu_loaded):
    """Phase LD's gates at B=64 x 301 steps: on each of the 16
    reference lanes alive as JAX x64 and err_mean within 1e-3 of the hull
    of x64's and the band of JAX's own f32 runs; What in [-1, 1]; the
    linear observer's last component exactly 0;
    the bilinear loop's err with the observer below 0.8x without; each
    kernel launched as the loop needs."""
    CS, L = gpu_loaded
    X0, W = CS.loaded_lanes(64, L.r)
    steps = L.r["steps"]
    err16 = {}
    for kind, use_obs in (("bilinear", True), ("bilinear", False),
                          ("linear", True)):
        obs = L.obs[kind] if use_obs else None
        sim = Ksim(L.arm, L.ctl[kind], observer=obs)
        BI.bilin_cuda.launches = IS.ipm_shared_cuda.launches = 0
        out = sim.batched_runner(L.ref, steps=steps)(X0, W)
        upd = sum(obs.updates(k) for k in range(1, steps)) if obs else 0
        if kind == "bilinear":
            assert (BI.bilin_cuda.launches, IS.ipm_shared_cuda.launches) \
                == (steps - 1, upd)
        else:
            assert IS.ipm_shared_cuda.launches == steps - 1 + upd
        jr = L.refs["runs"][f"{kind}/{use_obs}"]
        e = lane_tracking_error(out["Yp"], L.ref).cpu().numpy()[:16]
        assert (out["alive"][:16, -1].cpu().numpy()
                == np.asarray(jr["alive"])).all()
        off = CS.loaded_lane_gate(e, jr)
        assert (off < 1e-3).all(), (kind, use_obs, off)
        What = out["what"].cpu().numpy()
        assert np.abs(What).max() <= 1.0 + 1e-6
        if kind == "linear":
            assert (What[..., -1] == 0).all()
        err16[use_obs, kind] = e.mean()
    assert err16[True, "bilinear"] < 0.8 * err16[False, "bilinear"]


# ------------------------------------------------------------ dictionaries


@pytest.fixture(scope="module")
def gpu_dict():
    """Phase DX's paths on the card (``chip_smoke.dict_setup``: every
    dictionary asset's controllers in f32 and f64, the plants) with its
    builds made."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    import chip_smoke as CS
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    D = CS.dict_setup(dev, Arm(ArmConfig(**ARM), device=dev))
    specs = []
    for sp in D.specs.values():
        if sp not in specs:
            specs.append(sp)
    for r in _build.build_all(specs):
        print(r.path.name, f"{r.seconds:.1f}s", *r.ptxas, sep="\n  ")
    return CS, D


DX_KERNELS = {"bilin_lift": (bilin_lift_cuda, bilin_lift_plain),
              "bilin": (BI.bilin_cuda, BI.bilin_plain),
              "nmpc_pass": (NP.nmpc_pass_cuda, NP.nmpc_pass_plain)}


@pytest.mark.parametrize("B", [1000, 4099])
@pytest.mark.parametrize("path", ["del1", "nopca", "fs1", "nmpc-fs1",
                                  "nmpc-bilin"])
def test_dictionary_kernels_match_plain(gpu_dict, path, B):
    """Phase DX's new builds -- ``bilin_lift`` at nz=15 / degree 2 (the
    delayed model), ``bilin`` at NL=84 and NL=19, ``nmpc_pass`` of the
    jacfwd route -- on their paths' own closed-loop lanes after 6 steps,
    ragged batches: kernel against plain f32, both against plain f64.
    The batches hold at least 1000 lanes, so that the p99 of the gate is
    a percentile: at 129 lanes it is the second-farthest lane, and on the
    delayed model's QP, whose plain f32 solve is itself up to 2.8e-4 from
    f64, that compares two f32 orderings' extreme lanes (the kernel's
    4.1e-4 against plain's 1.3e-4 at B=129 in the first card run)."""
    CS, D = gpu_dict
    P = D.paths[path]
    a = CS.dict_kernel_args(P, B, 6)
    a32 = a[torch.float32]
    qp = a32[0]
    up = a32[4 if P.kernel == "nmpc_pass" else 2]
    shape = {"del1": lambda: (qp.nz, qp.nmono) == (15, 120),
             "nopca": lambda: qp.nzl == 84, "fs1": lambda: qp.nzl == 19,
             "nmpc-fs1": lambda: qp.nza == 9 and not qp.tables_host,
             "nmpc-bilin": lambda: qp.nza == 9 and not qp.tables_host}
    assert shape[path]()
    kern, plain = DX_KERNELS[P.kernel]
    kern.launches = 0
    _held(kern, plain, a32, a[torch.float64], P.mpc.constraints(),
          qp.cFr[:, None] - qp.F0r @ up)
    assert kern.launches == 1


@pytest.mark.parametrize("path", ["del1", "nopca", "fs1", "fs1-unblocked",
                                  "fs1-model", "mix", "nmpc-fs1",
                                  "nmpc-bilin"])
def test_dictionary_loops_on_card_track(gpu_dict, path):
    """Phase DX3's gate at B=16 x 301 in f32: each reference lane alive as
    JAX x64's or as one of JAX's own f32 runs', its err_mean within 1e-3
    of the hull of x64's and the band of JAX's own f32 runs (at most two
    lanes of a chaotic band excepted, ``chip_smoke.dict_lane_gate``);
    each step's QP through the path's kernel."""
    CS, D = gpu_dict
    P = D.paths[path]
    steps = D.refs["steps"]
    kern = {"ipm_factored": IF.ipm_factored_cuda,
            "ipm_shared": IS.ipm_shared_cuda}.get(P.kernel) \
        or DX_KERNELS[P.kernel][0]
    kern.launches = 0
    out = P.sim.batched_runner(blockM_reference(), steps=steps)(
        *CS.dict_lanes(P, D.refs["B"]))
    assert kern.launches == CS.dict_launches(P, steps)[P.kernel]
    e = lane_tracking_error(out["Yp"], blockM_reference()).cpu().numpy()
    assert CS.dict_alive_gate(out["alive"][:, -1].cpu().numpy(), P.r)
    ok, off, loose = CS.dict_lane_gate(e, P.r)
    assert ok, (path, off, loose)


# ---- the NMPC's unblocked stack (input_blocks=None: n=27, mc=108): the
# wide builds of nmpc_multipass, nmpc_stage, nmpc_pass (chord and the
# jacfwd route's) and ipm_factored's q0 build, each against its plain
# version on closed-loop lanes
NMPC_UB = dict(NMPC, input_blocks=None)


@pytest.fixture(scope="module")
def gpu_nmpc_ub():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    from koopman_realizations_torch.utils.checkpoint import ASSETS
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    fmodel, fscaler, _ = load_model(ASSETS / "arm3_nonlinear_fsparse1.npz")
    ctl = {}
    for dt in (torch.float32, torch.float64):
        ctl[dt] = {
            "nmpc": NonlinearKmpc(model, scaler, MpcConfig(**NMPC_UB),
                                  device="cuda", dtype=dt),
            "jacfwd": NonlinearKmpc(fmodel, fscaler, MpcConfig(**NMPC_UB),
                                    device="cuda", dtype=dt)}
    sim = Ksim(Arm(ArmConfig(**ARM), device="cuda"),
               ctl[torch.float32]["nmpc"])
    qp = ctl[torch.float32]["nmpc"].nmpc_qp()
    assert (qp.n, qp.mc) == (27, 108)
    specs = [NM.kernel_spec(qp), NP.kernel_spec(qp),
             NP.kernel_spec(ctl[torch.float32]["jacfwd"].nmpc_qp()),
             IF.kernel_spec(ctl[torch.float32]["nmpc"].constraints(), qp.p,
                            q0=True)] + [
        NS.kernel_spec(qp, mode) for mode in N.STAGE_MODES]
    for r in _build.build_all(specs):
        print(r.path.name, f"{r.seconds:.1f}s", *r.ptxas, sep="\n  ")
    return sim, ctl


def _ub_inputs(gpu_nmpc_ub, B=1000, rho=0.1):
    """One SQP pass's operands of the unblocked stack on B closed-loop
    lanes (per-lane windows), f32 and f64: the multipass plan as the
    linearization plan, its rollout, the fresh stage Jacobians (analytic;
    forward-mode on the fourier_sparser model), the condensed W, v of the
    'linear' update, x0 = U[m:], q0 = -2 rho U[m:] and the plan's
    multipliers (row units) as the warm start."""
    sim, ctl = gpu_nmpc_ub
    zeta, up, win = _nmpc_lanes(sim, B, 3)
    sq = win[3 + torch.arange(B, device="cuda") % 8].T.contiguous()
    U, sol = sim.mpc.solve(zeta, up, sq)
    out = {}
    for dt, c in ctl.items():
        m, mj = c["nmpc"], c["jacfwd"]
        qp = m.nmpc_qp(m.RdT_t + rho * m.bsizes_t)
        qj = mj.nmpc_qp(mj.RdT_t + rho * mj.bsizes_t)
        Ud, z, u, s = (t.to(dt).contiguous() for t in (U, zeta, up, sq))
        Z = N.rollout(qp, z, Ud)
        Zl, Fv = Z[:-1].contiguous(), Z[1:].contiguous()
        Jt, cv = N.stage_lin(qp, Zl, Ud, Fv=Fv)
        Zj = mj._rollout_full(z, Ud)
        Jj, cvj = mj.stage_lin(Zj[:-1], Ud, Fv=Zj[1:])
        W, v = N.condense(qp, Jt, cv, z, u, s)
        cons = m.constraints()
        out[dt] = dict(qp=qp, qj=qj, zeta=z, up=u, sq=s, Ul=Ud, Zl=Zl, Fv=Fv,
                       Jt=Jt, cv=cv, Jj=Jj.contiguous(), cvj=cvj.contiguous(),
                       W=W.contiguous(), v=v.contiguous(), cons=cons,
                       b=((m.cF_t[:, None] - m.F0_t @ u)
                          / cons.row[:, None]).contiguous(),
                       x0=m.moves(Ud).contiguous(),
                       q0=m.levenberg_q0(Ud, rho).contiguous(),
                       lam0=(sol.lam.to(dt) * qp.row[:, None]).contiguous())
    return out


def _ub_held(fns, args, cons_b):
    """Kernel (fns[0]) against plain f32 (fns[1]), both against plain f64,
    on args {dtype: (positional, keywords)}: equal ok masks, the kernel's
    distance to f64 within twice plain f32's (``_near_f64``)."""
    a32, k32 = args[torch.float32]
    rk = fns[0](*a32, **k32)
    torch.cuda.synchronize()
    rp = fns[1](*a32, **k32)
    a64, k64 = args[torch.float64]
    x64 = fns[1](*a64, **k64)[0]
    cons, b = cons_b
    okk = ok_mask(cons, b, *rk[:3], 3e-3, 5e-2)[0]
    okp = ok_mask(cons, b, *rp[:3], 3e-3, 5e-2)[0]
    assert torch.equal(okk, okp)
    _near_f64(rk[0], rp[0], x64)
    return rk


def test_nmpc_multipass_unblocked_matches_plain(gpu_nmpc_ub):
    """The wide multipass build (the sweep's projected rows handed over,
    a warp a lane forming the Gram) on 1000 closed-loop lanes."""
    sim, ctl = gpu_nmpc_ub
    zeta, up, win = _nmpc_lanes(sim, 1000, 3)
    sq = win[3 + torch.arange(1000, device="cuda") % 8].T.contiguous()
    args = {dt: ((c["nmpc"].nmpc_qp(), zeta.to(dt), up.to(dt),
                  sq.to(dt).contiguous(), 5, True, 8), {})
            for dt, c in ctl.items()}
    qp = args[torch.float32][0][0]
    rk = _ub_held((NM.nmpc_multipass_cuda, NM.nmpc_multipass_plain), args,
                  (qp.cons, N.rhs(qp, up)))
    assert torch.isfinite(rk[3]).all()


@pytest.mark.parametrize("mode", ["hold", "roll", "ship"])
@pytest.mark.parametrize("warm", [False, True])
def test_nmpc_stage_unblocked_matches_plain(gpu_nmpc_ub, mode, warm):
    ins = _ub_inputs(gpu_nmpc_ub)
    args = {}
    for dt, d in ins.items():
        traj = {"ship": dict(Zl=d["Zl"], Ul=d["Ul"], Fv=d["Fv"]),
                "roll": dict(Ul=d["Ul"]), "hold": {}}[mode]
        args[dt] = ((d["qp"], mode, d["zeta"], d["up"], d["sq"], d["x0"],
                     d["q0"], d["lam0"] if warm else None, 8, 1e-2), traj)
    d = ins[torch.float32]
    _ub_held((NS.nmpc_stage_cuda, NS.nmpc_stage_plain), args,
             (d["qp"].cons, N.rhs(d["qp"], d["up"])))


@pytest.mark.parametrize("route", ["chord", "jacfwd"])
def test_nmpc_pass_unblocked_matches_plain(gpu_nmpc_ub, route):
    """One pass from shipped Jacobians: the chord build (analytic
    Jacobians) and the jacfwd route's build (forward-mode Jacobians of the
    fourier_sparser model, no monomial tables)."""
    ins = _ub_inputs(gpu_nmpc_ub)
    jac = route == "jacfwd"
    args = {dt: (((d["qj"], d["Jj"], d["cvj"]) if jac
                  else (d["qp"], d["Jt"], d["cv"]))
                 + (d["zeta"], d["up"], d["sq"], d["x0"], d["q0"],
                    d["lam0"], 8, 1e-2), {})
            for dt, d in ins.items()}
    d = ins[torch.float32]
    q = d["qj"] if jac else d["qp"]
    _ub_held((NP.nmpc_pass_cuda, NP.nmpc_pass_plain), args,
             (q.cons, N.rhs(q, d["up"])))


@pytest.mark.parametrize("warm", [False, True])
def test_ipm_factored_q0_unblocked_matches_plain(gpu_nmpc_ub, warm):
    """The q0 build at n=27, mc=108 on the 'linear' update's QP."""
    ins = _ub_inputs(gpu_nmpc_ub)
    args = {dt: ((d["cons"], d["qp"].rdiag, d["W"], d["v"], d["b"], d["x0"],
                  d["lam0"] if warm else None, 8, 1e-2, d["q0"]), {})
            for dt, d in ins.items()}
    d = ins[torch.float32]
    _ub_held((IF.ipm_factored_cuda, IF.ipm_factored_plain), args,
             (d["cons"], d["b"]))


def test_nmpc_unblocked_runner_on_card_tracks(gpu_nmpc_ub):
    """The default configuration's general runner through the wide
    multipass build, B=16 over 301 steps, one launch a step: every lane
    alive."""
    sim, _ = gpu_nmpc_ub
    X0 = np.zeros((16, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, 16)
    NM.nmpc_multipass_cuda.launches = 0
    out = sim.batched_runner(blockM_reference(), steps=301)(
        X0, np.zeros((16, 2), np.float32))
    assert NM.nmpc_multipass_cuda.launches == 300
    assert out["alive"].all()
    assert torch.isfinite(lane_tracking_error(out["Yp"],
                                              blockM_reference())).all()
