"""The harness slice's new CUDA builds against their plain PyTorch
versions on the card: both fused steps with ``jac_mode='substep'`` on
marker and on angle outputs, and ``ipm_shared``'s lane-shared builds with
warm duals (n=12) and at the linear controller's unblocked shape (n=27,
band 3, and dense with state-bound rows); the timed runner's per-step
CUDA-event clock.

CUDA kernels have no CPU mode, so these tests need an NVIDIA GPU with the
CUDA toolkit and skip elsewhere.  They import no JAX:

    python -m pytest --noconftest -o addopts="" -m cuda \\
        tests/test_torch_cuda_harness.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import make_kmpc
from koopman_realizations_torch.control.ksim import Ksim, _Loop
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.ops.kernels import _build
from koopman_realizations_torch.ops.kernels import ipm_shared as IS
from koopman_realizations_torch.ops.kernels.linear_step_fused import (
    build_linear_step_fused,
)
from koopman_realizations_torch.ops.kernels.step_fused import (
    StepCarry,
    build_step_fused,
)
from koopman_realizations_torch.ops.qp import ok_mask
from koopman_realizations_torch.utils.checkpoint import (
    LINEAR_MODEL,
    load_model,
)
from koopman_realizations_torch.utils.trajectories import blockM_reference

pytestmark = pytest.mark.cuda

ASSETS = Path(__file__).resolve().parents[1] / "koopman_realizations_torch" \
    / "assets"
RUNNER_REFS = json.loads((ASSETS / "runner_refs.json").read_text())
BENCH_ARM = dict(Nmods=3, nlinks=1, L=1.0, m=0.1, output_type="markers",
                 substeps=3, newton_iters=1, jac_mode="step")
LOOPS = {"default_bilinear": ("arm3_bilinear_poly3.npz", "markers"),
         "default_linear": ("arm3_linear_poly3.npz", "markers"),
         "angles_bilinear": ("arm3_angles_bilinear_poly3.npz", "angles"),
         "angles_linear": ("arm3_angles_linear_poly3.npz", "angles")}


def _cfg(entry: dict) -> MpcConfig:
    """The port's ``MpcConfig`` of a refs entry's JAX configuration."""
    import dataclasses
    fields = {f.name for f in dataclasses.fields(MpcConfig)}
    tup = lambda v: tuple(tup(x) for x in v) if isinstance(v, list) else v
    return MpcConfig(**{k: tup(v) for k, v in entry.items()
                        if k in fields})


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _fused_op(name):
    asset, outs = LOOPS[name]
    model, scaler, _ = load_model(ASSETS / asset)
    mpc = make_kmpc(model, scaler,
                    _cfg(RUNNER_REFS["paths"][name]["config"]),
                    device="cuda")
    arm = Arm(ArmConfig(Nmods=3, nlinks=1, L=1.0, m=0.1, output_type=outs),
              device="cuda")
    sim = Ksim(arm, mpc)
    build = build_linear_step_fused if name.endswith("_linear") \
        else build_step_fused
    op = build(mpc, arm, scaler)
    ref = blockM_reference() if outs == "markers" \
        else np.asarray(RUNNER_REFS["angle_reference"])
    win = sim.reference_windows(ref, 40)
    return sim, op, op.fYr(win) if name.endswith("_linear") else win


@pytest.mark.parametrize("name", list(LOOPS))
def test_substep_fused_step_kernel_matches_plain(card, name):
    """One step of each new fused build (1000 lanes, not a block multiple,
    after two plain steps) against its plain version: the QP outputs
    within 1e-3 of scale, the plant's within 2e-2 (two f32 orderings of
    the Newton iterations), alive equal and all true."""
    sim, op, v = _fused_op(name)
    _build.build_all([op.kernel_spec()])
    B = 1000
    X0 = np.zeros((B, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    c = op.init_carry(X0, np.zeros((B, 2), np.float32))
    for k in range(2):
        c = op.step_plain(c, v[k])
    out = StepCarry(*(torch.empty_like(t) for t in c))
    kc = op.step(c, v[2], out=out)
    torch.cuda.synchronize()
    pc = op.step_plain(c, v[2])
    assert torch.equal(kc.alive, pc.alive) and bool(kc.alive.all())
    for f in ("upsc", "x0"):
        d = (getattr(kc, f) - getattr(pc, f)).abs().max().item()
        assert d < 1e-3, (f, d)
    for f in ("ysc", "xpl", "yp"):
        d = (getattr(kc, f) - getattr(pc, f)).abs().max().item()
        assert d < 2e-2, (f, d)
    assert kc.ysc.shape[0] == (3 if "angles" in name else 6)


def _linear(**knobs):
    model, scaler, _ = load_model(LINEAR_MODEL)
    base = dict(horizon=10, qp_iters=6, qp_dual_warm=False,
                input_blocks=(1, 1, 2, 5),
                input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8),
                input_slopeConst=1e-1, cost_running=10.0,
                cost_terminal=100.0, cost_input=(3e-3, 2e-3, 1e-3),
                proj_idx=(4, 5))
    cfg = MpcConfig(**{**base, **knobs})
    return [make_kmpc(model, scaler, cfg, device="cuda", dtype=dt)
            for dt in (torch.float32, torch.float64)]


# the linear state-bound knob's bounds (tests/test_torch_oracle.py:
# KNOB_PATHS): the loop's outputs widened by 2.0, the end effector's x
# capped at 0.55, which binds on every lane from about step 36 of blockM
SB = tuple((lo - 2.0, 0.55 if i == 4 else hi + 2.0) for i, (lo, hi) in
           enumerate(((-0.243, 0.145), (0.228, 0.333), (-0.148, 0.451),
                      (0.370, 0.666), (-0.19, 0.704), (0.14, 0.9995))))


@pytest.mark.parametrize("knobs", [
    dict(qp_dual_warm=True), dict(qp_dual_warm=True, qp_dual_shift=True),
    dict(input_blocks=None, qp_iters=8),
    dict(input_blocks=None, qp_iters=24, state_bounds=SB),
    dict(input_blocks=None, qp_iters=24, state_bounds=SB,
         qp_dual_warm=True)])
def test_lane_shared_builds_match_plain(card, knobs):
    """``ipm_shared``'s lane-shared builds on the QPs of 1000 closed-loop
    lanes of the linear controller (warm duals at n=12, the n=27
    unblocked stack without and with state-bound rows; after five steps,
    with state bounds after 40, where a state-bound row binds on every
    lane): kernel and plain f32 both within reach of f64 (median distance
    within twice plain f32's plus 1e-5), equal all-true ok masks, and the
    state-bound rows active on some lane."""
    m32, m64 = _linear(**knobs)
    sim = Ksim(Arm(ArmConfig(**BENCH_ARM), device="cuda"), m32)
    ref = blockM_reference()
    B = 1000
    at = 40 if "state_bounds" in knobs else 5
    X0 = np.zeros((B, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    loop = _Loop(sim, at + 3, sim.reference_windows(ref, at + 3),
                 sim._ref_rows(sim.prep_ref(ref), at + 3), (), X0,
                 np.zeros((B, 2), np.float32))
    for k in range(at):
        loop.step(k)
    args = {}
    for dt, m in ((torch.float32, m32), (torch.float64, m64)):
        c = lambda t: None if t is None else t.to(dt)
        args[dt] = m.qp_args(m.lift(c(loop.ysc)), c(loop.upsc),
                             c(loop.windows[at]), c(loop.U_plan),
                             c(loop.lam))[0]
    a32 = args[torch.float32]
    _build.build_all([IS.kernel_spec(a32[0], warm=a32[8] is not None)])
    xk, sk, lk = IS.ipm_shared_cuda(*a32)
    torch.cuda.synchronize()
    xp, sp, lp = IS.ipm_shared_plain(*a32)
    x64 = IS.ipm_shared_plain(*args[torch.float64])[0]
    cons, b = a32[0], a32[3]
    okk = ok_mask(cons, b, xk, sk, lk, 3e-3, 5e-2)[0]
    okp = ok_mask(cons, b, xp, sp, lp, 3e-3, 5e-2)[0]
    assert torch.equal(okk, okp) and bool(okk.all())
    dk = (xk.double() - x64).abs().amax(0).median()
    dp = (xp.double() - x64).abs().amax(0).median()
    assert dk <= 2 * dp + 1e-5, (dk, dp)
    if "state_bounds" in knobs:
        nsb = m32.n_con - 2 * m32.n * (m32.Np - 1)
        assert bool((lk[nsb:] > 1e-3).any())


def test_timed_runner_on_card(card):
    """``run_trial_mpc_timed`` on the card: a CUDA-event time a step,
    K-1 of them, the struct of ``run_trial_mpc``."""
    m32, _ = _linear()
    sim = Ksim(Arm(ArmConfig(**BENCH_ARM), device="cuda"), m32)
    res = sim.run_trial_mpc_timed(blockM_reference(), steps=12)
    ref = sim.run_trial_mpc(blockM_reference(), steps=12)
    assert res["comp_time"].shape == (11,) and (res["comp_time"] > 0).all()
    np.testing.assert_allclose(res["Y"], ref["Y"], rtol=0, atol=1e-5)
    assert set(res) == set(ref)
