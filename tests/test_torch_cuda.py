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
from koopman_realizations_torch.control.kmpc import BilinearKmpc
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.ops.kernels import _build
from koopman_realizations_torch.ops.kernels.bilin_lift import (
    bilin_lift_cuda,
    bilin_lift_plain,
    kernel_spec,
)
from koopman_realizations_torch.ops.kernels.step_fused import (
    StepCarry,
    build_step_fused,
)
from koopman_realizations_torch.utils.checkpoint import load_model
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
