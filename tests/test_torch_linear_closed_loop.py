"""The port's linear closed loops as a whole against the JAX general
runner: the linear controller (qp_iters=6, cold duals) on the committed
linear asset, the bench plant, the blockM reference.

Closed loops, B=16 over the full 301-step blockM reference, against the
asset header's JAX general runner (x64, the same 16 lanes): the port's
general runner in f64 to 1e-5 on err_mean, its fused runner (f32, the
kernel's plain version) to 1e-3 (measured 7e-8 and 5.8e-5); both keep
every lane alive.  The f64 general runner's records are also held against
a live JAX general run on the first 4 lanes over 60 steps (measured
max |dYp| 7.1e-9; bound 1e-6).
"""

import numpy as np
import pytest
import torch

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import LinearKmpc
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.utils.checkpoint import (
    LINEAR_MODEL,
    load_model,
)
from koopman_realizations_torch.utils.metrics import lane_tracking_error
from koopman_realizations_torch.utils.trajectories import blockM_reference

from test_torch_oracle import (
    BENCH_ARM,
    LINEAR_MPC,
    REF_B,
    REF_STEPS,
    bench_X0,
    jax_general_run,
)
from test_torch_oracle import one_thread  # noqa: E402,F401  (fixture)

# one torch thread a test process: the xdist workers' pools would
# oversubscribe the machine
pytestmark = pytest.mark.usefixtures("one_thread")


def _sim(dtype):
    model, scaler, _ = load_model(LINEAR_MODEL)
    mpc = LinearKmpc(model, scaler, MpcConfig(**LINEAR_MPC), device="cpu",
                     dtype=dtype)
    return Ksim(Arm(ArmConfig(**BENCH_ARM), device="cpu"), mpc,
                device="cpu")


@pytest.mark.parametrize("runner,dtype,bound", [
    ("batched_runner", torch.float64, 1e-5),
    ("fused_runner", torch.float32, 1e-3)])
def test_linear_closed_loop_matches_jax_reference(runner, dtype, bound):
    sim = _sim(dtype)
    if runner == "fused_runner":
        assert sim.fused_step_eligible()
    header = load_model(LINEAR_MODEL)[2]["jax_reference"]
    assert (header["B"], header["steps"]) == (REF_B, REF_STEPS)
    out = getattr(sim, runner)(blockM_reference(), steps=REF_STEPS)(
        bench_X0(REF_B), np.zeros((REF_B, 2), np.float32))
    assert out["Yp"].shape == (REF_B, REF_STEPS - 1, 2)
    assert out["alive"].all() and header["alive"] == 1.0
    err = lane_tracking_error(out["Yp"], blockM_reference()).numpy()
    assert abs(err.mean() - header["err_mean"]) < bound, \
        (err.mean(), header["err_mean"])


def test_linear_general_runner_records_match_live_jax():
    steps = 60
    jYp, jalive = jax_general_run(4, steps, "linear")
    out = _sim(torch.float64).batched_runner(blockM_reference(), steps=steps)(
        bench_X0(4), np.zeros((4, 2), np.float32))
    np.testing.assert_array_equal(out["alive"].numpy(), jalive)
    np.testing.assert_allclose(out["Yp"].numpy(), jYp, rtol=0, atol=1e-6)


def test_linear_fused_runner_rejects_f64():
    """The kernel is f32: an f64 controller is not eligible (no cast)."""
    sim = _sim(torch.float64)
    assert not sim.fused_step_eligible()
    with pytest.raises(ValueError):
        sim.fused_runner(blockM_reference(), steps=5)
