"""The port's closed loop as a whole against the JAX general runner: the
bench configuration on the committed model, B=16 lanes, the full 301-step
blockM reference.

- ``batched_runner`` in f64 (the CPU path of the port's general runner)
  against the JAX ``batched_runner`` in its x64 session: the same
  algorithm in the same precision, so the records agree closely (measured
  max |dYp| 8.5e-5 over 301 steps, bound 5e-4) and the mean tracking
  error to 4e-7 (bound 1e-5).
- ``fused_runner`` (the plain fused step, f32 as the kernel): f32 plant
  noise (~1e-3 per step, see test_torch_step_fused.py) moves single lanes
  by up to 7e-3 but the mean tracking error only by 1e-4 (0.3%); the bound
  is 1e-3 (3%) of the JAX value, 0.03113.
Both must keep every lane alive.
"""

import numpy as np
import pytest
import torch

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import BilinearKmpc
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.utils.checkpoint import load_model
from koopman_realizations_torch.utils.metrics import lane_tracking_error
from koopman_realizations_torch.utils.trajectories import blockM_reference

from test_torch_oracle import (
    BENCH_ARM,
    BENCH_MPC,
    REF_B,
    REF_STEPS,
    bench_X0,
    jax_general_run,
    lane_errors,
)
from test_torch_oracle import one_thread  # noqa: E402,F401  (fixture)

# one torch thread a test process: the xdist workers' pools would
# oversubscribe the machine
pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def jax_ref():
    Yp, alive = jax_general_run(REF_B, REF_STEPS)
    assert alive.all()
    err = lane_errors(Yp, blockM_reference(), REF_STEPS)
    return Yp, err


def _run(runner_name, dtype):
    model, scaler, header = load_model()
    mpc = BilinearKmpc(model, scaler, MpcConfig(**BENCH_MPC), device="cpu",
                       dtype=dtype)
    sim = Ksim(Arm(ArmConfig(**BENCH_ARM), device="cpu"), mpc,
               device="cpu")
    run = getattr(sim, runner_name)(blockM_reference(), steps=REF_STEPS)
    out = run(bench_X0(REF_B), np.zeros((REF_B, 2), np.float32))
    return out, header


@pytest.mark.parametrize("runner,dtype,bound", [
    ("batched_runner", torch.float64, 1e-5),
    ("fused_runner", torch.float32, 1e-3)])
def test_closed_loop_matches_jax_general_runner(jax_ref, runner, dtype,
                                                bound):
    jYp, jerr = jax_ref
    out, header = _run(runner, dtype)
    assert out["Yp"].shape == (REF_B, REF_STEPS - 1, 2)
    assert out["alive"].all()
    err = lane_tracking_error(out["Yp"], blockM_reference()).numpy()
    assert np.isfinite(err).all()
    assert abs(err.mean() - jerr.mean()) < bound, (err.mean(), jerr.mean())
    # the asset header records the same JAX run (written with the asset)
    assert abs(header["jax_reference"]["err_mean"] - jerr.mean()) < 1e-12
    if dtype == torch.float64:
        np.testing.assert_allclose(out["Yp"].numpy(), jYp, rtol=0,
                                   atol=5e-4)


def test_lane_tracking_error_matches_bench_formula():
    rng = np.random.default_rng(0)
    Yp = rng.normal(size=(3, 7, 2)).astype(np.float32)
    ref = rng.normal(size=(9, 2))
    got = lane_tracking_error(torch.from_numpy(Yp), ref).numpy()
    np.testing.assert_allclose(got, lane_errors(Yp, ref, 8), rtol=1e-6)
