"""The port's general runner with the SQP NMPC's 'linear' between-pass
update, alone and with best-of-passes, B=16 over the full 301 blockM steps
in f64, against the JAX general runner in the same regime
(``assets/nmpc_regime_refs.json``, ``python tests/test_torch_oracle.py
--write-regime-refs``: x64, CPU, the same 16 lanes): err_mean within 1e-5
(measured 3.5e-9 alone), alive equal (1.0).  A file of its own so that the
two ~40 s loops run beside the solve-level tests of
``test_torch_nmpc_linear.py``."""

import json

import numpy as np
import pytest
import torch

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import NonlinearKmpc
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.utils.checkpoint import (
    NONLINEAR_MODEL,
    load_model,
)
from koopman_realizations_torch.utils.metrics import lane_tracking_error
from koopman_realizations_torch.utils.trajectories import blockM_reference

from test_torch_oracle import (
    BENCH_ARM,
    NMPC_MPC,
    NMPC_REGIMES,
    REF_B,
    REF_STEPS,
    REGIME_REFS,
    bench_X0,
    one_thread,  # noqa: F401  (the fixture of pytestmark)
)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("regime", ["linear_update", "linear_update_best"])
def test_linear_update_loop_matches_jax_reference(regime):
    ref = json.loads(REGIME_REFS.read_text())
    assert (ref["B"], ref["steps"]) == (REF_B, REF_STEPS)
    jr = ref["regimes"][regime]
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    mpc = NonlinearKmpc(model, scaler,
                        MpcConfig(**NMPC_MPC, **NMPC_REGIMES[regime]),
                        device="cpu", dtype=torch.float64)
    assert mpc.route == "linear"
    sim = Ksim(Arm(ArmConfig(**BENCH_ARM), device="cpu"), mpc, device="cpu")
    out = sim.batched_runner(blockM_reference(), steps=REF_STEPS)(
        bench_X0(REF_B), np.zeros((REF_B, 2), np.float32))
    alive = out["alive"][:, -1].double().mean().item()
    err = lane_tracking_error(out["Yp"], blockM_reference()).numpy()
    print(f"{regime}: err_mean {err.mean():.9f} (JAX {jr['err_mean']:.9f})"
          f", alive {alive}")
    assert alive == jr["alive"] == 1.0
    assert abs(err.mean() - jr["err_mean"]) < 1e-5, (err.mean(),
                                                     jr["err_mean"])
