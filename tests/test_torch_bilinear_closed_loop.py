"""The bilinear controller's unblocked closed loops as a whole against the
JAX general runner: the port's f64 general runner in the ``unblocked``
(n=27, mc=108, banded) and ``unblocked_smooth`` (mc=156, dense A^T D A)
configurations of ``BILINEAR_ROUTES``, B=16 over 301 blockM steps, every
QP through ``ipm_factored``'s plain version, against the JAX general
runner's err_mean and alive (``assets/bilinear_route_refs.json``).  The
JAX controller's shared-Beta generator PG is f32 in its x64 session, the
port's f64: measured differences 4e-8 and 1.8e-6; bound 1e-5, as the
lift-fused loop's.  (The ``iters2`` loop is in test_torch_bilin.py.)
"""

import json

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
    BILINEAR_ROUTE_REFS,
    BILINEAR_ROUTES,
    REF_B,
    REF_STEPS,
    bench_X0,
    one_thread,  # noqa: F401  (the fixture of pytestmark)
)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("name", ["unblocked", "unblocked_smooth"])
def test_unblocked_closed_loop_matches_jax_reference(name):
    ref = json.loads(BILINEAR_ROUTE_REFS.read_text())["regimes"][name]
    model, scaler, _ = load_model()
    mpc = BilinearKmpc(model, scaler,
                       MpcConfig(**{**BENCH_MPC, **BILINEAR_ROUTES[name]}),
                       device="cpu", dtype=torch.float64)
    sim = Ksim(Arm(ArmConfig(**BENCH_ARM), device="cpu"), mpc, device="cpu")
    out = sim.batched_runner(blockM_reference(), steps=REF_STEPS)(
        bench_X0(REF_B), np.zeros((REF_B, 2), np.float32))
    err = lane_tracking_error(out["Yp"], blockM_reference()).numpy()
    assert out["alive"][:, -1].double().mean().item() == ref["alive"] == 1.0
    assert abs(err.mean() - ref["err_mean"]) < 1e-5, (err.mean(),
                                                      ref["err_mean"])
