"""The arm's other plants in the closed loop: the bench's bilinear
controller in the port's general runner on RK4 (200 substeps), SDIRK2
with exact Newton ('stage') and the adaptive 'rk45', each over the
bench's 16 lanes on the blockM, against the JAX x64 general runner's
values in ``assets/plant_refs.json`` (written by ``python
tests/test_torch_oracle.py --write-plants``), on the CPU in f64 with the
JAX controller's f32-rounded constants (``test_torch_delays.py``).

Each lane's err_mean within 1e-9 of JAX's (measured within 1.4e-12: the
port's closed-form RHS and JAX's autodiff one agree to rounding, and
these loops do not amplify it), so that errors of opposite sign on
different lanes cannot hide in the mean; the 16-lane mean within 1e-5
(measured 4.2e-14 rk4, 5.6e-16 stage, 9.0e-14 rk45); alive equal.  'rk4' and
'stage' run all 301 steps; 'rk45' (~0.4 s a period on one CPU thread,
about 125 Dormand-Prince iterations of the stiff arm) runs the
refs' first 101 (``short_steps``), held to their 101-step values; the
card runs all 301 (chip_smoke.py phase GN4).
"""

import json

import numpy as np
import pytest
import torch

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import make_kmpc
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.utils.checkpoint import BENCH_MODEL, load_model
from koopman_realizations_torch.utils.trajectories import blockM_reference

from test_torch_delays import F32_CONSTANTS
from test_torch_oracle import (
    BENCH_MPC,
    PLANT_ARMS,
    PLANT_REFS,
    PLANT_SHORT_STEPS,
    bench_X0,
    blockM_y,
    lane_errors,
    one_thread,  # noqa: F401  (fixture)
)

pytestmark = pytest.mark.usefixtures("one_thread")

STEPS = {"rk4": 301, "stage": 301, "rk45": PLANT_SHORT_STEPS}


def port_sim(plant: str):
    model, scaler, _ = load_model(BENCH_MODEL)
    mpc = make_kmpc(model, scaler, MpcConfig(**BENCH_MPC), device="cpu",
                    dtype=torch.float64)
    for name in F32_CONSTANTS:
        t = getattr(mpc, name, None)
        if t is not None:
            t.copy_(t.float().double())
    mpc.sqq = mpc.sqq.astype(np.float32).astype(np.float64)
    return Ksim(Arm(ArmConfig(**PLANT_ARMS[plant]), device="cpu"), mpc,
                device="cpu")


def test_plant_refs_are_the_recipe():
    refs = json.loads(PLANT_REFS.read_text())
    assert (refs["B"], refs["steps"], refs["short_steps"]) == \
        (16, 301, PLANT_SHORT_STEPS)
    assert set(refs["plants"]) == set(PLANT_ARMS)
    for name, r in refs["plants"].items():
        assert r["arm"] == PLANT_ARMS[name] and all(r["alive"])
        assert abs(np.mean(r["err_mean"]) - 0.031128) < 1e-3
    assert ArmConfig(**PLANT_ARMS["stage"]).substeps == 10


def hold_to_the_refs(plant: str):
    """The port's 16 lanes over the plant's steps against the refs."""
    r = json.loads(PLANT_REFS.read_text())["plants"][plant]
    steps = STEPS[plant]
    key = "" if steps == 301 else f"_{steps}"
    out = port_sim(plant).batched_runner(blockM_reference(), steps=steps)(
        bench_X0(16).astype(np.float64), np.zeros((16, 2)))
    e = lane_errors(out["Yp"].numpy(), blockM_y(), steps)
    np.testing.assert_array_equal(out["alive"][:, -1].numpy(),
                                  r["alive" + key])
    np.testing.assert_allclose(e, r["err_mean" + key], rtol=0, atol=1e-9)
    assert abs(e.mean() - np.mean(r["err_mean" + key])) < 1e-5


@pytest.mark.parametrize("plant", ["rk4", "rk45"])
def test_plant_in_the_loop_matches_the_refs(plant):
    """(The 'stage' plant's loop is in ``test_torch_plants_stage.py``, a
    file of its own so that two test workers share the three loops.)"""
    hold_to_the_refs(plant)
