"""The port's general runner on delay-embedded models and the other
dictionaries' closed loops, against the JAX package on the CPU: the
trailing windows' layout and starts, the fused step's eligibility and
the delayed lift-fused loop against the live JAX general runner (the
f64 B=16 x 301 loops against the JAX x64 references are in
``tests/test_torch_dictionary_loops.py``).

Tolerances, each with what it was measured at:
- the window's zeta rows exactly (copies);
- the B=4 x 30 delayed loop against live JAX x64: every tracked output
  and each lane's err_mean within 1e-5, alive equal.  The JAX bilinear
  controller casts its assembly generators, input cost and constraint
  right-hand side to the model's f32 even in an x64 session (ROADMAP
  "Parity notes"); the port's f64 controller is given the same
  f32-rounded constants here (``port_sim``).
"""

import numpy as np
import pytest
import torch

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import make_kmpc
from koopman_realizations_torch.control.ksim import KoopmanPlant, Ksim
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.utils.checkpoint import BENCH_MODEL
from koopman_realizations_torch.utils.checkpoint import load_model
from koopman_realizations_torch.utils.trajectories import blockM_reference

from test_torch_oracle import (
    BENCH_ARM,
    BENCH_MPC,
    DICT_PATHS,
    blockM_y,
    dict_asset_path,
    jax_dict_lanes,
    jax_dict_run,
    lane_errors,
    one_thread,  # noqa: F401  (fixture)
)

pytestmark = pytest.mark.usefixtures("one_thread")

# the constants the JAX bilinear controller keeps in the model's f32
F32_CONSTANTS = ("gens", "rdiag", "cFr", "F0r", "PG_t", "PA_t", "PAt_t",
                 "sqq_t", "A_t", "Bm_t", "cF_t", "F0_t")


def port_sim(path: str, qp_iters: int, dtype=torch.float64):
    """(Ksim, controller) of the port for a ``DICT_PATHS`` entry on the
    CPU, the bilinear controller with the JAX controller's f32-rounded
    constants."""
    asset, plant, knobs = DICT_PATHS[path]
    model, scaler, _ = load_model(dict_asset_path(asset))
    mpc = make_kmpc(model, scaler, MpcConfig(**dict(knobs,
                                                    qp_iters=qp_iters)),
                    device="cpu", dtype=dtype)
    if model.meta.model_type == "bilinear":
        for name in F32_CONSTANTS:
            t = getattr(mpc, name, None)
            if t is not None:
                t.copy_(t.float().to(dtype))
        # sqrt(Q), which scales the reference windows, in f32 as well
        mpc.sqq = mpc.sqq.astype(np.float32).astype(np.float64)
    pl = KoopmanPlant(model, scaler, "cpu") if plant == "model" \
        else Arm(ArmConfig(**BENCH_ARM), device="cpu")
    return Ksim(pl, mpc, device="cpu"), mpc


def test_delay_windows_start_tiled_and_carry_the_plan():
    """The delayed runner's zeta: the newest output, the output delay and
    the input window's second-newest row (zeta_from_window: the input
    the plant consumed over the last interval, chosen a step earlier), the
    windows started from the lane's tiled y0 and u0 (ksim.py:248-249),
    each step putting the plan's scaled U[1] into the input window
    (ksim.py:171, 190); the solve's previous input is its newest row."""
    sim, mpc = port_sim("del1", 4)
    seen = []
    solve = mpc.solve

    def record(z, up, sq, U, *rest):
        seen.append((z.clone(), up.clone()))
        out = solve(z, up, sq, U, *rest)
        seen[-1] += (out[0].clone(),)
        return out
    mpc.solve = record
    X0, W = jax_dict_lanes("del1", 3)
    sim.batched_runner(blockM_reference(), steps=4)(X0, W)
    sc = mpc.scaler
    y0 = sc.y_down(sim.plant.get_y(torch.as_tensor(X0).double().T), axis=0)
    u0 = sc.u_down(torch.zeros((3, 3), dtype=torch.float64), axis=0)
    z0, up0, U0 = seen[0]
    assert mpc.wants_zeta and z0.shape[0] == 15
    assert torch.equal(z0, torch.cat([y0, y0, u0]))
    assert torch.equal(up0, u0)
    z1, up1, U1 = seen[1]
    assert torch.equal(z1[6:12], y0)                # the output delay
    assert torch.equal(z1[12:], u0)                 # uwin[-2]
    assert torch.equal(up1, U0[3:6])                # the planned U[1]
    z2, up2, _ = seen[2]
    assert torch.equal(z2[6:12], z1[:6])
    assert torch.equal(z2[12:], U0[3:6])
    assert torch.equal(up2, U1[3:6])


def test_fused_step_takes_only_one_poly_family_with_pca():
    """``fused_step_eligible`` (ksim.py:409-437): the committed bench
    asset is eligible; delays, bases without PCA, other dictionaries and
    the model in the loop are not."""
    model, scaler, _ = load_model(BENCH_MODEL)
    arm = Arm(ArmConfig(**BENCH_ARM), device="cpu")
    mpc = make_kmpc(model, scaler, MpcConfig(**BENCH_MPC), device="cpu")
    assert Ksim(arm, mpc, device="cpu").fused_step_eligible()
    for path in ("del1", "nopca", "fs1", "fs1-model", "mix"):
        sim, _ = port_sim(path, 4, torch.float32)
        assert not sim.fused_step_eligible(), path
        with pytest.raises(ValueError, match="not eligible"):
            sim.fused_runner(blockM_reference(), steps=3)


def test_delayed_loop_matches_live_jax():
    B, steps, q = 4, 30, 11
    sim, _ = port_sim("del1", q)
    X0, W = jax_dict_lanes("del1", B)
    out = sim.batched_runner(blockM_reference(), steps=steps)(X0, W)
    ej, aj, Ypj = jax_dict_run("del1", q, B, steps)
    Yp = out["Yp"].numpy()
    np.testing.assert_allclose(Yp, Ypj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lane_errors(Yp, blockM_y(), steps), ej,
                               rtol=0, atol=1e-5)
    assert (out["alive"][:, -1].numpy() == aj).all()
