"""The fused closed-loop step on the default plant and on angle outputs
(JAX ``_fused_plant_ok``, ksim.py:399-407): SDIRK2 with its Jacobian
factored at every substep (``jac_mode='substep'``, ``ArmConfig()``'s
default) and the joint angles as outputs (``_markers_rows``,
ops/pallas/step_fused.py:61-70), in both fused steps.

- ``fused_step_eligible`` equals the JAX ``Ksim``'s on ``ArmConfig()``
  defaults with the main path's geometry, on the angle models, and with
  the knobs that keep a controller off the fused step.
- The port's plain fused step (the kernels' plain version, f32 on the
  CPU) over 16 lanes x 301 steps against the JAX x64 general runner's
  values in ``assets/runner_refs.json`` (``--write-angles``): the linear
  step on the angle model ('substep' and angles; the plant tail is both
  steps'), err_mean within 1e-3 (gate 2 of PERF.md §2), alive equal.
- Each build's plant defines (``KM_JAC_SUBSTEP``, ``KM_ANGLES``).
"""

import numpy as np
import pytest
import torch

from koopman_realizations_tpu.config import ArmConfig as JArmConfig
from koopman_realizations_tpu.config import MpcConfig as JMpcConfig
from koopman_realizations_tpu.control import Ksim as JKsim
from koopman_realizations_tpu.control import make_kmpc as jax_make_kmpc
from koopman_realizations_tpu.models.arm import Arm as JArm
from koopman_realizations_tpu.utils.checkpoint import (
    load_model as jax_load_model,
)

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import make_kmpc
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.ops.kernels.linear_step_fused import (
    build_linear_step_fused,
)
from koopman_realizations_torch.ops.kernels.step_fused import (
    build_step_fused,
)
from koopman_realizations_torch.utils.checkpoint import load_model
from koopman_realizations_torch.utils.metrics import lane_tracking_error

from test_torch_oracle import (
    RUNNER_PATHS,
    bench_X0,
    one_thread,  # noqa: F401  (the fixture of pytestmark)
    runner_reference,
    runner_refs,
)

pytestmark = pytest.mark.usefixtures("one_thread")


def port_sim(path, dtype=torch.float32, **knobs):
    kind, asset, mpc_cfg, arm, _ = RUNNER_PATHS[path]
    model, scaler, _ = load_model(asset)
    mpc = make_kmpc(model, scaler, MpcConfig(**{**mpc_cfg, **knobs}),
                    device="cpu", dtype=dtype)
    return Ksim(Arm(ArmConfig(**arm), device="cpu"), mpc, device="cpu")


def jax_sim(path, **knobs):
    kind, asset, mpc_cfg, arm, _ = RUNNER_PATHS[path]
    model, scaler = jax_load_model(str(asset))
    return JKsim(JArm(JArmConfig(**arm)), jax_make_kmpc(
        model, scaler, JMpcConfig(**{**mpc_cfg, **knobs})))


@pytest.mark.parametrize("knobs", [dict(), dict(qp_dual_shift=True),
                                   dict(qp_dual_warm=True),
                                   dict(qp_dual_warm=False)])
@pytest.mark.parametrize("path", list(RUNNER_PATHS))
def test_fused_step_eligible_as_jax(path, knobs):
    """Eligibility on the default plant and the angle models equals the
    JAX package's (``ArmConfig()``: SDIRK2, 'substep', 10 substeps, 3
    Newton iterations); the shift and the warm linear duals leave the
    fused step in both packages, cold bilinear duals too."""
    mine = port_sim(path, **knobs).fused_step_eligible()
    assert mine == jax_sim(path, **knobs).fused_step_eligible()
    if not knobs:
        assert mine


@pytest.mark.parametrize("path", ["angles_linear"])
def test_plain_fused_loop_matches_the_jax_runner(path):
    """The plain fused loop (f32) over the refs' 16 lanes x 301 steps on
    the angle model ('substep' and angles, the plant tail both fused
    steps share, ``FusedStepBase.finish_plain``): err_mean within 1e-3
    of the JAX x64 general runner's, every lane alive as there (the card
    runs all four loops, chip_smoke.py phase RN2)."""
    r = runner_refs()
    ref_path = r["paths"][path]
    sim = port_sim(path)
    assert sim.fused_step_eligible()
    assert sim.mpc.cfg.qp_iters == ref_path["qp_iters"]
    B, steps = r["B"], r["steps"]
    ref = runner_reference(path)
    out = sim.fused_runner(ref, steps)(bench_X0(B),
                                       np.zeros((B, 2), np.float32))
    e = lane_tracking_error(out["Yp"], ref).numpy()
    assert abs(e.mean() - np.mean(ref_path["err_mean"])) < 1e-3
    np.testing.assert_array_equal(out["alive"][:, -1].numpy(),
                                  ref_path["alive"])


@pytest.mark.parametrize("path", list(RUNNER_PATHS))
def test_plant_defines_of_the_builds(path):
    """A step's build carries the plant's Jacobian mode and outputs as
    defines; the angle build's outputs are the Nlinks joint angles."""
    sim = port_sim(path)
    build = build_linear_step_fused if path.endswith("_linear") else \
        build_step_fused
    op = build(sim.mpc, sim.plant, sim.scaler)
    cfg = op.plant_config()
    angles = sim.plant.cfg.output_type == "angles"
    assert "#define KM_JAC_SUBSTEP 1" in cfg
    assert f"#define KM_ANGLES {int(angles)}" in cfg
    assert f"#define KM_NY {3 if angles else 6}" in cfg
    assert "#define KM_SUBSTEPS 10" in cfg and "#define KM_NEWTON 3" in cfg


def test_runner_refs_are_the_recipe():
    """``assets/runner_refs.json`` (``--write-angles``) holds the angle
    reference's rows as ``ANGLE_REF`` defines them, 16 lanes a path at
    the controller's qp_iters (every path keeps its lanes alive at its
    controller's count), and the plant ``ArmConfig()``'s defaults."""
    from test_torch_oracle import angle_reference
    r = runner_refs()
    np.testing.assert_allclose(np.asarray(r["angle_reference"]),
                               angle_reference(), rtol=0, atol=1e-15)
    for path, (kind, asset, mpc_cfg, arm, ref) in RUNNER_PATHS.items():
        e = r["paths"][path]
        assert e["asset"] == asset.name and e["reference"] == ref
        assert e["qp_iters"] == mpc_cfg["qp_iters"] and all(e["alive"])
        cfg = ArmConfig(**arm)
        assert (cfg.jac_mode, cfg.substeps, cfg.newton_iters) == \
            ("substep", 10, 3)
