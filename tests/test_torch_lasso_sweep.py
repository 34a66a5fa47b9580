"""The port's closed-loop lasso sweep (``workflows/lasso_sweep.py``,
``device="cpu"``) against the JAX ``lasso_sweep_closed_loop`` on the same
candidate models: the port trains the bilinear asset recipe at lasso
(8, inf) on the committed corpus, and the JAX sweep reads the same two
candidates through ``save_model`` / the JAX ``load_model`` (the two
packages' f32 lifts part by ~5e-7, which an unconverged lasso fit carries
to ~3e-4 of K; fed the same models, the loops compare the sweeps alone).
The controller, plant and reference are JAX ``tests/test_lasso_sweep.py``'s
(the unblocked horizon-10 stack, n=27, mc=108, 12 iterations; the arm
with SDIRK2, 5 substeps, 3 Newton iterations, ``jac_mode='substep'``),
2 candidates x 30 steps of blockM.

The JAX controller rounds its generators to f32 even in an x64 session
(ROADMAP.md §3, parity note 1) and the port keeps them f64, so the f64
loop is held to JAX as the B=16 loops are: alive equal, each candidate's
per-step error within 1e-5 m (measured 5.0e-9); the f32 loop (the
card's dtype) to the f64 one in mean error, gate 2's 1e-3 (measured
2.6e-7); the step's QPs to the JAX pure path (``_bilin_assemble``,
``_factored_Pq``, ``_solve_qp_impl``) fed the port's f64 operands: P and
q 1e-12 (measured 4.3e-16 of max |P|, 8.9e-16), b 1e-13 (measured 0), x
1e-9 (measured 2.6e-13).
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koopman_realizations_tpu.config import ArmConfig as JArmConfig
from koopman_realizations_tpu.config import MpcConfig as JMpcConfig
from koopman_realizations_tpu.models.arm import Arm as JArm
from koopman_realizations_tpu.utils.checkpoint import load_model as jload
from koopman_realizations_tpu.workflows.lasso_sweep import (
    lasso_sweep_closed_loop as jsweep,
)
from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.config import SysidConfig
from koopman_realizations_torch.control.kmpc import BilinearKmpc
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.models.edmd import Ksysid
from koopman_realizations_torch.utils.checkpoint import (
    LINEAR_MODEL,
    load_model,
    save_model,
)
from koopman_realizations_torch.utils.data import load_corpus
from koopman_realizations_torch.utils.trajectories import blockM_reference
from koopman_realizations_torch.workflows.lasso_sweep import (
    lasso_sweep_closed_loop,
    sweep_generators,
    sweep_qp,
)

from test_torch_oracle import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

# JAX tests/test_lasso_sweep.py:17-25
SWEEP_ARM = dict(Nmods=3, nlinks=1, L=1.0, m=0.1, output_type="markers",
                 substeps=5)
SWEEP_MPC = dict(horizon=10, input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8),
                 input_slopeConst=1e-1, cost_running=10.0,
                 cost_terminal=100.0, cost_input=(3e-3, 2e-3, 1e-3),
                 proj_idx=(4, 5))
STEPS = 30


@functools.lru_cache(maxsize=None)
def trained():
    """The port's Ksysid (bilinear asset recipe, lasso (8, inf), 300
    FISTA iterations) and a JAX-side stand-in with the same candidates."""
    ks = Ksysid(load_corpus(), SysidConfig(
        model_type="bilinear", obs_type=("poly",), obs_degree=(3,),
        dim_red=True, dtype="float32", lasso=(8.0, float("inf")),
        lasso_iters=300), device="cpu").train_models()
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        loaded = [jload(save_model(f"{d}/c{i}", cd, ks.scaler))
                  for i, cd in enumerate(ks.candidates)]
    jks = types.SimpleNamespace(candidates=[m for m, _ in loaded],
                                scaler=loaded[0][1],
                                basis=loaded[0][0].basis)
    return ks, jks


@functools.lru_cache(maxsize=None)
def jax_run():
    _, jks = trained()
    return jsweep(jks, JArm(JArmConfig(**SWEEP_ARM)),
                  JMpcConfig(**SWEEP_MPC), blockM_reference(), steps=STEPS)


@functools.lru_cache(maxsize=None)
def port_run(dtype=torch.float64):
    ks, _ = trained()
    return lasso_sweep_closed_loop(ks, Arm(ArmConfig(**SWEEP_ARM),
                                           device="cpu"),
                                   MpcConfig(**SWEEP_MPC),
                                   blockM_reference(), steps=STEPS,
                                   device="cpu", dtype=dtype)


def test_sweep_matches_jax_f64():
    got, ref = port_run(), jax_run()
    assert got["lasso"] == ref["lasso"] == [8.0, float("inf")]
    assert got["err"].shape == got["alive"].shape == (2, STEPS - 1)
    np.testing.assert_array_equal(got["alive"], np.asarray(ref["alive"]))
    assert got["alive"][:, -1].all()
    np.testing.assert_allclose(got["err"], np.asarray(ref["err"]), rtol=0,
                               atol=1e-5)


def test_sweep_f32_tracks_as_f64():
    """The f32 loop (the card's dtype) on the CPU: alive equal, each
    candidate's mean error within gate 2's 1e-3 of the f64 loop's."""
    got, ref = port_run(torch.float32), port_run()
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    assert np.abs(got["err"].mean(1) - ref["err"].mean(1)).max() < 1e-3


def test_sweep_qps_match_the_jax_pure_path():
    """One step's per-lane QPs (both candidates at the lifted start state
    with a nonzero u_prev and plan): the port's assembly, P, q and
    ``solve_qp`` against the JAX bilinear pure-path pieces on the same f64
    generators (``_bilin_assemble``, ``_factored_Pq``, ``_solve_qp_impl``
    with shared rows, a warm primal, cold duals)."""
    import jax

    from koopman_realizations_tpu.ops import qp as jqp
    from koopman_realizations_torch.ops.qp import solve_qp
    ks, _ = trained()
    mpc = BilinearKmpc(ks.candidates[0], ks.scaler, MpcConfig(**SWEEP_MPC),
                       device="cpu", dtype=torch.float64)
    gens = sweep_generators(mpc, ks.candidates, torch.float64, "cpu")
    C = len(ks.candidates)
    rng = np.random.default_rng(4)
    ysc = torch.from_numpy(rng.uniform(-0.5, 0.5, (6, C)))
    up = torch.from_numpy(rng.uniform(-0.3, 0.3, (3, C)))
    U_plan = torch.from_numpy(rng.uniform(-0.3, 0.3, (mpc.Np * 3, C)))
    ref = mpc.scaler.ref_down(blockM_reference()[:mpc.Np + 1],
                              mpc.proj_idx).reshape(-1)
    sqYr = torch.from_numpy(mpc.sqq * ref)
    z = mpc.lift(ysc)
    P, q, cons, b, iters, x0 = sweep_qp(mpc, gens, z, up, sqYr, U_plan)
    assert (cons.n, cons.mc, iters) == (27, 108, 12)
    sol = solve_qp(P, q, cons, b, iters, x0=x0)
    A = jnp.asarray(mpc.F_red)
    for c in range(C):
        W, v, bj = jqp._bilin_assemble(
            jnp.asarray(z[:, c].numpy()), jnp.asarray(up[:, c].numpy()),
            jnp.asarray(ref), *(jnp.asarray(gens[k][c].numpy())
                                for k in ("PGW", "PG0", "PAsq")),
            jnp.asarray(mpc.sqq), jnp.asarray(mpc.cF_red),
            jnp.asarray(mpc.F0_red))
        Pj, qj = jqp._factored_Pq(W, v, jnp.asarray(mpc.rdiag.numpy()))
        np.testing.assert_allclose(P[..., c].numpy(), np.asarray(Pj),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(q[:, c].numpy(), np.asarray(qj),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(b[:, c].numpy(), np.asarray(bj),
                                   rtol=1e-13, atol=1e-13)
        sj = jax.jit(jqp._solve_qp_impl, static_argnums=(4, 6))(
            Pj, qj, A, bj, iters, jnp.asarray(x0[:, c].numpy()), True)
        assert bool(sol.ok[c]) and bool(sj.ok)
        np.testing.assert_allclose(sol.x[:, c].numpy(), np.asarray(sj.x),
                                   rtol=0, atol=1e-9)


def test_sweep_refuses_what_is_not_ported():
    ks, _ = trained()
    arm = Arm(ArmConfig(**SWEEP_ARM), device="cpu")
    for cands in ([], [load_model(LINEAR_MODEL)[0]]):
        other = types.SimpleNamespace(candidates=cands, scaler=ks.scaler)
        with pytest.raises(NotImplementedError,
                           match="bilinear candidates"):
            lasso_sweep_closed_loop(other, arm, MpcConfig(**SWEEP_MPC),
                                    blockM_reference(), steps=3,
                                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lasso_sweep_closed_loop(ks, arm, MpcConfig(**SWEEP_MPC),
                                    blockM_reference(), steps=3)
