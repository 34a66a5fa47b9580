"""Host-side pieces of the port against the JAX package: the blockM
reference, the poly tables, the scaler, and every host constant of the
blocked lift-fused controller and the fused step.

f64 host constants are held to 1e-12 (the port builds them with the same
numpy operations, so they agree to rounding); device operands, which both
packages keep in f32, must be equal after the cast.
"""

import inspect

import numpy as np
import pytest
import torch

from koopman_realizations_tpu.ops.observables import (
    poly_parent_tables as jax_tables,
)
from koopman_realizations_tpu.ops.pallas.step_fused import (
    build_step_fused as jax_build_step_fused,
)
from koopman_realizations_tpu.utils.trajectories import (
    get_blockM as jax_get_blockM,
    make_trajectory as jax_make_trajectory,
)

from koopman_realizations_torch.config import MpcConfig
from koopman_realizations_torch.control.kmpc import BilinearKmpc
from koopman_realizations_torch.ops.kernels.step_fused import pwarm_matrix
from koopman_realizations_torch.ops.observables import poly_parent_tables
from koopman_realizations_torch.utils.checkpoint import load_model
from koopman_realizations_torch.utils.trajectories import (
    blockM_reference,
    get_blockM,
    make_trajectory,
)

from test_torch_oracle import BENCH_MPC, jax_bench


@pytest.fixture(scope="module")
def both():
    model, scaler, _ = load_model()
    port = BilinearKmpc(model, scaler, MpcConfig(**BENCH_MPC), device="cpu")
    sim, jmpc, jarm = jax_bench()
    return port, jmpc, sim, jarm


def test_blockM_trajectory_matches_jax():
    args = ([0.45, -0.35], 0.5, 0.5)
    np.testing.assert_allclose(get_blockM(*args), jax_get_blockM(*args),
                               rtol=0, atol=1e-15)
    ref = make_trajectory(get_blockM(*args), T=15, Ts=0.05)["y"]
    jref = jax_make_trajectory(jax_get_blockM(*args), T=15, Ts=0.05)["y"]
    assert ref.shape == (301, 2)
    np.testing.assert_allclose(ref, jref, rtol=0, atol=1e-15)
    np.testing.assert_array_equal(blockM_reference(), ref)


@pytest.mark.parametrize("nz,degree", [(6, 3), (4, 2), (3, 4)])
def test_poly_parent_tables_equal(nz, degree):
    blocks, tables = poly_parent_tables(nz, degree)
    jblocks, jtabs = jax_tables(nz, degree)
    assert len(tables) == len(jtabs) == degree - 1
    for b, jb in zip(blocks, jblocks):
        np.testing.assert_array_equal(b, jb)
    for (p, d), (jp, jd) in zip(tables, jtabs):
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(d, jd)


def test_scaler_round_trips():
    _, scaler, _ = load_model()
    rng = np.random.default_rng(0)
    y = rng.normal(size=(5, 6))
    u = rng.normal(size=(5, 3))
    np.testing.assert_allclose(scaler.y_up(scaler.y_down(y)), y, atol=1e-14)
    np.testing.assert_allclose(scaler.u_up(scaler.u_down(u)), u, atol=1e-14)
    yt = torch.from_numpy(y.T.copy())
    np.testing.assert_allclose(scaler.y_down(yt, axis=0).numpy().T,
                               scaler.y_down(y), atol=1e-15)
    r = scaler.ref_down(y[:, 4:], (4, 5))
    np.testing.assert_allclose(scaler.ref_up(r, (4, 5)), y[:, 4:],
                               atol=1e-14)


def test_controller_host_constants_match_jax(both):
    port, jmpc, _, _ = both
    for name, jname in (("F_red", "F_red"), ("cF_red", "cF_red"),
                        ("F0_red", "F0_red"), ("Tb", "_Tb"),
                        ("Sel", "_Sel"), ("q_diag", "q_diag"),
                        ("r_diag", "r_diag")):
        np.testing.assert_allclose(getattr(port, name),
                                   np.asarray(getattr(jmpc, jname)),
                                   rtol=0, atol=1e-12, err_msg=name)
    assert port.band == jmpc._band == 3
    assert port.F_red.shape == (48, 12)
    # no reduced row lost every coefficient (equilibration invariant)
    assert (np.abs(np.concatenate([port.F_red, port.F0_red], 1))
            .max(1) > 0).all()
    assert port.lift_tables is not None
    for (p, d), (jp, jd) in zip(port.lift_tables, jmpc._lift_tables):
        assert tuple(p) == tuple(jp) and tuple(d) == tuple(jd)
    for k, jv in jmpc._lift_gens.items():
        jv = np.asarray(jv)
        assert jv.dtype == np.float32
        np.testing.assert_array_equal(
            np.asarray(port.lift_gens[k]).astype(np.float32).reshape(
                jv.shape), jv, err_msg=k)
    np.testing.assert_array_equal(
        port.RdT.astype(np.float32), np.asarray(jmpc.consts()["RdT"]))


def test_step_operands_match_jax(both):
    port, jmpc, sim, jarm = both
    step_fn, _, _ = jax_build_step_fused(jmpc, jarm, jmpc.scaler, tile=8,
                                         interpret=True)
    ops = inspect.getclosurevars(step_fn).nonlocals["operands"]
    (_, _, struct, cFr, F0r, A_eq, At, Pwarm, rdiag) = ops
    eq = lambda a, b, msg: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b), err_msg=msg)
    eq(port.A.numpy(), A_eq, "A_eq")
    eq(port.A.numpy().T, At, "At")
    eq(port.cFr.numpy(), cFr, "cFr")
    eq(port.F0r.numpy(), F0r, "F0r")
    eq(port.rdiag.numpy(), np.asarray(rdiag)[0], "RdT")
    eq(port.Wd.numpy(), struct[0], "Wd")
    eq(port.Wo.numpy(), struct[1], "Wo")
    eq(pwarm_matrix(port.Sel, port.Tb, port.Np, port.m).astype(np.float32),
       Pwarm, "Pwarm")
    sq_jax = np.sqrt(np.asarray(jmpc.Qd, np.float32))
    np.testing.assert_allclose(port.sqq.astype(np.float32), sq_jax,
                               rtol=1e-7)
    np.testing.assert_allclose(port.sqq, np.sqrt(np.asarray(jmpc.Qd)),
                               rtol=1e-15)
