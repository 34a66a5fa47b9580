"""Host-side pieces of the port's linear controller against the JAX
package: the condensed constants of ``LinearKmpc``, its lift, and every
lane-shared operand of the fused linear step.

f64 host constants are held to 1e-12 (the port builds them with the same
numpy operations, so they agree to rounding) and must be equal after the
f32 cast.  The fused step's operands are f32 in both packages and must be
equal, except the lift-folded gradient generators G1z and G1m, which the
JAX package ships as bf16 hi/lo pairs for its 3-pass GEMMs: hi + lo
recovers a value to the split's own precision, |X - (hi + lo)| <=
2^-18 |X| (bf16 keeps 8 mantissa bits, twice) plus the f32 rounding of
the sum, so the bound is 2^-17 |X|.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koopman_realizations_tpu.ops.pallas.step_fused import (
    build_linear_step_fused as jax_build_linear_step_fused,
)

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import LinearKmpc
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.ops.kernels.linear_step_fused import (
    build_linear_step_fused,
)
from koopman_realizations_torch.utils.checkpoint import (
    LINEAR_MODEL,
    load_model,
)

from test_torch_oracle import BENCH_ARM, LINEAR_MPC, jax_bench
from test_torch_oracle import one_thread  # noqa: E402,F401  (fixture)

# one torch thread a test process: the xdist workers' pools would
# oversubscribe the machine
pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def both():
    model, scaler, _ = load_model(LINEAR_MODEL)
    port = LinearKmpc(model, scaler, MpcConfig(**LINEAR_MPC), device="cpu",
                      dtype=torch.float64)
    _, jmpc, jarm = jax_bench("linear")
    return port, jmpc, jarm


def test_linear_controller_host_constants_match_jax(both):
    port, jmpc, _ = both
    for name, jname in (("CA", "CA"), ("CB", "CB"), ("H", "H"), ("L", "L"),
                        ("Mc", "Mc"), ("c", "c"), ("F_red", "F_red"),
                        ("F0_red", "F0_red"), ("cF_red", "cF_red"),
                        ("Tb", "_Tb"), ("Sel", "_Sel"), ("q_diag", "q_diag"),
                        ("r_diag", "r_diag")):
        mine = np.asarray(getattr(port, name))
        ref = np.asarray(getattr(jmpc, jname))
        assert mine.shape == ref.shape, name
        np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-12,
                                   err_msg=name)
        np.testing.assert_array_equal(mine.astype(np.float32),
                                      ref.astype(np.float32), err_msg=name)
    assert port.band == jmpc._band == 3
    assert port.CB.shape == (22, 15) and port.H.shape == (15, 15)
    assert port.n_con == jmpc.n_con == 48
    # the device buffers hold the same constants
    np.testing.assert_array_equal(port.H_t.numpy(), port.H)
    np.testing.assert_array_equal(port.CA_t.numpy(), port.CA)


def test_linear_lift_matches_jax(both):
    """``LinearKmpc.lift`` (device tables, lanes-minor) against the JAX
    basis lift on random scaled outputs."""
    port, jmpc, _ = both
    zeta = np.random.default_rng(0).uniform(-1, 1, (5, 6))
    jz = np.asarray(jax.vmap(jmpc.model.basis.lift)(jnp.asarray(zeta)))
    z = port.lift(torch.from_numpy(zeta.T.copy())).numpy().T
    assert z.shape == jz.shape == (5, 28)
    np.testing.assert_allclose(z, jz, rtol=0, atol=1e-13)


def test_linear_fused_operands_match_jax(both):
    _, jmpc, jarm = both
    model, scaler, _ = load_model(LINEAR_MODEL)
    mpc32 = LinearKmpc(model, scaler, MpcConfig(**LINEAR_MPC), device="cpu")
    op = build_linear_step_fused(mpc32, Arm(ArmConfig(**BENCH_ARM),
                                            device="cpu"), scaler)
    step_fn, _, fYr_fn, meta = jax_build_linear_step_fused(
        jmpc, jarm, jmpc.scaler, tile=8, interpret=True)
    gen_args, lift_args, struct_args, cFr, F0r, A_eq, At, Pwarm = \
        inspect.getclosurevars(step_fn).nonlocals["operands"]
    Psh, G1zh, G1zl, G1b, P21 = gen_args
    G2 = inspect.getclosurevars(fYr_fn).nonlocals["G2j"]
    eq = lambda mine, ref, msg: np.testing.assert_array_equal(
        mine.numpy(), np.asarray(ref, np.float32), err_msg=msg)
    cons = op.cons
    eq(op.Psh, Psh, "Psh")
    eq(op.P21, P21, "P21")
    eq(op.G2, G2, "G2")
    eq(cons.A, A_eq, "A_eq")
    eq(cons.A.T, At, "At")
    eq(cons.Wd, struct_args[0], "Wd")
    eq(cons.Wo, struct_args[1], "Wo")
    eq(op.cFr, cFr, "cFr")
    eq(op.F0r, F0r, "F0r")
    eq(op.Pwarm, Pwarm, "Pwarm")
    nz = G1zh.shape[1]
    G1m_parts = [np.asarray(lift_args[4 * d], np.float32)
                 + np.asarray(lift_args[4 * d + 1], np.float32)
                 for d in range(len(lift_args) // 4)]
    split = np.concatenate([np.asarray(G1zh, np.float32)
                            + np.asarray(G1zl, np.float32)] + G1m_parts, 1)
    mine = op.G1[:, :split.shape[1]].numpy()
    assert split.shape == (12, nz + 77) and op.G1.shape == (12, 84)
    assert (np.abs(mine - split) <= 2.0 ** -17 * np.abs(mine) + 1e-30).all()
    eq(op.G1[:, nz + 77], np.asarray(G1b)[:, 0], "G1b")
    assert not op.G1[:, nz + 78:].any()
    assert meta["n"] == cons.n == 12 and meta["mc"] == cons.mc == 48
