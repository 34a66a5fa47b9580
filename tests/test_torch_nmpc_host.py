"""Host-side pieces of the port's SQP NMPC controller against the JAX
package: the composed maps of F, the analytic Jacobian's generator, the
controller's constants and the lane-shared operands the JAX controller
ships to its multipass kernel.

f64 host constants are held to 1e-12 (the port builds them with the same
numpy operations) and must be equal after the f32 cast.  The JAX
controller pins some of them to f32 even in an x64 session
(``kmpc.py:1190-1200``, ``:1381-1388``); those are held as f32 values.
The JAX Jacobian generator ships as bf16 hi/lo pairs: hi + lo recovers it
to |X - (hi + lo)| <= 2^-17 |X| (see ``test_torch_linear_host.py``).
"""

import numpy as np
import pytest
import torch

from koopman_realizations_tpu.control.kmpc import (
    _composed_maps,
    _poly_jacobian_static,
)
from koopman_realizations_tpu.ops.qp import build_stage_roll_ops

from koopman_realizations_torch.config import MpcConfig
from koopman_realizations_torch.control.kmpc import (
    NonlinearKmpc,
    composed_maps,
    poly_jacobian_static,
)
from koopman_realizations_torch.ops.kernels.nmpc_multipass import (
    nmpc_config,
)
from koopman_realizations_torch.ops.nmpc import eval_F, stage_jacobian
from koopman_realizations_torch.utils.checkpoint import (
    NONLINEAR_MODEL,
    load_model,
)

from test_torch_oracle import NMPC_MPC, jax_bench
from test_torch_oracle import one_thread  # noqa: E402,F401  (fixture)

# one torch thread a test process: the xdist workers' pools would
# oversubscribe the machine
pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def both():
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    port = NonlinearKmpc(model, scaler, MpcConfig(**NMPC_MPC), device="cpu",
                         dtype=torch.float64)
    _, jmpc, _ = jax_bench("nonlinear")
    return port, jmpc


def _same(mine, ref, name, atol=1e-12):
    mine, ref = np.asarray(mine), np.asarray(ref)
    assert mine.shape == ref.shape, name
    np.testing.assert_allclose(mine, ref, rtol=0, atol=atol, err_msg=name)
    np.testing.assert_array_equal(mine.astype(np.float32),
                                  ref.astype(np.float32), err_msg=name)


def test_nonlinear_asset_loads_identically_in_both_packages(both):
    port, jmpc = both
    tm, jm = port.model, jmpc.model
    np.testing.assert_array_equal(tm.W, np.asarray(jm.W))
    np.testing.assert_array_equal(tm.C, np.asarray(jm.C))
    np.testing.assert_array_equal(tm.basis.pcs, np.asarray(jm.basis.pcs))
    assert tm.W.shape == (129, 6) and tm.basis.pcs.shape == (220, 119)
    assert tm.basis.nzeta_aug == jm.basis.nzeta_aug == 9
    assert tm.meta.model_type == "nonlinear"
    header = load_model(NONLINEAR_MODEL)[2]["jax_reference"]
    assert header["alive"] == 1.0
    assert header["controller"] == "qp_iters=8 qp_dual_warm=False sqp_iters=5"


def test_composed_maps_and_jacobian_statics_match_jax(both):
    port, jmpc = both
    for mine, ref, name in zip(composed_maps(port.model),
                               _composed_maps(jmpc.model),
                               ("A1", "A2", "a0")):
        _same(mine, ref, name)
    A1, G, blocks, tables, pos_x = poly_jacobian_static(port.model)
    jA1, jG, jblocks, jtables, jpos_x = _poly_jacobian_static(jmpc.model)
    _same(A1, jA1, "A1")
    _same(G, jG, "G")
    assert G.shape == (54, 54) and np.count_nonzero(G) == 2916
    np.testing.assert_array_equal(pos_x, jpos_x)
    for (p, d), (jp, jd) in zip(tables, jtables):
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(d, jd)
    assert [b.shape for b in blocks] == [np.asarray(b).shape for b in jblocks]


def test_nonlinear_controller_host_constants_match_jax(both):
    port, jmpc = both
    for name, jname in (("F_red", "F_red"), ("F0_red", "F0_red"),
                        ("cF_red", "cF_red"), ("Tb", "_Tb"), ("Sel", "_Sel"),
                        ("q_diag", "q_diag"), ("r_diag", "r_diag"),
                        ("Cz", "Cz")):
        _same(getattr(port, name), getattr(jmpc, jname), name)
    assert port.cols == jmpc._cols == (0, 3, 6, 9, 9, 12, 12, 12, 12, 12)
    assert port.band == jmpc._band == 3 and port.n_con == 48
    assert port.nz == jmpc.nz == 6
    # the constants the JAX controller pins to f32 (kmpc.py:1190-1200)
    for name, jname in (("F_red", "_Azj"), ("F0_red", "_F0j"),
                        ("cF_red", "_cFzj"), ("Tb", "_Tbj"),
                        ("Sel", "_Selj"), ("RdT", "_RdTj"),
                        ("bsizes", "_bsizes")):
        ref = np.asarray(getattr(jmpc, jname))
        assert ref.dtype == np.float32, jname
        np.testing.assert_array_equal(
            np.asarray(getattr(port, name)).astype(np.float32), ref,
            err_msg=name)
    # and the multipass route's (kmpc.py:1377-1388), formed as there
    rho = jmpc.cfg.sqp_damping
    np.testing.assert_array_equal(port.rdiag.astype(np.float32),
                                  np.asarray(jmpc._RdTj + rho * jmpc._bsizes))
    np.testing.assert_array_equal(
        port.q0c.astype(np.float32),
        -2.0 * rho * np.asarray(jmpc._bsizes))
    np.testing.assert_array_equal(
        port.Gup, np.tile(np.eye(3, dtype=np.float32), (4, 1)))
    assert port.hold0 and jmpc.cfg.sqp_init == "hold"


def test_device_operands_match_the_jax_kernel_operands(both):
    """The port's single f32 arrays against what the JAX controller ships
    to ``_nmpc_multipass_kernel``: the roll generators (A1 split per x
    section, a0, A2 per degree block) equal after the f32 cast; the
    Jacobian generator to the bf16 split's precision."""
    port, jmpc = both
    model32, scaler, _ = load_model(NONLINEAR_MODEL)
    qp = NonlinearKmpc(model32, scaler, MpcConfig(**NMPC_MPC),
                       device="cpu").nmpc_qp()
    roll, flayout = jmpc._roll_ops, jmpc._flayout
    assert flayout == (45, 165) and jmpc._jlayout == (45,)
    eq = lambda mine, ref, msg: np.testing.assert_array_equal(
        mine.numpy(), np.asarray(ref, np.float32), err_msg=msg)
    eq(qp.A1[:, :6], roll[0], "A1z")
    eq(qp.A1[:, 6:], roll[1], "A1u")
    eq(qp.a0, np.asarray(roll[2])[:, 0], "a0")
    eq(qp.A2[:, :45], roll[7], "A2 degree 2")
    eq(qp.A2[:, 45:], roll[11], "A2 degree 3")
    jac = jmpc._stage_ops
    eq(qp.G.new_tensor(port.A1.T.reshape(-1)), np.asarray(jac[0])[:, 0],
       "A1c")
    split = lambda hi, lo: (np.asarray(hi, np.float32)
                            + np.asarray(lo, np.float32))
    ref = np.concatenate([split(jac[1], jac[2]), split(jac[3], jac[4]),
                          split(jac[9], jac[10])], axis=1)
    mine = qp.G[:, :54].numpy()
    assert qp.G.shape == (54, 56) and not qp.G[:, 54:].any()
    assert (np.abs(mine - ref) <= 2.0 ** -17 * np.abs(mine) + 1e-30).all()
    # the f64 generator in the layout of build_stage_jac_ops (ops/qp.py:
    # 719-725: rows perm[i*nz + o] = o*nza + i, x columns at pos_x)
    A1, G, _, tables, pos_x = _poly_jacobian_static(jmpc.model)
    perm = [o * 9 + i for i in range(9) for o in range(6)]
    np.testing.assert_allclose(
        port.nmpc_qp().G[:, :54].numpy(),
        np.concatenate([G[perm][:, pos_x], G[perm][:, 9:]], axis=1),
        rtol=0, atol=1e-12)
    roll64, _ = build_stage_roll_ops(*_composed_maps(jmpc.model), tables, 6,
                                     9)
    eq(qp.A2[:, :45], roll64[7], "A2 degree 2 (statics)")
    cfg = nmpc_config(qp)
    assert "#define KN_NLOW 54" in cfg and "#define KN_NMONO 210" in cfg
    assert "#define KN_COLS {0, 3, 6, 9, 9, 12, 12, 12, 12, 12}" in cfg


def test_config_recurrence_reproduces_the_monomials(both):
    """The straight-line statements of the kernel configuration (g_low's
    blocks, the top-degree terms) evaluated here reproduce the plain
    g_low and F on random inputs."""
    port, _ = both
    qp = port.nmpc_qp()
    cfg = nmpc_config(qp)
    glow = cfg.split("#define KN_GLOW(g) do { ")[1].split(" } while")[0]
    top = cfg.split("#define KN_F_TOP(g, T) do { ")[1].split(" } while")[0]
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, 9)
    g = np.zeros(qp.G.shape[1])
    g[:9] = x
    run = lambda stmts, env: exec("\n".join(
        t.strip() for t in stmts.split(";") if t.strip()), env)
    run(glow, {"g": g})
    terms = []
    run(top, {"g": g, "T": lambda t, c: terms.append((c, t))})
    A2 = qp.A2.numpy()
    Fm = qp.A1.numpy() @ x + A2[:, :45] @ g[9:54] + qp.a0.numpy() + sum(
        A2[:, c] * t for c, t in terms)
    xt = torch.from_numpy(x[:, None])
    Fp = eval_F(qp, xt[:6], xt[6:])[:, 0].numpy()
    np.testing.assert_allclose(Fm, Fp, rtol=0, atol=1e-12)
    Jp = stage_jacobian(qp, xt[:6], xt[6:])[..., 0].numpy()    # [i, o]
    Jc = qp.G.numpy() @ g                               # rows (i, o)
    J = port.A1.T + Jc.reshape(9, 6)
    np.testing.assert_allclose(J, Jp, rtol=0, atol=1e-12)
    assert len(terms) == 165 and sorted(c for c, _ in terms) == list(
        range(45, 210))
