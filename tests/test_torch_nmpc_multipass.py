"""The port's plain NMPC math (``ops/nmpc.py``) and the
``nmpc_multipass`` kernel module's plain path against the JAX package.

(a) The pieces in f64 -- F, the stage Jacobians, the defects, the
    condensed W/v -- against the JAX functions on the same inputs:
    ``_compose_nonlinear_F`` and ``_compose_poly_jacobian`` of the model
    with W in f64 (the JAX controller casts the composed maps to the
    model's f32), ``_nmpc_condense_assemble``.  Same math, other operation
    orders: 1e-12.
(b) The whole SQP in f64 against an oracle composed from those exact JAX
    pieces with ``_factored_Pq`` and ``solve_qp``'s pure path, fed the
    port's own operands: 1e-9 on x and the multipliers, equal ok masks.
(c) Against ``_nmpc_multipass_pure``, the JAX package's own fallback, with
    its own operands: its Jacobian generator is a bf16 hi/lo split
    (~2^-16 relative) and its dynamics and QP constants f32, so the two
    differ by what that rounding moves through five passes: measured
    5.7e-6 on x here; bound 1e-4.
(d) f32 against f64, as for the other kernels: the port's f32 plain
    version may be at most twice as far from the f64 solution as the TPU
    kernel in interpret mode (``solve_qp_nmpc_multipass_batched``), plus
    1e-5, and the ok masks must be equal (measured 1.0e-6 against the
    TPU kernel's 7.7e-6).

Lanes: scaled outputs of random arm states, random previous inputs inside
the bounds, blockM reference windows of different steps per lane.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koopman_realizations_tpu.control.kmpc import (
    _compose_nonlinear_F,
    _compose_poly_jacobian,
)
from koopman_realizations_tpu.ops.pallas.qp_ipm import (
    solve_qp_nmpc_multipass_batched,
)
from koopman_realizations_tpu.ops.qp import (
    _factored_Pq,
    _nmpc_condense_assemble,
    _nmpc_multipass_pure,
    solve_qp,
)

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import NonlinearKmpc
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.ops import nmpc as N
from koopman_realizations_torch.ops.kernels.nmpc_multipass import (
    nmpc_multipass,
    nmpc_multipass_cuda,
    solve_qp_nmpc_multipass,
)
from koopman_realizations_torch.utils.checkpoint import (
    NONLINEAR_MODEL,
    load_model,
)
from koopman_realizations_torch.utils.trajectories import blockM_reference

from test_torch_oracle import BENCH_ARM, NMPC_MPC, jax_bench
from test_torch_oracle import one_thread  # noqa: E402,F401  (fixture)

# one torch thread a test process: the xdist workers' pools would
# oversubscribe the machine
pytestmark = pytest.mark.usefixtures("one_thread")

B = 12


@pytest.fixture(scope="module")
def setup():
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    mpcs = {dt: NonlinearKmpc(model, scaler, MpcConfig(**NMPC_MPC),
                              device="cpu", dtype=dt)
            for dt in (torch.float64, torch.float32)}
    arm = Arm(ArmConfig(**BENCH_ARM), device="cpu")
    rng = np.random.default_rng(7)
    X = np.zeros((6, B))
    X[:3] = rng.uniform(-0.4, 0.4, (3, B))
    X[3:] = rng.normal(0, 0.3, (3, B))
    zeta = scaler.y_down(arm.get_y(torch.from_numpy(X)), axis=0)
    up = torch.from_numpy(rng.uniform(-0.6, 0.6, (3, B)))
    wins = Ksim(arm, mpcs[torch.float64], device="cpu").reference_windows(
        blockM_reference(), 300)
    sq = wins[torch.from_numpy(rng.integers(0, 299, B))].T.contiguous()
    _, jmpc, _ = jax_bench("nonlinear")
    return mpcs, jmpc, zeta.double(), up, sq


def _jax_model64(jmpc):
    return dataclasses.replace(
        jmpc.model, W=jnp.asarray(np.asarray(jmpc.model.W, np.float64)))


def test_F_jacobian_defects_match_jax_f64(setup):
    mpcs, jmpc, zeta, up, _ = setup
    qp = mpcs[torch.float64].nmpc_qp()
    jm = _jax_model64(jmpc)
    F_fn, J_fn = _compose_nonlinear_F(jm), _compose_poly_jacobian(jm)
    zn, un = zeta.numpy().T, up.numpy().T
    jF = np.asarray(jax.vmap(F_fn)(zn, un))
    jJ = np.asarray(jax.vmap(J_fn)(zn, un))              # (B, nz, nza)
    F = N.eval_F(qp, zeta, up)
    J = N.stage_jacobian(qp, zeta, up)                  # [i, o, b]
    np.testing.assert_allclose(F.numpy().T, jF, rtol=0, atol=1e-12)
    np.testing.assert_allclose(J.permute(2, 1, 0).numpy(), jJ, rtol=0,
                               atol=1e-12)
    jcv = jF - np.einsum("bij,bj->bi", jJ[..., :6], zn) \
        - np.einsum("bij,bj->bi", jJ[..., 6:], un)
    np.testing.assert_allclose(N.defects(F, J, zeta, up).numpy().T,
                               jcv, rtol=0, atol=1e-12)
    assert J.shape == (9, 6, B)


@pytest.mark.parametrize("hold", [True, False])
def test_condensation_matches_jax_f64(setup, hold):
    """W and v of one pass (held or rolled linearization) against
    ``_nmpc_condense_assemble`` on the same Jacobians and defects."""
    mpcs, jmpc, zeta, up, sq = setup
    mpc = mpcs[torch.float64]
    qp = mpc.nmpc_qp()
    xp = qp.Gup @ up + 0.05
    Ul = torch.cat([up] + [xp[c - 3:c] for c in qp.cols[1:]])
    Jt, cv = N.stage_linearization(qp, "hold" if hold else "roll", zeta, up,
                                   Ul=Ul)
    W, v = N.condense(qp, Jt, cv, zeta, up, sq)
    jz = Jt[:, :6].transpose(1, 2).numpy()              # (Np, o, i, B)
    ju = Jt[:, 6:].transpose(1, 2).numpy()
    jW, jv = jax.vmap(
        lambda jz, ju, c, z, u, r: _nmpc_condense_assemble(
            jz, ju, c, z, u, mpc.sqq, r, mpc.Cz, mpc.cols, 3),
        in_axes=(3, 3, 2, 1, 1, 1))(jz, ju, cv.numpy(), zeta.numpy(),
                                    up.numpy(), sq.numpy())
    np.testing.assert_allclose(W.permute(2, 0, 1).numpy(), np.asarray(jW),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(v.T.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-12)
    assert W.shape == (22, 12, B)


def _oracle(mpc, jm, zeta, up, sqRef, passes, hold0, iters):
    """The whole SQP of one lane from exact JAX pieces (f64)."""
    F_fn, J_fn = _compose_nonlinear_F(jm), _compose_poly_jacobian(jm)
    m, Np, cols = mpc.m, mpc.Np, mpc.cols

    def lane(z0, u0, r):
        xp = jnp.asarray(mpc.Gup) @ u0
        b = jnp.asarray(mpc.cF_red) - jnp.asarray(mpc.F0_red) @ u0
        sol = None
        for p in range(passes):
            Ul = jnp.stack([u0] + [xp[c - m:c] for c in cols[1:]])
            if p == 0 and hold0:
                Zl = jnp.tile(z0[None], (Np, 1))
                Fv = jnp.tile(F_fn(z0, u0)[None], (Np, 1))
            else:
                zs, fs, z = [], [], z0
                for k in range(Np):
                    zs.append(z)
                    z = F_fn(z, Ul[k])
                    fs.append(z)
                Zl, Fv = jnp.stack(zs), jnp.stack(fs)
            J = jax.vmap(J_fn)(Zl, Ul)
            jz, ju = J[..., :mpc.nz], J[..., mpc.nz:]
            cv = Fv - jnp.einsum("kij,kj->ki", jz, Zl) \
                - jnp.einsum("kij,kj->ki", ju, Ul)
            W, v = _nmpc_condense_assemble(jz, ju, cv, z0, u0, mpc.sqq, r,
                                           mpc.Cz, cols, m)
            P, q = _factored_Pq(W, v, jnp.asarray(mpc.rdiag),
                                jnp.asarray(mpc.q0c) * xp)
            sol = solve_qp(P, q, jnp.asarray(mpc.F_red), b, iters=iters,
                           x0=xp, shared_A=True, backend="jax")
            xp = sol.x
        return sol.x, sol.lam, sol.ok

    return [np.asarray(a) for a in jax.jit(jax.vmap(lane))(
        zeta.numpy().T, up.numpy().T, sqRef.numpy().T)]


@pytest.mark.parametrize("init,per_lane", [("hold", True), ("hold", False),
                                           ("rollout", True)])
def test_f64_multipass_matches_composed_jax_oracle(setup, init, per_lane):
    mpcs, jmpc, zeta, up, sq = setup
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    mpc = NonlinearKmpc(model, scaler, MpcConfig(**NMPC_MPC, sqp_init=init),
                        device="cpu", dtype=torch.float64)
    sqRef = sq if per_lane else sq[:, 3].contiguous()
    sol = solve_qp_nmpc_multipass(mpc.nmpc_qp(), zeta, up, sqRef, 5,
                                  mpc.hold0, 8)
    jx, jlam, jok = _oracle(mpc, _jax_model64(jmpc), zeta, up,
                            sq if per_lane else sq[:, 3:4].expand(-1, B),
                            5, mpc.hold0, 8)
    np.testing.assert_array_equal(sol.ok.numpy(), jok)
    assert jok.all()
    np.testing.assert_allclose(sol.x.numpy().T, jx, rtol=0, atol=1e-9)
    np.testing.assert_allclose(sol.lam.numpy().T, jlam, rtol=0,
                               atol=1e-9 * max(1.0, np.abs(jlam).max()))


def _jax_operands(jmpc):
    rho = jmpc.cfg.sqp_damping
    return dict(rdiag=jmpc._RdTj + rho * jmpc._bsizes,
                q0c=-2.0 * rho * np.asarray(jmpc._bsizes),
                Gup=np.tile(np.eye(3, dtype=np.float32), (4, 1)),
                sq=np.sqrt(jmpc.q_diag))


def test_f64_multipass_near_jax_pure_fallback_with_split_operands(setup):
    """``_nmpc_multipass_pure`` with the JAX controller's own operands
    (bf16-split G, f32 dynamics and constants): the bound is the split's,
    see (c) of the module doc."""
    mpcs, jmpc, zeta, up, sq = setup
    o = _jax_operands(jmpc)
    x, _, ok = mpcs[torch.float64].solve(zeta, up, sq)[1][:3]

    def lane(z, u, r):
        sol = _nmpc_multipass_pure(
            z, u, o["sq"], r, jmpc.Cz, o["rdiag"], jmpc._Azj, jmpc._cFzj,
            jmpc._F0j, jmpc._cols, jmpc._stage_ops, jmpc._jlayout,
            jmpc._roll_ops, jmpc._flayout, o["Gup"], o["q0c"], 5, True, 8)
        return sol.x, sol.ok

    jx, jok = jax.jit(jax.vmap(lane))(zeta.numpy().T, up.numpy().T,
                                      sq.numpy().T)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    d = np.abs(x.numpy().T - np.asarray(jx)).max()
    print(f"max |dx| against the split fallback: {d:.3e}")
    assert 1e-9 < d < 1e-4, d


def test_f32_no_worse_than_the_tpu_kernel_interpret(setup):
    mpcs, jmpc, zeta, up, sq = setup
    o = _jax_operands(jmpc)
    x64 = mpcs[torch.float64].solve(zeta, up, sq)[1].x
    sol32 = mpcs[torch.float32].solve(zeta.float(), up.float(), sq.float())[1]
    kx, _, kok, _ = solve_qp_nmpc_multipass_batched(
        zeta.numpy().T, up.numpy().T, o["sq"], sq.numpy().T, jmpc.Cz,
        o["rdiag"], jmpc._Azj, jmpc._cFzj, jmpc._F0j, jmpc._stage_ops,
        jmpc._roll_ops, o["Gup"], o["q0c"], Np=10, nz=6, nstate=6, nproj=2,
        cols=jmpc._cols, jlayout=jmpc._jlayout, flayout=jmpc._flayout,
        n_passes=5, hold0=True, iters=8, interpret=True, tile=8, band=3)
    np.testing.assert_array_equal(sol32.ok.numpy(), np.asarray(kok))
    e_port = (sol32.x.double() - x64).abs().max().item()
    e_tpu = np.abs(np.asarray(kx, np.float64).T - x64.numpy()).max()
    print(f"max |dx| against f64: port f32 {e_port:.3e}, TPU kernel "
          f"(interpret) {e_tpu:.3e}")
    assert e_port <= 2 * e_tpu + 1e-5, (e_port, e_tpu)


def test_dispatcher_and_epilogue(setup):
    """CPU tensors take the plain version (no launch is counted); the
    epilogue turns non-finite x to NaN and fails the lane (an infinite
    previous input makes the plan infinite), and returns the multipliers
    in original units."""
    mpcs, _, zeta, up, sq = setup
    mpc = mpcs[torch.float64]
    qp = mpc.nmpc_qp()
    before = nmpc_multipass_cuda.launches
    x, s, lam, obj = nmpc_multipass(qp, zeta, up, sq, 5, True, 8)
    assert nmpc_multipass_cuda.launches == before
    ubad = up.clone()
    ubad[0, 1] = float("inf")
    sol = solve_qp_nmpc_multipass(qp, zeta, ubad, sq, 5, True, 8)
    assert torch.isnan(sol.x[:, 1]).all() and not sol.ok[1]
    keep = torch.arange(B) != 1
    torch.testing.assert_close(sol.x[:, keep], x[:, keep], rtol=0, atol=0)
    torch.testing.assert_close(sol.lam[:, keep],
                               (lam * obj / qp.row[:, None])[:, keep],
                               rtol=0, atol=0)
    assert sol.ok[keep].all()
