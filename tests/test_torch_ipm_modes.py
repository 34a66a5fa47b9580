"""The last three modes of the TPU kernel table against the JAX package:
``ipm_factored``'s additive q0, ``ipm_shared``'s per-lane Hessian (and the
shared-A entry ``ops/qp.py:solve_qp`` that routes to it) and the batched
SPD solve ``batch_chol``, each through its plain version.

(a) q0, on the 'linear' SQP update's QPs (n=12, mc=48, band 3; W and v of
    the explicit condensation at a plan's rollout, q0 = -2 rho Tb^T U):
    f64 against the JAX ``solve_qp_factored(..., backend='jax', q0=)``,
    1e-10 on x and on the multipliers relative to their scale; f32
    against ``solve_qp_factored_batched(..., q0=, interpret=True)``, two
    f32 orderings of the same solve held against the f64 one: equal ok
    masks, the port's median per-lane error at most twice the TPU
    kernel's plus 1e-6, its worst lane within 1e-3.  Cold and warm duals.
(b) Per-lane P, on the dense P = 2 (W^T W + diag r), q = 2 W^T v of the
    bilinear routes' QPs (banded: ``iters2``, n=12, mc=48; dense A^T D A:
    ``unblocked_smooth``, n=27, mc=156): f64 against the JAX pure path the
    routed solver takes unbatched (``_solve_qp_impl`` with shared A),
    1e-10 as (a) (measured 2.5e-13 on x, 1.7e-9 on multipliers of scale
    58 in the dense cold case); f32 against
    ``solve_qp_shared_batched(shared_P=False, interpret=True)`` with B
    not a multiple of the tile, as (a).  Cold and warm duals.  The entry
    ``solve_qp`` gives a 2-D P the lane-shared mode and a per-lane P this
    one; the two agree on a broadcast P.
(c) ``solve_spd`` against ``solve_spd_pallas(interpret=True)`` at the JAX
    tests' shapes (n=27, B=64, f32; n=8, B=256, f64): the plain version
    repeats the TPU kernel's operation order, so f64 agrees to 1e-12 and
    f32 to a few f32 ulps of the solution.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koopman_realizations_tpu.ops.pallas.batch_chol import solve_spd_pallas
from koopman_realizations_tpu.ops.pallas.qp_ipm import (
    solve_qp_factored_batched,
    solve_qp_shared_batched,
)
from koopman_realizations_tpu.ops.qp import (
    _solve_qp_impl,
    solve_qp_factored as jax_solve_qp_factored,
)

from koopman_realizations_torch.config import MpcConfig
from koopman_realizations_torch.control.kmpc import (
    BilinearKmpc,
    NonlinearKmpc,
)
from koopman_realizations_torch.ops import nmpc as N
from koopman_realizations_torch.ops.kernels import batch_chol as BC
from koopman_realizations_torch.ops.kernels import ipm_shared as IS
from koopman_realizations_torch.ops.kernels.ipm_factored import (
    ipm_factored,
    ipm_factored_cuda,
    solve_qp_factored,
)
from koopman_realizations_torch.ops.qp import solve_qp
from koopman_realizations_torch.utils.checkpoint import (
    NONLINEAR_MODEL,
    load_model,
)

from test_torch_oracle import (
    BENCH_MPC,
    BILINEAR_ROUTES,
    NMPC_MPC,
    bilinear_lanes,
    nmpc_lanes,
    one_thread,  # noqa: F401  (the fixture of pytestmark)
)

pytestmark = pytest.mark.usefixtures("one_thread")

RHO = 0.05
f32 = lambda a: jnp.asarray(np.asarray(a), jnp.float32)


def _hold_f32(x, x64, jx, ok, jok):
    """Equal all-true ok masks; the port's f32 per-lane error against the
    f64 solution, median within twice the TPU kernel's plus 1e-6, worst
    lane within 1e-3."""
    assert ok.all() and (ok == jok).all()
    e_port = np.abs(x - x64).max(1)
    e_tpu = np.abs(jx - x64).max(1)
    assert np.median(e_port) <= 2.0 * np.median(e_tpu) + 1e-6, \
        (e_port, e_tpu)
    assert e_port.max() <= 1e-3, (e_port, e_tpu)


# ------------------------------------------------------------ (a) q0


@pytest.fixture(scope="module")
def linear_qps():
    """The 'linear' update's factored QP (f64) on 13 test lanes: W and v
    of the explicit condensation along a plan's rollout, b in original
    units, x0 = Sel U, q0 = -2 rho Tb^T U and the plan's multipliers."""
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    mpc = NonlinearKmpc(model, scaler,
                        MpcConfig(**NMPC_MPC, sqp_update="linear"),
                        device="cpu", dtype=torch.float64)
    zeta, up, sq = nmpc_lanes(13, 4)
    U, sol = mpc.solve(zeta, up, sq)
    qp = mpc.nmpc_qp(mpc.RdT_t + RHO * mpc.bsizes_t)
    Z = N.rollout(qp, zeta, U)
    Jt, cv = N.stage_lin(qp, Z[:-1], U, Fv=Z[1:])
    W, v = N.condense(qp, Jt, cv, zeta, up, sq)
    b = mpc.cF_t[:, None] - mpc.F0_t @ up
    return mpc, qp.rdiag, (W, v, b, mpc.Sel_t @ U[3:],
                           -2.0 * RHO * (mpc.Tb_t.T @ U[3:]), sol.lam)


@pytest.mark.parametrize("warm", [False, True])
def test_q0_f64_matches_jax_solve_qp_factored(linear_qps, warm):
    mpc, rd, (W, v, b, x0, q0, lam) = linear_qps
    sol = solve_qp_factored(W, v, rd, mpc.constraints(), b, x0=x0,
                            lam0=lam if warm else None, iters=8, q0=q0)

    def one(W_, v_, b_, x0_, q0_, lam_):
        s = jax_solve_qp_factored(W_, v_, rd.numpy(), mpc.F_red, b_,
                                  iters=8, x0=x0_, backend="jax",
                                  band_offset=mpc.band,
                                  lam0=lam_ if warm else None, q0=q0_)
        return s.x, s.lam, s.ok

    jx, jlam, jok = (np.asarray(a) for a in jax.vmap(one)(
        W.permute(2, 0, 1).numpy(),
        *(t.T.numpy() for t in (v, b, x0, q0, lam))))
    assert jok.all() and (sol.ok.numpy() == jok).all()
    np.testing.assert_allclose(sol.x.numpy().T, jx, rtol=0, atol=1e-10)
    np.testing.assert_allclose(sol.lam.numpy().T, jlam, rtol=0,
                               atol=1e-10 * max(1.0, np.abs(jlam).max()))


@pytest.mark.parametrize("warm", [False, True])
def test_q0_f32_matches_tpu_kernel_interpret(linear_qps, warm):
    mpc, rd, (W, v, b, x0, q0, lam) = linear_qps
    lam0 = lam if warm else None
    x64 = solve_qp_factored(W, v, rd, mpc.constraints(), b, x0=x0,
                            lam0=lam0, iters=8, q0=q0).x.numpy().T
    cons = mpc.constraints()
    c32 = cons._replace(**{k: getattr(cons, k).float()
                           for k in ("A", "row", "Wd", "Wo")})
    sol = solve_qp_factored(*(t.float() for t in (W, v, rd)), c32,
                            b.float(), x0=x0.float(),
                            lam0=None if lam0 is None else lam0.float(),
                            iters=8, q0=q0.float())
    jx, _, jok, _ = solve_qp_factored_batched(
        f32(W.permute(2, 0, 1)), f32(v.T), f32(rd), f32(mpc.F_red),
        f32(b.T), x0=f32(x0.T), iters=8, interpret=True, tile=8,
        band=mpc.band, lam0=None if lam0 is None else f32(lam0.T),
        q0=f32(q0.T))
    _hold_f32(sol.x.numpy().T, x64, np.asarray(jx), sol.ok.numpy(),
              np.asarray(jok))


def test_q0_dispatch_and_kernel_refuses_cpu(linear_qps):
    """CPU tensors take the plain version (no launch counted), where q0
    enters as 2 W^T v + q0 before the objective scale: a q0 of zeros is
    no q0.  The kernel's wrapper refuses CPU tensors."""
    mpc, rd, (W, v, b, x0, q0, _) = linear_qps
    cons = mpc.constraints()
    b_eq = b / cons.row[:, None]
    args = (cons, rd, W, v, b_eq, x0, None, 8, 1e-2)
    before = ipm_factored_cuda.launches
    for a, c in zip(ipm_factored(*args), ipm_factored(*args,
                                                      torch.zeros_like(q0))):
        assert torch.equal(a, c)
    assert ipm_factored_cuda.launches == before
    with pytest.raises(ValueError):
        ipm_factored_cuda(*args, q0)


# ------------------------------------------------------- (b) per-lane P


@pytest.fixture(scope="module")
def route_qps():
    """Dense per-lane QPs of the bilinear routes, f64: (mpc, P (n, n, B),
    q, b, x0, lam) with P = 2 (W^T W + diag r), q = 2 W^T v."""
    model, scaler, _ = load_model()
    out = {}
    for name, B, seed in (("iters2", 13, 2), ("unblocked_smooth", 11, 3)):
        mpc = BilinearKmpc(model, scaler,
                           MpcConfig(**{**BENCH_MPC,
                                        **BILINEAR_ROUTES[name]}),
                           device="cpu", dtype=torch.float64)
        z, up, U, lam, _, sqYr = bilinear_lanes(mpc, B, seed)
        betas = mpc.roll(z, U)[1] if mpc.blocked else None
        W, v = mpc.factored_data(z, up, sqYr, betas)
        P = 2.0 * (torch.einsum("rib,rjb->ijb", W, W)
                   + torch.diag(mpc.rdiag)[..., None])
        q = 2.0 * torch.einsum("rib,rb->ib", W, v)
        b = mpc.cF_t[:, None] - mpc.F0_t @ up
        out[name] = (mpc, P, q, b, mpc.warm_start(U), lam)
    return out


LANE_P = [(name, warm) for name in ("iters2", "unblocked_smooth")
          for warm in (False, True)]


@pytest.mark.parametrize("name,warm", LANE_P)
def test_lane_p_f64_matches_jax_pure_path(route_qps, name, warm):
    mpc, P, q, b, x0, lam = route_qps[name]
    iters = mpc.cfg.qp_iters
    sol = solve_qp(P, q, mpc.constraints(), b, iters=iters, x0=x0,
                   lam0=lam if warm else None)

    def one(P_, q_, b_, x0_, lam_):
        return _solve_qp_impl(P_, q_, mpc.F_red, b_, iters, x0_, True,
                              lam_ if warm else None)

    js = jax.vmap(one)(P.permute(2, 0, 1).numpy(),
                       *(t.T.numpy() for t in (q, b, x0, lam)))
    jok = np.asarray(js.ok)
    assert jok.all() and (sol.ok.numpy() == jok).all()
    np.testing.assert_allclose(sol.x.numpy().T, np.asarray(js.x), rtol=0,
                               atol=1e-10)
    jlam = np.asarray(js.lam)
    np.testing.assert_allclose(sol.lam.numpy().T, jlam, rtol=0,
                               atol=1e-10 * max(1.0, np.abs(jlam).max()))


@pytest.mark.parametrize("name,warm", LANE_P)
def test_lane_p_f32_matches_tpu_kernel_interpret(route_qps, name, warm):
    mpc, P, q, b, x0, lam = route_qps[name]
    iters = mpc.cfg.qp_iters
    lam0 = lam if warm else None
    x64 = solve_qp(P, q, mpc.constraints(), b, iters=iters, x0=x0,
                   lam0=lam0).x.numpy().T
    cons = mpc.constraints()
    c32 = cons._replace(**{k: getattr(cons, k).float()
                           for k in ("A", "row", "Wd", "Wo")})
    sol = solve_qp(P.float(), q.float(), c32, b.float(), iters=iters,
                   x0=x0.float(), lam0=None if lam0 is None else lam0.float())
    jx, _, jok, _ = solve_qp_shared_batched(
        f32(P.permute(2, 0, 1)), f32(q.T), f32(mpc.F_red), f32(b.T),
        x0=f32(x0.T), iters=iters, interpret=True, tile=8, band=mpc.band,
        lam0=None if lam0 is None else f32(lam0.T), shared_P=False)
    _hold_f32(sol.x.numpy().T, x64, np.asarray(jx), sol.ok.numpy(),
              np.asarray(jok))


def test_solve_qp_routes_by_the_hessian(route_qps, monkeypatch):
    """``solve_qp`` hands a 2-D P to the lane-shared mode and a per-lane P
    to the per-lane mode of ``ipm_shared``; on a P broadcast over the
    lanes both give the same solve, with cold duals and with warm ones
    (the lane-shared mode's warm-dual build, JAX ``LinearKmpc`` with
    ``qp_dual_warm``)."""
    mpc, P, q, b, x0, lam = route_qps["iters2"]
    P0 = P[..., 0].contiguous()
    modes = []
    real = IS.ipm_shared

    def spy(cons, Psh, *a):
        modes.append(Psh.ndim)
        return real(cons, Psh, *a)

    monkeypatch.setattr(IS, "ipm_shared", spy)
    cons = mpc.constraints()
    shared = solve_qp(P0, q, cons, b, iters=4, x0=x0)
    lane = solve_qp(P0[..., None].expand(P.shape).contiguous(), q, cons, b,
                    iters=4, x0=x0)
    assert modes == [2, 3]
    for a, c in zip(shared, lane):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-12)
    shared = solve_qp(P0, q, cons, b, iters=4, x0=x0, lam0=lam)
    lane = solve_qp(P0[..., None].expand(P.shape).contiguous(), q, cons, b,
                    iters=4, x0=x0, lam0=lam)
    assert modes == [2, 3, 2, 3]
    for a, c in zip(shared, lane):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-12)


def test_lane_p_kernel_refuses_cpu_and_bad_shapes(route_qps):
    mpc, P, q, b, x0, _ = route_qps["iters2"]
    cons = mpc.constraints()
    iobj = 1.0 / P.abs().amax((0, 1))
    with pytest.raises(ValueError):
        IS.ipm_shared_cuda(cons, P, q, b[:48], x0, 4, 1e-2, iobj)


# --------------------------------------------------------- (c) batch_chol


def _spd_batch(rng, B, n):
    G = rng.standard_normal((B, n, n))
    return G @ np.swapaxes(G, 1, 2) + n * np.eye(n)


@pytest.mark.parametrize("B,n,dtype", [(64, 27, np.float32),
                                       (256, 8, np.float64)])
def test_solve_spd_matches_tpu_kernel_interpret(B, n, dtype):
    rng = np.random.default_rng(n)
    M = _spd_batch(rng, B, n).astype(dtype)
    b = rng.standard_normal((B, n)).astype(dtype)
    before = BC.solve_spd_cuda.launches
    x = BC.solve_spd(torch.from_numpy(M), torch.from_numpy(b)).numpy()
    assert BC.solve_spd_cuda.launches == before and x.dtype == dtype
    jx = np.asarray(solve_spd_pallas(jnp.asarray(M), jnp.asarray(b),
                                     interpret=True))
    ref = np.stack([np.linalg.solve(Mi.astype(np.float64), bi)
                    for Mi, bi in zip(M, b)])
    if dtype == np.float64:
        np.testing.assert_allclose(x, jx, rtol=0, atol=1e-12)
        np.testing.assert_allclose(x, ref, rtol=0, atol=1e-12)
    else:
        scale = np.abs(ref).max()
        assert np.abs(x - jx).max() <= 8 * np.finfo(np.float32).eps * scale
        assert np.abs(x - ref).max() <= 2 * np.abs(jx - ref).max() + 1e-7


def test_solve_spd_refuses_bad_shapes_and_cpu_kernel():
    M = torch.eye(4).expand(3, 4, 4).contiguous()
    with pytest.raises(ValueError):
        BC.solve_spd(M, torch.ones(3, 5))
    with pytest.raises(ValueError):
        BC.solve_spd_cuda(M, torch.ones(3, 4))
