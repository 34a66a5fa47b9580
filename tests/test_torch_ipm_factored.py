"""``ipm_factored_plain`` (and the ``solve_qp_factored`` wrapper) against
the JAX factored interior point in its three builds -- blocked n=12,
mc=48, band 3 (the re-rolled pass of iterated relinearization); unblocked
n=27, mc=108, band 3; unblocked with smoothness rows n=27, mc=156, dense
A^T D A -- cold and warm, on the W and v the port's controller
assembles.

(a) f64: against the JAX pure path (``_factored_Pq`` ->
    ``_solve_qp_impl``, x64) on the same f64 operands: 1e-10.
(b) f32: against the Pallas kernel in interpret mode
    (``solve_qp_factored_batched``, f32 throughout, the dense mode through
    its (n*n, mc) outer-product table), two f32 orderings of the same
    solve, both stated against the f64 solution.  The ok masks must be
    equal; the port's median per-lane error at most twice the TPU
    kernel's plus 1e-6 (measured 1e-7..3.4e-6 against 1e-7..4.1e-6); its
    worst lane within 1e-3, the single-lane f32 conditioning of 8-12
    unconverged iterations that both orderings show (measured: the
    port's 1.6e-4 against the TPU kernel's 2.6e-5 in the dense warm case,
    the TPU kernel's 1.0e-3 against the port's 5.4e-4 in the unblocked
    cold case); the multipliers within twice the TPU kernel's error plus
    1e-5 of their scale.
(c) The dense A^T D A of the kernels from each row's nonzeros
    (``row_nonzeros``: at most 3 a row) against the plain dense form.

The unblocked closed loops are in test_torch_bilinear_closed_loop.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koopman_realizations_tpu.ops.pallas.qp_ipm import (
    solve_qp_factored_batched,
)
from koopman_realizations_tpu.ops.qp import _factored_Pq, _solve_qp_impl

from koopman_realizations_torch.config import MpcConfig
from koopman_realizations_torch.control.kmpc import BilinearKmpc
from koopman_realizations_torch.ops.kernels.ipm_factored import (
    solve_qp_factored,
)
from koopman_realizations_torch.ops.qp import form_AtDA, row_nonzeros
from koopman_realizations_torch.utils.checkpoint import load_model

from test_torch_oracle import (
    BENCH_MPC,
    BILINEAR_ROUTES,
    bilinear_lanes,
    one_thread,  # noqa: F401  (the fixture of pytestmark)
)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def ports():
    model, scaler, _ = load_model()
    return {(name, dt): BilinearKmpc(
        model, scaler, MpcConfig(**{**BENCH_MPC, **knobs}), device="cpu",
        dtype=dt)
        for name, knobs in BILINEAR_ROUTES.items()
        for dt in (torch.float32, torch.float64)}


def _qp(ports, name, B, seed):
    """The controller's factored QP on test lanes, in f64: W (p, n, B),
    v, b (original units), x0 and lam0 -- for ``iters2`` the re-rolled
    second pass's."""
    m64 = ports[name, torch.float64]
    z, up, U, lam, _, sqYr = bilinear_lanes(m64, B, seed)
    betas = m64.roll(z, U)[1] if m64.blocked else None
    W, v = m64.factored_data(z, up, sqYr, betas)
    b = m64.cF_t[:, None] - m64.F0_t @ up
    return W, v, b, m64.warm_start(U), lam


def _port(ports, name, dtype, qp, warm):
    mpc = ports[name, dtype]
    W, v, b, x0, lam = (t.to(dtype) for t in qp)
    sol = solve_qp_factored(W, v, mpc.rdiag, mpc.constraints(), b, x0=x0,
                            lam0=lam if warm else None,
                            iters=mpc.cfg.qp_iters)
    return sol.x.numpy().T, sol.lam.numpy().T, sol.ok.numpy()


CASES = [(name, warm) for name in BILINEAR_ROUTES for warm in (False, True)]


@pytest.mark.parametrize("name,warm", CASES)
def test_f64_matches_jax_pure_path(ports, name, warm):
    m64 = ports[name, torch.float64]
    qp = _qp(ports, name, 16, seed=5 + warm)
    x, lam, ok = _port(ports, name, torch.float64, qp, warm)
    A = m64.F_red

    def one(W, v, b, x0, lam0):
        P, q = _factored_Pq(W, v, m64.rdiag.numpy())
        return _solve_qp_impl(P, q, A, b, m64.cfg.qp_iters, x0, True,
                              lam0 if warm else None)

    W, v, b, x0, l0 = qp
    sol = jax.vmap(one)(jnp.asarray(W.permute(2, 0, 1).numpy()),
                        *(jnp.asarray(t.T.numpy()) for t in (v, b, x0, l0)))
    assert ok.all() and (ok == np.asarray(sol.ok)).all()
    np.testing.assert_allclose(x, np.asarray(sol.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(lam, np.asarray(sol.lam), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("name,warm", CASES)
def test_f32_matches_tpu_kernel_interpret(ports, name, warm):
    m64 = ports[name, torch.float64]
    B = 13 if warm else 16
    qp = _qp(ports, name, B, seed=9 + warm)
    x64, lam64, _ = _port(ports, name, torch.float64, qp, warm)
    x, lam, ok = _port(ports, name, torch.float32, qp, warm)
    W, v, b, x0, l0 = qp
    f = lambda a: jnp.asarray(np.asarray(a), jnp.float32)
    jx, jlam, jok, _ = solve_qp_factored_batched(
        f(W.permute(2, 0, 1)), f(v.T), f(m64.rdiag), f(m64.F_red), f(b.T),
        x0=f(x0.T), iters=m64.cfg.qp_iters, interpret=True, tile=8,
        band=m64.band, lam0=f(l0.T) if warm else None)
    jx, jlam, jok = np.asarray(jx), np.asarray(jlam), np.asarray(jok)
    assert x.shape == jx.shape == (B, m64.A.shape[1])
    assert ok.all() and (ok == jok).all()
    e_port = np.abs(x - x64).max(1)
    e_tpu = np.abs(jx - x64).max(1)
    assert np.median(e_port) <= 2.0 * np.median(e_tpu) + 1e-6, \
        (e_port, e_tpu)
    assert e_port.max() <= 1e-3, (e_port, e_tpu)
    lam_scale = np.abs(lam64).max()
    assert np.abs(lam - lam64).max() <= \
        2.0 * np.abs(jlam - lam64).max() + 1e-5 * lam_scale


def test_dense_AtDA_from_row_nonzeros(ports):
    """The dense A^T D A the kernels form -- for each row its at most
    three nonzeros (``Constraints.cols``, values in ``Wd``), adding
    D_c a_c a_c^T to the lower triangle -- equals the plain dense
    einsum."""
    mpc = ports["unblocked_smooth", torch.float64]
    cons = mpc.constraints()
    assert cons.band is None and len(cons.cols) == cons.mc
    cols, vals = row_nonzeros(cons.A.numpy())
    assert cols == cons.cols
    np.testing.assert_array_equal(vals, cons.Wd.numpy())
    D = np.exp(np.random.default_rng(0).normal(0, 3, (cons.mc, 5)))
    M = np.zeros((cons.n, cons.n, 5))
    for c, row in enumerate(cols):
        for k, i in enumerate(row):
            for l, j in enumerate(row[:k + 1]):
                if i >= 0 and j >= 0:
                    M[i, j] += D[c] * vals[c, k] * vals[c, l]
    M = np.tril(M.transpose(2, 0, 1)).transpose(1, 2, 0)
    ref = form_AtDA(cons, torch.from_numpy(D)).numpy()
    np.testing.assert_allclose(M, np.tril(ref.transpose(2, 0, 1))
                               .transpose(1, 2, 0), rtol=1e-13, atol=0)
