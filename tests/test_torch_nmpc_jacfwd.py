"""The SQP NMPC's jacfwd route (dictionaries without an analytic poly
Jacobian: a fourier_sparser nonlinear model, and a bilinear model under
``mpc_type='nonlinear'``), ``make_kmpc``'s dispatch and the model in the
loop (``KoopmanPlant``, ``run_model_simulation``), against the JAX package
on the CPU in its x64 session.

Tolerances, each with what it was measured at:
- the stage Jacobians by ``torch.func.jacfwd`` under ``vmap`` in f64
  against ``jax.jacfwd`` of the JAX controller's F on the same f64
  arrays, and against the analytic poly Jacobian on the committed poly-3
  asset: 1e-10 (forward-mode through the same products; measured
  <= 4e-15);
- one controller solve against the JAX controller's (x64) on the same
  lanes: the plans within 1e-4 (5 SQP passes of 8 interior-point
  iterations; the JAX controller composes F in the model's f32 even in
  an x64 session, and the port's f64 controller is given the same
  f32-rounded maps here);
- the model in the loop at B=4 x 30 against the JAX general runner with
  the JAX ``KoopmanPlant``: tracked outputs and err_mean 1e-5, alive
  equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koopman_realizations_tpu.config import MpcConfig as JMpcConfig
from koopman_realizations_tpu.control import make_kmpc as jax_make_kmpc
from koopman_realizations_tpu.control import (
    run_model_simulation as jax_run_model_simulation,
)
from koopman_realizations_torch.config import MpcConfig
from koopman_realizations_torch.control.kmpc import (
    BilinearKmpc,
    LinearKmpc,
    NonlinearKmpc,
    make_kmpc,
)
from koopman_realizations_torch.control.ksim import run_model_simulation
from koopman_realizations_torch.utils.checkpoint import (
    BENCH_MODEL,
    NONLINEAR_MODEL,
    load_model,
)
from koopman_realizations_torch.utils.trajectories import blockM_reference

from test_torch_delays import port_sim
from test_torch_oracle import (
    DICT_PATHS,
    NMPC_MPC,
    blockM_y,
    dict_asset_path,
    jax_dict_lanes,
    jax_dict_model,
    jax_dict_run,
    lane_errors,
    nmpc_lanes,
    one_thread,  # noqa: F401  (fixture)
)

pytestmark = pytest.mark.usefixtures("one_thread")

JACFWD = ("nmpc-fs1", "nmpc-bilin")


def port_nmpc(path, dtype=torch.float64, round_maps=True):
    asset, _, knobs = DICT_PATHS[path]
    model, scaler, _ = load_model(dict_asset_path(asset))
    mpc = make_kmpc(model, scaler, MpcConfig(**knobs), device="cpu",
                    dtype=dtype)
    if round_maps and model.meta.model_type == "nonlinear":
        # the JAX controller's composed maps in the model's f32
        for name in ("fA1", "fA2", "fa0"):
            t = getattr(mpc, name)
            t.copy_(t.float().to(dtype))
    return mpc


def jax_nmpc_of(path, f64_model=False):
    asset, _, knobs = DICT_PATHS[path]
    model, scaler = jax_dict_model(asset)
    if f64_model:
        model = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), model)
    return jax_make_kmpc(model, scaler, JMpcConfig(**knobs))


def trajectory(mpc, B, seed):
    rng = np.random.default_rng(seed)
    Zl = rng.uniform(-0.8, 0.8, (mpc.Np, mpc.nz, B))
    Ul = rng.uniform(-0.6, 0.6, (mpc.Np * mpc.m, B))
    return Zl, Ul


@pytest.mark.parametrize("path", JACFWD)
def test_jacfwd_jacobians_match_jax(path):
    mpc = port_nmpc(path, round_maps=False)
    assert mpc.route == "jacfwd"
    jm = jax_nmpc_of(path, f64_model=True)
    Zl, Ul = trajectory(mpc, 3, 0)
    Jt = mpc.stage_jacobians(torch.from_numpy(Zl), torch.from_numpy(Ul))
    assert Jt.shape == (mpc.Np, mpc.nz + mpc.m, mpc.nz, 3)
    Z = jnp.asarray(Zl.transpose(0, 2, 1).reshape(-1, mpc.nz))
    U = jnp.asarray(Ul.reshape(mpc.Np, mpc.m, 3).transpose(0, 2, 1)
                    .reshape(-1, mpc.m))
    jz = jax.vmap(jax.jacfwd(jm.F_fn, argnums=0))(Z, U)
    ju = jax.vmap(jax.jacfwd(jm.F_fn, argnums=1))(Z, U)
    J = np.concatenate([np.asarray(jz), np.asarray(ju)], axis=2) \
        .reshape(mpc.Np, 3, mpc.nz, mpc.nz + mpc.m).transpose(0, 3, 2, 1)
    np.testing.assert_allclose(Jt.numpy(), J, rtol=0, atol=1e-10)
    # the dynamics values and defects of the same trajectory
    Fj = np.asarray(jax.vmap(jm.F_fn)(Z, U)).reshape(mpc.Np, 3, mpc.nz)
    _, cv = mpc.stage_lin(torch.from_numpy(Zl), torch.from_numpy(Ul))
    ur = Ul.reshape(mpc.Np, mpc.m, 3)
    cvj = Fj.transpose(0, 2, 1) - np.einsum("kiob,kib->kob", J[:, :mpc.nz],
                                            Zl) \
        - np.einsum("kiob,kib->kob", J[:, mpc.nz:], ur)
    np.testing.assert_allclose(cv.numpy(), cvj, rtol=0, atol=1e-10)


def test_jacfwd_matches_the_analytic_poly_jacobian():
    """On the committed poly-3 nonlinear asset the controller's analytic
    Jacobian and forward-mode AD of its own composed F agree."""
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    mpc = NonlinearKmpc(model, scaler, MpcConfig(**NMPC_MPC), device="cpu",
                        dtype=torch.float64)
    assert mpc.route == "multipass" and not mpc.jacfwd
    Zl, Ul = (torch.from_numpy(a) for a in trajectory(mpc, 4, 1))
    Ja = mpc.stage_lin(Zl, Ul)[0]
    Jf = NonlinearKmpc.stage_jacobians(mpc, Zl, Ul)
    np.testing.assert_allclose(Jf.numpy(), Ja.numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("path", JACFWD)
def test_jacfwd_solve_matches_jax(path):
    mpc = port_nmpc(path)
    jm = jax_nmpc_of(path)
    B = 4
    zeta, up, sq = nmpc_lanes(B, 7)
    Yr = sq.numpy() / mpc.sqq[:, None]
    refhor = Yr.T.reshape(B, mpc.Np + 1, mpc.nproj)
    U, sol = mpc.solve(zeta, up, sq)
    Uj, okj = jax.jit(jax.vmap(lambda z, u, r: jm.solve(z, u, r)))(
        jnp.asarray(zeta.numpy().T), jnp.asarray(up.numpy().T),
        jnp.asarray(refhor))
    Uj = np.asarray(Uj).reshape(B, -1).T
    assert bool(sol.ok.all()) and bool(np.asarray(okj).all())
    np.testing.assert_allclose(U.numpy(), Uj, rtol=0, atol=1e-4)


def test_make_kmpc_dispatches_as_the_reference():
    bm, bs, _ = load_model(BENCH_MODEL)
    nm, ns, _ = load_model(NONLINEAR_MODEL)
    lm, ls, _ = load_model(dict_asset_path("mix"))
    fm, fs, _ = load_model(dict_asset_path("nmpc-fs1"))
    cfg = MpcConfig(**NMPC_MPC)
    nl = dataclasses.replace(cfg, mpc_type="nonlinear")
    lin = dataclasses.replace(cfg, mpc_type="linear")
    assert isinstance(make_kmpc(lm, ls, cfg, device="cpu"), LinearKmpc)
    assert isinstance(make_kmpc(bm, bs, cfg, device="cpu"), BilinearKmpc)
    assert make_kmpc(bm, bs, nl, device="cpu").route == "jacfwd"
    assert make_kmpc(nm, ns, cfg, device="cpu").route == "multipass"
    assert make_kmpc(fm, fs, cfg, device="cpu").route == "jacfwd"
    # a nonlinear model takes the NMPC whatever mpc_type says (JAX
    # kmpc.py:1688-1689); a linear one has no NMPC
    assert isinstance(make_kmpc(nm, ns, lin, device="cpu"), NonlinearKmpc)
    with pytest.raises(ValueError, match="incompatible"):
        make_kmpc(lm, ls, nl, device="cpu")
    with pytest.raises(NotImplementedError, match="mpc_type='nonlinear'"):
        BilinearKmpc(bm, bs, nl, device="cpu")


def test_model_in_the_loop_matches_jax():
    """fs1-model: the port's general runner with ``KoopmanPlant`` against
    the JAX one from lifted 0.15 randn zetas, and ``run_model_simulation``
    from zeta 0 against JAX's."""
    B, steps, q = 4, 30, 8
    sim, mpc = port_sim("fs1-model", q)
    X0, W = jax_dict_lanes("fs1-model", B)
    out = sim.batched_runner(blockM_reference(), steps=steps)(X0, W)
    ej, aj, Ypj = jax_dict_run("fs1-model", q, B, steps)
    Yp = out["Yp"].numpy()
    np.testing.assert_allclose(Yp, Ypj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lane_errors(Yp, blockM_y(), steps), ej,
                               rtol=0, atol=1e-5)
    assert (out["alive"][:, -1].numpy() == aj).all()
    res = run_model_simulation(mpc, blockM_reference(), steps=steps,
                               device="cpu")
    model, scaler = jax_dict_model("fs1")
    jres = jax_run_model_simulation(
        jax_make_kmpc(model, scaler, JMpcConfig(
            **dict(DICT_PATHS["fs1-model"][2], qp_iters=q))),
        blockM_y(), steps=steps)
    np.testing.assert_allclose(res["Yp"][0].numpy(),
                               jres["Y"][:, list(mpc.proj_idx)], rtol=0,
                               atol=1e-5)
    assert bool(res["alive"].all()) == bool(np.asarray(jres["alive"]).all())
