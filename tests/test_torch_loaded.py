"""The port's loaded pipeline against the JAX package on the CPU: the
loaded lifts, the loaded rollouts, loaded training on the committed
loaded corpus (``assets/arm2_loaded_corpus.npz``), the loaded assets in
both packages' checkpoint formats, the loaded bilinear and linear
controllers on their routes and the general closed loop with the load
observer on the circle reference (the experiment of
``tests/test_loaded.py``; data written by
``python tests/test_torch_oracle.py --write-loaded``).

Tolerances, each with what it was measured at:
- ``lift_loaded`` / ``lift_loaded_input`` in f64: 1e-12 (the same
  products; measured 0);
- the loaded rollouts in f64 (linear, bilinear, nonlinear): 1e-10
  relative to the trajectory's scale;
- loaded training against the JAX-trained assets in scaled one-step
  prediction: 1.2e-7 (bilinear; measured 2.5e-14), or for the linear
  model twice what a one-ulp change of the f32 extraction matrix
  L = Px A^T + u B^T moves the asset's own extraction, if that is more
  (the minimum-norm second solve of ``get_model`` amplifies L's last bit:
  ~5e-7..1e-6 on this corpus; the port's L sums in another order,
  measured 3.1e-7);
- the short f64 closed loop (B=4 x 30 steps) against the JAX general
  runner (x64): err_mean and What 1e-5.  The JAX bilinear controller
  casts its assembly generators, input cost and constraint right-hand
  side to the model's f32 even in an x64 session (``kmpc.py:544-552,
  815-861``; ROADMAP "Parity notes"), which moves What by 2.3e-5 over 30
  steps through the observer's box QP; the port's f64 controller is given
  the same f32-rounded constants here (What then within 1.3e-6, err_mean
  within 1.4e-9, measured).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koopman_realizations_tpu.models import koopman as JK
from koopman_realizations_tpu.ops.observables import (
    KoopmanBasis as JKoopmanBasis,
)
from koopman_realizations_tpu.utils.checkpoint import (
    load_model as jax_load_model,
)
from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.config import SysidConfig
from koopman_realizations_torch.control.kmpc import (
    BilinearKmpc,
    LinearKmpc,
    NonlinearKmpc,
)
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.control.observer import make_load_observer
from koopman_realizations_torch.models import koopman as TK
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.models.edmd import Ksysid
from koopman_realizations_torch.ops.observables import KoopmanBasis
from koopman_realizations_torch.utils.checkpoint import (
    LOADED_BILINEAR_MODEL,
    LOADED_LINEAR_MODEL,
    load_model,
    save_model,
)
from koopman_realizations_torch.utils.data import LOADED_CORPUS, load_corpus
from koopman_realizations_torch.utils.metrics import one_step_predictions
from koopman_realizations_torch.utils.trajectories import circle_reference

from test_torch_oracle import (
    LOADED,
    LOADED_ASSETS,
    circle_y,
    jax_loaded_run,
    jax_loaded_sim,
    loaded_lanes,
    one_thread,  # noqa: F401  (fixture)
)

pytestmark = pytest.mark.usefixtures("one_thread")

PATHS = {"bilinear": LOADED_BILINEAR_MODEL, "linear": LOADED_LINEAR_MODEL}
CONTROLLERS = {"bilinear": BilinearKmpc, "linear": LinearKmpc}


def mpc_cfg(**kw) -> MpcConfig:
    return MpcConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in {**LOADED["mpc"], **kw}.items()})


@functools.lru_cache(maxsize=None)
def trained(kind):
    """The port's loaded training on the committed loaded corpus, on the
    CPU."""
    return Ksysid(load_corpus(LOADED_CORPUS),
                  SysidConfig(model_type=kind, **LOADED["sysid"]),
                  device="cpu").train_models()


def test_committed_data_is_the_recipes():
    """The loaded assets are the JAX trainer's on this corpus, and the
    corpus carries each trial's load (the 16-load grid, constant a
    trial)."""
    assert LOADED_ASSETS == {"bilinear": LOADED_BILINEAR_MODEL,
                             "linear": LOADED_LINEAR_MODEL}
    ds = load_corpus(LOADED_CORPUS)
    assert (len(ds.train), len(ds.val)) == (15, 1)
    loads = np.stack([tr.w[0] for tr in ds.train + ds.val])
    np.testing.assert_array_equal(loads, np.asarray(LOADED["corpus"]["loads"]))
    for tr in ds.train:
        assert tr.w.shape == (tr.y.shape[0], 2) and (tr.w == tr.w[0]).all()
    np.testing.assert_array_equal(circle_reference(), circle_y())
    assert circle_reference().shape == (301, 2)


@pytest.mark.parametrize("lift", ["lift_loaded", "lift_loaded_input"])
def test_loaded_lifts_match_jax(lift):
    """Both loaded lifts of the bilinear asset's basis (PCA, nw=2) on
    seeded lanes, f64: 1e-12."""
    model, _, _ = load_model(LOADED_BILINEAR_MODEL)
    b = model.basis
    jb = JKoopmanBasis(model_type=b.model_type, n=b.n, m=b.m, nd=b.nd,
                       nw=b.nw, families=b.families, pcs=b.pcs)
    rng = np.random.default_rng(0)
    B = 6
    zeta = rng.uniform(-1, 1, (B, b.nzeta))
    w = rng.uniform(-1, 1, (B, b.nw))
    u = rng.uniform(-1, 1, (B, b.m))
    t = lambda a: torch.from_numpy(a.T.copy())
    if lift == "lift_loaded":
        port = b.lift_loaded(t(zeta), t(w))
        ref = jax.vmap(jb.lift_loaded)(zeta, w)
        assert port.shape == (b.N_loaded, B) and b.N_loaded == 42
    else:
        port = b.lift_loaded_input(t(zeta), t(w), t(u))
        ref = jax.vmap(jb.lift_loaded_input)(zeta, w, u)
        assert port.shape == (b.N_loaded * (b.m + 1), B)
    np.testing.assert_allclose(port.T.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


def _nonlinear_loaded():
    """A seeded loaded nonlinear model (poly-2 on [zeta; u], no PCA): W
    small enough that 20 steps stay bounded."""
    rng = np.random.default_rng(1)
    n, m, nw = 4, 2, 2
    tb = KoopmanBasis(model_type="nonlinear", n=n, m=m, nd=0, nw=nw,
                      families=(("poly", 2),))
    NL = tb.N * (nw + 1)
    W = 0.05 * rng.standard_normal((NL, n))
    W[:n] += 0.9 * np.eye(n)
    meta = TK.ModelMeta("nonlinear", "discrete", n, m, 0, nw, tb.N, n, 0.05)
    jb = JKoopmanBasis(model_type="nonlinear", n=n, m=m, nd=0, nw=nw,
                       families=(("poly", 2),))
    port = TK.NonlinearModel(W=W, C=np.eye(n), meta=meta, basis=tb)
    jm = JK.NonlinearModel(W=jnp.asarray(W), C=jnp.eye(n), K=None,
                           meta=JK.ModelMeta(**dataclasses.asdict(meta)),
                           basis=jb)
    return port, jm


@pytest.mark.parametrize("kind", ["linear", "bilinear", "nonlinear"])
def test_loaded_rollouts_match_jax(kind):
    """The loaded rollout (the lifted state re-mixed with each step's
    load) of each model type, f64, 20 steps of seeded inputs and a load
    that changes halfway: 1e-10 of the trajectory's scale."""
    rng = np.random.default_rng(2)
    T = 20
    if kind == "nonlinear":
        port, jm = _nonlinear_loaded()
        init = rng.uniform(-0.5, 0.5, port.meta.nzeta)
    else:
        port, _, _ = load_model(PATHS[kind])
        jm, _ = jax_load_model(str(PATHS[kind]))
        cast = lambda a: np.asarray(a, np.float64)
        port = dataclasses.replace(port, A=cast(port.A), B=cast(port.B),
                                   C=cast(port.C))
        jm = dataclasses.replace(jm, A=jnp.asarray(cast(jm.A)),
                                 B=jnp.asarray(cast(jm.B)),
                                 C=jnp.asarray(cast(jm.C)))
        zeta0 = rng.uniform(-0.5, 0.5, port.meta.nzeta)
        init = None
    U = rng.uniform(-0.5, 0.5, (T, port.meta.m))
    W = np.repeat(rng.uniform(-1, 1, (2, port.meta.nw)), T // 2, axis=0)
    if init is None:
        init = np.array(jm.basis.lift_loaded(jnp.asarray(zeta0),
                                             jnp.asarray(W[0])))
    Yj, Zj = JK.rollout(jm, jnp.asarray(init), jnp.asarray(U),
                        jnp.asarray(W))
    Yp, Zp = TK.rollout(port, torch.from_numpy(init), torch.from_numpy(U),
                        torch.from_numpy(W))
    scale = max(1.0, float(np.abs(np.asarray(Zj)).max()))
    assert np.isfinite(np.asarray(Zj)).all()
    np.testing.assert_allclose(Zp.numpy(), np.asarray(Zj), rtol=0,
                               atol=1e-10 * scale)
    np.testing.assert_allclose(Yp.numpy(), np.asarray(Yj), rtol=0,
                               atol=1e-10 * scale)
    with pytest.raises(ValueError, match="loads"):
        TK.rollout(port, torch.from_numpy(init), torch.from_numpy(U))


@pytest.mark.parametrize("kind", ["bilinear", "linear"])
def test_loaded_training_matches_the_jax_assets(kind):
    """``Ksysid(..., loaded=True)`` on the committed loaded corpus against
    the JAX-trained asset: NL = 42 (N = 14, nw = 2), the load scaler
    carried, scaled one-step predictions within 1.2e-7 (the linear model:
    within twice its extraction's one-ulp floor where that is more,
    ``chip_smoke.one_ulp_floor``), and
    the open-loop validation bounded (``tests/test_loaded.py:47-55``)."""
    ks = trained(kind)
    asset, scaler, _ = load_model(PATHS[kind])
    assert (ks.N, ks.NL, ks.nw) == (14, 42, 2)
    assert ks.model.meta == asset.meta
    for f in ("w_factor", "w_offset", "y_factor", "u_offset"):
        np.testing.assert_array_equal(getattr(ks.scaler, f),
                                      getattr(scaler, f))
    d = np.abs(one_step_predictions(ks.model, ks.valdata, "cpu")
               - one_step_predictions(asset, ks.valdata, "cpu")).max()
    bound = 1.2e-7
    if kind == "linear":
        import chip_smoke
        bound = max(bound, 2.0 * chip_smoke.one_ulp_floor(ks, asset))
    assert d <= bound, (d, bound)
    res = ks.validate()[0]
    assert np.isfinite(res["sim"]["y"]).all()
    assert float(res["error"]["euclid_mean"]) < 0.6 if kind == "bilinear" \
        else float(res["error"]["euclid_mean"]) < 1.0


@pytest.mark.parametrize("kind", ["bilinear", "linear"])
def test_loaded_checkpoints_in_both_packages(kind, tmp_path):
    """The port's loaded model written by its ``save_model`` reads back in
    both packages with nw and the load scaler; the JAX asset reads in the
    port likewise."""
    ks = trained(kind)
    path = save_model(tmp_path / kind, ks.model, ks.scaler)
    tm, ts, _ = load_model(path)
    jm, js = jax_load_model(path)
    for m in (tm, jm):
        assert m.meta.nw == 2 and m.basis.nw == 2
        np.testing.assert_array_equal(np.asarray(m.A), ks.model.A)
    for s in (ts, js):
        np.testing.assert_array_equal(np.asarray(s.w_factor),
                                      ks.scaler.w_factor)
        np.testing.assert_array_equal(np.asarray(s.w_offset),
                                      ks.scaler.w_offset)
    am, asc, _ = load_model(PATHS[kind])
    jam, jasc = jax_load_model(str(PATHS[kind]))
    assert am.meta.NL == jam.meta.NL == 42
    np.testing.assert_array_equal(asc.w_factor, np.asarray(jasc.w_factor))


def test_loaded_controllers_take_their_routes():
    """The loaded bilinear controller leaves the lift-fused route (its
    lifted state carries the load estimate) for ``bilin``'s: NL=42, m=2,
    n=8, mc=32, p=22; the loaded linear one keeps ``ipm_shared``'s
    lane-shared QP at n=8, mc=32.  The lift takes the estimate."""
    cfg = mpc_cfg()
    bm, bs, _ = load_model(LOADED_BILINEAR_MODEL)
    lm, ls, _ = load_model(LOADED_LINEAR_MODEL)
    b = BilinearKmpc(bm, bs, cfg, device="cpu")
    assert not b.lift_fused and not b.wants_zeta
    q = b.bilin_qp()
    assert (q.nzl, q.m, q.n, q.mc, q.p) == (42, 2, 8, 32, 22)
    lin = LinearKmpc(lm, ls, cfg, device="cpu")
    assert (lin.constraints().n, lin.constraints().mc) == (8, 32)
    zeta = torch.zeros((4, 3))
    what = torch.tensor([[0.5, 0.0, -1.0], [0.25, 1.0, 0.0]])
    z = b.lift(zeta, what)
    assert z.shape == (42, 3)
    torch.testing.assert_close(z[14:28], what[0] * z[:14], rtol=0, atol=0)
    torch.testing.assert_close(z[28:], what[1] * z[:14], rtol=0, atol=0)
    with pytest.raises(ValueError):
        b.lift(zeta)


def test_nmpc_and_delays_with_loads_are_refused():
    """As in the JAX package the NMPC refuses loaded models; delays with
    loads are accepted everywhere (trainer, controllers, observer; the
    loaded delayed pipeline is held to JAX in
    ``test_torch_loaded_delays.py``)."""
    lm, ls, _ = load_model(LOADED_LINEAR_MODEL)
    delayed = dataclasses.replace(lm, meta=dataclasses.replace(lm.meta,
                                                               nd=1))
    assert LinearKmpc(delayed, ls, mpc_cfg(), device="cpu").meta.nd == 1
    # a whole horizon of delay-embedded rows before the first update
    obs = make_load_observer(delayed, mpc_cfg(load_obs_period=1),
                             device="cpu")
    assert obs.nd == 1 and not obs.updates(obs.horizon + 1)
    assert obs.updates(obs.horizon + 2)
    nl = dataclasses.replace(lm, meta=dataclasses.replace(
        lm.meta, model_type="nonlinear"))
    with pytest.raises(NotImplementedError, match="loaded"):
        NonlinearKmpc(nl, ls, mpc_cfg(sqp_iters=2), device="cpu")
    ds = load_corpus(LOADED_CORPUS)
    ks = Ksysid(ds, SysidConfig(model_type="linear", obs_degree=(2,),
                                loaded=True, delays=1), device="cpu")
    assert (ks.nd, ks.nw, ks.nzeta) == (1, 2, 10)


LOOPS = [("bilinear", True), ("bilinear", False), ("linear", True)]


@pytest.mark.parametrize("kind,observer", LOOPS)
def test_short_loaded_loop_matches_live_jax(kind, observer):
    """The port's f64 general runner against the JAX general runner (x64)
    on the loaded assets, the circle and the experiment's first 4 lanes
    (3 loads), 30 steps (the observer updates at k = 12, 14, ..., 28):
    every step's tracked outputs, err_mean and What within 1e-5; What in
    [-1, 1], the linear observer's last component exactly 0, every lane
    alive; the loaded controllers are not fused-eligible."""
    B, steps = 4, 30
    X0, W = loaded_lanes(B)
    jr = jax_loaded_run(jax_loaded_sim(kind, observer), X0, W, steps)
    model, scaler, _ = load_model(PATHS[kind])
    cfg = mpc_cfg()
    mpc = CONTROLLERS[kind](model, scaler, cfg, device="cpu",
                            dtype=torch.float64)
    if kind == "bilinear":
        # the JAX controller's f32 constants (see the module doc)
        for name in ("gens", "rdiag", "cFr", "F0r"):
            getattr(mpc, name).copy_(getattr(mpc, name).float().double())
    obs = make_load_observer(model, cfg, device="cpu",
                             dtype=torch.float64) if observer else None
    sim = Ksim(Arm(ArmConfig(**LOADED["arm"]), device="cpu"), mpc,
               observer=obs, device="cpu")
    assert not sim.fused_step_eligible()
    out = sim.batched_runner(circle_reference(), steps=steps)(X0, W)
    Yp = out["Yp"].numpy()
    err = np.sqrt(((Yp - circle_reference()[None, :steps - 1]) ** 2)
                  .sum(-1))
    What = out["what"].numpy()
    assert out["alive"].all() and jr["alive"].all()
    np.testing.assert_allclose(err.mean(1), jr["err"].mean(1), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(What, jr["What"], rtol=0, atol=1e-5)
    assert np.abs(What).max() <= 1.0 + 1e-9
    if observer:
        assert np.abs(What).max() > 0.1
    else:
        assert not What.any()
    if kind == "linear":
        assert (What[..., -1] == 0).all()


def test_loaded_refs_are_the_recipe_chip_smoke_runs():
    """``assets/loaded_refs.json`` carries the recipe, controller and
    trainer of ``LOADED`` that chip_smoke.py's phase LD reads from it;
    chip_smoke's lanes are the oracle's (the first 16 the references');
    the JAX f32 band of each run holds its f32 run as trained, and phase
    LD3's per-lane gate (``loaded_lane_gate``) passes it and x64's and
    fails lanes beyond its reach."""
    import json

    import chip_smoke
    from test_torch_oracle import LOADED_F32_COPIES, LOADED_REFS, LOADED_RUNS
    refs = json.loads(LOADED_REFS.read_text())
    norm = lambda d: json.loads(json.dumps(d))
    assert chip_smoke.LOADED_REFS == LOADED_REFS
    assert refs["recipe"] == norm({k: v for k, v in LOADED.items()
                                   if k not in ("mpc", "sysid")})
    assert refs["mpc"] == norm(LOADED["mpc"])
    assert refs["sysid"] == norm(LOADED["sysid"])
    assert set(refs["runs"]) == {f"{k}/{o}" for k, o in LOADED_RUNS}
    for B in (4, 16, 2048):
        X0, W = loaded_lanes(B)
        cX, cW = chip_smoke.loaded_lanes(B, refs["recipe"])
        np.testing.assert_array_equal(cX, X0.astype(np.float32))
        np.testing.assert_array_equal(cW, W.astype(np.float32))
    assert refs["f32"].startswith("JAX with x64 off") \
        and f"{LOADED_F32_COPIES - 1} copies" in refs["f32"]
    for run in refs["runs"].values():
        assert len(run["err_mean"]) == LOADED["B_ref"] == 16
        for e, (lo, hi) in zip(run["f32"]["err_mean"], run["f32"]["band"]):
            assert lo <= e <= hi
        lo, hi = run["f32"]["band_mean"]
        assert lo <= np.mean(run["f32"]["err_mean"]) <= hi
        # phase LD3's per-lane gate passes JAX's own f32 run and x64's
        for e in (run["f32"]["err_mean"], run["err_mean"]):
            assert not chip_smoke.loaded_lane_gate(e, run).any()
        hi = np.maximum(run["err_mean"], np.asarray(run["f32"]["band"])[:, 1])
        off = chip_smoke.loaded_lane_gate(hi + 1.5e-3, run)
        np.testing.assert_allclose(off, 1.5e-3, rtol=1e-9)
    assert refs["f32_full"]["B"] == LOADED["B_full"]
