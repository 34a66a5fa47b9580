"""Loaded models with delays (nd > 0 and nw > 0) in the port against the
JAX package on the CPU: the trainer on the committed loaded corpus at
delays=1 (nzeta = 4 * 2 + 2 = 10), the load observer's delay-embedded
regression rows, and the general closed loop with the observer on the
circle; the asset and references are the JAX trainer's and runner's
(``assets/arm2_loaded_bilinear_poly2_del1.npz``,
``assets/loaded_delays_refs.json``, ``python tests/test_torch_oracle.py
--write-loaded-delays``).

Tolerances, each with what it was measured at:
- the port's training against the JAX-trained asset in scaled one-step
  prediction: 1e-5;
- ``LoadObserver.embed_zetas`` against the JAX observer's rows, exactly,
  and the estimate of one window against the JAX observer's (x64): 1e-6;
- the short f64 closed loop (B=4 x 30 steps; the observer updates from
  k = 12) against the JAX general runner (x64), with the JAX controller's
  f32-rounded constants given to the port's f64 controller (as in
  ``test_torch_loaded.py``): err_mean 1e-5 (measured 4.7e-6); What at the
  first update 2e-5 (measured 8.3e-6) and over the 30 steps 1e-3
  (measured 3.9e-4: the delayed regression amplifies the two
  controllers' ~1e-7 difference in the windows, and the loop through
  the observer amplifies it again);
- the f64 loop at B=16 x 301 against the reference's x64 lanes: alive
  equal, err_mean within 1e-3 of the hull of x64 and JAX's f32 band on
  every lane (the loop with the observer amplifies rounding, ROADMAP §3
  parity note 2).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.config import SysidConfig
from koopman_realizations_torch.control.kmpc import BilinearKmpc
from koopman_realizations_torch.control.ksim import Ksim
from koopman_realizations_torch.control.observer import make_load_observer
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.models.edmd import Ksysid
from koopman_realizations_torch.utils.checkpoint import load_model
from koopman_realizations_torch.utils.data import LOADED_CORPUS, load_corpus
from koopman_realizations_torch.utils.metrics import one_step_predictions
from koopman_realizations_torch.utils.trajectories import circle_reference

from test_torch_oracle import (
    LOADED,
    LOADED_DEL_ASSET,
    LOADED_DEL_REFS,
    LOADED_DEL_SYSID,
    jax_loaded_del_model,
    jax_loaded_run,
    jax_loaded_sim,
    loaded_lanes,
    one_thread,  # noqa: F401  (the fixture of pytestmark)
)

pytestmark = pytest.mark.usefixtures("one_thread")


def mpc_cfg(**kw) -> MpcConfig:
    return MpcConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in {**LOADED["mpc"], **kw}.items()})


def refs():
    return json.loads(LOADED_DEL_REFS.read_text())


def test_training_matches_the_jax_asset():
    """The port's loaded training at delays=1 on the committed corpus: the
    JAX asset's dimensions and its one-step prediction on the validation
    trial within 1e-5."""
    ks = Ksysid(load_corpus(LOADED_CORPUS),
                SysidConfig(model_type="bilinear", **LOADED_DEL_SYSID),
                device="cpu").train_models()
    asset, _, _ = load_model(LOADED_DEL_ASSET)
    assert (ks.nd, ks.nw, ks.nzeta) == (1, 2, 10)
    assert ks.model.meta == asset.meta
    osp = lambda m: one_step_predictions(m, ks.valdata, "cpu")
    d = np.abs(osp(ks.model) - osp(asset)).max()
    print(f"one-step distance to the JAX-trained asset: {d:.3e}")
    assert d < 1e-5, d


def _windows(B, rows, seed=0):
    """Seeded trailing windows (rows, n, B) and (rows, m, B), f64."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.5, (rows, 4, B)),
            rng.uniform(-0.5, 0.5, (rows, 2, B)))


def test_observer_rows_and_estimate_match_jax():
    """The observer's delay-embedded rows (JAX ``embed_zetas``: each
    time's output, its delays newest first, then the input delays) and one
    estimate on seeded windows of hor + 1 + nd rows, f64."""
    from koopman_realizations_tpu.control.observer import (
        make_load_observer as jax_make_load_observer,
    )
    model, _, _ = load_model(LOADED_DEL_ASSET)
    jm, _ = jax_loaded_del_model()
    cfg = mpc_cfg()
    obs = make_load_observer(model, cfg, device="cpu", dtype=torch.float64)
    B, rows = 3, obs.horizon + 1 + obs.nd
    yw, uw = _windows(B, rows)
    t = torch.from_numpy
    Z = obs.embed_zetas(t(yw), t(uw)).numpy()
    assert Z.shape == (obs.horizon + 1, 10, B)
    for b in range(B):
        for r in range(obs.horizon + 1):
            i = rows - 1 - obs.horizon + r
            np.testing.assert_array_equal(
                Z[r, :, b], np.concatenate([yw[i, :, b], yw[i - 1, :, b],
                                            uw[i - 1, :, b]]))
    w = obs.estimate(t(yw), t(uw)).numpy()
    jobs = jax_make_load_observer(jm, cfg)
    jw = np.stack([np.asarray(jobs(jnp.int32(12),
                                   jnp.asarray(yw[..., b]),
                                   jnp.asarray(uw[..., b]),
                                   jnp.zeros(2)))
                   for b in range(B)], axis=1)
    print(f"observer estimate: max |dw| against JAX {np.abs(w - jw).max():.3e}")
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-6)
    assert np.abs(w).max() > 0


def _port_sim(dtype=torch.float64):
    model, scaler, _ = load_model(LOADED_DEL_ASSET)
    cfg = mpc_cfg()
    mpc = BilinearKmpc(model, scaler, cfg, device="cpu", dtype=dtype)
    assert not mpc.lift_fused and mpc.meta.nd == 1
    obs = make_load_observer(model, cfg, device="cpu", dtype=dtype)
    sim = Ksim(Arm(ArmConfig(**LOADED["arm"]), device="cpu"), mpc,
               observer=obs, device="cpu")
    assert sim.win == max(2, obs.horizon + 1 + 1)
    return sim


def test_short_loop_matches_live_jax():
    B, steps = 4, 30
    X0, W = loaded_lanes(B)
    jm, js = jax_loaded_del_model()
    jr = jax_loaded_run(jax_loaded_sim("bilinear", True, jm, js), X0, W,
                        steps)
    sim = _port_sim()
    mpc = sim.mpc
    # the JAX controller's f32 constants (test_torch_loaded.py's note)
    for name in ("gens", "rdiag", "cFr", "F0r"):
        getattr(mpc, name).copy_(getattr(mpc, name).float().double())
    out = sim.batched_runner(circle_reference(), steps=steps)(X0, W)
    Yp = out["Yp"].numpy()
    err = np.sqrt(((Yp - circle_reference()[None, :steps - 1]) ** 2)
                  .sum(-1))
    What = out["what"].numpy()
    assert out["alive"].all() and jr["alive"].all()
    print(f"short loop: max |d err_mean| "
          f"{np.abs(err.mean(1) - jr['err'].mean(1)).max():.3e}, max "
          f"|dWhat| {np.abs(What - jr['What']).max():.3e}")
    np.testing.assert_allclose(err.mean(1), jr["err"].mean(1), rtol=0,
                               atol=1e-5)
    # the first estimate (step 12) within 2e-5 (measured 8.3e-6: the
    # regression amplifies the windows' ~1e-7 rounding), then the loop
    # through the observer amplifies it further (3.9e-4 by step 30)
    np.testing.assert_allclose(What[:, 11], jr["What"][:, 11], rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(What, jr["What"], rtol=0, atol=1e-3)
    # the first update at k = hor + nd + 1 = 12 (the observer's step
    # counter is the reference's, 1-based)
    assert not What[:, :10].any() and np.abs(What[:, 11:]).max() > 0.1


def test_loop_matches_jax_reference():
    r = refs()
    assert (r["B"], r["steps"]) == (LOADED["B_ref"], LOADED["steps"])
    assert r["asset"] == LOADED_DEL_ASSET.name and r["nzeta"] == 10
    X0, W = loaded_lanes(r["B"])
    out = _port_sim().batched_runner(circle_reference(),
                                     steps=r["steps"])(X0, W)
    Yp = out["Yp"].numpy()
    err = np.sqrt(((Yp - circle_reference()[None, :r["steps"] - 1]) ** 2)
                  .sum(-1)).mean(1)
    np.testing.assert_array_equal(out["alive"][:, -1].numpy(), r["alive"])
    f32 = np.asarray([[e for _, e in c] for c in r["f32_copies"]])
    lo = np.minimum(f32.min(0), r["err_mean"]) - 1e-3
    hi = np.maximum(f32.max(0), r["err_mean"]) + 1e-3
    print(f"loaded delayed loop: err_mean {err.mean():.6f} (JAX x64 "
          f"{np.mean(r['err_mean']):.6f}), max lane distance to x64 "
          f"{np.abs(err - r['err_mean']).max():.3e}")
    assert ((err >= lo) & (err <= hi)).all(), (err, lo, hi)
