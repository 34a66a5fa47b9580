"""The port's load observer (``control/observer.py``) against the JAX
package's (``koopman_realizations_tpu/control/observer.py``) on the CPU,
on the committed loaded assets and the scaled validation trial of the
committed loaded corpus (``python tests/test_torch_oracle.py
--write-loaded``).

The estimate is a box QP a lane with a per-lane Hessian and shared rows,
solved by ``ops/qp.py:solve_qp`` (on the CPU the plain version of the
``ipm_shared`` kernel's per-lane-P build), the JAX one by its pure
interior point; both run 15 iterations from the same cold start in f64.
Tolerances: the estimates 1e-6 (measured 5e-14: the two interior points
take the same steps), ``validate_observer`` 1e-6 on every step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koopman_realizations_tpu.config import MpcConfig as JMpcConfig
from koopman_realizations_tpu.control.observer import (
    make_load_observer as jax_make_load_observer,
)
from koopman_realizations_tpu.control.observer import (
    validate_observer as jax_validate_observer,
)
from koopman_realizations_torch.config import MpcConfig
from koopman_realizations_torch.control.observer import (
    OBS_QP_ITERS,
    make_load_observer,
    validate_observer,
)
from koopman_realizations_torch.utils.checkpoint import (
    LOADED_BILINEAR_MODEL,
    LOADED_LINEAR_MODEL,
    load_model,
)
from koopman_realizations_torch.utils.data import LOADED_CORPUS, load_corpus

from test_torch_oracle import (
    LOADED,
    jax_loaded_model,
    one_thread,  # noqa: F401  (fixture)
)

pytestmark = pytest.mark.usefixtures("one_thread")

PATHS = {"bilinear": LOADED_BILINEAR_MODEL, "linear": LOADED_LINEAR_MODEL}
SLOPE = 0.05


def cfgs(slope=None):
    """(port MpcConfig, JAX MpcConfig) of the experiment's controller."""
    kw = dict(LOADED["mpc"], load_obs_slope=slope)
    return (MpcConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in kw.items()}), JMpcConfig(**kw))


@functools.lru_cache(maxsize=None)
def val_trial(kind):
    """The validation trial of the loaded corpus in the asset's scaled
    space (y, u, w)."""
    _, scaler, _ = load_model(PATHS[kind])
    return scaler.trial_down(load_corpus(LOADED_CORPUS).val[0])


def windows(kind, B, seed=0):
    """B lanes of trailing windows (11 rows) from the scaled validation
    trial at seeded times, lanes-minor (W, n|m, B), and seeded previous
    estimates (nw, B) inside the box."""
    tr = val_trial(kind)
    rng = np.random.default_rng(seed)
    idx = rng.integers(10, tr.y.shape[0], B)
    yw = np.stack([tr.y[i - 10:i + 1] for i in idx], axis=-1)
    uw = np.stack([tr.u[i - 10:i + 1] for i in idx], axis=-1)
    wp = rng.uniform(-0.8, 0.8, (2, B))
    return yw, uw, wp


@pytest.mark.parametrize("slope", [None, SLOPE])
@pytest.mark.parametrize("kind", ["bilinear", "linear"])
def test_estimate_matches_jax(kind, slope):
    """``estimate`` on 12 lanes of the validation trial, the bilinear
    M_i = A3 + sum_j u_ij B4 and the linear variant with its pinned last
    component, with and without the slope rows about a previous estimate:
    within 1e-6 of JAX's ``observer.estimate`` lane by lane (f64)."""
    model, _, _ = load_model(PATHS[kind])
    cfg, jcfg = cfgs(slope)
    obs = make_load_observer(model, cfg, device="cpu", dtype=torch.float64)
    jobs = jax_make_load_observer(jax_loaded_model(kind)[0], jcfg)
    yw, uw, wp = windows(kind, 12)
    port = obs.estimate(torch.from_numpy(yw), torch.from_numpy(uw),
                        torch.from_numpy(wp)).numpy()
    est = jax.jit(jobs.estimate)
    ref = np.stack([np.asarray(est(jnp.asarray(yw[..., b]),
                                   jnp.asarray(uw[..., b]),
                                   jnp.asarray(wp[:, b])))
                    for b in range(yw.shape[-1])], axis=-1)
    assert port.shape == (2, 12)
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-6)
    assert np.abs(port).max() <= 1.0 + 1e-9
    if slope is not None:
        assert np.abs(port - wp)[:obs.nfree].max() <= slope + 1e-6
    if kind == "linear":
        assert obs.nfree == 1 and (port[-1] == 0).all()
    else:
        assert obs.nfree == 2


@pytest.mark.parametrize("kind", ["bilinear", "linear"])
def test_observer_qp_shapes(kind):
    """The estimate's QP as ``solve_qp`` takes it: a per-lane P (nfree,
    nfree, B) -- n=2 bilinear, n=1 linear, the ``ipm_shared`` per-lane-P
    builds on the card -- the box rows shared (mc = 2 nfree, diagonal
    band), and with the slope rows 4 nfree; 15 iterations, cold."""
    model, _, _ = load_model(PATHS[kind])
    yw, uw, wp = windows(kind, 5)
    for slope, rows in ((None, 2), (SLOPE, 4)):
        obs = make_load_observer(model, cfgs(slope)[0], device="cpu")
        P, q, cons, b, iters = obs.qp(torch.from_numpy(yw),
                                      torch.from_numpy(uw),
                                      torch.from_numpy(wp))
        nf = 2 if kind == "bilinear" else 1
        assert P.shape == (nf, nf, 5) and q.shape == (nf, 5)
        assert (cons.n, cons.mc, cons.band) == (nf, rows * nf, 0)
        assert b.shape == (rows * nf, 5) and iters == OBS_QP_ITERS
        assert P.dtype == torch.float32
        torch.testing.assert_close(P, P.transpose(0, 1), rtol=0, atol=0)


@pytest.mark.parametrize("sparse", [0, 5])
@pytest.mark.parametrize("kind", ["bilinear", "linear"])
def test_validate_observer_matches_jax(kind, sparse):
    """``validate_observer`` over the whole validation trial (600 steps,
    one estimate a step as in JAX), also the sparse variant
    (an update every 5 steps, the running mean): every step's estimate
    within 1e-6 of JAX's; the true load comes back as ``wreal``."""
    model, _, _ = load_model(PATHS[kind])
    cfg, jcfg = cfgs()
    tr = val_trial(kind)
    port = validate_observer(model, cfg, tr, sparse_period=sparse,
                             device="cpu")
    ref = jax_validate_observer(jax_loaded_model(kind)[0], jcfg, tr,
                                sparse_period=sparse)
    for key in ("what", "wreal", "werr"):
        np.testing.assert_allclose(port[key], ref[key], rtol=0, atol=1e-6)
    assert not port["what"][:11].any() and port["what"][11:].any()


def test_validate_observer_with_slope_matches_jax():
    """With slope rows every estimate depends on the previous one: the
    first 80 steps of the validation trial against JAX's, 1e-6."""
    import dataclasses
    model, _, _ = load_model(LOADED_BILINEAR_MODEL)
    cfg, jcfg = cfgs(SLOPE)
    tr = val_trial("bilinear")
    tr = dataclasses.replace(tr, t=tr.t[:80], y=tr.y[:80], u=tr.u[:80],
                             w=tr.w[:80])
    port = validate_observer(model, cfg, tr, device="cpu")
    ref = jax_validate_observer(jax_loaded_model("bilinear")[0], jcfg, tr)
    np.testing.assert_allclose(port["what"], ref["what"], rtol=0, atol=1e-6)
    assert np.abs(np.diff(port["what"], axis=0)).max() <= SLOPE + 1e-6


def test_update_gate_and_failed_lanes():
    """The closed loop's gate: an update at k % period == 0 and k >
    horizon (k the 1-based step counter), else the previous estimate
    itself; a lane whose QP is not ok (a non-finite window) gets the zero
    estimate, the other lanes theirs."""
    model, _, _ = load_model(LOADED_BILINEAR_MODEL)
    obs = make_load_observer(model, cfgs()[0], device="cpu",
                             dtype=torch.float64)
    assert [k for k in range(1, 20) if obs.updates(k)] == [12, 14, 16, 18]
    yw, uw, wp = (torch.from_numpy(a) for a in windows("bilinear", 4))
    prev = torch.full((2, 4), 0.25, dtype=torch.float64)
    assert obs(11, yw, uw, prev) is prev and obs(13, yw, uw, prev) is prev
    good = obs(12, yw, uw, prev)
    yw[3, 1, 2] = float("nan")
    out = obs.estimate(yw, uw)
    assert (out[:, 2] == 0).all()
    keep = [0, 1, 3]
    torch.testing.assert_close(out[:, keep], good[:, keep], rtol=0,
                               atol=1e-12)


def test_observer_refuses_and_defaults_to_the_card():
    """An unloaded model has no observer; without ``device=`` the
    observer asks for CUDA."""
    model, _, _ = load_model()
    with pytest.raises(ValueError, match="no loads"):
        make_load_observer(model, cfgs()[0], device="cpu")
    lm, _, _ = load_model(LOADED_BILINEAR_MODEL)
    if torch.cuda.is_available():
        assert make_load_observer(lm, cfgs()[0]).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_load_observer(lm, cfgs()[0])
