"""The port's observable dictionaries against the JAX package on the CPU:
every family (poly, fourier, fourier_sparser, gaussian, hermite) and a
mixed list, the econ, bilinear and loaded lifts on them, the seeded
gaussian centers, ``zeta_from_window``, the checkpoint round trip with
centers, the controllers' own lift and the port's CPU training of the
dictionary assets' recipes (``tests/test_torch_oracle.py:DICT_ASSETS``,
written by ``--write-dictionaries``), JAX in its x64 session.

Tolerances, each with what it was measured at:
- N_full and the gaussian centers exactly (the same numpy draw);
- every lift in f64: 1e-12 (the same products; measured <= 1.1e-16);
- the f32 lift against the f64 lift: 1e-5 absolute (sin(2 pi j z),
  Hermite powers up to |H_3| ~ 4 and exp(-r^2) in f32; measured
  <= 6.0e-7), never against another f32 ordering;
- the port's CPU training of each asset recipe against the JAX-trained
  asset in scaled one-step prediction: 1.2e-7, or twice the model's
  one-ulp lift floor where that is more (``chip_smoke.lift_ulp_floor``:
  the f64 regression of an f32 lift amplifies its last bit, and the
  packages' PCA projections sum in different orders; measured 3.9e-7 for
  the delayed poly-2 model against a floor of 3.2e-7, <= 1.2e-7 for the
  four others).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koopman_realizations_tpu.config import SysidConfig as JSysidConfig
from koopman_realizations_tpu.ops.observables import (
    build_basis as jax_build_basis,
)
from koopman_realizations_tpu.ops.observables import (
    zeta_from_window as jax_zeta_from_window,
)
from koopman_realizations_tpu.utils.checkpoint import (
    load_model as jax_load_model,
)
from koopman_realizations_tpu.utils.checkpoint import (
    save_model as jax_save_model,
)
from koopman_realizations_torch.config import MpcConfig, SysidConfig
from koopman_realizations_torch.control.kmpc import make_kmpc
from koopman_realizations_torch.models.edmd import Ksysid
from koopman_realizations_torch.ops.observables import (
    build_basis,
    zeta_from_window,
)
from koopman_realizations_torch.utils.checkpoint import load_model, save_model
from koopman_realizations_torch.utils.data import load_corpus
from koopman_realizations_torch.utils.metrics import one_step_predictions

from chip_smoke import lift_ulp_floor
from test_torch_oracle import (
    DICT_ASSETS,
    DICT_PATHS,
    dict_asset_path,
    dict_sysid,
    one_thread,  # noqa: F401  (fixture)
)

pytestmark = pytest.mark.usefixtures("one_thread")

# (model_type, families, degrees, delays): each family alone and a mix
DICTS = {
    "poly": ("bilinear", ("poly",), (3,), 0),
    "fourier": ("linear", ("fourier",), (1,), 0),
    "fourier_sparser": ("bilinear", ("fourier_sparser",), (2,), 0),
    "gaussian": ("linear", ("gaussian",), (20,), 0),
    "hermite": ("linear", ("hermite",), (3,), 0),
    "mixed": ("nonlinear", ("poly", "gaussian", "hermite",
                            "fourier_sparser"), (2, 5, 2, 1), 1),
}


def both_bases(name, n=3, m=2, seed=0):
    mt, fams, degs, nd = DICTS[name]
    kw = dict(model_type=mt, obs_type=fams, obs_degree=degs, delays=nd,
              seed=seed)
    return (jax_build_basis(JSysidConfig(**kw), n, m),
            build_basis(SysidConfig(**kw), n, m))


def zetas(nz, B=7, seed=1):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (B, nz))


@pytest.mark.parametrize("name", list(DICTS))
def test_family_lifts_match_jax(name):
    jb, tb = both_bases(name)
    assert tb.N_full == jb.N_full
    Z = zetas(tb.nzeta_aug)
    gj = np.asarray(jax.vmap(jb.lift_full)(jnp.asarray(Z)))
    g64 = tb.lift_full(torch.from_numpy(Z.T)).T.numpy()
    assert g64.shape == (Z.shape[0], tb.N_full)
    np.testing.assert_allclose(g64, gj, rtol=0, atol=1e-12)
    g32 = tb.lift_full(torch.from_numpy(Z.T).float())
    assert g32.dtype == torch.float32
    np.testing.assert_allclose(g32.T.double().numpy(), g64, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("lift", ["lift", "lift_input", "lift_loaded",
                                  "lift_loaded_input"])
def test_composed_lifts_on_a_mixed_pca_basis_match_jax(lift):
    """The econ lift [zeta; pcs^T g; 1] and its bilinear and loaded
    compositions on a mixed dictionary with a PCA basis (random
    orthonormal components)."""
    kw = dict(model_type="bilinear", obs_type=("fourier_sparser", "gaussian",
                                               "hermite"),
              obs_degree=(1, 4, 2), loaded=True, seed=5)
    jb = jax_build_basis(JSysidConfig(**kw), 3, 2, nw=2)
    tb = build_basis(SysidConfig(**kw), 3, 2, nw=2)
    rng = np.random.default_rng(2)
    pcs = np.linalg.qr(rng.standard_normal((tb.N_full, 9)))[0]
    jb, tb = jb.with_pcs(pcs), tb.with_pcs(pcs)
    B = 5
    Z, U, W = zetas(3, B), rng.uniform(-1, 1, (B, 2)), rng.uniform(
        0, 1, (B, 2))
    args = {"lift": (Z,), "lift_input": (Z, U), "lift_loaded": (Z, W),
            "lift_loaded_input": (Z, W, U)}[lift]
    gj = np.asarray(jax.vmap(getattr(jb, lift))(*map(jnp.asarray, args)))
    gt = getattr(tb, lift)(*(torch.from_numpy(a.T) for a in args)).T
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-12)


@pytest.mark.parametrize("model_type,nd,seed", [
    ("linear", 0, 0), ("nonlinear", 0, 3), ("bilinear", 2, 11)])
def test_gaussian_centers_bitwise(model_type, nd, seed):
    kw = dict(model_type=model_type, obs_type=("gaussian", "poly",
                                               "gaussian"),
              obs_degree=(7, 2, 12), delays=nd, seed=seed)
    jb = jax_build_basis(JSysidConfig(**kw), 4, 2)
    tb = build_basis(SysidConfig(**kw), 4, 2)
    assert tb.gaussian_centers.shape == (tb.nzeta_aug, 12)
    assert np.array_equal(tb.gaussian_centers, jb.gaussian_centers)
    assert build_basis(SysidConfig(model_type="linear"), 4, 2) \
        .gaussian_centers is None


def test_checkpoint_round_trip_with_centers(tmp_path):
    """A gaussian model saved by the port loads in JAX with its centers,
    and the JAX-written mixed asset loads in the port with the same
    lift."""
    tm, tsc, _ = load_model(dict_asset_path("mix"))
    assert tm.basis.gaussian_centers is not None
    p = save_model(tmp_path / "mix", tm, tsc)
    jm, _ = jax_load_model(p)
    np.testing.assert_array_equal(np.asarray(jm.basis.gaussian_centers),
                                  tm.basis.gaussian_centers)
    jasset, _ = jax_load_model(str(dict_asset_path("mix")))
    Z = zetas(6, 5)
    gj = np.asarray(jax.vmap(jasset.basis.lift)(jnp.asarray(Z)))
    gt = tm.basis.lift(torch.from_numpy(Z.T)).T.numpy()
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-12)
    back, _, _ = load_model(jax_save_model(str(tmp_path / "j"), jm))
    assert np.array_equal(back.basis.gaussian_centers,
                          tm.basis.gaussian_centers)


@pytest.mark.parametrize("nd", [1, 2])
def test_zeta_from_window_matches_jax(nd):
    rng = np.random.default_rng(nd)
    B = 4
    yw, uw = rng.standard_normal((nd + 1, 3, B)), rng.standard_normal(
        (nd + 1, 2, B))
    t = zeta_from_window(torch.from_numpy(yw), torch.from_numpy(uw), nd)
    for b in range(B):
        j = jax_zeta_from_window(yw[..., b], uw[..., b], nd)
        np.testing.assert_array_equal(t[:, b].numpy(), np.asarray(j))


@pytest.mark.parametrize("path", ["del1", "nopca", "fs1", "mix",
                                  "nmpc-fs1"])
def test_controllers_lift_with_the_basis(path):
    """Each controller's device lift (its buffers) is the basis's lift of
    the JAX-written asset, in f64."""
    asset, _, knobs = DICT_PATHS[path]
    model, scaler, _ = load_model(dict_asset_path(asset))
    mpc = make_kmpc(model, scaler, MpcConfig(**knobs), device="cpu",
                    dtype=torch.float64)
    jm, _ = jax_load_model(str(dict_asset_path(asset)))
    Z = zetas(model.basis.nzeta_aug, 6)
    gj = np.asarray(jax.vmap(jm.basis.lift)(jnp.asarray(Z)))
    np.testing.assert_allclose(mpc.lift_econ(torch.from_numpy(Z.T)).T
                               .numpy(), gj, rtol=0, atol=1e-12)


@functools.lru_cache(maxsize=None)
def corpus():
    return load_corpus()


@pytest.mark.parametrize("name", list(DICT_ASSETS))
def test_cpu_training_matches_the_jax_assets(name):
    ks = Ksysid(corpus(), SysidConfig(**dict_sysid(name)),
                device="cpu").train_models()
    am, _, header = load_model(dict_asset_path(name))
    assert ks.model.meta == am.meta
    assert ks.basis.families == am.basis.families
    if am.basis.gaussian_centers is not None:
        assert np.array_equal(ks.basis.gaussian_centers,
                              am.basis.gaussian_centers)
    d = np.abs(one_step_predictions(ks.model, ks.valdata, "cpu")
               - one_step_predictions(am, ks.valdata, "cpu")).max()
    limit = 1.2e-7 if d <= 1.2e-7 else max(1.2e-7, 2 * lift_ulp_floor(ks))
    assert d <= limit, (name, d, limit)


def test_new_entry_points_default_to_the_card():
    """``one_step_predictions``, ``make_kmpc``, ``KoopmanPlant`` and
    ``run_model_simulation`` ask for CUDA unless the caller passes
    ``device="cpu"`` (no quiet run on the host)."""
    from koopman_realizations_torch.control.ksim import (
        KoopmanPlant,
        run_model_simulation,
    )
    from koopman_realizations_torch.utils.trajectories import (
        blockM_reference,
    )
    model, scaler, _ = load_model(dict_asset_path("fs1"))
    cfg = MpcConfig(**DICT_PATHS["fs1"][2])
    if torch.cuda.is_available():
        assert make_kmpc(model, scaler, cfg).device.type == "cuda"
        return
    mpc = make_kmpc(model, scaler, cfg, device="cpu")
    for call in (lambda: one_step_predictions(model, corpus().val[:1]),
                 lambda: make_kmpc(model, scaler, cfg),
                 lambda: KoopmanPlant(model, scaler),
                 lambda: run_model_simulation(mpc, blockM_reference(),
                                              steps=2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    out = run_model_simulation(mpc, blockM_reference(), steps=3,
                               device="cpu")
    assert out["Y"][:, list(mpc.proj_idx)].shape == (2, 2)
    assert bool(out["alive"].all())
