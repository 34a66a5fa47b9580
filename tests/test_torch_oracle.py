"""JAX-side oracle for the PyTorch port's tests, and the model asset.

The port (``koopman_realizations_torch``) never imports JAX; its tests hold
it against the JAX package on the same inputs.  This module builds the JAX
side once per process -- the bench controller, the arm plant, the closed
loop -- from the committed model asset, and other ``tests/test_torch_*.py``
files import these helpers.

The asset is the JAX trainer's output on the in-repo generated corpus
(the MATLAB datafile the bench was tuned on is not part of the repo):

    python tests/test_torch_oracle.py --write-asset

regenerates it: ``generate(15, 60.0, n_val=5, seed=0)`` ->
``Ksysid`` bilinear poly-3 with PCA, f32 -> ``save_model``, plus the JAX
general runner's tracking error at B=16 over 301 steps in the header, so
the GPU smoke run can gate on it without JAX.
"""

from __future__ import annotations

import functools
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)      # as tests/conftest.py
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from koopman_realizations_tpu.config import (  # noqa: E402
    ArmConfig,
    MpcConfig,
    SysidConfig,
)

ASSET = ROOT / "koopman_realizations_torch" / "assets" / \
    "arm3_bilinear_poly3.npz"

# the bench controller (bench.py:95-105 at its defaults)
BENCH_MPC = dict(
    horizon=10, qp_iters=4, qp_dual_warm=True, qp_dual_shift=False,
    input_blocks=(1, 1, 2, 5),
    input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8), input_slopeConst=1e-1,
    cost_running=10.0, cost_terminal=100.0,
    cost_input=(0.1 * 3e-2, 0.1 * 2e-2, 0.1 * 1e-2), proj_idx=(4, 5))
# the bench plant (bench.py:118-122)
BENCH_ARM = dict(Nmods=3, nlinks=1, L=1.0, m=0.1, output_type="markers",
                 substeps=3, newton_iters=1, jac_mode="step")
CORPUS = dict(trials=15, tf=60.0, n_val=5, seed=0)
REF_B, REF_STEPS = 16, 301


def blockM_y() -> np.ndarray:
    """The bench's blockM reference, (301, 2), built in-repo."""
    from koopman_realizations_tpu.utils.trajectories import (
        get_blockM,
        make_trajectory,
    )
    return make_trajectory(get_blockM([0.45, -0.35], 0.5, 0.5),
                           T=15, Ts=0.05)["y"]


def bench_X0(B: int) -> np.ndarray:
    """The bench's initial states: first joint spread over +-0.2 rad."""
    X0 = np.zeros((B, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    return X0


def lane_errors(Yp, ref_y, steps: int):
    """Per-lane mean tracking error, as bench.py:159-165."""
    Yl = np.asarray(Yp, np.float64)
    Rl = np.asarray(ref_y, np.float32)[None, : steps - 1].astype(np.float64)
    return np.sqrt(((Yl - Rl) ** 2).sum(-1)).mean(axis=1)


@functools.lru_cache(maxsize=None)
def jax_model():
    """(model, scaler) of the committed asset, through the JAX loader."""
    from koopman_realizations_tpu.utils.checkpoint import load_model
    return load_model(str(ASSET))


@functools.lru_cache(maxsize=None)
def jax_bench():
    """(Ksim, BilinearKmpc, Arm) of the JAX package at the bench config."""
    from koopman_realizations_tpu.control import Ksim, make_kmpc
    from koopman_realizations_tpu.models.arm import Arm
    model, scaler = jax_model()
    mpc = make_kmpc(model, scaler, MpcConfig(**BENCH_MPC))
    arm = Arm(ArmConfig(**BENCH_ARM))
    return Ksim(arm, mpc), mpc, arm


def generate_corpus():
    from examples.generate_arm_data import generate
    return generate(CORPUS["trials"], CORPUS["tf"], n_val=CORPUS["n_val"],
                    seed=CORPUS["seed"])


def train_jax(ds):
    from koopman_realizations_tpu.models.edmd import Ksysid
    return Ksysid(ds, SysidConfig(model_type="bilinear", obs_type=("poly",),
                                  obs_degree=(3,), dim_red=True,
                                  dtype="float32")).train_models()


def one_step_predictions(model, valdata) -> np.ndarray:
    """Scaled one-step output predictions C (A z + Beta(z) u) over every
    validation step -- invariant to PCA component signs."""
    out = []
    for tr in valdata:
        zeta = np.asarray(tr.y, np.float64)[:-1]
        u = np.asarray(tr.u, np.float64)[:-1]
        z = np.asarray(jax.vmap(model.basis.lift)(zeta), np.float64)
        A = np.asarray(model.A, np.float64)
        Bm = np.asarray(model.B, np.float64)
        C = np.asarray(model.C, np.float64)
        z1 = z @ A.T + np.einsum("kmj,tj,tm->tk", Bm, z, u)
        out.append(z1 @ C.T)
    return np.concatenate(out)


@functools.lru_cache(maxsize=None)
def jax_general_run(B: int, steps: int):
    """The JAX general runner at the bench config: (Yp, alive) as numpy."""
    sim, _, _ = jax_bench()
    run = sim.batched_runner(blockM_y(), steps=steps, record=("Yp", "alive"))
    out = jax.block_until_ready(
        run(bench_X0(B), np.zeros((B, 2), np.float32)))
    return np.asarray(out["Yp"]), np.asarray(out["alive"])


def write_asset() -> dict:
    """Train on the generated corpus and write the asset (see module doc)."""
    from koopman_realizations_tpu.utils.checkpoint import save_model
    ks = train_jax(generate_corpus())
    ASSET.parent.mkdir(parents=True, exist_ok=True)
    save_model(str(ASSET), ks.model, ks.scaler, overwrite=True)
    jax_model.cache_clear()
    jax_bench.cache_clear()
    jax_general_run.cache_clear()
    Yp, alive = jax_general_run(REF_B, REF_STEPS)
    err = lane_errors(Yp, blockM_y(), REF_STEPS)
    data = dict(np.load(ASSET, allow_pickle=False))
    header = json.loads(str(data.pop("header")))
    header["provenance"] = {
        "corpus": "examples/generate_arm_data.py:generate"
                  "(15, 60.0, n_val=5, seed=0)",
        "sysid": "Ksysid bilinear poly-3 dim_red=True dtype=float32",
        "written_by": "python tests/test_torch_oracle.py --write-asset",
    }
    header["jax_reference"] = {
        "runner": "Ksim.batched_runner (x64 session, CPU)",
        "B": REF_B, "steps": REF_STEPS,
        "alive": float(alive[:, -1].mean()),
        "err_mean": float(err.mean()), "err_worst": float(err.max()),
    }
    np.savez(ASSET, header=json.dumps(header), **data)
    return header


# ---------------------------------------------------------------- tests


def test_asset_loads_identically_in_both_packages():
    from koopman_realizations_torch.utils.checkpoint import load_model
    jm, js = jax_model()
    tm, ts, header = load_model(ASSET)
    for name in ("A", "B", "C"):
        np.testing.assert_array_equal(np.asarray(getattr(jm, name)),
                                      getattr(tm, name))
    np.testing.assert_array_equal(np.asarray(jm.basis.pcs), tm.basis.pcs)
    for name in ("y_factor", "y_offset", "u_factor", "u_offset"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name))
    assert tm.meta.NL == jm.meta.NL == 28
    assert tm.basis.families == jm.basis.families
    assert header["jax_reference"]["alive"] == 1.0


def test_from_jax_arrays_round_trip():
    import dataclasses

    from koopman_realizations_torch.models.koopman import from_jax_arrays
    jm, js = jax_model()
    header = {"meta": dataclasses.asdict(jm.meta),
              "basis": {"model_type": jm.basis.model_type, "n": jm.basis.n,
                        "m": jm.basis.m, "nd": jm.basis.nd,
                        "nw": jm.basis.nw,
                        "families": [list(f) for f in jm.basis.families]}}
    arrays = {"A": np.asarray(jm.A), "B": np.asarray(jm.B),
              "C": np.asarray(jm.C), "pcs": np.asarray(jm.basis.pcs)}
    arrays.update({"scaler_" + k: np.asarray(getattr(js, k))
                   for k in ("y_factor", "y_offset", "u_factor",
                             "u_offset")})
    tm, ts = from_jax_arrays(header, arrays)
    z = np.random.default_rng(0).standard_normal(6)
    np.testing.assert_allclose(
        tm.basis.lift(torch.from_numpy(z[:, None]))[:, 0].numpy(),
        np.asarray(jm.basis.lift(z)), rtol=1e-13, atol=1e-14)
    np.testing.assert_array_equal(tm.B, np.asarray(jm.B))
    np.testing.assert_array_equal(ts.u_factor, np.asarray(js.u_factor))
    assert tm.meta == type(tm.meta)(**dataclasses.asdict(jm.meta))


def test_asset_provenance_retrain():
    """Retraining on the generated corpus reproduces the asset's one-step
    predictions (predictions, not raw matrices: PCA signs may flip across
    LAPACK builds)."""
    ks = train_jax(generate_corpus())
    jm, js = jax_model()
    for k in ("y_factor", "y_offset", "u_factor", "u_offset"):
        np.testing.assert_allclose(np.asarray(getattr(ks.scaler, k)),
                                   np.asarray(getattr(js, k)), rtol=1e-12)
    p_new = one_step_predictions(ks.model, ks.valdata)
    p_asset = one_step_predictions(jm, ks.valdata)
    assert np.abs(p_new - p_asset).max() < 1e-5


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write-asset", action="store_true",
                    help="retrain and rewrite the committed model asset")
    args = ap.parse_args()
    if not args.write_asset:
        ap.error("nothing to do (pass --write-asset)")
    print(json.dumps(write_asset(), indent=1))
