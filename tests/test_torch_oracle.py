"""JAX-side oracle for the PyTorch port's tests, and the model asset.

The port (``koopman_realizations_torch``) never imports JAX; its tests hold
it against the JAX package on the same inputs.  This module builds the JAX
side once per process -- the bench controller, the arm plant, the closed
loop -- from the committed model asset, and other ``tests/test_torch_*.py``
files import these helpers.

The three model assets are the JAX trainer's output on the in-repo
generated corpus (the MATLAB datafile the bench was tuned on is not part
of the repo):

    python tests/test_torch_oracle.py --write-asset [KIND ...]

regenerates the named ones (all three without a name):
``generate(15, 60.0, n_val=5, seed=0)`` -> ``Ksysid`` poly-3 with PCA,
f32 -> ``save_model``, once bilinear (``arm3_bilinear_poly3.npz``, the
bench controller ``BENCH_MPC``), once linear (``arm3_linear_poly3.npz``,
the linear controller ``LINEAR_MPC``) and once nonlinear with PCA at
99.99 % explained variance (``arm3_nonlinear_poly3.npz``, the SQP NMPC
controller ``NMPC_MPC``), each with the JAX general runner's tracking
error at B=16 over 301 steps in its header, so the GPU smoke run can gate
on it without JAX.  ``--write-asset nonlinear`` leaves the other two
files as they are.

The corpus itself is committed too, for the port's trainer (which runs
without JAX): ``python tests/test_torch_oracle.py --write-corpus`` writes
the generator's f64 ``t``, ``y`` and ``u`` of every train and validation
trial to ``assets/arm3_corpus.npz`` (``x`` and ``w`` are left out: no
model reads them), read back by the port's ``utils/data.py:load_corpus``.

The linear controller runs ``qp_iters=6`` with cold duals.  The JAX
package's "verified linear floor" of 3 iterations
(``ops/pallas/step_fused.py:201,244``, ``tests/test_step_fused.py:98``)
belongs to the MATLAB datafile's model: on this corpus's linear model
(NL=28, spectral radius 1.0000) the JAX general runner at B=16 over 301
blockM steps (x64, CPU) loses every lane between steps 59 and 62 at
``qp_iters=3`` and at 4 (alive 0.0), keeps them all from 5 on (err_mean
0.63318 at 5, 0.63300 at 6, 0.63317 at 8, 0.63318 at 12).  6 is one
iteration above the 16-lane edge, because iteration floors move with
batch size and precision.
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
import pytest  # noqa: E402
import torch  # noqa: E402

from koopman_realizations_tpu.config import (  # noqa: E402
    ArmConfig,
    MpcConfig,
    SysidConfig,
)

ASSETS = ROOT / "koopman_realizations_torch" / "assets"
ASSET = ASSETS / "arm3_bilinear_poly3.npz"
LINEAR_ASSET = ASSETS / "arm3_linear_poly3.npz"
NONLINEAR_ASSET = ASSETS / "arm3_nonlinear_poly3.npz"
CORPUS_ASSET = ASSETS / "arm3_corpus.npz"

# the bench controller (bench.py:95-105 at its defaults)
BENCH_MPC = dict(
    horizon=10, qp_iters=4, qp_dual_warm=True, qp_dual_shift=False,
    input_blocks=(1, 1, 2, 5),
    input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8), input_slopeConst=1e-1,
    cost_running=10.0, cost_terminal=100.0,
    cost_input=(0.1 * 3e-2, 0.1 * 2e-2, 0.1 * 1e-2), proj_idx=(4, 5))
# the linear controller: the bench's horizon, blocks, bounds and costs
# (tests/test_step_fused.py:97-102) at qp_iters=6, cold duals (see above)
LINEAR_MPC = dict(BENCH_MPC, qp_iters=6, qp_dual_warm=False)
# the SQP NMPC controller: the bench's horizon, blocks, bounds and costs
# with the JAX package's verified NMPC setting (scripts/perf_report.py:
# 137-148): qp_iters=8, cold duals, MpcConfig's default SQP regime
# (5 passes, damping 0.05, 'hold' first pass)
NMPC_MPC = dict(BENCH_MPC, qp_iters=8, qp_dual_warm=False)
# the SQP regimes that leave the multipass route, each on top of NMPC_MPC:
# the six single knobs and the line search with best-of-passes, and the
# 'linear' between-pass update alone and with best-of-passes, with the
# values the JAX package pins (tests/test_closed_loop.py:270-283).  The
# JAX general runner (x64, CPU, B=16 x 301 blockM steps) keeps every lane
# of the 'linear' update from qp_iters=4 on (0.875 alive at 3), with
# best-of-passes from 3 on; they run at NMPC_MPC's 8.
NMPC_REGIMES = {
    "dual_warm": dict(sqp_dual_warm=True),
    "damping_decay": dict(sqp_damping=0.3, sqp_damping_decay=0.5),
    "linesearch": dict(sqp_linesearch=2),
    "best_of_passes": dict(sqp_best_of_passes=True),
    "multistart": dict(sqp_multistart=True),
    "jac_period": dict(sqp_jac_period=2),
    "linesearch_best": dict(sqp_linesearch=2, sqp_best_of_passes=True),
    "linear_update": dict(sqp_update="linear"),
    "linear_update_best": dict(sqp_update="linear", sqp_best_of_passes=True),
}
REGIME_REFS = ASSETS / "nmpc_regime_refs.json"
# the bilinear controller off the lift-fused route, each on top of
# BENCH_MPC: iterated relinearization (pass 0 assembly-fused and blocked,
# pass 1 re-rolled), and the unblocked stack the MATLAB reference runs
# (Ksim.m:210), without and with smoothness rows (dense A^T D A).  On this
# corpus's model the JAX general runner (x64, CPU, B=16 x 301 blockM
# steps) keeps every lane of the unblocked stack from qp_iters=6 on
# (0.75 alive at 4), and of the smooth stack at 12 (all lanes lost from
# step 3 at 4, 0.8125 alive at 8 with smoothness 1.0); 8 is two above
# the 16-lane edge, because iteration floors move with batch size and
# precision.
BILINEAR_ROUTES = {
    "iters2": dict(bilinear_iters=2),
    "unblocked": dict(input_blocks=None, qp_iters=8),
    "unblocked_smooth": dict(input_blocks=None, input_smoothConst=0.1,
                             qp_iters=12),
}
BILINEAR_ROUTE_REFS = ASSETS / "bilinear_route_refs.json"
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


def nmpc_lanes(B: int, seed: int):
    """NMPC test lanes, f64 lanes-minor: scaled outputs of random arm
    states (nz, B), random previous inputs inside the bounds (m, B) and
    the sqrt(Q)-scaled blockM reference windows of random steps (p, B),
    built by the port."""
    from koopman_realizations_torch.config import ArmConfig as TArm
    from koopman_realizations_torch.config import MpcConfig as TMpc
    from koopman_realizations_torch.control.kmpc import NonlinearKmpc
    from koopman_realizations_torch.control.ksim import Ksim
    from koopman_realizations_torch.models.arm import Arm
    from koopman_realizations_torch.utils.checkpoint import load_model
    from koopman_realizations_torch.utils.trajectories import (
        blockM_reference,
    )
    model, scaler, _ = load_model(NONLINEAR_ASSET)
    mpc = NonlinearKmpc(model, scaler, TMpc(**NMPC_MPC), device="cpu",
                        dtype=torch.float64)
    arm = Arm(TArm(**BENCH_ARM), device="cpu")
    rng = np.random.default_rng(seed)
    X = np.zeros((6, B))
    X[:3] = rng.uniform(-0.4, 0.4, (3, B))
    X[3:] = rng.normal(0, 0.3, (3, B))
    zeta = scaler.y_down(arm.get_y(torch.from_numpy(X)), axis=0).double()
    up = torch.from_numpy(rng.uniform(-0.6, 0.6, (3, B)))
    wins = Ksim(arm, mpc, device="cpu").reference_windows(
        blockM_reference(), 300)
    sq = wins[torch.from_numpy(rng.integers(0, 299, B))].T.contiguous()
    return zeta, up, sq


def bilinear_lanes(port, B: int, seed: int):
    """Bilinear controller test lanes, f64 lanes-minor, for the port's
    controller ``port``: the lifted states of random arm states' scaled
    outputs (NL, B), previous inputs inside the bounds (m, B), a
    near-held previous plan (Np*m, B), positive multipliers in original
    units (mc, B), and the blockM reference windows of random steps --
    unscaled (B, Np+1, nproj) for JAX and sqrt(Q)-scaled (p, B) for the
    port."""
    from koopman_realizations_torch.config import ArmConfig as TArm
    from koopman_realizations_torch.models.arm import Arm
    rng = np.random.default_rng(seed)
    arm = Arm(TArm(**BENCH_ARM), device="cpu")
    X = np.zeros((6, B))
    X[:3] = rng.uniform(-0.4, 0.4, (3, B))
    X[3:] = rng.normal(0, 0.3, (3, B))
    zeta = port.scaler.y_down(arm.get_y(torch.from_numpy(X)), axis=0)
    up = torch.from_numpy(rng.uniform(-0.6, 0.6, (3, B)))
    U = up.repeat(port.Np, 1) + torch.from_numpy(
        rng.normal(0, 0.01, (port.Np * 3, B)))
    lam = torch.from_numpy(np.exp(rng.normal(-1.0, 1.0, (port.n_con, B))))
    ref = port.scaler.ref_down(blockM_y(), port.proj_idx)
    ks = rng.integers(0, ref.shape[0] - port.Np - 1, B)
    refhor = np.stack([ref[k:k + port.Np + 1] for k in ks])
    sqYr = torch.from_numpy(port.sqq[:, None] * refhor.reshape(B, -1).T)
    return port.lift(zeta.double()), up, U, lam, refhor, sqYr


@pytest.fixture
def one_thread():
    """The port's CPU tests run B <= 16 lanes, whose tensors are tiny: one
    thread runs them faster than the pool (measured ~2x on the closed
    loops); the count is restored afterwards.  Test modules use it with
    ``pytestmark = pytest.mark.usefixtures("one_thread")`` after importing
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lane_errors(Yp, ref_y, steps: int):
    """Per-lane mean tracking error, as bench.py:159-165."""
    Yl = np.asarray(Yp, np.float64)
    Rl = np.asarray(ref_y, np.float32)[None, : steps - 1].astype(np.float64)
    return np.sqrt(((Yl - Rl) ** 2).sum(-1)).mean(axis=1)


MODELS = {"bilinear": (ASSET, BENCH_MPC),
          "linear": (LINEAR_ASSET, LINEAR_MPC),
          "nonlinear": (NONLINEAR_ASSET, NMPC_MPC)}
# PCA threshold of each model's training (SysidConfig.pca_explained; the
# JAX default 99 for the condensed controllers)
PCA_EXPLAINED = {"bilinear": 99.0, "linear": 99.0, "nonlinear": 99.99}


@functools.lru_cache(maxsize=None)
def jax_model(kind: str = "bilinear"):
    """(model, scaler) of a committed asset, through the JAX loader."""
    from koopman_realizations_tpu.utils.checkpoint import load_model
    return load_model(str(MODELS[kind][0]))


@functools.lru_cache(maxsize=None)
def jax_bench(kind: str = "bilinear"):
    """(Ksim, controller, Arm) of the JAX package: the bench controller on
    the bilinear asset, the linear controller on the linear one, or the
    SQP NMPC controller on the nonlinear one (cached per process: the
    NMPC controller's first run compiles for tens of seconds)."""
    from koopman_realizations_tpu.control import Ksim, make_kmpc
    from koopman_realizations_tpu.models.arm import Arm
    model, scaler = jax_model(kind)
    mpc = make_kmpc(model, scaler, MpcConfig(**MODELS[kind][1]))
    arm = Arm(ArmConfig(**BENCH_ARM))
    return Ksim(arm, mpc), mpc, arm


@functools.lru_cache(maxsize=None)
def jax_nmpc(**knobs):
    """(Ksim, controller) of the JAX package: the SQP NMPC controller on
    the nonlinear asset with the SQP ``knobs`` (an entry of
    ``NMPC_REGIMES``, or any other) on top of ``NMPC_MPC``."""
    from koopman_realizations_tpu.control import Ksim, make_kmpc
    from koopman_realizations_tpu.models.arm import Arm
    model, scaler = jax_model("nonlinear")
    mpc = make_kmpc(model, scaler, MpcConfig(**NMPC_MPC, **knobs))
    return Ksim(Arm(ArmConfig(**BENCH_ARM)), mpc), mpc


@functools.lru_cache(maxsize=None)
def generate_corpus():
    from examples.generate_arm_data import generate
    return generate(CORPUS["trials"], CORPUS["tf"], n_val=CORPUS["n_val"],
                    seed=CORPUS["seed"])


def write_corpus(path: Path = CORPUS_ASSET) -> dict:
    """Write the generated corpus's f64 t, y, u of every trial to ``path``
    (see module doc); returns its header."""
    ds = generate_corpus()
    header = {
        "recipe": "examples/generate_arm_data.py:generate"
                  "(15, 60.0, n_val=5, seed=0), JAX x64 session on the CPU",
        "written_by": "python tests/test_torch_oracle.py --write-corpus",
        "fields": "t [T], y [T, n], u [T, m] of each trial, f64 (x and w "
                  "left out)",
        "split": {"train": len(ds.train), "val": len(ds.val)},
        "params": ds.params}
    arrays = {f"{split}{i}_{f}": np.asarray(getattr(tr, f), np.float64)
              for split in ("train", "val")
              for i, tr in enumerate(getattr(ds, split))
              for f in ("t", "y", "u")}
    np.savez(path, header=json.dumps(header), **arrays)
    return header


def train_jax(ds, kind: str = "bilinear"):
    from koopman_realizations_tpu.models.edmd import Ksysid
    return Ksysid(ds, SysidConfig(model_type=kind, obs_type=("poly",),
                                  obs_degree=(3,), dim_red=True,
                                  pca_explained=PCA_EXPLAINED[kind],
                                  dtype="float32")).train_models()


def one_step_predictions(model, valdata) -> np.ndarray:
    """Scaled one-step output predictions C (A z + B u) (linear) or
    C (A z + Beta(z) u) (bilinear) over every validation step -- invariant
    to PCA component signs."""
    out = []
    for tr in valdata:
        zeta = np.asarray(tr.y, np.float64)[:-1]
        u = np.asarray(tr.u, np.float64)[:-1]
        z = np.asarray(jax.vmap(model.basis.lift)(zeta), np.float64)
        A = np.asarray(model.A, np.float64)
        Bm = np.asarray(model.B, np.float64)
        C = np.asarray(model.C, np.float64)
        if Bm.ndim == 2:
            z1 = z @ A.T + u @ Bm.T
        else:
            z1 = z @ A.T + np.einsum("kmj,tj,tm->tk", Bm, z, u)
        out.append(z1 @ C.T)
    return np.concatenate(out)


@functools.lru_cache(maxsize=None)
def jax_general_run(B: int, steps: int, kind: str = "bilinear"):
    """The JAX general runner on one asset: (Yp, alive) as numpy."""
    sim, _, _ = jax_bench(kind)
    run = sim.batched_runner(blockM_y(), steps=steps, record=("Yp", "alive"))
    out = jax.block_until_ready(
        run(bench_X0(B), np.zeros((B, 2), np.float32)))
    return np.asarray(out["Yp"]), np.asarray(out["alive"])


def write_assets(kinds=tuple(MODELS)) -> dict:
    """Train on the generated corpus and write the assets of ``kinds``
    (see module doc); returns their headers."""
    from koopman_realizations_tpu.utils.checkpoint import save_model
    ds = generate_corpus()
    headers = {}
    for kind in kinds:
        path, mpc_cfg = MODELS[kind]
        ks = train_jax(ds, kind)
        path.parent.mkdir(parents=True, exist_ok=True)
        save_model(str(path), ks.model, ks.scaler, overwrite=True)
        jax_model.cache_clear()
        jax_bench.cache_clear()
        jax_general_run.cache_clear()
        Yp, alive = jax_general_run(REF_B, REF_STEPS, kind)
        err = lane_errors(Yp, blockM_y(), REF_STEPS)
        data = dict(np.load(path, allow_pickle=False))
        header = json.loads(str(data.pop("header")))
        header["provenance"] = {
            "corpus": "examples/generate_arm_data.py:generate"
                      "(15, 60.0, n_val=5, seed=0)",
            "sysid": f"Ksysid {kind} poly-3 dim_red=True "
                     + ("pca_explained=99.99 " if kind == "nonlinear"
                        else "")
                     + "dtype=float32",
            "written_by": "python tests/test_torch_oracle.py --write-asset"
                          + (" nonlinear" if kind == "nonlinear" else ""),
        }
        header["jax_reference"] = {
            "runner": "Ksim.batched_runner (x64 session, CPU)",
            "controller": f"qp_iters={mpc_cfg['qp_iters']} "
                          f"qp_dual_warm={mpc_cfg['qp_dual_warm']}"
                          + (f" sqp_iters={MpcConfig().sqp_iters}"
                             if kind == "nonlinear" else ""),
            "B": REF_B, "steps": REF_STEPS,
            "alive": float(alive[:, -1].mean()),
            "err_mean": float(err.mean()), "err_worst": float(err.max()),
        }
        np.savez(path, header=json.dumps(header), **data)
        headers[path.name] = header
    return headers


@functools.lru_cache(maxsize=None)
def jax_bilinear(**knobs):
    """(Ksim, controller) of the JAX package: the bilinear controller on
    the bilinear asset with ``knobs`` (an entry of ``BILINEAR_ROUTES``, or
    any other) on top of ``BENCH_MPC``."""
    from koopman_realizations_tpu.control import Ksim, make_kmpc
    from koopman_realizations_tpu.models.arm import Arm
    model, scaler = jax_model("bilinear")
    mpc = make_kmpc(model, scaler, MpcConfig(**{**BENCH_MPC, **knobs}))
    return Ksim(Arm(ArmConfig(**BENCH_ARM)), mpc), mpc


def _write_refs(configs: dict, sim_of, asset: str, path: Path,
                flag: str) -> dict:
    """Run the JAX general runner (x64, CPU, B=16 over 301 blockM steps,
    the bench's initial states) in each configuration and write err_mean,
    err_worst, alive and the full controller configuration of each to
    ``path`` under "regimes"; the model assets are not touched."""
    import dataclasses
    regimes = {}
    for name, knobs in configs.items():
        sim, mpc = sim_of(**knobs)
        run = sim.batched_runner(blockM_y(), steps=REF_STEPS,
                                 record=("Yp", "alive"))
        out = jax.block_until_ready(
            run(bench_X0(REF_B), np.zeros((REF_B, 2), np.float32)))
        err = lane_errors(np.asarray(out["Yp"]), blockM_y(), REF_STEPS)
        regimes[name] = {
            "knobs": knobs,
            "config": dataclasses.asdict(mpc.cfg),
            "alive": float(np.asarray(out["alive"])[:, -1].mean()),
            "err_mean": float(err.mean()), "err_worst": float(err.max())}
        print(name, regimes[name]["alive"], regimes[name]["err_mean"],
              flush=True)
    refs = {
        "runner": "koopman_realizations_tpu Ksim.batched_runner "
                  f"(jax_enable_x64, CPU) on assets/{asset}",
        "written_by": f"python tests/test_torch_oracle.py {flag}",
        "B": REF_B, "steps": REF_STEPS,
        "X0": "first joint spread over +-0.2 rad (bench_X0)",
        "reference": "blockM([0.45, -0.35], 0.5, 0.5), T=15, Ts=0.05",
        "regimes": regimes}
    path.write_text(json.dumps(refs, indent=1) + "\n")
    return refs


def write_regime_refs() -> dict:
    """The JAX quality of each SQP regime of ``NMPC_REGIMES`` on the
    nonlinear asset, in ``REGIME_REFS``."""
    return _write_refs(NMPC_REGIMES, jax_nmpc, NONLINEAR_ASSET.name,
                       REGIME_REFS, "--write-regime-refs")


def write_bilinear_refs() -> dict:
    """The JAX quality of each configuration of ``BILINEAR_ROUTES`` on the
    bilinear asset, in ``BILINEAR_ROUTE_REFS``."""
    return _write_refs(BILINEAR_ROUTES, jax_bilinear, ASSET.name,
                       BILINEAR_ROUTE_REFS, "--write-bilinear-refs")


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


def test_linear_asset_loads_identically_in_both_packages():
    from koopman_realizations_torch.models.koopman import LinearModel
    from koopman_realizations_torch.utils.checkpoint import (
        LINEAR_MODEL,
        load_model,
    )
    jm, js = jax_model("linear")
    tm, ts, header = load_model(LINEAR_MODEL)
    assert isinstance(tm, LinearModel) and tm.B.shape == (28, 3)
    for name in ("A", "B", "C"):
        np.testing.assert_array_equal(np.asarray(getattr(jm, name)),
                                      getattr(tm, name))
    np.testing.assert_array_equal(np.asarray(jm.basis.pcs), tm.basis.pcs)
    for name in ("y_factor", "y_offset", "u_factor", "u_offset"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name))
    assert tm.meta.NL == jm.meta.NL == 28
    assert tm.meta.model_type == "linear"
    assert tm.basis.families == jm.basis.families
    ref = header["jax_reference"]
    assert ref["alive"] == 1.0
    assert ref["controller"] == "qp_iters=6 qp_dual_warm=False"


def test_linear_asset_provenance_retrain():
    """Retraining the linear model on the generated corpus reproduces the
    linear asset's one-step predictions C (A z + B u)."""
    ks = train_jax(generate_corpus(), "linear")
    jm, js = jax_model("linear")
    for k in ("y_factor", "y_offset", "u_factor", "u_offset"):
        np.testing.assert_allclose(np.asarray(getattr(ks.scaler, k)),
                                   np.asarray(getattr(js, k)), rtol=1e-12)
    p_new = one_step_predictions(ks.model, ks.valdata)
    p_asset = one_step_predictions(jm, ks.valdata)
    assert np.abs(p_new - p_asset).max() < 1e-5



def test_corpus_asset_matches_generator():
    """The committed corpus the port trains on is the generator's: t, y
    and u of every train and validation trial bitwise, the same split and
    params."""
    from koopman_realizations_torch.utils.data import CORPUS, load_corpus
    assert CORPUS == CORPUS_ASSET
    ds, committed = generate_corpus(), load_corpus(CORPUS)
    assert committed.params == ds.params
    for split in ("train", "val"):
        gen, com = getattr(ds, split), getattr(committed, split)
        assert len(com) == len(gen)
        for tg, tc in zip(gen, com):
            for f in ("t", "y", "u"):
                np.testing.assert_array_equal(getattr(tc, f),
                                              np.asarray(getattr(tg, f)))
                assert getattr(tc, f).dtype == np.float64

if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write-asset", nargs="*", choices=tuple(MODELS),
                    metavar="KIND",
                    help="retrain and rewrite the committed model assets of "
                         "these kinds (all of them when none is named)")
    ap.add_argument("--write-corpus", action="store_true",
                    help="write the generated corpus's t, y, u to "
                         "assets/arm3_corpus.npz")
    ap.add_argument("--write-regime-refs", action="store_true",
                    help="record the JAX general runner's quality in every "
                         "SQP regime of NMPC_REGIMES (nmpc_regime_refs.json)")
    ap.add_argument("--write-bilinear-refs", action="store_true",
                    help="record the JAX general runner's quality in every "
                         "bilinear configuration of BILINEAR_ROUTES "
                         "(bilinear_route_refs.json)")
    args = ap.parse_args()
    if args.write_asset is None and not (args.write_corpus
                                         or args.write_regime_refs
                                         or args.write_bilinear_refs):
        ap.error("nothing to do (pass --write-asset, --write-corpus, "
                 "--write-regime-refs or --write-bilinear-refs)")
    if args.write_corpus:
        print(json.dumps(write_corpus(), indent=1))
    if args.write_asset is not None:
        print(json.dumps(write_assets(tuple(args.write_asset)
                                      or tuple(MODELS)), indent=1))
    if args.write_regime_refs:
        print(json.dumps(write_regime_refs(), indent=1))
    if args.write_bilinear_refs:
        print(json.dumps(write_bilinear_refs(), indent=1))
