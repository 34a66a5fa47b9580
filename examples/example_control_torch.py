"""Closed-loop trajectory tracking with K-MPC, K-BMPC and K-NMPC on the
blockM trajectory with the PyTorch port (reference ``example_control.m``),
beside the reference's results where its files exist.

Run:  python examples/example_control_torch.py [--datafile FILE.mat]
      [--reffile FILE.mat] [--steps N] [--batch B] [--device cuda|cpu]

The models train on the ``data4sysid`` datafile (the reference's arm
datafile under ``$REFERENCE_DIR`` by default; see
``example_sysid_torch.py``).  The reference
trajectory is the reference's blockM file where it exists, a
``--reffile`` (``utils/matio.py:save_ref_trajectory`` layout), or else
the blockM built in the repository (``utils/trajectories.py``).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from examples.example_sysid_torch import (  # noqa: E402
    DEFAULT_DATA,
    REFERENCE_DIR,
    datafile,
)
from koopman_realizations_torch.config import (  # noqa: E402
    ArmConfig,
    MpcConfig,
    SysidConfig,
)
from koopman_realizations_torch.control.kmpc import make_kmpc  # noqa: E402
from koopman_realizations_torch.control.ksim import Ksim  # noqa: E402
from koopman_realizations_torch.models.arm import Arm  # noqa: E402
from koopman_realizations_torch.models.edmd import Ksysid  # noqa: E402
from koopman_realizations_torch.utils.matio import (  # noqa: E402
    load_data4sysid,
    load_ref_trajectory,
    load_sim_results,
)
from koopman_realizations_torch.utils.trajectories import (  # noqa: E402
    blockM_reference,
)

REF_FILE = os.path.join(REFERENCE_DIR, "trajectories", "files",
                        "blockM_c0p45-0p35_0p5x0p5_15sec.mat")
GOLD = os.path.join(REFERENCE_DIR, "systems",
                    "thesis-arm-markers_noload_3-mods_1-links_20hz",
                    "simulations", "blockM_c0p45-0p35_0p5x0p5_15sec")
GOLD_FILES = {
    "linear": "linear_poly-3_n-6_m-3_del-0_2020-06-09_16-42.mat",
    "bilinear": "bilinear_poly-3_n-6_m-3_del-0_2020-06-09_16-43.mat",
    "nonlinear": "nonlinear_poly-3_n-6_m-3_del-0_2020-06-13_14-10.mat",
}


def reference_rows(path) -> np.ndarray:
    """The blockM rows (K, 2): ``path``, the reference's file, or the
    in-repo blockM."""
    if path:
        return load_ref_trajectory(path)["y"]
    if os.path.exists(REF_FILE):
        return load_ref_trajectory(REF_FILE)["y"]
    print(f"{REF_FILE} is missing: the blockM built in the repository")
    return blockM_reference()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--datafile", default=None,
                    help=f"data4sysid .mat file (default {DEFAULT_DATA})")
    ap.add_argument("--reffile", default=None,
                    help="reference trajectory .mat file")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=0,
                    help="also run a batch of B perturbed scenarios")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    data = load_data4sysid(datafile(args.datafile, DEFAULT_DATA,
                                    "the datafile"))
    ref = reference_rows(args.reffile)
    arm = Arm(ArmConfig(Nmods=3, nlinks=1, L=1.0, m=0.1,
                        output_type="markers", substeps=5),
              device=args.device)
    mpc_cfg = MpcConfig(
        horizon=10, input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8),
        input_slopeConst=1e-1, cost_running=10.0, cost_terminal=100.0,
        cost_input=(0.1 * 3e-2, 0.1 * 2e-2, 0.1 * 1e-2), proj_idx=(4, 5))
    out = {}
    for model_type in ("linear", "bilinear", "nonlinear"):
        # nonlinear: 99.99 % PCA keeps the vector field accurate enough
        # for the SQP transient
        pca = 99.99 if model_type == "nonlinear" else 99.0
        ks = Ksysid(data, SysidConfig(model_type=model_type,
                                      obs_type=("poly",), obs_degree=(3,),
                                      dim_red=True, pca_explained=pca),
                    device=args.device).train_models()
        sim = Ksim(arm, make_kmpc(ks.model, ks.scaler, mpc_cfg,
                                  device=args.device), device=args.device)
        t0 = time.time()
        res = sim.run_trial_mpc(ref, steps=args.steps)
        dt = time.time() - t0
        line = (f"{model_type:9s}: err mean {res['err'].mean():.4f} "
                f"max {res['err'].max():.4f}  "
                f"({res['err'].shape[0]} steps, {dt:.1f}s)")
        gold_path = os.path.join(GOLD, GOLD_FILES[model_type])
        if os.path.exists(gold_path):
            g = load_sim_results(gold_path)
            line += (f"   [reference: mean {g['err'].mean():.4f} "
                     f"max {g['err'].max():.4f}]")
        print(line)
        out[model_type] = res
        if args.batch and model_type == "bilinear":
            X0 = np.zeros((args.batch, 6))
            X0[:, :3] = np.random.default_rng(0).uniform(
                -0.2, 0.2, (args.batch, 3))
            t0 = time.time()
            b = sim.run_batch(ref, X0, steps=args.steps)
            dt = time.time() - t0
            n_steps = b["err"].shape[0] * b["err"].shape[1]
            print(f"  batch {args.batch}: {n_steps / dt:,.0f} MPC steps/s, "
                  f"err mean {b['err'].mean():.4f}, "
                  f"alive {b['alive'][:, -1].mean():.2f}")
            out["batch"] = b
    return out


if __name__ == "__main__":
    main()
