"""Model-class comparison over random-system ensembles with the PyTorch
port (reference ``evaluate_rand_models.m``): 13 linear + 6 bilinear + 4
nonlinear model fits per system, every system of a configuration trained
at once.

Run:  python examples/evaluate_rand_models_torch.py [--folder DIR]
      [--generate S] [--device cuda|cpu]

``--folder`` is a ``rand-systems_*`` folder holding an ``rsys-all_*.mat``
ensemble (``utils/matio.py:save_rsys_ensemble`` writes one); without it
the first folder of at least 20 systems under ``$REFERENCE_DIR``'s
datafiles is read where it exists.  ``--generate S`` draws S fresh random systems instead.
"""

import argparse
import glob
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from koopman_realizations_torch.models.rsys import (  # noqa: E402
    construct_systems,
    simulate_systems,
)
from koopman_realizations_torch.utils.matio import load_rsys_all  # noqa: E402
from koopman_realizations_torch.workflows import evaluate_rand_models  # noqa: E402

from examples.example_sysid_torch import REFERENCE_DIR  # noqa: E402

REF_FOLDERS = os.path.join(REFERENCE_DIR, "datafiles", "rand-systems_*")


def ensemble(folder):
    """(folder, DataSets) of ``folder``'s ``rsys-all_*.mat``, or of the
    first reference folder with at least 20 systems; (folder, None) when
    there is none."""
    for cand in [folder] if folder else sorted(glob.glob(REF_FOLDERS)):
        files = glob.glob(os.path.join(cand, "rsys-all_*.mat"))
        if files:
            loaded = load_rsys_all(files[0])
            if folder or len(loaded) >= 20:
                return cand, loaded
    return folder or REF_FOLDERS, None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--folder", default=None,
                    help="rand-systems_* folder with an rsys-all_*.mat")
    ap.add_argument("--generate", type=int, default=0,
                    help="instead, generate this many fresh random systems")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.generate:
        rng = np.random.default_rng(0)
        ens = construct_systems(args.generate, num_terms=5, degree_x=4,
                                degree_u=1, rng=rng)
        datasets = simulate_systems(ens, t_end=50.0, Ts=0.05, num_trials=11,
                                    rng=rng, device=args.device)
        print(f"generated {args.generate} random systems")
    else:
        folder, datasets = ensemble(args.folder)
        if datasets is None:
            sys.exit(f"no rsys-all_*.mat ensemble in {folder} (it is "
                     f"missing); pass --folder or --generate N")
        print(f"loaded {len(datasets)} systems from {folder}")

    t0 = time.time()
    out = evaluate_rand_models(datasets, device=args.device)
    n_fits = (13 + 6 + 4) * len(datasets)
    print(f"{n_fits} model fits in {time.time() - t0:.1f}s")
    for fam in ("linear", "bilinear", "nonlinear"):
        o = out[fam]
        print(f"\n{fam} (kept {o['kept']}/{len(datasets)} systems):")
        for d, e in zip(o["dims"], o["median"]):
            bar = "#" * int(min(e, 1.0) * 50)
            print(f"  N={d:3d}  median normed err {e:8.4f}  {bar}")
    return out


if __name__ == "__main__":
    main()
