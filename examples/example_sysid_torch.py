"""Train linear, bilinear and nonlinear Koopman realizations of the
3-link arm with the PyTorch port and compare their validation rollouts
(reference ``example_sysid.m``).

Run:  python examples/example_sysid_torch.py [--datafile FILE.mat]
      [--save DIR] [--device cuda|cpu]

The datafile is a ``data4sysid`` .mat file (the reference's, or one that
``examples/generate_arm_data_torch.py --out`` wrote); without
``--datafile`` the reference's arm datafile is read from the MATLAB
reference tree at ``$REFERENCE_DIR`` where it exists.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from koopman_realizations_torch.config import SysidConfig  # noqa: E402
from koopman_realizations_torch.models.edmd import Ksysid  # noqa: E402
from koopman_realizations_torch.utils.checkpoint import save_model  # noqa: E402
from koopman_realizations_torch.utils.matio import load_data4sysid  # noqa: E402
from koopman_realizations_torch.utils.naming import model_classname  # noqa: E402

# the MATLAB reference tree (its datafiles, trajectories and results)
REFERENCE_DIR = os.environ.get("REFERENCE_DIR", "reference")
DEFAULT_DATA = os.path.join(
    REFERENCE_DIR, "datafiles",
    "arm-3link-markers-noload-50trials_train-10_val-5.mat")


def datafile(path, default: str, what: str) -> str:
    """The file to read: ``path``, else ``default`` where it exists; a
    missing one ends the script saying so."""
    path = path or default
    if not os.path.exists(path):
        sys.exit(f"{what} {path} is missing; pass one (e.g. written by "
                 f"examples/generate_arm_data_torch.py --out FILE.mat)")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--datafile", default=None,
                    help=f"data4sysid .mat file (default {DEFAULT_DATA})")
    ap.add_argument("--save", default=None, help="directory to save models")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    data = load_data4sysid(datafile(args.datafile, DEFAULT_DATA,
                                    "the datafile"))
    models = {}
    for model_type in ("linear", "bilinear", "nonlinear"):
        cfg = SysidConfig(model_type=model_type, obs_type=("poly",),
                          obs_degree=(3,), dim_red=True)
        ks = Ksysid(data, cfg, device=args.device).train_models()
        err = ks.val_model(ks.model, ks.valdata[0])["error"]
        print(f"{model_type:9s}: N={ks.N:3d}  "
              f"NRMSE={np.round(np.asarray(err['nrmse']), 4)}  "
              f"mean euclid={float(err['euclid_mean']):.4f}")
        models[model_type] = ks
        if args.save:
            name = model_classname(model_type, "poly", 3, ks.n, ks.m, ks.nd)
            path = save_model(os.path.join(args.save, name), ks.model,
                              scaler=ks.scaler)
            print(f"          saved -> {path}")
    return models


if __name__ == "__main__":
    main()
