"""Generate an arm training corpus with the PyTorch port (reference
``Arm_setup.m`` + ``Arm.simulate_rampNhold`` + ``Data.get_data4sysid``):
every excitation trial steps at once as a lane of one batch, on the card
by default.

Run:  python examples/generate_arm_data_torch.py [--trials 15] [--tf 60]
      [--val 5] [--seed 0] [--out FILE.mat] [--device cuda|cpu]

``--out`` writes the reference's ``data4sysid`` layout
(``utils/matio.py:save_data4sysid``), which ``load_data4sysid`` and
``examples/example_sysid_torch.py --datafile`` read.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from koopman_realizations_torch.utils.matio import save_data4sysid  # noqa: E402
from koopman_realizations_torch.workflows.arm_data import generate  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=15)
    ap.add_argument("--tf", type=float, default=60.0)
    ap.add_argument("--val", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help=".mat file to write")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ds = generate(args.trials, args.tf, n_val=args.val, seed=args.seed,
                  device=args.device)
    print(f"generated {len(ds.train)} train + {len(ds.val)} val trials, "
          f"T={ds.train[0].T}, y dim {ds.train[0].n}")
    if args.out:
        save_data4sysid(args.out, ds)
        print("saved ->", args.out)
    return ds


if __name__ == "__main__":
    main()
