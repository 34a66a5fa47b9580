"""The f64 B=16 x 301 closed loops of phase DX's paths ``del1``,
``nopca``, ``fs1`` and ``mix`` on the CPU against the JAX x64 references
of ``assets/dictionary_refs.json`` (written by
``python tests/test_torch_oracle.py --write-dictionaries``), the port's
bilinear controllers with the JAX controller's f32-rounded constants
(``test_torch_delays.py:port_sim``).

Tolerances, each with what it was measured at: the 16-lane err_mean
within 1e-5 of JAX x64's, alive equal (measured 9.9e-6 nopca, 8.4e-7
fs1, 6.4e-6 mix).  Single lanes part by up to 9e-4 (nopca): the two
packages' f64 arm periods differ by ~5e-11 from the first step and these
loops amplify it.  The delayed loop flips lanes; it is held as phase DX3
holds the card (see its test).
"""

import json

import numpy as np
import pytest

from koopman_realizations_torch.utils.trajectories import blockM_reference

from chip_smoke import dict_alive_gate, dict_lane_gate
from test_torch_delays import port_sim
from test_torch_oracle import (
    DICT_REFS,
    blockM_y,
    jax_dict_lanes,
    lane_errors,
    one_thread,  # noqa: F401  (fixture)
)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("path", ["del1", "nopca", "fs1", "mix"])
def test_f64_loops_match_the_refs(path):
    """The 16-lane err_mean within 1e-5 of JAX x64's, alive equal.  The
    delayed loop ``del1`` at its qp_iters of 11 (the edge: 10 keeps 9 of
    16 lanes) is chaotic: the two packages' f64 arm periods part by
    ~5e-11 from the first step, and that grows until a lane's survival
    flips (here from step ~42; 16-lane err_mean 3.7e-3 from x64).  It is
    held as phase DX3 holds the card: each lane alive as JAX's x64 or one
    of JAX's own f32 runs, its err_mean within 1e-3 of the hull of x64's
    and the JAX f32 band (``chip_smoke.dict_lane_gate``)."""
    refs = json.loads(DICT_REFS.read_text())
    r = refs["paths"][path]
    sim, mpc = port_sim(path, r["qp_iters"])
    X0, W = jax_dict_lanes(path, refs["B"])
    out = sim.batched_runner(blockM_reference(), steps=refs["steps"])(X0, W)
    e = lane_errors(out["Yp"].numpy(), blockM_y(), refs["steps"])
    alive = out["alive"][:, -1].numpy()
    if path == "del1":
        assert dict_alive_gate(alive, r)
        assert dict_lane_gate(e, r)[0], dict_lane_gate(e, r)[1:]
        return
    assert (alive == np.asarray(r["alive"])).all()
    assert abs(e.mean() - np.mean(r["err_mean"])) < 1e-5
