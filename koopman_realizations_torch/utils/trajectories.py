"""Reference trajectory generators (numpy; port of the JAX package's
``utils/trajectories.py`` ``get_blockM`` and ``make_trajectory``)."""

from __future__ import annotations

import numpy as np

__all__ = ["get_blockM", "make_trajectory"]


def get_blockM(center, width: float, height: float) -> np.ndarray:
    """81-point outline of the block M (``functions/get_blockM.m``)."""
    dw = width / 18.0
    dh = height / 11.0
    o = np.zeros((81, 2))
    o[0] = np.asarray(center, float)

    def seg(i0, i1, step):
        for i in range(i0, i1):
            o[i] = o[i - 1] + step

    seg(1, 5, [dw, dh])
    seg(5, 10, [dw, 0])
    seg(10, 13, [0, -dh])
    o[13] = o[12] + [-dw, 0]
    seg(14, 19, [0, -dh])
    o[19] = o[18] + [dw, 0]
    seg(20, 23, [0, -dh])   # the MATLAB source runs its 21:23 loop twice;
    seg(20, 23, [0, -dh])   # the second pass reproduces identical values
    seg(23, 29, [-dw, 0])
    seg(29, 32, [0, dh])
    o[32] = o[31] + [dw, 0]
    seg(33, 37, [0, dh])
    seg(37, 41, [-dw, -dh])
    seg(41, 45, [-dw, dh])
    seg(45, 49, [0, -dh])
    o[49] = o[48] + [dw, 0]
    seg(50, 53, [0, -dh])
    seg(53, 59, [-dw, 0])
    seg(59, 62, [0, dh])
    o[62] = o[61] + [dw, 0]
    seg(63, 68, [0, dh])
    o[68] = o[67] + [-dw, 0]
    seg(69, 72, [0, dh])
    seg(72, 77, [dw, 0])
    seg(77, 81, [dw, -dh])
    return o


def make_trajectory(waypoints: np.ndarray, T: float, Ts: float,
                    name: str = "traj", flip_y: bool = True,
                    preamble_from=(0.0, 1.0), preamble_pts: int = 10) -> dict:
    """Assemble a ref struct from waypoints (``def_trajectory.m:24-36``):
    optional y flip, a linear ramp from the resting configuration, and
    interpolation to the control timestep.  Returns {name, T, Ts, t, y}."""
    y_old = np.asarray(waypoints, float)
    if flip_y:
        y_old = np.stack([y_old[:, 0], -y_old[:, 1]], axis=1)
    if preamble_from is not None:
        pre = np.stack(
            [np.linspace(preamble_from[0], y_old[0, 0], preamble_pts),
             np.linspace(preamble_from[1], y_old[0, 1], preamble_pts)],
            axis=1)
        y_old = np.concatenate([pre[:-1], y_old], axis=0)
    t_old = np.linspace(0.0, T, y_old.shape[0])
    t = np.arange(0.0, T + 1e-12, Ts)
    y = np.stack([np.interp(t, t_old, y_old[:, k])
                  for k in range(y_old.shape[1])], axis=1)
    return {"name": name, "T": T, "Ts": Ts, "t": t, "y": y}


def blockM_reference() -> np.ndarray:
    """The bench's blockM reference (centre (0.45, -0.35), 0.5 x 0.5, 15 s
    at 20 Hz): (301, 2) end-effector positions."""
    return make_trajectory(get_blockM([0.45, -0.35], 0.5, 0.5),
                           T=15, Ts=0.05)["y"]
