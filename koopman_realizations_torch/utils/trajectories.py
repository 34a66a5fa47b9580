"""Reference trajectory generators (numpy; port of the JAX package's
``utils/trajectories.py``: ``get_blockM``, ``get_circle``,
``get_pacman``, ``get_polygon`` and ``make_trajectory``)."""

from __future__ import annotations

import numpy as np

__all__ = ["get_blockM", "get_circle", "get_pacman", "get_polygon",
           "make_trajectory", "blockM_reference", "circle_reference"]


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


def get_circle(center, radius: float) -> np.ndarray:
    """Circle outline starting at the bottom (``functions/get_circle.m``)."""
    t = np.arange(-np.pi / 2, 3 * np.pi / 2 + 1e-12, np.pi / 50)
    return np.stack([radius * np.cos(t) + center[0],
                     radius * np.sin(t) + center[1]], axis=1)


def get_pacman(center, radius: float) -> np.ndarray:
    """Pacman outline (``functions/get_pacman.m``): the upper jaw out
    from the centre, the body from pi/6 to 2 pi - pi/6, the lower jaw
    back in."""
    center = np.asarray(center, float)
    t1 = np.arange(0, 1 + 1e-12, 1 / 30)[:, None]
    t2 = np.arange(np.pi / 6, 2 * np.pi - np.pi / 6 + 1e-12, np.pi / 50)
    mouth = np.array([radius * np.cos(np.pi / 6),
                      radius * np.sin(np.pi / 6)])
    body = np.stack([radius * np.cos(t2) + center[0],
                     radius * np.sin(t2) + center[1]], axis=1)
    jaw = np.array([radius * np.cos(-np.pi / 6),
                    radius * np.sin(-np.pi / 6)])
    return np.concatenate([center + t1 * mouth, body,
                           (center + jaw) - t1 * jaw], axis=0)


def get_polygon(vertices) -> np.ndarray:
    """The polygon's vertices as waypoints, (k, 2) floats."""
    return np.asarray(vertices, float)


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


def circle_reference() -> np.ndarray:
    """The loaded-arm experiment's circle reference (centre (0, -0.7),
    radius 0.3, y-flipped into the workspace, 15 s at 20 Hz, from the
    resting configuration (0, 1)): (301, 2) end-effector positions."""
    return make_trajectory(get_circle([0.0, -0.7], 0.3), T=15.0, Ts=0.05,
                           flip_y=True, preamble_from=(0.0, 1.0))["y"]
