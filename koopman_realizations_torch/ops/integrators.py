"""Fixed-step RK4 (port of ``ops/integrators.py:17-34`` of the JAX
package): ``rk4_step`` and ``rk4`` over whatever tensors ``f`` maps, lanes
in their columns, a Python loop of ``substeps`` steps on the caller's
device.  The adaptive RKF45 and the generic SDIRK2 serve only the full
``models/arm.py`` and are not ported (ROADMAP.md queue 1, item 8); the
arm's SDIRK2 control period is ``models/arm_lanes.py``."""

from __future__ import annotations


def rk4_step(f, x, dt: float):
    """One classical Runge-Kutta step of dx/dt = f(x)."""
    k1 = f(x)
    k2 = f(x + 0.5 * dt * k1)
    k3 = f(x + 0.5 * dt * k2)
    k4 = f(x + dt * k3)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def rk4(f, x0, T: float, substeps: int):
    """Integrate dx/dt = f(x) over [0, T] with ``substeps`` RK4 steps."""
    dt = T / substeps
    x = x0
    for _ in range(substeps):
        x = rk4_step(f, x, dt)
    return x
