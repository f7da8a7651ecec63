"""Orbital geometry: star-planet projected position.

The counterpart of transit_tpu.rt.orbit (numpy, on the host).
Reference: transit/src/geometry.c:57-99 (setgeom) — solves the Kepler
equation for the planet's orbital position at a given time.  Only the
stellar radius affects the emergent spectrum (the reference's
starvariation() is a stub, geometry.c:107-115); this module provides the
orbit solution for transit-timing uses.
"""

from __future__ import annotations

import numpy as np

from transit_tpu_torch.constants import AU, DEGREES, HOUR


def kepler_solve(M, ecc, tol=1e-12, maxiter=50):
    """Eccentric anomaly E from mean anomaly M (Newton iteration)."""
    M = np.asarray(M, dtype=np.float64)
    E = M.copy() if M.ndim else np.float64(M)
    for _ in range(maxiter):
        dE = (E - ecc * np.sin(E) - M) / (1.0 - ecc * np.cos(E))
        E = E - dE
        if np.max(np.abs(dE)) < tol:
            break
    return E


def planet_position(smaxis=1.0, time=0.0, incl=0.0, ecc=0.0,
                    long_node=0.0, arg_per=0.0, period=None,
                    smaxis_fct=AU, time_fct=HOUR, angle_fct=DEGREES):
    """Projected (x, y) position and star-planet separation (cm).

    Angles in degrees by default (gorbpar units, argum.c:308-314).
    """
    a = smaxis * smaxis_fct
    if period is None:
        period = 2.0 * np.pi  # one radian of mean anomaly per time unit
    M = 2.0 * np.pi * (time * time_fct) / (period * time_fct)
    E = kepler_solve(M, ecc)
    i = incl * angle_fct
    O = long_node * angle_fct
    w = arg_per * angle_fct
    # True anomaly and radius:
    nu = 2.0 * np.arctan2(np.sqrt(1 + ecc) * np.sin(E / 2),
                          np.sqrt(1 - ecc) * np.cos(E / 2))
    r = a * (1.0 - ecc * np.cos(E))
    # Project onto the sky plane:
    x = r * (np.cos(O) * np.cos(w + nu) -
             np.sin(O) * np.sin(w + nu) * np.cos(i))
    y = r * (np.sin(O) * np.cos(w + nu) +
             np.cos(O) * np.sin(w + nu) * np.cos(i))
    return x, y, np.hypot(x, y)
