"""Sampling-grid construction (wavenumber, radius, impact parameter, temp).

Reference: transit/src/makesample.c.  All grids are built host-side with
static shapes — grid sizes become compile-time constants of the jitted
kernels.  The value arrays match the reference bit-for-bit (same
``i + k*delta`` fill in double precision, makesample.c:100-104).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Sampling:
    """Mirror of prop_samp (structures_tr.h:14-22)."""
    i: float            # initial value
    f: float            # final value
    d: float            # spacing (pre-oversampling)
    o: int              # oversampling factor
    v: np.ndarray       # sample values
    fct: float = 1.0    # units factor to cgs

    @property
    def n(self):
        return self.v.shape[0]


def _fill(i: float, delta: float, n: int) -> np.ndarray:
    # v[k] = i + k*delta, evaluated exactly as the C loop does:
    return i + np.arange(n, dtype=np.float64) * delta


def make_sampling(ini: float, fin: float, delta: float, osamp: int = 1,
                  fct: float = 1.0) -> Sampling:
    """makesample1 with spacing-driven sampling (makesample.c:77-104)."""
    okexcess = 1e-8 if delta > 0 else -1e-8
    n = int(((1.0 + okexcess) * fin - ini) / delta + 1)
    if n < 0:
        n = -n
    n = (n - 1) * osamp + 1
    osd = delta / float(osamp)
    return Sampling(i=ini, f=fin, d=delta, o=osamp, v=_fill(ini, osd, n),
                    fct=fct)


def make_wn_sampling(wnlow: float = 0.0, wnhigh: float = 0.0,
                     wllow: float = 0.0, wlhigh: float = 0.0,
                     wndelt: float = 1.0, wnosamp: int = 2160,
                     wnfct: float = 1.0, wlfct: float = 1e-4):
    """makewnsample (makesample.c:308-400): returns (wns, owns).

    Wavenumber limits come from wnlow/wnhigh if positive, else from the
    wavelength limits (1/wl).  Internally always cm-1.
    """
    if wnlow > 0:
        ini = wnlow * wnfct
    elif wlhigh > 0:
        ini = 1.0 / (wlhigh * wlfct)
    else:
        raise ValueError("initial wavenumber not provided")
    if wnhigh > 0:
        fin = wnhigh * wnfct
    elif wllow > 0:
        fin = 1.0 / (wllow * wlfct)
    else:
        raise ValueError("final wavenumber not provided")
    if wndelt <= 0:
        raise ValueError("wavenumber spacing must be positive")
    owns = make_sampling(ini, fin, wndelt, wnosamp)
    wns = make_sampling(ini, fin, wndelt, 1)
    return wns, owns


def make_temp_sampling(tlow: float = 500.0, thigh: float = 3000.0,
                       tempdelt: float = 100.0) -> Sampling:
    """maketempsample (makesample.c:613-636) for the opacity grid."""
    return make_sampling(tlow, thigh, tempdelt, 1)


def make_ip_sampling(rads: Sampling) -> Sampling:
    """makeipsample, default path (makesample.c:564-574): the impact
    parameter grid is the reversed radius grid."""
    return Sampling(i=rads.f, f=rads.i, d=0.0, o=0,
                    v=rads.v[::-1].copy(), fct=rads.fct)


def divisors(n: int):
    """Exact divisors of n (pu/src/iomisc.c:1113-1131)."""
    return np.array([i for i in range(1, n + 1) if n % i == 0],
                    dtype=np.int64)
