"""Eclipse (dayside emission) intensity and flux.

Reference: transit/src/eclipse.c:117-287 (eclipse_intens, flux).
Vectorized over angles and wavenumbers; the reference's per-wavenumber
tau.last early-stop becomes a mask.  The angles' tensors (mu = cos of
each angle, the flux's area weights) are made once per (angles, dtype,
device), so that a step copies nothing from the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from transit_tpu_torch.constants import H, LS, KB, PI, DEGREES


def planck(wn_cgs, temp):
    """B_nu(wavenumber) = 2 h nu^3 c^2 / (exp(h nu c / kB T) - 1),
    erg/s/sr/cm (eclipse.c:149-156)."""
    return (2.0 * H * wn_cgs ** 3 * LS * LS /
            (torch.exp(H * wn_cgs * LS / (KB * temp)) - 1.0))


@functools.lru_cache(maxsize=None)
def _angle_tables(angles: tuple, dtype, device):
    """(mus, area): cos of each raygrid angle, and the flux's area weights
    sin^2 a_{i+1} - sin^2 a_i over the grid of angle midpoints
    (eclipse.c:242-287), each (nangle,) in ``dtype`` on ``device``."""
    mus = torch.cos(torch.as_tensor(
        np.asarray(angles, dtype=np.float64) * DEGREES, dtype=dtype,
        device=device))
    an = len(angles)
    grid = np.zeros(an + 1)
    grid[0] = 0.0
    grid[an] = 90.0 * DEGREES
    for i in range(1, an):
        grid[i] = (angles[i - 1] + angles[i]) * DEGREES / 2.0
    area = np.sin(grid[1:]) ** 2 - np.sin(grid[:-1]) ** 2
    return mus, torch.as_tensor(area, dtype=dtype, device=device)


def eclipse_intensities(tau, last, wns_cgs, temp_rev, angles_deg):
    """Emergent intensity (nangle, nwn) at every raygrid angle.

    Args:
      tau: (nwn, nrad) vertical optical depth, top-down rows.
      last: (nwn,) index where tau first exceeded toomuch.
      temp_rev: (nrad,) layer temperatures from the TOP down
        (temp[rnn-1-i] in eclipse.c:155).
    """
    nwn, nrad = tau.shape
    mus = _angle_tables(tuple(angles_deg), tau.dtype, tau.device)[0]
    dtau = torch.exp(-tau[None] / mus[:, None, None])    # (na, nwn, nrad)
    B = planck(wns_cgs[:, None], temp_rev[None, :])      # (nwn, nrad)
    idx = torch.arange(nrad, device=tau.device)
    # Boundary term B[last] * exp(-tau[last]/mu):
    blast = torch.gather(B, 1, last[:, None])[:, 0]
    lidx = last[None, :, None].expand(dtau.shape[0], nwn, 1)
    dlast = torch.gather(dtau, 2, lidx)[..., 0]
    # integ_trapz(dtau, B, last+1) with x = dtau (eclipse.c:158-159):
    seg = (dtau[..., 1:] - dtau[..., :-1]) * (B[:, 1:] + B[:, :-1]) * 0.5
    mask = idx[None, 1:] <= last[:, None]
    integral = torch.where(mask, seg, torch.zeros((), dtype=seg.dtype,
                                                   device=seg.device))
    return blast * dlast - integral.sum(dim=2)


def flux(intensities, angles_deg):
    """F = pi * sum_i I_i (sin^2 a_{i+1} - sin^2 a_i) over the area grid
    built from angle midpoints (eclipse.c:242-287)."""
    area = _angle_tables(tuple(angles_deg), intensities.dtype,
                         intensities.device)[1]
    return PI * torch.tensordot(area, intensities, dims=([0], [0]))
