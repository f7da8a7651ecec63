"""Cloud-deck extinction models.

Reference: transit/src/extinction.c:629-693 (computeextcloud).  Five models
between cloudtop and cloudbot pressures (log10-bar inputs, converted to the
pressure array's units by the caller):
  1 constant extinction          2 constant opacity (x mean density)
  3 Barstow et al. (2017)        4 Fisher & Heng (2018)
  5 Pinhas et al. (2019)
Layers above cloudtop and at/below cloudbot get zero.
"""

from __future__ import annotations

import dataclasses

import torch

from transit_tpu_torch.constants import PI


@dataclasses.dataclass
class CloudParams:
    flag: int = 0
    cloudext: float = 0.0     # extinction parameter
    cloudtop: float = 2.0     # log10(pressure) of cloud top
    cloudbot: float = 2.0     # log10(pressure) of cloud bottom
    gamma: float = 0.0
    Q: float = 0.0
    r: float = 0.0            # particle size (cm)
    sig: float = 0.0
    refwn: float = 1.0


def cloud_extinction(cl: CloudParams, press, mean_dens, nH, wns):
    """e_c (nwn, nlayer), cm-1.  press in the atmosphere's native units
    (the reference compares pow(10, cloudtop) directly against atm.p,
    extinction.c:640-641, tau.c:227), wns in cm-1 (cgs, wn*wfct).  All
    array arguments are tensors."""
    nl = press.shape[0]
    if cl.flag == 0 or cl.cloudext == 0.0:
        return torch.zeros((wns.shape[0], nl), dtype=press.dtype,
                           device=press.device)

    cloudtop = 10.0 ** cl.cloudtop
    cloudbot = 10.0 ** cl.cloudbot
    # The C scan marks layers with pressure >= cloudtop as "at/below top";
    # the cloud occupies pressures in [cloudtop, cloudbot):
    inside = (press >= cloudtop) & (press < cloudbot)

    x = 2.0 * PI * cl.r * wns
    if cl.flag == 1:
        prof = torch.full((wns.shape[0], nl), cl.cloudext,
                          dtype=press.dtype, device=press.device)
    elif cl.flag == 2:
        prof = cl.cloudext * mean_dens[None, :].expand(wns.shape[0], nl)
    elif cl.flag == 3:
        kBP = cl.cloudext * wns ** cl.gamma
        prof = kBP[:, None] * mean_dens[None, :]
    elif cl.flag == 4:
        kFH = cl.cloudext / (cl.Q * x ** (-cl.gamma) + x ** 0.2)
        prof = kFH[:, None] * mean_dens[None, :]
    elif cl.flag == 5:
        kBP = cl.cloudext * wns ** cl.gamma
        refwn = cl.refwn ** cl.gamma
        prof = (nH[None, :] * kBP[:, None] * cl.sig / refwn *
                mean_dens[None, :])
    else:
        raise ValueError(f"unknown cloud flag {cl.flag}")
    return prof * inside[None, :]
