"""Rayleigh-scattering extinction.

Reference: transit/src/extinction.c:586-624 (computeextscat).
flag 0: none; flag 1: Lecavelier Des Etangs et al. (2008) H2 approximation;
flag 2: polarizability-based sum over species.
"""

from __future__ import annotations

import torch

from transit_tpu_torch.constants import PI, E0H2, RAYEXP, MICRON, NAVOGADRO


def scattering_extinction(flag: int, logext, press, temp, wns,
                          densities=None, mol_mass=None, mol_pol=None):
    """e_s (nwn, nlayer) in cm-1.  press/temp in the atmosphere file's
    *native* units (the reference passes tr->atm.p / tr->atm.t unscaled,
    tau.c:113-114,226 — the unit choice is absorbed by logext), wns cm-1
    (cgs); densities cgs.  All array arguments are tensors."""
    nl = press.shape[0]
    if flag == 0:
        return torch.zeros((wns.shape[0], nl), dtype=press.dtype,
                           device=press.device)
    if flag == 1:
        # extinction.c:604-608:
        return (10.0 ** logext * E0H2 * (press / temp)[None, :] *
                (wns ** RAYEXP)[:, None])
    if flag == 2:
        # extinction.c:610-622 (PSG handbook polarizability form):
        per_mol = (PI * 8e-32 / 3.0 * mol_pol ** 2 / mol_mass * NAVOGADRO)
        wn4 = (2.0 * PI * wns * MICRON) ** 4
        layer = torch.sum(per_mol[:, None] * densities, dim=0)  # (nl,)
        return wn4[:, None] * layer[None, :]
    raise ValueError(f"unknown scattering flag {flag}")
