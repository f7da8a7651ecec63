"""Collision-induced absorption / cross-section opacity.

Reference: transit/src/crosssec.c:271-428 (interpcs + bicubicinterpolate).
The C code natural-spline interpolates each table first along temperature
(to the layer temperatures) and then along wavenumber (to the transit grid),
zeroing everything outside the tabulated rectangle and clamping negative
interpolants (crosssec.c:328-334).  Densities convert cm-1 amagat^-n to cm-1.

The source tables are static, so everything that depends only on them is
precomputed once per model (:func:`precompute_cs`): the temperature-direction
second derivatives and the wavenumber-direction spline operator, and every
table as tensors on the model's device in its dtype.  Only the layer
temperatures change per step, and the step copies nothing from the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from transit_tpu_torch.constants import AMU, AMAGAT
from transit_tpu_torch.numerics.spline import (
    spline_second_derivs_np, spline_operator_np, spline_second_derivs_torch,
    spline_eval_torch)


@dataclasses.dataclass
class CsPre:
    """Static per-table spline data, as tensors on the model's device in
    its dtype, made once (:func:`precompute_cs`)."""
    temps: torch.Tensor  # (nt,) the table's temperatures
    cs: torch.Tensor     # (nwn_src, nt) the table
    zT: torch.Tensor     # (nwn_src, nt) temperature-direction 2nd derivs
    wn: torch.Tensor     # (nwn_src,) the table's wavenumbers
    A_wn: torch.Tensor   # (nwn_src-2, nwn_src-2) wavenumber spline operator


def precompute_cs(tables, dtype=torch.float64, device="cpu"):
    """Static spline coefficients per table (on the host, in float64),
    and each table's tensors, in ``dtype`` on ``device``."""
    out = []
    for tb in tables:
        zT = np.stack([spline_second_derivs_np(tb.temps, tb.cs[i])
                       for i in range(tb.wn.shape[0])])
        t = [torch.as_tensor(a, dtype=dtype, device=device) for a in
             (tb.temps, tb.cs, zT, tb.wn, spline_operator_np(tb.wn))]
        out.append(CsPre(*t))
    return out


def interp_cs_one(tb, pre: CsPre, wns: torch.Tensor, temps: torch.Tensor):
    """Bicubic interpolation of one table onto (wns x temps), from the
    tensors of ``pre`` (:func:`precompute_cs` in the dtype and on the
    device of ``temps``).

    Returns (nwn, nlayer).  Outside the table rectangle the result is zero
    (no extrapolation; crosssec.c:376-392)."""
    # Stage 1 (crosssec.c:407-411): spline along temperature for each source
    # wavenumber row, evaluated at the layer temperatures:
    f2 = spline_eval_torch(pre.temps, pre.cs.T, pre.zT.T, temps).T
    # Stage 2 (crosssec.c:414-419): spline along source wavenumber for each
    # layer, evaluated at the transit wavenumbers:
    z2 = spline_second_derivs_torch(pre.wn, f2, pre.A_wn)
    res = spline_eval_torch(pre.wn, f2, z2, wns)        # (nwn, nl)
    # Zero outside the table rectangle (fi/li, fj/lj logic):
    wn_in = (wns >= tb.wn[0]) & (wns <= tb.wn[-1])
    t_in = (temps >= tb.temps[0]) & (temps <= tb.temps[-1])
    return res * wn_in[:, None] * t_in[None, :]


def cs_extinction(tables, precomp, wns, temps, densities, mol_mass,
                  species_idx):
    """Total cross-section extinction e_cs (nwn, nlayer), cm-1.

    Args:
      tables: list of CrossSection.
      precomp: list of CsPre (from :func:`precompute_cs`).
      wns: (nwn,) tensor of wavenumbers (cm-1).
      temps: (nlayer,) layer temperatures (cgs).
      densities: (nmol, nlayer) mass densities.
      species_idx: list of index-arrays, the atmosphere species of each
        table's 1-2 collision partners.
    """
    nwn = wns.shape[0]
    nl = densities.shape[1]
    total = torch.zeros((nwn, nl), dtype=densities.dtype,
                        device=densities.device)
    for tb, pre, sidx in zip(tables, precomp, species_idx):
        e = interp_cs_one(tb, pre, wns, temps)
        dens = torch.ones(nl, dtype=densities.dtype, device=densities.device)
        for k in sidx:
            dens = dens * densities[k] / (AMU * mol_mass[k] * AMAGAT)
        # Negative-interpolant guard (crosssec.c:328-334):
        total = total + torch.where(e > 0, e, 0.0) * dens[None, :]
    return total
