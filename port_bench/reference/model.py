"""The plain reference spectrum and its gradient.

:class:`Reference` computes, for one profile (T (nl,) K, number
abundances q (nmol, nl)) at a time, the eclipse flux of a configuration
and the gradient of a chi-square of it in T and q, in plain torch on any
device and in any float dtype.  It imports nothing of the program, reads
the input files itself (:mod:`.inputs`) and works out from them and the
profile everything the program's set-up derives: grids, densities,
partition functions, widths, strengths, the ethresh cut, groups and the
profile table, CIA, path weights.  The line extinction is computed a
block of layers at a time, so that it fits beside the program; the
gradient follows the extinction's cotangent back block by block."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import exact, fast, physics
from .constants import KB, AMU, TLI_WAV_UNITS
from .inputs import Problem
from .pairs import runs
from .voigt import ProfileTable


def wn_grid(c: dict):
    """(first wavenumber, spacing, count) of the coarse grid: the C
    fill ini + k delta (makesample.c:77-104)."""
    ini, fin, d = c["wnlow"] * c["wnfct"], c["wnhigh"] * c["wnfct"], \
        c["wndelt"]
    n = int(((1.0 + 1e-8) * fin - ini) / d + 1)
    return ini, d, n


@contextlib.contextmanager
def tf32(on: bool):
    """PyTorch's TF32 switch for float32 matrix products, set for the
    block and restored."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class Reference:
    """The reference model of ``problem`` on ``device`` in ``dtype``;
    ``allow_tf32``: float32 products in TF32 (the control), else full
    precision."""

    def __init__(self, problem: Problem, device, dtype=torch.float64,
                 allow_tf32: bool = False):
        c = self.c = problem.cfg
        self.mode = c.get("mode", "fast")
        self.device, self.dtype, self.allow_tf32 = device, dtype, allow_tf32
        def t(a):
            if isinstance(a, torch.Tensor):
                return a.to(device=device, dtype=dtype)
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                   device=device)
        self.t = t
        atm = self.atm = problem.atm
        self.grid = wn_grid(c)
        wn0, dwn, nwn = self.grid
        # Positions (the grid, the tables' abscissae, line centers) stay
        # float64 in every dtype: a difference of two is then taken in
        # float64 and the result cast; all other arithmetic is in dtype.
        self.wns = torch.as_tensor(wn0 + np.arange(nwn) * dwn,
                                   device=device)
        self.press_cgs = t(atm.press * atm.pfct)
        self.mol_mass = t(atm.mol_mass)
        self.W = t(physics.eclipse_weights(atm.radius))
        self.rfct = atm.rfct
        self.cia = problem.cia
        tli = problem.tli
        species = atm.species
        wl, iso, elow, gf = problem.lines
        wavn = 1.0 / (wl * TLI_WAV_UNITS)
        self.L = {
            "wavn": t(wavn), "elow": t(elow), "gf": t(gf),
            "iso": torch.as_tensor(iso, device=device),
            "iso_mass": t(tli.iso_mass), "iso_ratio": t(tli.iso_ratio),
            "iso_imol": torch.as_tensor([species.index(m)
                                         for m in tli.iso_mol],
                                        device=device),
            "mol_mass": self.mol_mass, "mol_radius": t(atm.mol_radius),
            "wavn_f64": torch.as_tensor(wavn, device=device),
            "iso_runs": runs(np.asarray(iso)),
            "wavn_np": wavn, "iso_np": np.asarray(iso)}
        self.pf = [(torch.as_tensor(x, device=device), t(z))
                   for x, z in zip(tli.pf_temps, tli.pf_z)]
        self.pf = [(x, z, physics.spline_z(x, z)) for x, z in self.pf]
        self.plan = None
        if self.mode == "exact":
            table = ProfileTable(dwn / c["wnosamp"],
                                 (nwn - 1) * c["wnosamp"] + 1, c["nwidth"],
                                 c["ndop"], c["nlor"], c["dmin"], c["dmax"],
                                 c["lmin"], c["lmax"], device)
            self.plan = exact.Plan(self.L, table, self.grid, c["wnosamp"],
                                   device, dtype)
        # Layers a block: on the card the fast list's (rows, lines) tables
        # are small, exact mode's ~10 float64 (rows, lines) ones are not.
        nl = atm.radius.shape[0]
        self.rows = ((10 if self.plan is not None else nl)
                     if device.type == "cuda" else 4)

    # --- per profile --------------------------------------------------
    def densities(self, T, q, layers=slice(None)):
        """Ideal-gas mass densities (nmol, nl) of the ``layers``."""
        return (AMU * q * self.press_cgs[layers] / KB / T *
                self.mol_mass[:, None])

    def partition(self, T):
        return torch.stack([physics.spline_eval(x, z, z2, T)
                            for x, z, z2 in self.pf])

    def line_rows(self, T, dens):
        """Line extinction (rows, nwn) of the layers T (rows,), dens
        (nmol, rows)."""
        Z = self.partition(T)
        c = self.c
        if self.plan is not None:
            return exact.extinction(self.L, self.plan, T, dens, Z,
                                    c["ethreshold"])
        return fast.extinction(self.L, T, dens, Z, self.grid, c["nwidth"],
                               c["ethreshold"])

    def line_extinction(self, T, q):
        """(nl, nwn), a block of ``rows`` layers at a time, no gradient."""
        with torch.no_grad():
            dens = self.densities(T, q)
            return torch.cat([self.line_rows(T[s], dens[:, s])
                              for s in self.blocks(T.shape[0])])

    def blocks(self, nl):
        return [slice(a, min(a + self.rows, nl))
                for a in range(0, nl, self.rows)]

    def assemble(self, T, q, ex):
        """The eclipse flux (nwn,) from the line extinction ``ex`` (nl,
        nwn): CIA, the optical depth and the emergent flux."""
        dens = self.densities(T, q)
        e_cia = physics.cia_extinction(self.cia, self.wns, T, dens,
                                       self.atm.species, self.mol_mass)
        er = ex.T + e_cia
        with tf32(self.allow_tf32):
            tau = self.rfct * er @ self.W.T
        return physics.eclipse_flux(tau, self.c["toomuch"], self.wns,
                                    T.flip(0),
                                    [float(a) for a in
                                     self.c["raygrid"].split()])

    def spectrum(self, T, q):
        T, q = self.t(T), self.t(q)
        with torch.no_grad():
            return self.assemble(T, q, self.line_extinction(T, q))

    def chi2_grad(self, T, q, obs, sigma):
        """(flux, d chi2/dT, d chi2/dq) of chi2 = sum((flux - obs) /
        sigma)^2: the flux's gradient through the assembly by autograd,
        then each block of the line extinction recomputed under autograd
        and pulled back with its part of the extinction's cotangent."""
        T, q = self.t(T), self.t(q)
        obs, sigma = self.t(obs), self.t(sigma)
        ex = self.line_extinction(T, q).requires_grad_()
        Tg, qg = T.clone().requires_grad_(), q.clone().requires_grad_()
        flux = self.assemble(Tg, qg, ex)
        chi2 = (((flux - obs) / sigma) ** 2).sum()
        gT, gq, gex = torch.autograd.grad(chi2, (Tg, qg, ex))
        for s in self.blocks(T.shape[0]):
            Tb = T[s].clone().requires_grad_()
            qb = q[:, s].clone().requires_grad_()
            part = self.line_rows(Tb, self.densities(Tb, qb, s))
            dT, dq = torch.autograd.grad(part, (Tb, qb), gex[s])
            gT[s] += dT
            gq[:, s] += dq
        return flux.detach(), gT, gq
