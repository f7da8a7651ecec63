"""The atmosphere's physics around the line extinction, in plain torch:
natural cubic splines (partition functions, CIA tables), line widths,
CIA extinction, the eclipse path weights of the optical depth, and the
emergent eclipse flux.  The formulas are the reference C code's
(pu/src/spline.c, extinction.c:364-395, crosssec.c:271-428,
eclipse.c:28-287), written plainly; each function works on tensors of
any float dtype and is differentiable in its per-step arguments."""

from __future__ import annotations

import numpy as np
import torch

from .constants import (AMAGAT, AMU, DEGREES, H, KB, LS, PI, SQRTLN2)


# --- natural cubic spline ---------------------------------------------------

def spline_z(x, y):
    """Second derivatives (n, ...) of the natural cubic spline through
    (x (n,), y (n, ...)), by the tridiagonal elimination of spline.c.
    The abscissae's spacings are taken in x's dtype (the tables' float64)
    and the rest in y's."""
    n = x.shape[0]
    z = torch.zeros_like(y)
    if n < 3:
        return z
    h = (x[1:] - x[:-1]).to(y.dtype)
    hb = h.reshape((-1,) + (1,) * (y.dim() - 1))
    b = (y[1:] - y[:-1]) / hb
    u = [None, 2.0 * (h[1] + h[0])]
    v = [None, 6.0 * (b[1] - b[0])]
    for i in range(2, n - 1):
        u.append(2.0 * (h[i] + h[i - 1]) - h[i - 1] * h[i - 1] / u[i - 1])
        v.append(6.0 * (b[i] - b[i - 1]) - v[i - 1] * h[i - 1] / u[i - 1])
    zs = [torch.zeros_like(y[0])] * n
    for i in range(n - 2, 0, -1):
        zs[i] = (v[i] - h[i] * zs[i + 1]) / u[i]
    return torch.stack(zs)


def spline_eval(x, y, z, xout):
    """The spline through (x, y) with second derivatives z at ``xout``
    (m,): (m, ...).  The interval is the one whose lower end is the
    largest x <= xout (clamped to the table), as splinterp_pt finds it."""
    n = x.shape[0]
    # The interval search in float32 at least (bfloat16 has no search):
    up = torch.promote_types(x.dtype, torch.float32)
    idx = (torch.searchsorted(x.to(up), xout.to(up).contiguous(),
                              right=True) - 1).clamp(0, n - 2)
    shape = (-1,) + (1,) * (y.dim() - 1)
    xl = x[idx]
    h = (x[idx + 1] - xl).to(y.dtype).reshape(shape)
    dx = (xout.to(x.dtype) - xl).to(y.dtype).reshape(shape)
    y0, y1, z0, z1 = y[idx], y[idx + 1], z[idx], z[idx + 1]
    a = (z1 - z0) / (6.0 * h)
    b = 0.5 * z0
    c = (y1 - y0) / h - h / 6.0 * (z1 + 2.0 * z0)
    return y0 + dx * (c + dx * (b + dx * a))


# --- widths -----------------------------------------------------------------

def line_widths(temps, densities, iso_mass, iso_imol, mol_mass, mol_radius):
    """Lorentz width and Doppler factor per (layer, isotope), each
    (nl, niso), for temps (nl,) K and mass densities (nmol, nl): the
    Doppler width of a line is its factor times its wavenumber."""
    fdop = torch.sqrt(2.0 * KB * temps / AMU) * SQRTLN2 / LS
    flor = torch.sqrt(2.0 * KB * temps / PI / AMU) / (AMU * LS)
    diam = mol_radius[None, :] + mol_radius[iso_imol][:, None]   # (ni, nm)
    coll = (densities.T[:, None, :] / mol_mass * diam * diam *
            torch.sqrt(1.0 / iso_mass[:, None] + 1.0 / mol_mass[None, :]))
    return flor[:, None] * coll.sum(dim=2), fdop[:, None] / torch.sqrt(
        iso_mass)[None, :]


# --- CIA --------------------------------------------------------------------

def cia_extinction(tables, wns, temps, densities, species, mol_mass):
    """CIA extinction (nwn, nl), cm-1: each table splined along
    temperature to the layer temperatures, then along wavenumber to the
    grid, zero outside the table and where negative, times the two
    partners' amagat densities."""
    dt, dev = densities.dtype, densities.device
    total = torch.zeros((wns.shape[0], temps.shape[0]), dtype=dt, device=dev)
    for tb in tables:
        t_tab = torch.as_tensor(tb.temps, dtype=torch.float64, device=dev)
        w_tab = torch.as_tensor(tb.wn, dtype=torch.float64, device=dev)
        cs = torch.as_tensor(tb.cs, dtype=dt, device=dev)      # (nw, nt)
        zt = spline_z(t_tab, cs.T)                             # (nt, nw)
        f = spline_eval(t_tab, cs.T, zt, temps)                # (nl, nw)
        zw = spline_z(w_tab, f.T)                              # (nw, nl)
        e = spline_eval(w_tab, f.T, zw, wns)                   # (nwn, nl)
        inside = (((wns >= tb.wn[0]) & (wns <= tb.wn[-1]))[:, None] &
                  ((temps >= tb.temps[0]) & (temps <= tb.temps[-1]))[None])
        amagat = torch.ones_like(temps)
        for s in tb.species:
            k = species.index(s)
            amagat = amagat * densities[k] / (AMU * mol_mass[k] * AMAGAT)
        total = total + torch.where(inside & (e > 0), e, 0.0) * amagat
    return total


# --- optical depth: eclipse path weights ------------------------------------

def _simpson_weights(x: np.ndarray) -> np.ndarray:
    """w with w @ y the reference's non-uniform Simpson integral
    (numerical.c simps: a trapezoid on the first interval of an even
    count)."""
    n = x.shape[0]
    w = np.zeros(n)
    if n < 2:
        return w
    h = np.diff(x)
    if n == 2:
        w[:] = h[0] / 2.0
        return w
    even = int(n % 2 == 0)
    for i in range((n - 1) // 2):
        j = 2 * i + even
        h0, h1 = h[j], h[j + 1]
        hs = h0 + h1
        w[j] += (2.0 - h1 / h0) * hs / 6.0
        w[j + 1] += hs * hs / (h0 * h1) * hs / 6.0
        w[j + 2] += (2.0 - h0 / h1) * hs / 6.0
    if even:
        w[0] += h[0] / 2.0
        w[1] += h[0] / 2.0
    return w


def _parabola(x3: np.ndarray, xr: float) -> np.ndarray:
    """Coefficients c with c @ y3 the parabola through three equispaced
    samples at xr (numerical.c interp_parab)."""
    dx = x3[1] - x3[0]
    x0 = x3[0] / dx
    out = np.zeros(3)
    for k in range(3):
        y = np.eye(3)[k]
        my = y[0] + y[2] - 2.0 * y[1]
        a = my / (2.0 * dx * dx)
        b = (y[2] - y[1] - (x0 + 1.5) * my) / dx
        c = y[0] + x0 * (y[2] - 4.0 * y[1] + 3.0 * y[0] + x0 * my) / 2.0
        out[k] = xr * xr * a + xr * b + c
    return out


def eclipse_weights(rad: np.ndarray) -> np.ndarray:
    """W (nh, nl), heights from the top down: the vertical optical depth
    from height h to the top is rfct * er @ W[h] (eclipsetau,
    eclipse.c:28-105, with its first sample replaced by the parabola and
    its two-layer case)."""
    n = rad.shape[0]
    W = np.zeros((n, n))
    for ri in range(1, n):          # the top height's depth is 0
        rs = n - 1 - ri
        if n - rs == 2:
            p = _parabola(rad[rs - 1:rs + 2], rad[rs])
            r3 = np.array([rad[rs], (rad[rs] + rad[rs + 1]) / 2.0,
                           rad[rs + 1]])
            w = _simpson_weights(np.r_[0.0, np.cumsum(np.diff(r3))])
            C = np.zeros((3, n))
            C[0, rs - 1:rs + 2] = p
            C[1, rs - 1:rs + 2] = p / 2.0
            C[1, rs + 1] += 0.5
            C[2, rs + 1] = 1.0
            W[ri] = w @ C
        else:
            p = _parabola(rad[rs:rs + 3], rad[rs])
            w = _simpson_weights(np.r_[0.0, np.cumsum(np.diff(rad[rs:]))])
            W[ri, rs:] = w
            W[ri, rs:rs + 3] += w[0] * p - w[0] * np.array([1.0, 0, 0])
    return W


# --- eclipse emission -------------------------------------------------------

def planck(wn_cgs, temp):
    return (2.0 * H * wn_cgs ** 3 * LS * LS /
            (torch.exp(H * wn_cgs * LS / (KB * temp)) - 1.0))


def eclipse_flux(tau, toomuch, wns, temps_top_down, angles):
    """Flux (nwn,) of the emergent intensities at the ray angles (deg):
    per angle the intensity B[last] exp(-tau[last]/mu) minus the
    trapezoid integral of B over exp(-tau/mu) down to ``last``, the first
    height whose tau passes ``toomuch`` (eclipse.c:117-287), then the
    area-weighted sum over the angle grid's midpoints."""
    nwn, nh = tau.shape
    over = tau > toomuch
    last = torch.where(over.any(dim=1), over.int().argmax(dim=1),
                       torch.full((nwn,), nh - 1, device=tau.device))
    ang = np.asarray(angles, dtype=np.float64)
    mus = torch.as_tensor(np.cos(ang * DEGREES), dtype=tau.dtype,
                          device=tau.device)
    grid = np.r_[0.0, (ang[:-1] + ang[1:]) * DEGREES / 2.0, 90.0 * DEGREES]
    area = torch.as_tensor(np.sin(grid[1:]) ** 2 - np.sin(grid[:-1]) ** 2,
                           dtype=tau.dtype, device=tau.device)
    B = planck(wns.to(tau.dtype)[:, None], temps_top_down[None, :])
    flux = torch.zeros(nwn, dtype=tau.dtype, device=tau.device)
    used = torch.arange(1, nh, device=tau.device)[None, :] <= last[:, None]
    for a in range(ang.shape[0]):
        e = torch.exp(-tau / mus[a])
        edge = (B.gather(1, last[:, None]) * e.gather(1, last[:, None]))[:, 0]
        seg = (e[:, 1:] - e[:, :-1]) * (B[:, 1:] + B[:, :-1]) * 0.5
        flux = flux + area[a] * (edge - torch.where(used, seg, 0.0).sum(1))
    return PI * flux
