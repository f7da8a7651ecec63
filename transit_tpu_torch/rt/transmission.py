"""Transit (transmission) modulation spectrum.

The counterpart of transit_tpu.rt.transmission.  Reference:
transit/src/slantpath.c:274-473 (modulation1 / modulationm1).  The radial
integral runs over a per-wavenumber, tau.last-dependent number of
impact-parameter samples; Simpson weight rows for every possible count
are precomputed, and each wavenumber takes its row, which turns the
data-dependent loop into masked tensor ops.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from transit_tpu_torch.numerics.simpson import (simpson_weights_np,
                                                simpson_weights_torch)


def modulation_weight_table(ipv_asc: np.ndarray) -> np.ndarray:
    """Wmod[(count), j]: Simpson weights over the ascending impact-parameter
    tail of length ``count`` (positions ipn-count..ipn-1), zero elsewhere.
    modulation1 integrates rinteg over exactly that tail
    (slantpath.c:399-408)."""
    ipn = ipv_asc.shape[0]
    W = np.zeros((ipn + 1, ipn))
    for count in range(2, ipn + 1):
        W[count, ipn - count:] = simpson_weights_np(ipv_asc[ipn - count:])
    return W


@functools.lru_cache(maxsize=None)
def _roll_tables(ipn: int, device):
    """(fwd, back, counts) index tables of the rolls by each count, as
    tensors on ``device`` made once: fwd and back (ipn+1, ipn), row c of
    fwd puts the tail of length c first (jnp.roll(x, c)), back rolls its
    weights back into place (jnp.roll(w, -c)); counts 0..ipn."""
    c = np.arange(ipn + 1)[:, None]
    k = np.arange(ipn)[None, :]
    return tuple(torch.as_tensor(a, device=device) for a in (
        (k - c) % ipn, (k + c) % ipn, c[:, 0]))


def modulation_weight_table_torch(ipv_asc):
    """Differentiable modulation_weight_table for ascending impact
    parameters (..., ipn): (..., ipn+1, ipn).  Every count's row in one
    pass: the tail rolled to the front, the prefix-masked Simpson
    weights, rolled back (transit_tpu rt/transmission.py:30-45)."""
    ipn = ipv_asc.shape[-1]
    fwd, back, counts = _roll_tables(ipn, ipv_asc.device)
    rolled = ipv_asc[..., fwd]                            # (..., ipn+1, ipn)
    w = simpson_weights_torch(rolled, counts.expand(rolled.shape[:-1]))
    return torch.gather(w, -1, back.expand(w.shape))


def modulation(tau, last, ip_v, ip_fct, starrad_cm, toomuch,
               transparent=False, Wmod=None):
    """Modulation spectrum M(wn), modulation1 (slantpath.c:350-436).

    Args:
      tau: (nwn, nip) optical depth, rows over descending impact parameter
        (index 0 = largest b = top).
      ip_v: (nip,) impact parameters, *descending* (reversed radii); may
        require grad, with Wmod built from it (or left None: then it is
        built here with the tensor table).

    Each wavenumber integrates with the weight row of its sample count:
    integ[w] = (rint_asc @ Wmod.T)[w, count[w]], a matrix product and
    one gather per row (whose backward adds one value per row, with no
    duplicate indices) in place of gathering the (nwn, nip) rows of
    Wmod."""
    nwn, ipn = tau.shape
    ipv_desc = ip_v * ip_fct
    ipv_asc = ipv_desc.flip(-1)                # ascending, index ipn-1-i
    if Wmod is None:
        Wmod = modulation_weight_table_torch(ipv_asc)

    idx = torch.arange(ipn, device=tau.device)
    # rinteg[ipn-1-i] = exp(-tau[i]) * ipv[i] for i <= last, 0 beyond
    # (slantpath.c:374-385).  tau is masked before the exp too: beyond
    # last the parabolic tangent correction's negative path weights can
    # make it negative enough that exp(-tau) overflows, and the
    # unselected branch's zero gradient times inf is NaN.
    live = idx[None, :] <= last[:, None]
    zero = torch.zeros((), dtype=tau.dtype, device=tau.device)
    rint_desc = torch.where(live, torch.exp(-torch.where(live, tau, zero))
                            * ipv_desc[None, :], zero)
    rint_asc = rint_desc.flip(-1)

    # Number of integration samples: last+2 capped at ipn
    # (slantpath.c:381-393: one extra zero row, then count = last+1+1):
    count = torch.clamp(last + 2, max=ipn)
    integ = torch.gather(rint_asc @ Wmod.T, 1, count[:, None])[:, 0]

    res = ipv_asc[-1] * ipv_asc[-1] - 2.0 * integ
    if transparent:
        # slantpath.c:424-425: subtract the opaque-disc term at the
        # innermost integrated impact parameter:
        maxtau = torch.gather(tau, 1, last[:, None])[:, 0]
        maxtau = maxtau.clamp_min(toomuch)
        inner = ipv_asc[ipn - count]
        res = res - torch.exp(-maxtau) * inner * inner
    return res / (starrad_cm * starrad_cm)


def modulation_m1(tau, last, ip_v, ip_fct, starrad_cm, toomuch):
    """Opaque-disc modulation, modulationm1 (slantpath.c:446-473):
    the radius where tau = toomuch, linearly interpolated, squared over the
    stellar radius.  Returns -1 where toomuch was not reached."""
    nwn, ipn = tau.shape
    ipv = ip_v * ip_fct
    tlast = torch.gather(tau, 1, last[:, None])[:, 0]
    reached = tlast >= toomuch

    ini = torch.clamp(last + 1 - 2, min=0)
    ini1 = torch.clamp(ini + 1, max=ipn - 1)
    t0 = torch.gather(tau, 1, ini[:, None])[:, 0]
    t1 = torch.gather(tau, 1, ini1[:, None])[:, 0]
    p0 = ipv[ini]
    p1 = ipv[ini1]
    # interp_line(tau+ini, ipv, toomuch) (numerical.c:202-211):
    m = (p1 - p0) / (t1 - t0)
    muchrad = p0 + (toomuch - t0) * m
    res = muchrad * muchrad / (starrad_cm * starrad_cm)
    return torch.where(reached, res, torch.full_like(res, -1.0))
