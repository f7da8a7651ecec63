"""The inputs of a run, made from its seed: the line list of a
configuration that splits one, the pool of (T, q) profiles and the
observed spectrum the chi-square is formed against."""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.inputs import split_lines, write_tli
from port_bench.reference.physics import planck
from port_bench.reference.constants import PI


def seed_of(seed: int) -> int:
    """A seed as a non-negative 63-bit number (torch and numpy take
    it)."""
    return int(seed) % (1 << 63)


def write_line_list(path, problem_tli, config: dict, seed: int) -> int:
    """The configuration's split line list (``lines``: copies and the
    wavenumber jitter) written to ``path``; returns its line count."""
    c, s = config["transit"], config["lines"]
    lines = split_lines(problem_tli, c["wnlow"], c["wnhigh"], s["copies"],
                        s["jitter_cm1"], seed_of(seed))
    write_tli(path, problem_tli, *lines)
    return int(lines[0].shape[0])


def _modes(nl: int, k: int, device):
    """The first k Legendre polynomials above the constant over the
    layers, (k, nl) float64."""
    x = torch.linspace(-1.0, 1.0, nl, dtype=torch.float64, device=device)
    p = [torch.ones_like(x), x]
    for n in range(1, k):
        p.append(((2 * n + 1) * x * p[n] - n * p[n - 1]) / (n + 1))
    return torch.stack(p[1:k + 1])


def make_pool(atm, traffic: dict, seed: int, device, dtype):
    """``pool`` profiles (T (P, nl), q (P, nmol, nl)) on ``device``: the
    atmosphere's T times 1 + t_rel x a smooth curve (t_modes Legendre
    modes, each weight uniform in +-1/t_modes), clipped to t_range; each
    of q_species' abundances times 10^(q_dex (u + the same kind of
    curve) / 2), u uniform in +-1; the other species as the file has
    them.  Drawn in float64 from a generator on the device."""
    g = torch.Generator(device=device).manual_seed(seed_of(seed))
    f64 = dict(dtype=torch.float64, device=device)
    P, k = traffic["pool"], traffic["t_modes"]
    nl = atm.temp.shape[0]
    modes = _modes(nl, k, device)

    def curve(n):
        return (torch.rand((n, k), generator=g, **f64) * 2 - 1) / k @ modes

    T0 = torch.as_tensor(atm.temp, **f64)
    T = (T0 * (1 + traffic["t_rel"] * curve(P))).clamp(*traffic["t_range"])
    q = torch.as_tensor(atm.q, **f64).expand(P, -1, -1).clone()
    for s in traffic["q_species"]:
        i = atm.species.index(s)
        u = torch.rand((P, 1), generator=g, **f64) * 2 - 1
        q[:, i] *= 10.0 ** (traffic["q_dex"] * (u + curve(P)) / 2)
    return T.to(dtype), q.to(dtype)


def make_obs(wns: np.ndarray, traffic: dict, seed: int, device, dtype):
    """(obs, sigma) (nwn,): the flux pi B_nu(T_obs) of an isothermal
    atmosphere at T_obs uniform in obs_t (drawn from the seed), and
    obs_sigma_rel of it."""
    g = torch.Generator(device="cpu").manual_seed(seed_of(seed) ^ 0x5EED)
    lo, hi = traffic["obs_t"]
    t_obs = lo + (hi - lo) * float(torch.rand((), generator=g,
                                              dtype=torch.float64))
    wn = torch.as_tensor(wns, dtype=torch.float64, device=device)
    obs = PI * planck(wn, torch.tensor(t_obs, dtype=torch.float64,
                                       device=device))
    return obs.to(dtype), (traffic["obs_sigma_rel"] * obs).to(dtype)
