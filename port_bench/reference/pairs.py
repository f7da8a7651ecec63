"""Expanding per-entry runs of bins into (entry, bin) pairs in chunks,
and per-isotope columns over items sorted into isotope runs."""

from __future__ import annotations

import numpy as np
import torch


def chunks(counts, budget: int):
    """Consecutive slices of the entries whose ``counts`` (m,) sum to at
    most ``budget`` each (an entry above it gets a slice of its own)."""
    m = counts.shape[0]
    if m == 0:
        return
    cum = torch.cumsum(counts, 0).cpu()
    a = 0
    while a < m:
        base = int(cum[a - 1]) if a else 0
        b = int(torch.searchsorted(cum, base + budget, right=True))
        b = max(b, a + 1)
        yield slice(a, b)
        a = b


def expand(first, counts):
    """(entry index, bin) of every pair: entry e gets bins first[e],
    first[e] + 1, ..., first[e] + counts[e] - 1."""
    entry = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device), counts)
    start = torch.cumsum(counts, 0) - counts
    return entry, first[entry] + (torch.arange(entry.shape[0],
                                               device=counts.device) -
                                  start[entry])


def runs(iso: np.ndarray) -> list:
    """(isotope, first, end) of each run of equal isotopes."""
    cut = np.r_[0, np.flatnonzero(np.diff(iso)) + 1, iso.shape[0]]
    return [(int(iso[a]), int(a), int(b)) for a, b in zip(cut[:-1], cut[1:])
            if b > a]


def by_runs(x, rs: list):
    """x[:, iso] (rows, n) for items sorted into isotope runs ``rs``: each
    run's column expanded (its backward a sum over the run, not an
    indexed scatter)."""
    return torch.cat([x[:, i:i + 1].expand(x.shape[0], b - a)
                      for i, a, b in rs], dim=1)
