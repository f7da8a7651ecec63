"""The Doppler index's forward fill of exact mode, lbl.doppler_fill_plain
(the plain version of the kernel kernel_profile.doppler_fill), against a
scalar loop of the C code's extinction.c:479-483, group after group
within each row, on small synthetic tables of three isotope runs.  Port
only; the kernel against this plain version: tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from transit_tpu_torch.opacities import lbl

# Three isotope runs, their isotopes out of order, so a group's isotope
# is not its run's position.
RUN_ISO = (2, 0, 1)
RUN_LEN = (7, 5, 9)
ROWS = 3
# aDop, exact binary fractions: an aD halfway between two entries is a
# tie, which goes to the lower index.
ADOP = 0.5 * np.arange(1, 61)


def tables(case: str, dtype):
    """(keep, alphad, alphal, idop0, g_iso, g_wavn, g_iso_start, aDop) of
    ``case``, as numpy arrays (floats in ``dtype``).  alphad * wavn /
    alphal is wavn * ratio / 12: at least 0.104 on the first two rows, at
    most 0.05 on the last, where no group recomputes."""
    g_iso = np.repeat(RUN_ISO, RUN_LEN).astype(np.int32)
    first = np.cumsum((0,) + RUN_LEN[:-1])
    g_iso_start = np.repeat(first, RUN_LEN).astype(np.int32)
    ng, niso = g_iso.shape[0], len(RUN_ISO)
    # Wavenumbers descend along a run (the lines go by wavelength).
    g_wavn = np.concatenate([np.linspace(12.0, 2.5, n) for n in RUN_LEN])
    alphad = np.array([[0.5, 0.75, 1.0], [1.25, 0.5, 0.25],
                       [0.5, 0.5, 0.5]])
    ratio = np.array([0.5, 0.5, 0.05])
    alphal = alphad * 12.0 / ratio[:, None]
    idop0 = np.array([[3, 4, 5], [6, 7, 8], [9, 10, 11]], dtype=np.int64)
    rng = np.random.default_rng(RUN_LEN)
    keep = rng.uniform(size=(ROWS, ng)) < 0.4
    run = np.repeat(np.arange(len(RUN_LEN)), RUN_LEN)
    if case == "no_cond_in_a_run":
        keep[:, run == 1] = False
    elif case == "cond_at_run_start_only":
        keep[:] = False
        keep[:, first] = True
    elif case == "cond_in_previous_run_only":
        keep[:] = False
        keep[:, g_iso_start == first[0]] = True
    elif case == "cond_everywhere":
        keep[:] = True
    elif case == "tie":
        # aD = 0.5 * wavn halfway between two aDop entries, and on one.
        g_wavn = np.where(np.arange(ng) % 2 == 0, 2.5, 4.0)
        alphad = np.full((ROWS, niso), 0.5)
        alphal = alphad * 12.0 / ratio[:, None]
        keep[:] = True
    return (keep, alphad.astype(dtype), alphal.astype(dtype), idop0,
            g_iso, g_wavn.astype(dtype), g_iso_start, ADOP.astype(dtype))


def nearest_scalar(aDop, v):
    """The reference's binsearchapprox (iomisc.c:1089-1108): the lower of
    the two bracketing entries unless the upper one is strictly nearer."""
    hi = 1
    while hi < len(aDop) - 1 and aDop[hi] < v:
        hi += 1
    return hi if abs(aDop[hi] - v) < abs(aDop[hi - 1] - v) else hi - 1


def fill_loop(keep, alphad, alphal, idop0, g_iso, g_wavn, aDop):
    """extinction.c:479-483 as a loop: each row starts every isotope at
    its initial index; a kept group whose alphad * wavn / alphal >= 0.1
    recomputes its isotope's index; each group takes its isotope's
    current one.  numpy scalars, so the arithmetic is the arrays'."""
    out = np.zeros(keep.shape, dtype=np.int32)
    tenth = alphad.dtype.type(0.1)
    for r in range(keep.shape[0]):
        idop = list(idop0[r])
        for g in range(keep.shape[1]):
            i = g_iso[g]
            aD = alphad[r, i] * g_wavn[g]
            if keep[r, g] and aD / alphal[r, i] >= tenth:
                idop[i] = nearest_scalar(aDop, aD)
            out[r, g] = idop[i]
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["no_cond_in_a_run",
                                  "cond_at_run_start_only",
                                  "cond_in_previous_run_only",
                                  "cond_everywhere", "tie"])
def test_doppler_fill_plain_is_the_loop(case, dtype):
    arrays = tables(case, dtype)
    got = lbl.doppler_fill_plain(*(torch.as_tensor(a) for a in arrays))
    keep, alphad, alphal, idop0, g_iso, g_wavn, _, aDop = arrays
    want = fill_loop(keep, alphad, alphal, idop0, g_iso, g_wavn, aDop)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    initial = want == idop0[:, g_iso]
    # Each case reaches the branch it is named for.
    if case == "no_cond_in_a_run":
        assert initial[:, RUN_LEN[0]:RUN_LEN[0] + RUN_LEN[1]].all()
    elif case == "cond_in_previous_run_only":
        assert initial[:, RUN_LEN[0]:].all() and not initial[0].all()
    elif case == "cond_at_run_start_only":
        assert not initial[:2].any() and initial[2].all()
    elif case == "tie":
        aD = alphad[0, g_iso] * g_wavn
        i = want[0]
        assert (aD == 1.25).any() and (aD == 2.0).any()
        assert (aDop[i][aD == 1.25] == 1.0).all()     # halfway: the lower
        assert (aDop[i][aD == 2.0] == 2.0).all()      # on an entry
