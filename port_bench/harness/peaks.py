"""The H100 SXM's peaks (NVIDIA data sheet, 700 W): FP32 outside the
tensor cores, the special-function unit (16 results a clock on each of
132 SMs at 1.98 GHz, a quarter of the FP32 rate) and HBM3 bandwidth."""

PEAK_FP32 = 67e12
PEAK_MUFU = 132 * 16 * 1.98e9
PEAK_BYTES = 3.35e12


def bound(ops: float, mufu: float, nbytes: float) -> tuple:
    """(least seconds, the term that sets them) of work at the peaks."""
    terms = {"fp32": ops / PEAK_FP32, "mufu": mufu / PEAK_MUFU,
             "bytes": nbytes / PEAK_BYTES}
    by = max(terms, key=terms.get)
    return terms[by], by
