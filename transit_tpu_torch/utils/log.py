"""Leveled logging and stage timers.

Reference: transit/src/transitstd.c:30-83 (tr_output level-gated printing)
and timestart/timecheck (transitstd.c:346-374) wall-clock stage
checkpoints; the counterpart of transit_tpu.utils.log.  A stage given a
``sync`` (a CUDA device, or a tensor on one) waits for that device's
queued work before it stops its clock, so device work is attributed to
the stage that launched it.
"""

from __future__ import annotations

import contextlib
import logging
import sys
import time

import torch

logger = logging.getLogger("transit_tpu_torch")

# Verbosity mapping of the reference's 1..5 levels (flags_tr.h:106-115):
_LEVELS = {1: logging.ERROR, 2: logging.WARNING, 3: logging.INFO,
           4: logging.INFO, 5: logging.DEBUG}


def set_verbosity(verb: int):
    """Map the reference's --verb 1..5 to logging levels."""
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("%(levelname)s :: %(message)s"))
        logger.addHandler(h)
    logger.setLevel(_LEVELS.get(int(verb), logging.INFO))


def warn(msg: str, *args):
    """tr_output(TOUT_WARN, ...) analogue (transitstd.c:30-83)."""
    logger.warning(msg, *args)


def _synchronize(sync):
    device = sync.device if isinstance(sync, torch.Tensor) else \
        torch.device(sync)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timers:
    """Stage wall-clock checkpoints (transitstd.c timestart/timecheck)."""

    def __init__(self):
        self.records = []
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _synchronize(sync)
        dt = time.perf_counter() - t0
        self.records.append((name, dt))
        logger.info("stage %-28s %8.3f s", name, dt)

    def report(self) -> str:
        total = time.perf_counter() - self._t0
        lines = [f"  {n:<30} {dt:8.3f} s" for n, dt in self.records]
        lines.append(f"  {'TOTAL':<30} {total:8.3f} s")
        return "\n".join(lines)
