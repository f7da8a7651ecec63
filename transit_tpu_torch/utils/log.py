"""Warnings (reference: transit/src/transitstd.c:30-83, tr_output)."""

from __future__ import annotations

import logging

logger = logging.getLogger("transit_tpu_torch")


def warn(msg: str, *args):
    """tr_output(TOUT_WARN, ...) analogue (transitstd.c:30-83)."""
    logger.warning(msg, *args)
