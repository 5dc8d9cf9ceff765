"""Bound observability: one-line logs whenever a fixed capacity binds.

SURVEY "no silent caps" principle: every place a fixed bound can DROP data
or stop a search early (ring-matcher per-pair match cap, triangulation
track width, RANSAC round budget) reports through this logger, so forced-
truncation tests can assert on the records and large runs surface silent
quality loss in their logs.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("monocularsfm_torch.caps")


def warn_cap(msg: str, *args) -> None:
    logger.warning(msg, *args)
