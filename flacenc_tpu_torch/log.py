"""Logging/observability (the reference's `log` feature analogue).

`FLACENC_LOG` selects the level like the reference CLI's env_logger wiring
(``flacenc-rs/flacenc-bin/src/main.rs:430``); run statistics are
emitted as single JSONL lines like par-mode's counters
(``flacenc-rs/src/par.rs:414-421``).
"""

from __future__ import annotations

import json
import logging
import os

logger = logging.getLogger("flacenc_tpu_torch")

_level = os.environ.get("FLACENC_LOG", "").upper()
if _level:
    # env_logger levels: error/warn/info/debug/trace; python has no TRACE,
    # so the most-verbose level maps to DEBUG (not silently to INFO)
    _resolved = {
        "ERROR": logging.ERROR, "WARN": logging.WARNING,
        "WARNING": logging.WARNING, "INFO": logging.INFO,
        "DEBUG": logging.DEBUG, "TRACE": logging.DEBUG,
    }.get(_level, logging.INFO)
    logging.basicConfig(level=_resolved)
    logger.setLevel(_resolved)


def info_stats(**stats) -> None:
    """Emit a one-line JSON stats record at INFO level."""
    if logger.isEnabledFor(logging.INFO):
        logger.info(json.dumps(stats, sort_keys=True))
