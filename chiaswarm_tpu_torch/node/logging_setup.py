"""Rotating-file + console logging: a copy of
``chiaswarm_tpu/node/logging_setup.py`` (capability of
swarm/log_setup.py:5-29).

Uses the stdlib RotatingFileHandler (the reference pulls in an external
concurrent-log-handler package; one process per host writes the log here, so
stdlib rotation is sufficient and dependency-free).
"""

from __future__ import annotations

import logging
import logging.handlers
from pathlib import Path

_MAX_BYTES = 50 * 1024 * 1024
_BACKUP_COUNT = 7

_FORMAT = "%(asctime)s %(levelname)s %(name)s %(message)s"


def setup_logging(log_dir: Path | str, filename: str = "swarm-tpu.log",
                  level: str = "INFO") -> logging.Logger:
    root = logging.getLogger()
    root.setLevel(getattr(logging, str(level).upper(), logging.INFO))

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)

    have_file = any(
        isinstance(h, logging.handlers.RotatingFileHandler) for h in root.handlers
    )
    if not have_file:
        handler = logging.handlers.RotatingFileHandler(
            log_dir / filename, maxBytes=_MAX_BYTES, backupCount=_BACKUP_COUNT
        )
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)

    have_stream = any(
        type(h) is logging.StreamHandler for h in root.handlers
    )
    if not have_stream:
        console = logging.StreamHandler()
        console.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(console)
    return root
