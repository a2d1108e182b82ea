"""Leveled logging (reference src/logging.h: Log::log[debug/info/warn/error]).

Thin wrapper over the stdlib logging module with the reference's level
semantics: default shows warn+error; --quiet shows error only; --debug all.
"""

from __future__ import annotations

import logging as _logging
import sys

logger = _logging.getLogger("mlsgpu_tpu_torch")
if not logger.handlers:
    _handler = _logging.StreamHandler(sys.stderr)
    _handler.setFormatter(_logging.Formatter("%(message)s"))
    logger.addHandler(_handler)
    logger.setLevel(_logging.INFO)
    logger.propagate = False

debug = logger.debug
info = logger.info
warn = logger.warning
error = logger.error


def set_log_level(verbosity: str) -> None:
    """verbosity in {'debug', 'info', 'quiet'} (maps --debug/default/--quiet)."""
    level = {"debug": _logging.DEBUG, "info": _logging.INFO,
             "quiet": _logging.ERROR}[verbosity]
    logger.setLevel(level)
