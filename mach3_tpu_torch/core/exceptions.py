"""Exceptions with throw-site context.

Equivalent of the reference's ``MaCh3Exception``
(``Manager/MaCh3Exception.h:23-45``) which logs file:line at the throw site.
Python tracebacks already carry the location, so we only mirror the logging
behaviour: the error is logged when raised.
"""
from __future__ import annotations

import inspect

from .logging import get_logger

_log = get_logger("mach3_torch")


class MaCh3Error(Exception):
    """Framework error; logs file:line of the raise site like the reference."""

    def __init__(self, message: str):
        frame = inspect.stack()[1]
        _log.error("%s:%d: %s", frame.filename, frame.lineno, message)
        super().__init__(message)


class ConfigError(MaCh3Error):
    """Bad or missing configuration (YAML) entry."""
