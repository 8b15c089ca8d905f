"""Logging, the equivalent of ``Manager/MaCh3Logger.h``.

The reference wraps spdlog with ``MACH3LOG_{TRACE..CRITICAL}`` macros and a
compile-time level (``cmake/Modules/Logger.cmake``). Here we use stdlib logging
with a process-wide level configurable via ``MACH3_LOG_LEVEL``.
"""
from __future__ import annotations

import logging
import os
import sys

_FORMAT = "[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    level = os.environ.get("MACH3_LOG_LEVEL", "INFO").upper()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
    root = logging.getLogger("mach3_torch")
    root.setLevel(getattr(logging, level, logging.INFO))
    root.addHandler(handler)
    root.propagate = False
    _configured = True


def get_logger(name: str = "mach3_torch") -> logging.Logger:
    _configure()
    if name != "mach3_torch" and not name.startswith("mach3_torch."):
        name = f"mach3_torch.{name}"
    return logging.getLogger(name)


class capture_stdout:
    """Route third-party ``print`` output through the logger — the reference's
    ``LoggerPrint`` wrapper (``Manager/MaCh3Logger.h``: captures library stdout
    into spdlog so every line carries the framework's formatting/level).

    >>> with capture_stdout("thirdparty"):
    ...     noisy_library_call()
    """

    def __init__(self, name: str = "capture", level: int = logging.INFO):
        self._logger = get_logger(name)
        self._level = level
        self._buffer = ""

    def write(self, text: str) -> int:
        self._buffer += text
        while "\n" in self._buffer:
            line, self._buffer = self._buffer.split("\n", 1)
            if line.strip():
                self._logger.log(self._level, "%s", line)
        return len(text)

    def flush(self) -> None:
        if self._buffer.strip():
            self._logger.log(self._level, "%s", self._buffer)
        self._buffer = ""

    def __enter__(self) -> "capture_stdout":
        self._saved = sys.stdout
        sys.stdout = self
        return self

    def __exit__(self, *exc) -> None:
        self.flush()
        sys.stdout = self._saved
