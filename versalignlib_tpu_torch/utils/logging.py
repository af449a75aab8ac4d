"""Leveled component logging (the port's copy of
``versalignlib_tpu/utils/logging.py``).

Analogue of the reference's injected ``AlignmentLogger``
(AlignmentLogger.h:13-22) and its ``CustomLogger`` (CustomLogger.h:17-60),
which formats ``SEVERITY\\t[component]\\tmessage`` to stderr with levels
0=INFO / 1=WARNING / 3=DRASTIC, on top of the stdlib ``logging`` module.
"""

from __future__ import annotations

import logging
import os
import sys

_ROOT_NAME = "versalignlib_tpu_torch"
_CONFIGURED = False

#: Reference numeric level -> stdlib level (CustomLogger.h:22-35; level 2 is
#: unused in the reference and falls through to ERROR, as does anything else).
_REF_LEVELS = {0: logging.INFO, 1: logging.WARNING, 3: logging.CRITICAL}


def _configure() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    root = logging.getLogger(_ROOT_NAME)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(levelname)s\t[%(name)s]\t%(message)s")
        )
        root.addHandler(handler)
    level = os.environ.get("VERSALIGN_LOG", "WARNING").upper()
    root.setLevel(getattr(logging, level, logging.WARNING))
    root.propagate = False
    _CONFIGURED = True


def get_logger(component: str) -> logging.Logger:
    """Logger for a named component (``[versalignlib_tpu_torch.<c>]``)."""
    _configure()
    return logging.getLogger(f"{_ROOT_NAME}.{component}")


def set_level(level: int | str) -> None:
    _configure()
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    logging.getLogger(_ROOT_NAME).setLevel(level)


def log(level: int, component: str, msg: str, *args) -> None:
    """Reference-compatible entry point (AlignmentLogger::log semantics):
    numeric levels 0=INFO, 1=WARNING, 3=DRASTIC, anything else ERROR; extra
    args are appended as additional lines (CustomLogger.h:41-48)."""
    logger = get_logger(component)
    std = _REF_LEVELS.get(level, logging.ERROR)
    if args:
        msg = "\n".join([msg, *map(str, args)])
    logger.log(std, msg)
