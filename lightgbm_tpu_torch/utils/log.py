"""Leveled logging (copied from lightgbm_tpu/utils/log.py, without the
structured event channel; reference `utils/log.h:37-48` + the verbosity
mapping in `config.cpp:184-192`): Fatal raises, Warning/Info/Debug print subject
to the level, and a host-language callback can capture output (the
reference's C API installs one so logs flow to Python/R).
"""
from __future__ import annotations

import sys
from typing import Callable, Optional

FATAL, WARNING, INFO, DEBUG = -1, 0, 1, 2

_level = INFO
_callback: Optional[Callable[[str], None]] = None


def set_verbosity(verbosity: int) -> None:
    """config `verbosity` -> level (reference config.cpp:184-192):
    <0 fatal only, 0 warnings, 1 info, >1 debug."""
    global _level
    if verbosity < 0:
        _level = FATAL
    elif verbosity == 0:
        _level = WARNING
    elif verbosity == 1:
        _level = INFO
    else:
        _level = DEBUG


def register_callback(fn: Optional[Callable[[str], None]]) -> None:
    """Route log lines to `fn` instead of stderr (reference
    `LGBM_RegisterLogCallback`)."""
    global _callback
    _callback = fn


def _emit(tag: str, msg: str) -> None:
    line = f"[LightGBM-TPU] [{tag}] {msg}"
    if _callback is not None:
        _callback(line)
    else:
        print(line, file=sys.stderr, flush=True)


def debug(msg: str) -> None:
    if _level >= DEBUG:
        _emit("Debug", msg)


def info(msg: str) -> None:
    if _level >= INFO:
        _emit("Info", msg)


def warning(msg: str) -> None:
    if _level >= WARNING:
        _emit("Warning", msg)


def fatal(msg: str) -> None:
    """Always raises (reference Log::Fatal throws)."""
    _emit("Fatal", msg)
    raise RuntimeError(msg)
