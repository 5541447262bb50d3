"""Two-stream leveled logging (the port's copy of firedancer_tpu/utils/log.py).

Eight syslog-style levels; an ephemeral stream to stderr for the operator
and a permanent stream to a log file for forensics, each with its own
threshold.  WARNING and above always flush; ERR and above raise LogError
by default (the reference aborts the tile; containment is the
supervisor's job, runtime/topo.py).

Configured by `init()` only: stderr at NOTICE, no log file, until a caller
says otherwise (the JAX package also reads FDTPU_LOG_* variables; the port
reads no environment).
"""

from __future__ import annotations

import os
import sys
import threading
import time

DEBUG, INFO, NOTICE, WARNING, ERR, CRIT, ALERT, EMERG = range(8)
_NAMES = ["DEBUG", "INFO", "NOTICE", "WARNING", "ERR", "CRIT", "ALERT", "EMERG"]


class LogError(RuntimeError):
    """Raised for ERR+ logs (the fd_log abort, catchable in Python)."""


class _LogState:
    def __init__(self):
        self.lock = threading.Lock()
        self.stderr_level = NOTICE
        self.file_level = INFO
        self.path = ""
        self._file = None
        self.raise_on_err = True

    def file(self):
        if self._file is None and self.path:
            self._file = open(self.path, "a", buffering=1)
        return self._file


_state = _LogState()


def init(*, path: str | None = None, stderr_level: int | None = None,
         file_level: int | None = None, raise_on_err: bool | None = None) -> None:
    with _state.lock:
        if path is not None:
            _state.path = path
            _state._file = None
        if stderr_level is not None:
            _state.stderr_level = stderr_level
        if file_level is not None:
            _state.file_level = file_level
        if raise_on_err is not None:
            _state.raise_on_err = raise_on_err


def _emit(level: int, tag: str, msg: str) -> None:
    if level < min(_state.stderr_level, _state.file_level) and level < ERR:
        return
    ts = time.strftime("%H:%M:%S", time.localtime())
    line = f"{ts} {_NAMES[level]:<7} {os.getpid()} {tag}: {msg}"
    with _state.lock:
        if level >= _state.stderr_level:
            print(line, file=sys.stderr)
            if level >= WARNING:
                sys.stderr.flush()
        f = _state.file()
        if f is not None and level >= _state.file_level:
            f.write(line + "\n")
    if level >= ERR and _state.raise_on_err:
        raise LogError(msg)


class Logger:
    """A component's handle; `tag` prefixes every line (the stage's name)."""

    __slots__ = ("tag",)

    def __init__(self, tag: str):
        self.tag = tag

    def debug(self, msg: str) -> None:
        _emit(DEBUG, self.tag, msg)

    def info(self, msg: str) -> None:
        _emit(INFO, self.tag, msg)

    def notice(self, msg: str) -> None:
        _emit(NOTICE, self.tag, msg)

    def warning(self, msg: str) -> None:
        _emit(WARNING, self.tag, msg)

    def err(self, msg: str) -> None:
        _emit(ERR, self.tag, msg)

    def crit(self, msg: str) -> None:
        _emit(CRIT, self.tag, msg)


def get_logger(tag: str) -> Logger:
    return Logger(tag)
