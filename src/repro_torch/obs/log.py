"""Minimal structured logger (a copy of the reference's ``obs/log.py``,
which uses no framework).

Design constraints that ruled out stdlib ``logging``: the default output
must stay byte-compatible-ish with the existing ``[loop] step 12: ...``
style (tests and humans read it), level control is a single env var
(``REPRO_LOG=debug|info|warning|error|off``) read lazily at call time so
tests can flip it without re-importing, and there is no handler tree to
misconfigure.  ``REPRO_LOG_FORMAT=json`` switches to one-JSON-object-per-
line for machine consumption.
"""
from __future__ import annotations

import json
import os
import sys

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40, "off": 99}
_DEFAULT = "info"


def _threshold() -> int:
    # read at call time: REPRO_LOG set mid-process takes effect immediately
    return LEVELS.get(os.environ.get("REPRO_LOG", _DEFAULT).lower(), LEVELS[_DEFAULT])


class Logger:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def _emit(self, level: str, msg: str, fields: dict) -> None:
        if LEVELS[level] < _threshold():
            return
        if os.environ.get("REPRO_LOG_FORMAT", "").lower() == "json":
            rec = {"level": level, "logger": self.name, "msg": msg}
            rec.update(fields)
            line = json.dumps(rec)
        else:
            # human default matches the repo's historical print style
            line = f"[{self.name}] {msg}"
            if fields:
                line += " " + " ".join(f"{k}={v}" for k, v in fields.items())
        stream = sys.stderr if LEVELS[level] >= LEVELS["warning"] else sys.stdout
        print(line, file=stream, flush=True)

    def debug(self, msg: str, **fields) -> None:
        self._emit("debug", msg, fields)

    def info(self, msg: str, **fields) -> None:
        self._emit("info", msg, fields)

    def warning(self, msg: str, **fields) -> None:
        self._emit("warning", msg, fields)

    def error(self, msg: str, **fields) -> None:
        self._emit("error", msg, fields)


_LOGGERS: dict = {}


def get_logger(name: str) -> Logger:
    lg = _LOGGERS.get(name)
    if lg is None:
        lg = _LOGGERS[name] = Logger(name)
    return lg
