"""Structured logging (reference parity: logging/logging.go, logging/default.go).

Counterpart of `sonido_sonar_tpu/logging/__init__.py`, the same surface
under this package's own logger name.

The reference exposes a Logger interface with Debug/Info/Warn/Error +
WithFields, a swappable global logger, and a colored stdout default.
Here we wrap Python's stdlib logging with the same structured-fields
surface so pipeline components can log `component=... function=...`
fields the way the Go code does (e.g. analyzers/spectral.go:398-405).
"""

from __future__ import annotations

import logging as _pylog
import sys
import threading
from typing import Any, Dict, Mapping, Optional

Fields = Dict[str, Any]

_LEVELS = {
    "debug": _pylog.DEBUG,
    "info": _pylog.INFO,
    "warn": _pylog.WARNING,
    "error": _pylog.ERROR,
    "fatal": _pylog.CRITICAL,
}

_COLORS = {
    _pylog.DEBUG: "\x1b[36m",
    _pylog.INFO: "\x1b[32m",
    _pylog.WARNING: "\x1b[33m",
    _pylog.ERROR: "\x1b[31m",
    _pylog.CRITICAL: "\x1b[35m",
}
_RESET = "\x1b[0m"


class Logger:
    """Structured logger: level methods + with_fields (logging.go:49-64)."""

    def __init__(
        self,
        name: str = "sonido_sonar_tpu_torch",
        fields: Optional[Fields] = None,
        py_logger: Optional[_pylog.Logger] = None,
    ):
        self._name = name
        self._fields: Fields = dict(fields or {})
        self._log = py_logger or _pylog.getLogger(name)

    # -- field scoping -------------------------------------------------
    def with_fields(self, **fields: Any) -> "Logger":
        merged = {**self._fields, **fields}
        return Logger(self._name, merged, self._log)

    def with_context(self, context: Any) -> "Logger":
        """WithContext (logging.go:60): attach a request/trace context
        object as a field."""
        return self.with_fields(context=context)

    def with_component(self, component: str, function: str = "") -> "Logger":
        f: Fields = {"component": component}
        if function:
            f["function"] = function
        return self.with_fields(**f)

    # -- emit ----------------------------------------------------------
    def _fmt(self, msg: str, extra: Mapping[str, Any]) -> str:
        fields = {**self._fields, **extra}
        if not fields:
            return msg
        kv = " ".join(f"{k}={v}" for k, v in sorted(fields.items()))
        return f"{msg} | {kv}"

    def debug(self, msg: str, **fields: Any) -> None:
        self._log.debug(self._fmt(msg, fields))

    def info(self, msg: str, **fields: Any) -> None:
        self._log.info(self._fmt(msg, fields))

    def warn(self, msg: str, **fields: Any) -> None:
        self._log.warning(self._fmt(msg, fields))

    warning = warn

    def error(self, msg: str, **fields: Any) -> None:
        self._log.error(self._fmt(msg, fields))

    def fatal(self, msg: str, **fields: Any) -> None:
        self._log.critical(self._fmt(msg, fields))
        raise SystemExit(1)

    def set_level(self, level: str) -> None:
        self._log.setLevel(_LEVELS.get(level.lower(), _pylog.INFO))


class _ColorFormatter(_pylog.Formatter):
    """Colored TTY output (default.go:16-56)."""

    def __init__(self, use_color: bool):
        super().__init__("%(asctime)s %(levelname)-5s %(message)s", "%H:%M:%S")
        self._use_color = use_color

    def format(self, record: _pylog.LogRecord) -> str:
        out = super().format(record)
        if self._use_color:
            color = _COLORS.get(record.levelno, "")
            return f"{color}{out}{_RESET}"
        return out


def new_default_logger(level: str = "info") -> Logger:
    py = _pylog.getLogger("sonido_sonar_tpu_torch")
    if not py.handlers:
        handler = _pylog.StreamHandler(sys.stderr)
        handler.setFormatter(_ColorFormatter(sys.stderr.isatty()))
        py.addHandler(handler)
        py.propagate = False
    py.setLevel(_LEVELS.get(level.lower(), _pylog.INFO))
    return Logger(py_logger=py)


_global_lock = threading.Lock()
_global_logger: Optional[Logger] = None


def get_global_logger() -> Logger:
    """Swappable global logger (logging.go:66-106)."""
    global _global_logger
    with _global_lock:
        if _global_logger is None:
            _global_logger = new_default_logger()
        return _global_logger


def set_global_logger(logger: Logger) -> None:
    global _global_logger
    with _global_lock:
        _global_logger = logger


class AppLoggerAdapter(Logger):
    """Duck-typed adapter wrapping an application's own logger object —
    the Python equivalent of the reference's reflection-based
    LoggerFromAppLogger (logging/logging.go:129-263), which probes an
    arbitrary logger for Debug/Info/Warn/Error methods at runtime.

    Any object exposing some subset of debug/info/warning|warn/error/
    critical|fatal (stdlib logging.Logger, structlog, loguru, ...) can
    back the framework's structured logging; missing levels fall back to
    `info`, and fields are appended key=value as the reference does.
    """

    def __init__(self, app_logger: Any, fields: Optional[Dict[str, Any]] = None):
        self._app = app_logger
        self._fields: Dict[str, Any] = dict(fields or {})

    def _resolve(self, *names: str):
        for name in names:
            fn = getattr(self._app, name, None)
            if callable(fn):
                return fn
        fn = getattr(self._app, "info", None)
        return fn if callable(fn) else (lambda *_a, **_k: None)

    def with_fields(self, **fields: Any) -> "AppLoggerAdapter":
        merged = dict(self._fields)
        merged.update(fields)
        return AppLoggerAdapter(self._app, merged)

    def with_context(self, context: Any) -> "AppLoggerAdapter":
        return self.with_fields(context=context)

    def with_component(self, component: str, function: str = "") -> "AppLoggerAdapter":
        f = {"component": component}
        if function:
            f["function"] = function
        return self.with_fields(**f)

    def _emit(self, names, msg: str, extra: Mapping[str, Any]) -> None:
        self._resolve(*names)(self._fmt(msg, extra))

    def debug(self, msg: str, **fields: Any) -> None:
        self._emit(("debug",), msg, fields)

    def info(self, msg: str, **fields: Any) -> None:
        self._emit(("info",), msg, fields)

    def warn(self, msg: str, **fields: Any) -> None:
        self._emit(("warning", "warn"), msg, fields)

    def error(self, msg: str, **fields: Any) -> None:
        self._emit(("error",), msg, fields)

    def fatal(self, msg: str, **fields: Any) -> None:
        self._emit(("critical", "fatal", "error"), msg, fields)
        raise SystemExit(1)

    def set_level(self, level: str) -> None:
        set_level = getattr(self._app, "setLevel", None)
        if callable(set_level):
            import logging as _std

            set_level(getattr(_std, level.upper(), _std.INFO))


def logger_from_app_logger(app_logger: Any) -> Logger:
    """LoggerFromAppLogger (logging.go:129-263): wrap any duck-typed
    logger; None falls back to the default logger."""
    if app_logger is None:
        return new_default_logger()
    return AppLoggerAdapter(app_logger)
