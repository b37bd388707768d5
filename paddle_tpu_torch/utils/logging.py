"""Logging (``paddle_tpu/utils/logging.py``; reference paddle/utils/
Logging.h, the glog wrapper).

Two formats, chosen by ``PADDLE_TPU_LOG_FORMAT`` (or ``set_format()``):
``text`` (the default), the glog-style line, and ``json``, one JSON
object per line.  Both append the context-local correlation fields that
``log_context(request_id=..., trace_id=...)`` installs for the lines
logged inside its ``with`` block: the text format as ``k=v`` pairs, the
json format as top-level fields and in the same ``k=v`` tail.
"""

import contextlib
import contextvars
import json
import logging
import os
import sys

_FMT = "%(levelname).1s %(asctime)s %(name)s] %(message)s"

# context-local correlation fields (per thread and per async context)
_log_ctx = contextvars.ContextVar("paddle_tpu_torch_log_ctx",
                                  default=None)


@contextlib.contextmanager
def log_context(**fields):
    """Attach correlation fields (request_id=, trace_id=, ...) to every
    log line emitted inside the with-body on this thread/context.
    Falsy values are dropped; nesting merges."""
    merged = dict(_log_ctx.get() or {})
    merged.update({k: str(v) for k, v in fields.items() if v})
    token = _log_ctx.set(merged)
    try:
        yield
    finally:
        _log_ctx.reset(token)


def context_fields():
    """The currently attached correlation fields (read-only copy)."""
    return dict(_log_ctx.get() or {})


def _ctx_tail():
    fields = _log_ctx.get()
    if not fields:
        return ""
    return " " + " ".join(f"{k}={fields[k]}" for k in sorted(fields))


class _TextFormatter(logging.Formatter):
    def format(self, record):
        return super().format(record) + _ctx_tail()


class _JsonFormatter(logging.Formatter):
    def format(self, record):
        out = {
            "ts": self.formatTime(record, "%Y-%m-%dT%H:%M:%S"),
            "level": record.levelname,
            "logger": record.name,
            # the greppable tail rides inside msg too, so one
            # `grep trace_id=<id>` crosses text- and json-format logs
            "msg": record.getMessage() + _ctx_tail(),
        }
        out.update(_log_ctx.get() or {})
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def _make_formatter(fmt=None):
    fmt = fmt or os.environ.get("PADDLE_TPU_LOG_FORMAT", "text")
    if fmt == "json":
        return _JsonFormatter()
    return _TextFormatter(_FMT, datefmt="%m%d %H:%M:%S")


def set_format(fmt):
    """Switch every handler this module installed to ``"text"`` or
    ``"json"`` (the env var sets the initial choice)."""
    for log in _loggers:
        for h in log.handlers:
            h.setFormatter(_make_formatter(fmt))


_loggers = []


def get_logger(name="paddle_tpu_torch", level=None):
    log = logging.getLogger(name)
    if not log.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_make_formatter())
        log.addHandler(handler)
        log.propagate = False
        log.setLevel(level or os.environ.get("PADDLE_TPU_LOG_LEVEL", "INFO"))
        _loggers.append(log)
    return log


logger = get_logger()
