"""Host-side observability: end-to-end request tracing (``obs/trace.py``;
``paddle_tpu/obs``).  Per-request spans, propagated by a traceparent
header, exported as Chrome trace-event JSON."""

from paddle_tpu_torch.obs.trace import (NULL, Span, Tracer, chrome_trace,
                                        current, current_trace_id,
                                        debug_payload, disable,
                                        dump_chrome_trace, enable, enabled,
                                        extract, get_tracer, inject,
                                        instant, set_process, slowest,
                                        snapshot, span, start_span)

__all__ = [
    "NULL", "Span", "Tracer", "chrome_trace", "current",
    "current_trace_id", "debug_payload", "disable", "dump_chrome_trace",
    "enable", "enabled", "extract", "get_tracer", "inject", "instant",
    "set_process", "slowest", "snapshot", "span", "start_span",
]
