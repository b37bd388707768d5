"""Serving exceptions — copies of the classes in ``paddle_tpu/serving/
engine.py`` (``InvalidRequestError``) and ``paddle_tpu/serving/batcher.py``
(the rest).  The HTTP front-end maps each to a status code."""


class InvalidRequestError(ValueError):
    """The request does not fit the engine (ids, lengths, max_tokens) —
    raised BEFORE the request reaches the queue (HTTP 400)."""


class OverloadedError(RuntimeError):
    """The bounded request queue is full; retry with backoff (HTTP 429)."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before it reached the engine."""


class ShutdownError(RuntimeError):
    """The batcher is draining/closed; no new requests are admitted."""


class BatchExecutionError(RuntimeError):
    """The engine failed while executing the step holding this request
    (cause chained); later steps are unaffected."""
