"""Logging (the glog-style text format of ``paddle_tpu/utils/logging.py``;
its JSON format and per-request correlation fields wait for the port's
tracing slice)."""

import logging
import os
import sys

_FMT = "%(levelname).1s %(asctime)s %(name)s] %(message)s"


def get_logger(name="paddle_tpu_torch", level=None):
    log = logging.getLogger(name)
    if not log.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FMT,
                                               datefmt="%m%d %H:%M:%S"))
        log.addHandler(handler)
        log.propagate = False
        log.setLevel(level or os.environ.get("PADDLE_TPU_LOG_LEVEL", "INFO"))
    return log


logger = get_logger()
