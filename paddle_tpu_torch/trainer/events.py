"""Trainer event stream (a copy of ``paddle_tpu/trainer/events.py``;
reference: python/paddle/v2/event.py)."""

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class BeginPass:
    pass_id: int


@dataclasses.dataclass
class EndPass:
    pass_id: int
    evaluator_results: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BeginIteration:
    pass_id: int
    batch_id: int


@dataclasses.dataclass
class EndIteration:
    pass_id: int
    batch_id: int
    # a 0-d tensor on the trainer's device (float(e.cost) syncs) — keeps
    # the train loop free of per-batch host round-trips
    cost: Any
    evaluator_results: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class EndTesting:
    pass_id: int
    cost: float
    evaluator_results: Dict[str, Any] = dataclasses.field(default_factory=dict)
