"""Core data structures (``paddle_tpu/core``)."""
