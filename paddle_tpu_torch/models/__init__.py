"""Models (counterparts of ``paddle_tpu/models``)."""
