"""Host-side utilities (JAX-free copies of ``paddle_tpu/utils``)."""
