"""Tensor ops of the LM trunk (counterparts of ``paddle_tpu/ops``)."""
