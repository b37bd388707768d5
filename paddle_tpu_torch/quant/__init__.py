"""Weight-quantization hooks on the LM entry points (``paddle_tpu/quant``)."""
