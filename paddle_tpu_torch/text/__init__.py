"""Text models of the port (paddle_tpu/text)."""
