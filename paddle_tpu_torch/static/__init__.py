"""Host-side step drivers of the port (paddle_tpu/static)."""
