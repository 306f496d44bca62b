"""Host-side utilities of the port (``paddle_tpu_torch.utils``)."""
