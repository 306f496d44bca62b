"""Command-line tooling for paddle_tpu_torch (``python -m paddle_tpu_torch.tools.<tool>``)."""
