"""Command-line entry points (``python -m eadgan_tpu_torch.cli.<name>``)."""
