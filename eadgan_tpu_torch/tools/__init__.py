"""Probes and measurement entry points
(``python -m eadgan_tpu_torch.tools.<name>``)."""
