"""Utilities: metric logging and device selection."""

from eadgan_tpu_torch.utils.device import platform_device, resolve_device
from eadgan_tpu_torch.utils.logging import MetricLogger

__all__ = ["MetricLogger", "resolve_device", "platform_device"]
