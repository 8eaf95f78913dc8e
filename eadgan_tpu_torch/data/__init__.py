"""Dataset ingest (host numpy/PIL) and the host-to-card feed.

The per-step engine and the chained engine's raw windows feed the card
through :class:`eadgan_tpu_torch.data.loader.Prefetcher`, which prepares
the next batches on a background thread (the native gathers of
``data/native.py``, into pinned memory) while the current step runs.
"""

from eadgan_tpu_torch.data.celeba import load_image_folder
from eadgan_tpu_torch.data.dsprites import DspritesData, load_dsprites
from eadgan_tpu_torch.data.loader import Prefetcher, epoch_batches
from eadgan_tpu_torch.data.mnist import load_mnist

__all__ = [
    "Prefetcher",
    "epoch_batches",
    "load_image_folder",
    "load_dsprites",
    "DspritesData",
    "load_mnist",
]
