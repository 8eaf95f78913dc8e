"""Disentanglement evaluation suite (PyTorch counterpart of
``eadgan_tpu.eval``).

Six metrics x two dataset variants: BetaVAE, FactorVAE, MIG, SAP, DCI,
F-statistic (modularity/explicitness).  The encoders and the warp run
batched on the device (:class:`Representer`); the classical-statistics
heads run on the host in numpy/scipy (``eval/heads.py``), where the JAX
package calls scikit-learn.
"""

from eadgan_tpu_torch.eval.data import make_metric_data
from eadgan_tpu_torch.eval.metrics import (
    betavae_score,
    dci_score,
    factorvae_score,
    fstat_score,
    mig_score,
    sap_score,
)
from eadgan_tpu_torch.eval.representation import Representer

__all__ = [
    "make_metric_data",
    "Representer",
    "betavae_score",
    "factorvae_score",
    "mig_score",
    "sap_score",
    "dci_score",
    "fstat_score",
]
