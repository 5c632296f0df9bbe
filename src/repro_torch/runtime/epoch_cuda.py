"""The epoch engine with its rate-groups on the port's contention kernel.

``runtime/epoch.py`` is a copy of the JAX package's array-programmed epoch
engine. Above ``KERNEL_MIN`` lanes per rate-group (``DARIS_EPOCH_KERNEL_MIN``
overrides it) it sends a group to a kernel; this subclass makes that the
port's ``kernels.contention_eta.rates`` on the server's torch device (the
Hopper kernel on the card, its plain version on the CPU), and leaves smaller
groups on ``ContentionModel.rates_seq``. Both return the same bits, so
where the threshold sits cannot change a result.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..kernels import contention_eta
from .epoch import EpochSimBackend


class CudaEpochSimBackend(EpochSimBackend):
    """``EpochSimBackend`` whose large rate-groups run on ``device``."""

    def __init__(self, noise_sigma: float = 0.06,
                 rng: Optional[np.random.Generator] = None, *,
                 device: torch.device):
        super().__init__(noise_sigma=noise_sigma, rng=rng)
        self.device = device

    def _rates_for(self, contention, u, ns, mf) -> List[float]:
        if len(u) >= self._kernel_min:
            return contention_eta.rates(contention.device, u, ns, mf,
                                        device=self.device)
        return contention.rates_seq(u, ns, mf)
