"""Small helpers of the training loop (counterpart of
``de6d_tpu/utils/common_utils.py``: ``AverageMeter``,
``set_random_seed``)."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_random_seed(seed: int):
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


class AverageMeter:
    """Running average of a scalar."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
