"""Seeding (counterpart of the JAX ``utils/seeds.py``).

The port draws its tensors' randomness from explicit ``torch.Generator``s
(the models take a ``generator``), so it sets no global torch seed; host
code (shuffling, scanners) draws from Python's and numpy's generators."""

from __future__ import annotations

import random

import numpy as np
import torch


def fix_seeds(seed: int = 0) -> torch.Generator:
    """Seed numpy's and Python's global generators and return a
    ``torch.Generator`` seeded with ``seed`` (where the JAX function returns
    ``PRNGKey(seed)``)."""
    np.random.seed(seed)
    random.seed(seed)
    return torch.Generator().manual_seed(seed)
