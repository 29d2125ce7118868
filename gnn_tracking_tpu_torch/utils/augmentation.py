"""Physics-exact training augmentations (counterpart of the JAX
``utils/augmentation.py``): a global rotation in phi, a reflection in z and
hit dropout, each a ``Trainer`` ``train_transform`` called as
``t(batch, step)``, and ``Compose``.

Each transform draws from a numpy ``default_rng([seed + offset, step])``
exactly as the JAX one does, so the two packages make the same draws for a
given ``(seed, step)``; the transform itself acts on the graph's tensors on
their device and never modifies them in place. Node-feature layout (the
graph builder's DEFAULT_FEATURES): column 1 is phi / pi, 2 is z, 3 is
eta_rz, 4 / 5 the conformal u / v, 12 / 13 the global cell direction (geta,
gphi); edge attributes are (dr, dphi, dz, dR). ``extras["cell_refl"]``
holds each hit's mirror-module (geta, gphi).
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch

from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.training.config import obj_from_config

logger = logging.getLogger(__name__)

PHI_COLUMN = 1
UV_COLUMNS = (4, 5)
GPHI_COLUMN = 13
PHI_SCALE = float(np.pi)  # phi is stored as phi / pi by the graph builder
Z_COLUMN = 2
ETA_RZ_COLUMN = 3
GETA_COLUMN = 12
EDGE_DZ_COLUMN = 2


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _wrap(angle: torch.Tensor) -> torch.Tensor:
    """Wrap to [-pi, pi)."""
    pi = _scalar(math.pi, angle)
    return torch.remainder(angle + pi, 2.0 * pi) - pi


def rotate_phi(x: torch.Tensor, delta: float, *, phi_scale: float = PHI_SCALE) -> torch.Tensor:
    """``x`` with its phi-dependent columns rotated by ``delta`` (rounded to
    float32, as the JAX function takes it). ``phi_scale`` is column 1's
    convention: pi for graph-stage features (phi / pi), 1.0 for point-cloud
    features (radians)."""
    d = _scalar(float(np.float32(delta)), x)
    scale = _scalar(phi_scale, x)
    x = x.clone()
    x[:, PHI_COLUMN] = _wrap(x[:, PHI_COLUMN] * scale + d) / scale
    if x.shape[1] > max(UV_COLUMNS):
        c, s = torch.cos(d), torch.sin(d)
        u, v = x[:, UV_COLUMNS[0]].clone(), x[:, UV_COLUMNS[1]].clone()
        x[:, UV_COLUMNS[0]] = c * u - s * v
        x[:, UV_COLUMNS[1]] = s * u + c * v
    if x.shape[1] > GPHI_COLUMN:
        x[:, GPHI_COLUMN] = _wrap(x[:, GPHI_COLUMN] + d)
    return x


@dataclasses.dataclass
class PhiRotation:
    """A global rotation in phi by ``delta ~ U(-pi, pi)`` from
    ``default_rng([seed, step])``. The stored mirror-module gphi
    (``cell_refl[:, 1]``) turns with the event, so a ``ZReflection`` before
    or after it gives the same features."""

    seed: int = 0
    phi_scale: float = PHI_SCALE

    def delta(self, step: int) -> float:
        return float(np.random.default_rng([self.seed, int(step)]).uniform(-np.pi, np.pi))

    def __call__(self, batch: EventGraph, step: int) -> EventGraph:
        delta = self.delta(step)
        x = rotate_phi(batch.x, delta, phi_scale=self.phi_scale)
        extras = batch.extras
        if "cell_refl" in extras and x.shape[1] > GPHI_COLUMN:
            refl = extras["cell_refl"].clone()
            refl[:, 1] = _wrap(refl[:, 1] + _scalar(float(np.float32(delta)), refl))
            extras = {**extras, "cell_refl": refl}
        return batch.replace(x=x, extras=extras)


def reflect_z(batch: EventGraph) -> EventGraph:
    """The event reflected through z = 0: z, eta_rz, the truth eta and the
    edges' dz flip sign; (geta, gphi) and ``cell_refl`` swap, which makes the
    transform an exact involution. Without ``cell_refl``, geta flips sign
    (approximate)."""
    x = batch.x.clone()
    n_cols = x.shape[1]
    x[:, Z_COLUMN] = -x[:, Z_COLUMN]
    if n_cols > ETA_RZ_COLUMN:
        x[:, ETA_RZ_COLUMN] = -x[:, ETA_RZ_COLUMN]
    extras = dict(batch.extras)
    if "cell_refl" in extras and n_cols > GPHI_COLUMN:
        refl = extras["cell_refl"]
        old = torch.stack([x[:, GETA_COLUMN], x[:, GPHI_COLUMN]], dim=1)
        x[:, GETA_COLUMN] = refl[:, 0].to(x.dtype)
        x[:, GPHI_COLUMN] = refl[:, 1].to(x.dtype)
        extras["cell_refl"] = old.to(refl.dtype)
    elif n_cols > GETA_COLUMN:
        x[:, GETA_COLUMN] = -x[:, GETA_COLUMN]
    edge_attr = batch.edge_attr
    if edge_attr.ndim == 2 and edge_attr.shape[1] > EDGE_DZ_COLUMN:
        edge_attr = edge_attr.clone()
        edge_attr[:, EDGE_DZ_COLUMN] = -edge_attr[:, EDGE_DZ_COLUMN]
    return batch.replace(x=x, edge_attr=edge_attr, eta=-batch.eta, extras=extras)


@dataclasses.dataclass
class ZReflection:
    """The event reflected in z when a coin from
    ``default_rng([seed + 2_000_003, step])`` falls below ``p``."""

    p: float = 0.5
    seed: int = 0
    _warned: bool = dataclasses.field(default=False, repr=False)

    def coin(self, step: int) -> float:
        return float(np.random.default_rng([self.seed + 2_000_003, int(step)]).random())

    def __call__(self, batch: EventGraph, step: int) -> EventGraph:
        if self.coin(step) >= self.p:
            return batch
        if "cell_refl" not in batch.extras and not self._warned:
            logger.warning("batch has no cell_refl extra; geta / gphi use the approximate "
                           "sign-flip mapping")
            self._warned = True
        return reflect_z(batch)


def drop_hits(batch: EventGraph, keep: torch.Tensor) -> EventGraph:
    """``keep`` [N] bool ANDed into the node mask; candidate and true edges
    that touch a dropped hit are masked. Shapes are unchanged."""
    node_mask = batch.node_mask & keep.to(batch.node_mask.device)
    src, dst = batch.edge_index.long()
    ta, tb = batch.true_edge_index.long()
    return batch.replace(
        node_mask=node_mask,
        edge_mask=batch.edge_mask & node_mask[src] & node_mask[dst],
        true_edge_mask=batch.true_edge_mask & node_mask[ta] & node_mask[tb],
    )


@dataclasses.dataclass
class HitDropout:
    """Each hit dropped with probability ``p``: ``keep = u >= p`` for
    uniforms ``u`` from ``default_rng([seed + 1_000_003, step])``, one a
    node in node order."""

    p: float = 0.1
    seed: int = 0

    def keep(self, n: int, step: int) -> np.ndarray:
        return np.random.default_rng([self.seed + 1_000_003, int(step)]).random(n) >= self.p

    def __call__(self, batch: EventGraph, step: int) -> EventGraph:
        return drop_hits(batch, torch.from_numpy(self.keep(batch.node_mask.shape[0], step)))


@dataclasses.dataclass
class Compose:
    """Train transforms applied left to right; ``{class_path, init_args}``
    entries are built with ``training.config.obj_from_config``."""

    transforms: list

    def __post_init__(self):
        self.transforms = [
            obj_from_config(t) if isinstance(t, dict) and "class_path" in t else t
            for t in self.transforms
        ]

    def __call__(self, batch: EventGraph, step: int) -> EventGraph:
        for t in self.transforms:
            batch = t(batch, step)
        return batch
