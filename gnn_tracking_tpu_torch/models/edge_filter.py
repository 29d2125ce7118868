"""Edge filters: per-edge scores without message passing (counterpart of the
JAX ``models/edge_filter.py``: ``EFDeepSet``, ``EFMLP`` and
``GeometricEF``).

``EFDeepSet`` and ``EFMLP`` return ``{"W": scores in (0, 1)}``, as
``MLGraphConstruction(ef=..., ec_threshold=...)`` and ``ECModule`` take
them; ``GeometricEF`` returns the boolean keep-mask itself, as in JAX.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.models.mlp import MLP, NormalLinear
from gnn_tracking_tpu_torch.utils.device import resolve_device


class EFDeepSet(nn.Module):
    """Deep-sets edge filter (JAX ``edge_filter.py:16-48``): a node encoder
    (``MLP``, no biases, last ReLU included) on the L2-normalized features,
    the permutation invariants ``|x_i - x_j|`` and ``x_i + x_j`` of each
    edge, and an aggregator ``MLP`` (width ``2 * hidden_dim``, no biases) to
    one logit. The JAX module reads the input width from its first call;
    here it is ``node_indim``. ``model_config`` holds the constructor
    arguments."""

    def __init__(
        self,
        node_indim: int,
        hidden_dim: int = 128,
        depth: int = 3,
        *,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.model_config = {"node_indim": node_indim, "hidden_dim": hidden_dim, "depth": depth}
        g = generator
        self.node_encoder = MLP(
            node_indim, hidden_dim, hidden_dim, L=depth, bias=False,
            include_last_activation=True, generator=g,
        )
        self.aggregator = MLP(2 * hidden_dim, 1, 2 * hidden_dim, L=depth, bias=False, generator=g)
        self.to(dev)

    def forward(self, data: EventGraph) -> dict[str, torch.Tensor]:
        norm = torch.linalg.vector_norm(data.x, dim=-1, keepdim=True)
        x_encoded = self.node_encoder(data.x / torch.clamp(norm, min=1e-12))
        src, dst = data.edge_index.long()
        xi, xj = x_encoded[src], x_encoded[dst]
        logits = self.aggregator(torch.cat([torch.abs(xi - xj), xi + xj], dim=1))
        epsilon = 1e-8
        return {"W": epsilon + (1 - 2 * epsilon) * torch.sigmoid(logits).squeeze(-1)}


class EFMLP(nn.Module):
    """Residual MLP edge filter over ``[x_i, x_j, edge_attr]`` (JAX
    ``edge_filter.py:51-82``): a ``NormalLinear`` encoder (variance
    ``1 / in``), ``depth - 1`` residual layers ``x = sqrt(beta) *
    layer(relu(x)) + sqrt(1 - beta) * x`` and a decoder (variance ``2 /
    hidden_dim``), none with biases; ``W = 0.001 + 0.998 * sigmoid``.
    ``edge_indim = 0`` leaves the edge features out. ``model_config`` holds
    the constructor arguments."""

    def __init__(
        self,
        node_indim: int,
        hidden_dim: int,
        depth: int,
        edge_indim: int = 0,
        beta: float = 0.4,
        *,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.model_config = {
            "node_indim": node_indim, "hidden_dim": hidden_dim, "depth": depth,
            "edge_indim": edge_indim, "beta": beta,
        }
        self.edge_indim, self.beta = edge_indim, beta
        g = generator
        in_dim = 2 * node_indim + edge_indim
        self.encoder = NormalLinear(in_dim, hidden_dim, 1.0 / in_dim, bias=False, generator=g)
        self.layers = nn.ModuleList(
            NormalLinear(hidden_dim, hidden_dim, 2.0 / hidden_dim, bias=False, generator=g)
            for _ in range(depth - 1)
        )
        self.decoder = NormalLinear(hidden_dim, 1, 2.0 / hidden_dim, bias=False, generator=g)
        self.to(dev)

    def forward(self, data: EventGraph) -> dict[str, torch.Tensor]:
        src, dst = data.edge_index.long()
        features = [data.x[src], data.x[dst]]
        if self.edge_indim > 0:
            features.append(data.edge_attr)
        x = self.encoder(torch.cat(features, dim=1))
        for layer in self.layers:
            x = math.sqrt(self.beta) * layer(torch.relu(x)) + math.sqrt(1 - self.beta) * x
        logits = self.decoder(torch.relu(x))
        return {"W": 0.001 + 0.998 * torch.sigmoid(logits).squeeze(-1)}


class GeometricEF(nn.Module):
    """Parameter-free geometric edge filter: the keep-mask of the cuts on
    ``|phi_slope| < phi_slope_max``, ``|z0| < z0_max`` and ``|dR| < dR_max``
    of each edge (JAX ``edge_filter.py:85-110``). Node features are read as
    ``[r, phi, z, eta, ...]``."""

    def __init__(self, phi_slope_max: float, z0_max: float, dR_max: float):
        super().__init__()
        self.phi_slope_max, self.z0_max, self.dR_max = phi_slope_max, z0_max, dR_max

    def forward(self, data: EventGraph) -> torch.Tensor:
        r, phi, z, eta = data.x[:, 0], data.x[:, 1], data.x[:, 2], data.x[:, 3]
        i, j = data.edge_index.long()
        dz, dr = z[i] - z[j], r[i] - r[j]
        dphi, deta = phi[i] - phi[j], eta[i] - eta[j]
        dR = torch.sqrt(deta**2 + dphi**2)
        phi_slope = dphi / dR
        z0 = z[i] - r[i] * dz / dr
        return (
            (torch.abs(phi_slope) < self.phi_slope_max)
            & (torch.abs(z0) < self.z0_max)
            & (torch.abs(dR) < self.dR_max)
        )
