"""Metric-learning embedding and learned graph construction (counterpart of
the JAX ``models/graph_construction.py``: ``_LatentNormalization``,
``GraphConstructionFCNN`` and ``MLGraphConstruction``).

``MLGraphConstruction`` embeds the hits, builds a fixed-degree kNN graph in
the embedding space (``ops/knn.py``), labels its edges with the truth and
builds edge features. Its graph has ``N * k`` edge slots; the radius cut
and false-edge subsampling only change ``edge_mask``.

Not ported yet (``NotImplementedError``): the edge filter ``ef``, and the
heterogeneous and ResIN embedding models.
"""

from __future__ import annotations

import torch
from torch import nn

from gnn_tracking_tpu_torch.graphs import DERIVED_KEYS, EventGraph
from gnn_tracking_tpu_torch.models.mlp import ResFCNN
from gnn_tracking_tpu_torch.ops.knn import knn_with_max_radius
from gnn_tracking_tpu_torch.utils.device import resolve_device


class _LatentNormalization(nn.Module):
    """Learnable scalar scale of the latent space."""

    def __init__(self):
        super().__init__()
        self.latent_normalization = nn.Parameter(torch.ones(1))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return h * self.latent_normalization


class GraphConstructionFCNN(nn.Module):
    """ResFCNN embedding (no biases) with a learnable latent normalization.
    Output dict: ``H``, the latent coordinates. ``model_config`` holds the
    constructor arguments (what a checkpoint stores)."""

    def __init__(
        self,
        in_dim: int,
        hidden_dim: int,
        out_dim: int,
        depth: int,
        alpha: float = 0.6,
        *,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.in_dim = in_dim
        self.fcnn = ResFCNN(
            in_dim, out_dim, hidden_dim, depth, alpha=alpha, bias=False, generator=generator
        )
        self.latent_norm = _LatentNormalization()
        self.model_config = {
            "in_dim": in_dim, "hidden_dim": hidden_dim, "out_dim": out_dim,
            "depth": depth, "alpha": alpha,
        }
        self.to(dev)

    def forward(self, data: EventGraph) -> dict[str, torch.Tensor]:
        if data.x.shape[-1] != self.in_dim:
            msg = f"expected {self.in_dim} node features, got {data.x.shape[-1]}"
            raise ValueError(msg)
        return {"H": self.latent_norm(self.fcnn(data.x))}


class MLGraphConstruction(nn.Module):
    """Learned graph construction: embed, kNN with a radius cut, truth
    labels, optional false-edge subsampling (in training mode only) and edge
    features ``[x_i - x_j, x_i + x_j]``.

    Without ``ml``, the embedding is ``data.x[:, embedding_slice]``.
    """

    def __init__(
        self,
        ml: nn.Module | None = None,
        ef: nn.Module | None = None,
        *,
        max_radius: float = 1.0,
        max_num_neighbors: int = 256,
        use_embedding_features: bool = False,
        ratio_of_false: float | None = None,
        build_edge_features: bool = True,
        ec_threshold: float | None = None,
        embedding_slice: tuple[int | None, int | None] = (None, None),
    ):
        super().__init__()
        if ef is not None:
            msg = "the edge filter (ef) is not ported"
            raise NotImplementedError(msg)
        if ml is None and use_embedding_features:
            msg = "use_embedding_features requires ml to be not None"
            raise ValueError(msg)
        if ml is not None and tuple(embedding_slice) != (None, None):
            msg = "embedding_slice requires ml to be None"
            raise ValueError(msg)
        self.ml = ml
        self.max_radius = max_radius
        self.max_num_neighbors = max_num_neighbors
        self.use_embedding_features = use_embedding_features
        self.ratio_of_false = ratio_of_false
        self.build_edge_features = build_edge_features
        self.ec_threshold = ec_threshold
        self.embedding_slice = tuple(embedding_slice)

    def forward(self, data: EventGraph) -> EventGraph:
        if self.ml is not None:
            embedding = self.ml(data)["H"]
        else:
            s = self.embedding_slice
            embedding = data.x[:, s[0] : s[1]]
        edge_index, edge_mask = knn_with_max_radius(
            embedding,
            k=min(self.max_num_neighbors, data.num_nodes - 1),
            max_radius=self.max_radius,
            node_mask=data.node_mask,
            batch=data.batch,
        )
        pid = data.particle_id
        src, dst = edge_index.long()
        y = (pid[src] == pid[dst]) & (pid[src] > 0) & edge_mask

        if self.ml is not None and self.use_embedding_features:
            x = torch.cat([embedding, data.x], dim=1)
        else:
            x = data.x

        if self.ratio_of_false and self.training:
            # keep the first num_true * ratio false edges in edge-slot order
            false_mask = edge_mask & ~y
            false_rank = torch.cumsum(false_mask.to(torch.int32), 0) - 1
            keep = false_rank < (y.sum() * self.ratio_of_false).to(torch.int32)
            edge_mask = edge_mask & (y | (false_mask & keep))

        edge_attr = data.edge_attr
        if self.build_edge_features:
            edge_attr = torch.cat([x[src] - x[dst], x[src] + x[dst]], dim=1)

        return data.replace(
            x=x,
            edge_index=edge_index,
            edge_attr=edge_attr,
            y=y,
            edge_mask=edge_mask,
            # the CSR arrays of the input's edges do not describe the new ones
            extras={k: v for k, v in data.extras.items() if k not in DERIVED_KEYS},
        )
