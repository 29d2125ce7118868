"""Metric-learning embeddings and learned graph construction (counterpart
of the JAX ``models/graph_construction.py``: ``_LatentNormalization``,
``GraphConstructionFCNN``, ``GraphConstructionHeteroResFCNN``,
``GraphConstructionHeteroEncResFCNN``, ``GraphConstructionResIN``,
``MLGraphConstruction`` and ``MLPCTransformer``).

``MLGraphConstruction`` embeds the hits, builds a fixed-degree kNN graph in
the embedding space (``ops/knn.py``), labels its edges with the truth,
builds edge features and, with an edge filter ``ef``
(``models/edge_filter.py``), masks the edges whose filter score is not
above ``ec_threshold``. Its graph has ``N * k`` edge slots; the radius cut,
false-edge subsampling and the filter only change ``edge_mask``.
"""

from __future__ import annotations

import torch
from torch import nn

from gnn_tracking_tpu_torch.graphs import DERIVED_KEYS, EventGraph
from gnn_tracking_tpu_torch.models.mlp import MLP, HeterogeneousResFCNN, ResFCNN
from gnn_tracking_tpu_torch.models.resin import ResIN
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


class GraphConstructionHeteroResFCNN(nn.Module):
    """Separate ``ResFCNN`` towers (no biases) for pixel and strip hits
    (``data.layer``), with a learnable latent normalization (JAX
    ``graph_construction.py:59-79``). Output dict: ``H``."""

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
        self.fcnn = HeterogeneousResFCNN(
            in_dim, out_dim, hidden_dim, depth, alpha=alpha, bias=False, generator=generator
        )
        self.latent_norm = _LatentNormalization()
        self.model_config = {
            "in_dim": in_dim, "hidden_dim": hidden_dim, "out_dim": out_dim,
            "depth": depth, "alpha": alpha,
        }
        self.to(dev)

    def forward(self, data: EventGraph) -> dict[str, torch.Tensor]:
        return {"H": self.latent_norm(self.fcnn(data.x, data.layer))}


class GraphConstructionHeteroEncResFCNN(nn.Module):
    """A heterogeneous (pixel / strip) encoder to ``hidden_dim``, ReLU, then
    one shared ``ResFCNN`` (no biases) and a learnable latent normalization
    (JAX ``graph_construction.py:82-115``). Output dict: ``H``."""

    def __init__(
        self,
        in_dim: int,
        hidden_dim_enc: int,
        hidden_dim: int,
        out_dim: int,
        depth_enc: int,
        depth: int,
        alpha: float = 0.6,
        *,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.in_dim = in_dim
        g = generator
        self.encoder = HeterogeneousResFCNN(
            in_dim, hidden_dim, hidden_dim_enc, depth_enc, alpha=alpha, bias=False, generator=g
        )
        self.fcnn = ResFCNN(hidden_dim, out_dim, hidden_dim, depth, alpha=alpha, bias=False, generator=g)
        self.latent_norm = _LatentNormalization()
        self.model_config = {
            "in_dim": in_dim, "hidden_dim_enc": hidden_dim_enc, "hidden_dim": hidden_dim,
            "out_dim": out_dim, "depth_enc": depth_enc, "depth": depth, "alpha": alpha,
        }
        self.to(dev)

    def forward(self, data: EventGraph) -> dict[str, torch.Tensor]:
        if data.x.shape[-1] != self.in_dim:
            msg = f"expected {self.in_dim} node features, got {data.x.shape[-1]}"
            raise ValueError(msg)
        enc = torch.relu(self.encoder(data.x, data.layer))
        return {"H": self.latent_norm(self.fcnn(enc))}


class GraphConstructionResIN(nn.Module):
    """Refinement of a built graph's latent: node and edge encoders, a
    ``ResIN`` stack over the graph (the fused op: on CUDA the graph must be
    sorted by target, ``EventGraph.sort_edges_by_target``), a decoder, and a
    residual back to the first ``h_outdim`` input coordinates, ``H =
    alpha_fcnn * x[:, :h_outdim] + (1 - alpha_fcnn) * delta``, with a
    learnable latent normalization (JAX ``graph_construction.py:118-168``).
    Output dict: ``H``."""

    def __init__(
        self,
        node_indim: int,
        edge_indim: int,
        h_outdim: int = 8,
        hidden_dim: int = 40,
        alpha: float = 0.5,
        n_layers: int = 1,
        alpha_fcnn: float = 0.5,
        *,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.node_indim, self.edge_indim = node_indim, edge_indim
        self.h_outdim, self.alpha_fcnn = h_outdim, alpha_fcnn
        g = generator
        self.node_encoder = MLP(node_indim, hidden_dim, hidden_dim, L=2, bias=False, generator=g)
        self.edge_encoder = MLP(edge_indim, hidden_dim, hidden_dim, L=2, bias=False, generator=g)
        self.resin = ResIN(
            hidden_dim, hidden_dim, object_hidden_dim=hidden_dim,
            relational_hidden_dim=hidden_dim, n_layers=n_layers, alpha=alpha, generator=g,
        )
        self.decoder = MLP(hidden_dim, h_outdim, hidden_dim, L=2, bias=False, generator=g)
        self.latent_norm = _LatentNormalization()
        self.model_config = {
            "node_indim": node_indim, "edge_indim": edge_indim, "h_outdim": h_outdim,
            "hidden_dim": hidden_dim, "alpha": alpha, "n_layers": n_layers,
            "alpha_fcnn": alpha_fcnn,
        }
        self.to(dev)

    def forward(self, data: EventGraph) -> dict[str, torch.Tensor]:
        if data.x.shape[-1] != self.node_indim or data.edge_attr.shape[-1] != self.edge_indim:
            msg = (f"expected {self.node_indim} node and {self.edge_indim} edge features, got "
                   f"{data.x.shape[-1]} and {data.edge_attr.shape[-1]}")
            raise ValueError(msg)
        x_fcnn = data.x[:, : self.h_outdim]
        x = self.node_encoder(data.x)
        edge_attr = self.edge_encoder(data.edge_attr)
        x, _, _ = self.resin(x, data.edge_index, edge_attr, data.edge_mask, csr=data.csr())
        h = self.alpha_fcnn * x_fcnn + (1 - self.alpha_fcnn) * self.decoder(x)
        return {"H": self.latent_norm(h)}


class MLGraphConstruction(nn.Module):
    """Learned graph construction: embed, kNN with a radius cut, truth
    labels, optional false-edge subsampling (in training mode only), edge
    features ``[x_i - x_j, x_i + x_j]``, and with an edge filter ``ef`` the
    cut ``W > ec_threshold`` on its scores (``ef`` sees the built graph).

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
        if ef is not None and ec_threshold is None:
            msg = "ec_threshold must be set if ec/ef is not None"
            raise ValueError(msg)
        if ml is None and use_embedding_features:
            msg = "use_embedding_features requires ml to be not None"
            raise ValueError(msg)
        if ml is not None and tuple(embedding_slice) != (None, None):
            msg = "embedding_slice requires ml to be None"
            raise ValueError(msg)
        self.ml = ml
        self.ef = ef
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

        out = data.replace(
            x=x,
            edge_index=edge_index,
            edge_attr=edge_attr,
            y=y,
            edge_mask=edge_mask,
            # the CSR arrays of the input's edges do not describe the new ones
            extras={k: v for k, v in data.extras.items() if k not in DERIVED_KEYS},
        )
        if self.ef is not None:
            out = out.mask_edges(self.ef(out)["W"] > self.ec_threshold)
        return out


class MLPCTransformer(nn.Module):
    """Replace (``original_features=False``) or prepend to the point cloud's
    features the metric-learning latent ``H`` of ``model``, without building
    a graph (JAX ``graph_construction.py:267-282``)."""

    def __init__(self, model: nn.Module, original_features: bool = False):
        super().__init__()
        self.model = model
        self.original_features = original_features

    def forward(self, data: EventGraph) -> EventGraph:
        h = self.model(data)["H"]
        return data.replace(x=torch.cat([h, data.x], dim=1) if self.original_features else h)
