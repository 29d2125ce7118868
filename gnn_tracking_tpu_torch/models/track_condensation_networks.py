"""Track-condensation networks (counterpart of the JAX
``models/track_condensation_networks.py``: ``ModularGraphTCN`` with or
without an edge classifier, ``GraphTCN``, ``PerfectECGraphTCN``,
``GraphTCNForMLGCPipeline``, ``PreTrainedECGraphTCN``, and the
point-cloud-direct ``INConvBlock`` and ``PointCloudTCN``).

As in the JAX package, the EC cut is an edge mask that the condensation
interaction networks run under; outputs keep the full (masked) length.
Every class records its constructor arguments in ``model_config`` (what a
checkpoint stores); a module among them (``ModularGraphTCN``'s ``hc_in``
and ``ec``, ``PreTrainedECGraphTCN``'s ``ec``) is recorded as itself, and a
checkpoint nests its own ``model_config``.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from gnn_tracking_tpu_torch.graphs import EventGraph, target_csr
from gnn_tracking_tpu_torch.models.edge_classifier import (
    ECForGraphTCN,
    PerfectEdgeClassification,
)
from gnn_tracking_tpu_torch.models.dynamic_edge_conv import dynamic_edge_conv
from gnn_tracking_tpu_torch.models.interaction_network import InteractionNetwork
from gnn_tracking_tpu_torch.models.mlp import MLP, HeterogeneousResFCNN, ResFCNN
from gnn_tracking_tpu_torch.models.resin import ResIN
from gnn_tracking_tpu_torch.utils.device import resolve_device


class INConvBlock(nn.Module):
    """Dynamic edge convolution followed by interaction networks, for the
    point-cloud-direct ``PointCloudTCN`` (JAX
    ``track_condensation_networks.py:30-76``, reference ``tcn.py:23-66``).

    The node encoder (``MLP(2 * indim, h_dim)``) is the ``"add"`` edge
    convolution's message network over the kNN graph of ``x`` at ``k``
    neighbours; edge features are ``relu(edge_encoder([h_src, h_dst]))``;
    then ``L`` interaction networks ``in_i`` run on that graph (the fused
    op, with the graph's CSR arrays: the kNN graph is query-major, so its
    targets are sorted), each followed by ``h = alpha * h + (1 - alpha) *
    delta_h``. Returns ``h``."""

    def __init__(
        self,
        indim: int,
        h_dim: int,
        e_dim: int,
        L: int,
        k: int,
        hidden_dim: int = 100,
        alpha: float = 0.5,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.k, self.alpha, self.n_layers = k, alpha, L
        g = generator
        self.node_encoder = MLP(2 * indim, h_dim, hidden_dim, L=1, generator=g)
        self.edge_encoder = MLP(2 * h_dim, e_dim, hidden_dim, L=1, generator=g)
        for i in range(L):
            self.add_module(f"in_{i}", InteractionNetwork(
                h_dim, e_dim, node_outdim=h_dim, edge_outdim=e_dim, node_hidden_dim=hidden_dim,
                edge_hidden_dim=hidden_dim, generator=g,
            ))

    def forward(
        self,
        x: torch.Tensor,
        node_mask: torch.Tensor | None = None,
        batch: torch.Tensor | None = None,
    ) -> torch.Tensor:
        h, edge_index, edge_mask = dynamic_edge_conv(
            self.node_encoder, x, self.k, "add", node_mask=node_mask, batch=batch
        )
        h = torch.relu(h)
        src, dst = edge_index.long()
        edge_attr = torch.relu(self.edge_encoder(torch.cat([h[src], h[dst]], dim=1)))
        csr = target_csr(edge_index, x.shape[0])
        for i in range(self.n_layers):
            delta_h, edge_attr = getattr(self, f"in_{i}")(
                h, edge_index, edge_attr, edge_mask, csr=csr
            )
            h = self.alpha * h + (1 - self.alpha) * delta_h
        return h


class PointCloudTCN(nn.Module):
    """Point-cloud-direct track condensation: no pre-built graph (JAX
    ``track_condensation_networks.py:79-117``, reference ``tcn.py:69-115``).

    ``block_0`` (at ``k = N_blocks`` neighbours, as in JAX) and
    ``N_blocks`` more ``INConvBlock``s (``block_{i+1}`` at ``k =
    max(N_blocks - i, 1)``), then the heads ``B`` (``sigmoid + 1e-11``) and
    ``X``. Output dict: ``H``, ``B``, and ``W`` / ``P`` None.
    ``model_config`` holds the constructor arguments."""

    def __init__(
        self,
        node_indim: int,
        h_dim: int = 10,
        e_dim: int = 10,
        h_outdim: int = 5,
        hidden_dim: int = 100,
        N_blocks: int = 3,
        L: int = 3,
        *,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.model_config = {
            "node_indim": node_indim, "h_dim": h_dim, "e_dim": e_dim, "h_outdim": h_outdim,
            "hidden_dim": hidden_dim, "N_blocks": N_blocks, "L": L,
        }
        g = generator
        self.n_blocks = N_blocks
        self.block_0 = INConvBlock(node_indim, h_dim, e_dim, L, N_blocks, hidden_dim, generator=g)
        for i in range(N_blocks):
            self.add_module(f"block_{i + 1}", INConvBlock(
                h_dim, h_dim, e_dim, L, max(N_blocks - i, 1), hidden_dim, generator=g
            ))
        self.B = MLP(h_dim, 1, hidden_dim, L=3, generator=g)
        self.X = MLP(h_dim, h_outdim, hidden_dim, L=3, generator=g)
        self.to(dev)

    def forward(self, data: EventGraph) -> dict[str, torch.Tensor | None]:
        h = data.x
        for i in range(self.n_blocks + 1):
            h = getattr(self, f"block_{i}")(h, node_mask=data.node_mask, batch=data.batch)
        beta = torch.sigmoid(self.B(h)).squeeze(-1) + 1e-11
        return {"W": None, "H": self.X(h), "B": beta, "P": None}


class ModularGraphTCN(nn.Module):
    """Optional edge classifier (``ECForGraphTCN``, the truth-based
    ``PerfectEdgeClassification`` or a restored EC) + HC encoders +
    condensation ResIN + beta / cluster-coordinate heads (JAX
    ``ModularGraphTCN``).

    Without ``ec`` the condensation runs on the graph's own edge mask and
    ``W`` is None; ``feed_edge_weights`` then appends the baked
    ``extras["ec_score"]`` (``ECCut``) to the edge features. With
    ``alpha_latent`` the latent is ``sqrt(alpha) * x[:, :n_embedding_coords]``
    (zero-padded) ``+ sqrt(1 - alpha) * h``. ``heterogeneous_node_encoder``
    encodes pixel and strip hits (``data.layer``) with separate towers.

    Output dict: ``W`` edge weights, ``H`` clustering coordinates,
    ``B`` condensation likelihood, ``ec_hit_mask`` / ``ec_edge_mask``.
    """

    #: the JAX subclasses hold this module's own parameters one level down
    #: (``utils.param_convert`` drops the level and puts it back)
    jax_inner_name: str | None = None

    def __init__(
        self,
        hc_in: ResIN,
        ec: nn.Module | None,
        node_indim: int,
        edge_indim: int,
        h_dim: int = 5,
        e_dim: int = 4,
        h_outdim: int = 2,
        hidden_dim: int = 40,
        feed_edge_weights: bool = False,
        ec_threshold: float = 0.5,
        mask_orphan_nodes: bool = False,
        use_ec_embeddings_for_hc: bool = False,
        alpha_latent: float = 0.0,
        n_embedding_coords: int = 0,
        heterogeneous_node_encoder: bool = False,
        *,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.model_config = {
            "hc_in": hc_in, "ec": ec, "node_indim": node_indim, "edge_indim": edge_indim,
            "h_dim": h_dim, "e_dim": e_dim, "h_outdim": h_outdim, "hidden_dim": hidden_dim,
            "feed_edge_weights": feed_edge_weights, "ec_threshold": ec_threshold,
            "mask_orphan_nodes": mask_orphan_nodes,
            "use_ec_embeddings_for_hc": use_ec_embeddings_for_hc, "alpha_latent": alpha_latent,
            "n_embedding_coords": n_embedding_coords,
            "heterogeneous_node_encoder": heterogeneous_node_encoder,
        }
        if alpha_latent and not 0 < n_embedding_coords <= h_outdim:
            msg = f"alpha_latent needs 0 < n_embedding_coords <= h_outdim, got {n_embedding_coords}"
            raise ValueError(msg)
        if use_ec_embeddings_for_hc and ec is None:
            msg = "use_ec_embeddings_for_hc needs an ec"
            raise ValueError(msg)
        self.ec = ec
        self.hc_in = hc_in
        self.ec_threshold = ec_threshold
        self.feed_edge_weights = feed_edge_weights
        self.mask_orphan_nodes = mask_orphan_nodes
        self.use_ec_embeddings_for_hc = use_ec_embeddings_for_hc
        self.alpha_latent = alpha_latent
        self.n_embedding_coords = n_embedding_coords
        self.heterogeneous_node_encoder = heterogeneous_node_encoder
        x_in, e_in = node_indim, edge_indim
        if use_ec_embeddings_for_hc:
            x_in += ec.ec_node_encoder.linears[-1].weight.shape[0]
            e_in += ec.ec_edge_encoder.linears[-1].weight.shape[0]
        if feed_edge_weights:
            e_in += 1
        g = generator
        if heterogeneous_node_encoder:
            self.hc_node_encoder = HeterogeneousResFCNN(
                x_in, h_dim, hidden_dim, depth=2, alpha=0.0, bias=False, generator=g
            )
        else:  # depth=1 (== L=2), alpha=0 for backwards compatibility
            self.hc_node_encoder = ResFCNN(
                x_in, h_dim, hidden_dim, depth=1, alpha=0.0, bias=False, generator=g
            )
        self.hc_edge_encoder = MLP(e_in, e_dim, hidden_dim, L=2, bias=False, generator=g)
        self.p_beta = MLP(h_dim, 1, hidden_dim, L=3, generator=g)
        self.p_cluster = MLP(h_dim, h_outdim, hidden_dim, L=3, generator=g)
        self.latent_normalization = nn.Parameter(torch.ones(1))
        self.to(dev)

    def forward(self, data: EventGraph, exchange=None) -> dict[str, torch.Tensor]:
        """``exchange``: the graph-parallel hook (``parallel.halo.HaloExchange``;
        see ``ResIN``), handed to the edge classifier and the condensation
        ResIN: with it this module runs on one shard of a partitioned event
        (``parallel.sharded_model.ShardedTCN``). Under it
        ``mask_orphan_nodes`` counts the shard's own edges only, as in JAX
        (an edge whose source lies on another shard adds to its target
        alone)."""
        hit_mask, ec_edge_mask, edge_weights = data.node_mask, data.edge_mask, None
        xs, edge_attrs = [data.x], [data.edge_attr]
        if self.ec is not None:
            ec_result = self.ec(data) if exchange is None else self.ec(data, exchange=exchange)
            edge_weights = ec_result["W"]
            # EC cut as masking (reference: data.edge_subgraph)
            ec_edge_mask = data.edge_mask & (edge_weights > self.ec_threshold)
            if self.mask_orphan_nodes:
                n = data.num_nodes
                deg = torch.zeros(n, dtype=torch.int32, device=data.device)
                for row in data.edge_index:
                    # sources in a shard's halo (>= n) are not its nodes (JAX drops them)
                    local = row < n
                    deg.index_add_(0, torch.where(local, row, 0), (ec_edge_mask & local).to(torch.int32))
                hit_mask = data.node_mask & (deg > 0)
            if self.use_ec_embeddings_for_hc:
                xs.append(ec_result["node_embedding"])
                edge_attrs.append(ec_result["edge_embedding"])
        if self.feed_edge_weights:
            # without an ec: the scores an ECCut baked into the graph
            w = data.extras["ec_score"] if self.ec is None else edge_weights
            edge_attrs.append(w.reshape(-1, 1).to(data.edge_attr.dtype))
        x = torch.cat(xs, dim=1)
        edge_attr = torch.cat(edge_attrs, dim=1)

        if self.heterogeneous_node_encoder:
            h_hc = self.hc_node_encoder(x, data.layer)
        else:
            h_hc = self.hc_node_encoder(x)
        h_hc = torch.relu(h_hc)
        edge_attr_hc = torch.relu(self.hc_edge_encoder(edge_attr))
        # track condenser runs under the post-EC edge mask (its batch
        # norms, where it has them, under the post-EC hit mask)
        h_hc, _, _ = self.hc_in(
            h_hc, data.edge_index, edge_attr_hc, ec_edge_mask,
            node_mask=hit_mask, csr=data.csr(), exchange=exchange,
        )
        beta = torch.sigmoid(self.p_beta(h_hc))
        epsilon = 1e-6  # soft clipping against NaN in arctanh(beta)
        beta = epsilon + (1 - 2 * epsilon) * beta
        h = self.p_cluster(h_hc)
        if self.alpha_latent:
            nec = self.n_embedding_coords
            residual = F.pad(data.x[:, :nec], (0, h.shape[1] - nec))
            h = math.sqrt(self.alpha_latent) * residual + math.sqrt(1 - self.alpha_latent) * h
        h = h * self.latent_normalization
        return {
            "W": edge_weights,
            "H": h,
            "B": beta.squeeze(-1),
            "ec_hit_mask": hit_mask,
            "ec_edge_mask": ec_edge_mask,
        }


class GraphTCN(ModularGraphTCN):
    """``ModularGraphTCN`` with a fresh ``ECForGraphTCN``.

    The JAX GraphTCN wraps a ModularGraphTCN whose own parameters sit under
    ``gtcn`` in its tree; this class *is* the ModularGraphTCN, so
    ``utils.param_convert`` drops that level. ``remat`` recomputes every
    interaction layer (EC and HC) in the backward pass. ``model_config``
    holds the constructor arguments (what a checkpoint stores).
    """

    jax_inner_name = "gtcn"

    def __init__(
        self,
        node_indim: int,
        edge_indim: int,
        h_dim: int = 5,
        e_dim: int = 4,
        h_outdim: int = 2,
        hidden_dim: int = 40,
        L_ec: int = 3,
        L_hc: int = 3,
        alpha_ec: float = 0.5,
        alpha_hc: float = 0.5,
        ec_threshold: float = 0.5,
        mask_orphan_nodes: bool = False,
        use_ec_embeddings_for_hc: bool = False,
        feed_edge_weights: bool = False,
        halo_edge_split: int = 0,
        remat: bool = False,
        *,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ):
        resolve_device(device)
        config = {
            "node_indim": node_indim, "edge_indim": edge_indim, "h_dim": h_dim,
            "e_dim": e_dim, "h_outdim": h_outdim, "hidden_dim": hidden_dim,
            "L_ec": L_ec, "L_hc": L_hc, "alpha_ec": alpha_ec, "alpha_hc": alpha_hc,
            "ec_threshold": ec_threshold, "mask_orphan_nodes": mask_orphan_nodes,
            "use_ec_embeddings_for_hc": use_ec_embeddings_for_hc,
            "feed_edge_weights": feed_edge_weights, "halo_edge_split": halo_edge_split,
            "remat": remat,
        }
        ec = ECForGraphTCN(
            node_indim, edge_indim, interaction_node_dim=h_dim,
            interaction_edge_dim=e_dim, hidden_dim=hidden_dim, L_ec=L_ec,
            alpha=alpha_ec, halo_edge_split=halo_edge_split, remat=remat, device="cpu",
            generator=generator,
        )
        hc_in = ResIN(
            h_dim, e_dim, object_hidden_dim=hidden_dim,
            relational_hidden_dim=hidden_dim, alpha=alpha_hc, n_layers=L_hc,
            halo_edge_split=halo_edge_split, remat=remat, generator=generator,
        )
        super().__init__(
            hc_in, ec, node_indim, edge_indim, h_dim=h_dim, e_dim=e_dim,
            h_outdim=h_outdim, hidden_dim=hidden_dim,
            feed_edge_weights=feed_edge_weights, ec_threshold=ec_threshold,
            mask_orphan_nodes=mask_orphan_nodes,
            use_ec_embeddings_for_hc=use_ec_embeddings_for_hc,
            device=device, generator=generator,
        )
        self.model_config = config


class PerfectECGraphTCN(ModularGraphTCN):
    """``ModularGraphTCN`` with the truth-based ``PerfectEdgeClassification``
    (JAX ``track_condensation_networks.py:334-396``). As for ``GraphTCN``,
    ``utils.param_convert`` drops the JAX tree's ``gtcn`` level; the EC has
    no parameters. ``model_config`` holds the constructor arguments."""

    jax_inner_name = "gtcn"

    def __init__(
        self,
        node_indim: int,
        edge_indim: int,
        h_dim: int = 5,
        e_dim: int = 4,
        h_outdim: int = 2,
        hidden_dim: int = 40,
        L_hc: int = 3,
        alpha_hc: float = 0.5,
        ec_tpr: float = 1.0,
        ec_tnr: float = 1.0,
        ec_threshold: float = 0.5,
        mask_orphan_nodes: bool = False,
        feed_edge_weights: bool = False,
        residual_type: str = "skip1",
        compat_overlap: bool = False,
        halo_edge_split: int = 0,
        *,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ):
        resolve_device(device)
        config = {
            "node_indim": node_indim, "edge_indim": edge_indim, "h_dim": h_dim,
            "e_dim": e_dim, "h_outdim": h_outdim, "hidden_dim": hidden_dim, "L_hc": L_hc,
            "alpha_hc": alpha_hc, "ec_tpr": ec_tpr, "ec_tnr": ec_tnr,
            "ec_threshold": ec_threshold, "mask_orphan_nodes": mask_orphan_nodes,
            "feed_edge_weights": feed_edge_weights,
            "residual_type": residual_type, "compat_overlap": compat_overlap,
            "halo_edge_split": halo_edge_split,
        }
        hc_in = ResIN(
            h_dim, e_dim, object_hidden_dim=hidden_dim,
            relational_hidden_dim=hidden_dim, alpha=alpha_hc, n_layers=L_hc,
            residual_type=residual_type, compat_overlap=compat_overlap,
            halo_edge_split=halo_edge_split, generator=generator,
        )
        super().__init__(
            hc_in, PerfectEdgeClassification(tpr=ec_tpr, tnr=ec_tnr), node_indim, edge_indim,
            h_dim=h_dim, e_dim=e_dim, h_outdim=h_outdim, hidden_dim=hidden_dim,
            feed_edge_weights=feed_edge_weights, ec_threshold=ec_threshold,
            mask_orphan_nodes=mask_orphan_nodes, device=device, generator=generator,
        )
        self.model_config = config


class GraphTCNForMLGCPipeline(ModularGraphTCN):
    """``ModularGraphTCN`` without an edge classifier, for graphs built by
    learned graph construction (JAX ``track_condensation_networks.py:398``);
    the condensation runs on the graph's own edge mask. As for ``GraphTCN``,
    ``utils.param_convert`` drops the JAX tree's ``gtcn`` level."""

    jax_inner_name = "gtcn"

    def __init__(
        self,
        node_indim: int,
        edge_indim: int,
        h_dim: int = 5,
        e_dim: int = 4,
        h_outdim: int = 2,
        hidden_dim: int = 40,
        L_hc: int = 3,
        alpha_hc: float = 0.5,
        alpha_latent: float = 0.0,
        n_embedding_coords: int = 0,
        feed_edge_weights: bool = False,
        heterogeneous_node_encoder: bool = False,
        residual_type: str = "skip1",
        compat_overlap: bool = False,
        halo_edge_split: int = 0,
        *,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ):
        resolve_device(device)
        config = {
            "node_indim": node_indim, "edge_indim": edge_indim, "h_dim": h_dim,
            "e_dim": e_dim, "h_outdim": h_outdim, "hidden_dim": hidden_dim, "L_hc": L_hc,
            "alpha_hc": alpha_hc, "alpha_latent": alpha_latent,
            "n_embedding_coords": n_embedding_coords, "feed_edge_weights": feed_edge_weights,
            "heterogeneous_node_encoder": heterogeneous_node_encoder,
            "residual_type": residual_type, "compat_overlap": compat_overlap,
            "halo_edge_split": halo_edge_split,
        }
        hc_in = ResIN(
            h_dim, e_dim, object_hidden_dim=hidden_dim,
            relational_hidden_dim=hidden_dim, alpha=alpha_hc, n_layers=L_hc,
            residual_type=residual_type, compat_overlap=compat_overlap,
            halo_edge_split=halo_edge_split, generator=generator,
        )
        super().__init__(
            hc_in, None, node_indim, edge_indim, h_dim=h_dim, e_dim=e_dim,
            h_outdim=h_outdim, hidden_dim=hidden_dim, feed_edge_weights=feed_edge_weights,
            alpha_latent=alpha_latent, n_embedding_coords=n_embedding_coords,
            heterogeneous_node_encoder=heterogeneous_node_encoder,
            device=device, generator=generator,
        )
        self.model_config = config


class PreTrainedECGraphTCN(ModularGraphTCN):
    """``ModularGraphTCN`` around an edge classifier that was trained before
    (JAX ``track_condensation_networks.py:465``), e.g. one restored with
    ``training.restore.ec_from_chkpt``. The ``ec`` module is taken as it
    is; freeze it with ``TrackingModule(frozen_prefixes=("model/ec",))``.
    ``node_indim`` / ``edge_indim`` default to the EC's (its
    ``model_config``). As in JAX the EC's parameters sit under ``ec`` and
    the module's own under ``gtcn`` in the JAX tree."""

    jax_inner_name = "gtcn"

    def __init__(
        self,
        ec: nn.Module,
        node_indim: int | None = None,
        edge_indim: int | None = None,
        h_dim: int = 5,
        e_dim: int = 4,
        h_outdim: int = 2,
        hidden_dim: int = 40,
        L_hc: int = 3,
        alpha_hc: float = 0.5,
        ec_threshold: float = 0.5,
        mask_orphan_nodes: bool = False,
        use_ec_embeddings_for_hc: bool = False,
        feed_edge_weights: bool = False,
        residual_type: str = "skip1",
        compat_overlap: bool = False,
        halo_edge_split: int = 0,
        *,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ):
        resolve_device(device)
        ec_config = getattr(ec, "model_config", {})
        node_indim = ec_config["node_indim"] if node_indim is None else node_indim
        edge_indim = ec_config["edge_indim"] if edge_indim is None else edge_indim
        config = {
            "ec": ec, "node_indim": node_indim, "edge_indim": edge_indim, "h_dim": h_dim,
            "e_dim": e_dim, "h_outdim": h_outdim, "hidden_dim": hidden_dim, "L_hc": L_hc,
            "alpha_hc": alpha_hc, "ec_threshold": ec_threshold,
            "mask_orphan_nodes": mask_orphan_nodes,
            "use_ec_embeddings_for_hc": use_ec_embeddings_for_hc,
            "feed_edge_weights": feed_edge_weights,
            "residual_type": residual_type, "compat_overlap": compat_overlap,
            "halo_edge_split": halo_edge_split,
        }
        hc_in = ResIN(
            h_dim, e_dim, object_hidden_dim=hidden_dim,
            relational_hidden_dim=hidden_dim, alpha=alpha_hc, n_layers=L_hc,
            residual_type=residual_type, compat_overlap=compat_overlap,
            halo_edge_split=halo_edge_split, generator=generator,
        )
        super().__init__(
            hc_in, ec, node_indim, edge_indim, h_dim=h_dim, e_dim=e_dim,
            h_outdim=h_outdim, hidden_dim=hidden_dim, feed_edge_weights=feed_edge_weights,
            ec_threshold=ec_threshold, mask_orphan_nodes=mask_orphan_nodes,
            use_ec_embeddings_for_hc=use_ec_embeddings_for_hc,
            device=device, generator=generator,
        )
        self.model_config = config
