"""Edge classifier for the Graph TCN (counterpart of the JAX
``models/edge_classifier.py:ECForGraphTCN``), the model of ``ECModule`` and
the first stage of ``GraphTCN``."""

from __future__ import annotations

import torch
from torch import nn

from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.models.mlp import MLP
from gnn_tracking_tpu_torch.models.resin import ResIN
from gnn_tracking_tpu_torch.ops.csr_segment import gather_endpoints
from gnn_tracking_tpu_torch.utils.device import resolve_device


class ECForGraphTCN(nn.Module):
    """Node/edge encoder MLPs -> ResIN stack -> W head over
    ``[h[src], h[dst], *edge_embeds]`` with an eps-clipped sigmoid. On CUDA
    the graph must be target-sorted (``EventGraph.csr()``): the endpoint
    gathers' gradients are sorted segment-sums. ``fused_save_acts`` is
    handed to every interaction network; ``model_config`` holds the
    constructor arguments (what a checkpoint stores)."""

    def __init__(
        self,
        node_indim: int,
        edge_indim: int,
        interaction_node_dim: int = 5,
        interaction_edge_dim: int = 4,
        hidden_dim: int | None = None,
        L_ec: int = 3,
        alpha: float = 0.5,
        residual_type: str = "skip1",
        use_intermediate_edge_embeddings: bool = True,
        use_node_embedding: bool = True,
        fused_save_acts: bool = False,
        *,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.model_config = {
            "node_indim": node_indim, "edge_indim": edge_indim,
            "interaction_node_dim": interaction_node_dim,
            "interaction_edge_dim": interaction_edge_dim, "hidden_dim": hidden_dim,
            "L_ec": L_ec, "alpha": alpha, "residual_type": residual_type,
            "use_intermediate_edge_embeddings": use_intermediate_edge_embeddings,
            "use_node_embedding": use_node_embedding, "fused_save_acts": fused_save_acts,
        }
        g = generator
        self.ec_node_encoder = MLP(
            node_indim, interaction_node_dim, hidden_dim, L=2, bias=False, generator=g
        )
        self.ec_edge_encoder = MLP(
            edge_indim, interaction_edge_dim, hidden_dim, L=2, bias=False, generator=g
        )
        self.ec_resin = ResIN(
            interaction_node_dim, interaction_edge_dim,
            object_hidden_dim=hidden_dim, relational_hidden_dim=hidden_dim,
            alpha=alpha, n_layers=L_ec, residual_type=residual_type,
            collect_hidden_edge_embeds=use_intermediate_edge_embeddings,
            fused_save_acts=fused_save_acts, generator=g,
        )
        self.use_intermediate_edge_embeddings = use_intermediate_edge_embeddings
        self.use_node_embedding = use_node_embedding
        w_in = (
            self.ec_resin.concat_edge_embeddings_length
            if use_intermediate_edge_embeddings
            else interaction_edge_dim
        )
        if use_node_embedding:
            w_in += 2 * interaction_node_dim
        self.W = MLP(w_in, 1, hidden_dim, L=3, generator=g)
        self.to(dev)

    def forward(self, data: EventGraph) -> dict[str, torch.Tensor]:
        edge_index = data.edge_index
        h_ec = torch.relu(self.ec_node_encoder(data.x))
        edge_attr_ec = torch.relu(self.ec_edge_encoder(data.edge_attr))
        h_ec, edge_attr_ec, edge_attrs_ec = self.ec_resin(
            h_ec, edge_index, edge_attr_ec, data.edge_mask,
            csr=data.csr(),
        )
        w_input = [edge_attr_ec]
        if self.use_intermediate_edge_embeddings:
            w_input = edge_attrs_ec
        if self.use_node_embedding:
            h_src, h_dst = gather_endpoints(h_ec, edge_index, data.csr())
            w_input = [h_src, h_dst, *w_input]
        eps = 0.001
        logits = self.W(torch.cat(w_input, dim=1))
        edge_weights = eps + (1 - 2 * eps) * torch.sigmoid(logits)
        return {
            "W": edge_weights.squeeze(-1),
            "node_embedding": h_ec,
            "edge_embedding": edge_attr_ec,
        }
