"""Edge classifiers for the Graph TCN (counterpart of the JAX
``models/edge_classifier.py``): ``ECForGraphTCN``, the model of
``ECModule`` and the first stage of ``GraphTCN``, and the truth-based
``PerfectEdgeClassification``, the first stage of ``PerfectECGraphTCN``."""

from __future__ import annotations

import math

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
    gathers' gradients are sorted segment-sums. ``residual_type`` and
    ``compat_overlap`` select the ResIN's residual scheme;
    ``fused_save_acts`` is handed to every interaction network and
    ``remat`` to the ResIN (each layer recomputed in the backward pass);
    ``model_config`` holds the constructor arguments (what a checkpoint
    stores)."""

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
        compat_overlap: bool = False,
        use_intermediate_edge_embeddings: bool = True,
        use_node_embedding: bool = True,
        fused_save_acts: bool = False,
        halo_edge_split: int = 0,
        remat: bool = False,
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
            "compat_overlap": compat_overlap,
            "use_intermediate_edge_embeddings": use_intermediate_edge_embeddings,
            "use_node_embedding": use_node_embedding, "fused_save_acts": fused_save_acts,
            "halo_edge_split": halo_edge_split, "remat": remat,
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
            compat_overlap=compat_overlap, collect_hidden_edge_embeds=use_intermediate_edge_embeddings,
            fused_save_acts=fused_save_acts, halo_edge_split=halo_edge_split, remat=remat, generator=g,
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

    def forward(self, data: EventGraph, exchange=None) -> dict[str, torch.Tensor]:
        """``exchange``: the graph-parallel hook (see ``ResIN``); the W head
        then gathers the endpoints' embeddings from the extended array."""
        edge_index = data.edge_index
        h_ec = torch.relu(self.ec_node_encoder(data.x))
        edge_attr_ec = torch.relu(self.ec_edge_encoder(data.edge_attr))
        h_ec, edge_attr_ec, edge_attrs_ec = self.ec_resin(
            h_ec, edge_index, edge_attr_ec, data.edge_mask,
            csr=data.csr(), exchange=exchange,
        )
        w_input = [edge_attr_ec]
        if self.use_intermediate_edge_embeddings:
            w_input = edge_attrs_ec
        if self.use_node_embedding:
            h_src, h_dst = _endpoints(h_ec, edge_index, data.csr(), exchange,
                                      self.ec_resin.halo_edge_split)
            w_input = [h_src, h_dst, *w_input]
        eps = 0.001
        logits = self.W(torch.cat(w_input, dim=1))
        edge_weights = eps + (1 - 2 * eps) * torch.sigmoid(logits)
        return {
            "W": edge_weights.squeeze(-1),
            "node_embedding": h_ec,
            "edge_embedding": edge_attr_ec,
        }


def _endpoints(h, edge_index, csr, exchange, split: int):
    """``(h[src], h[dst])`` (``gather_endpoints``); under an exchange from the
    extended array, per edge block where the layers split them."""
    if exchange is None:
        return gather_endpoints(h, edge_index, csr)
    h_ext = exchange(h)
    if not split:
        return gather_endpoints(h_ext, edge_index, exchange.csr)
    ei_local, ei_halo = exchange.block_edges()
    local = gather_endpoints(h, ei_local, exchange.block_csr("local"))
    halo = gather_endpoints(h_ext, ei_halo, exchange.block_csr("halo"))
    return torch.cat([local[0], halo[0]]), torch.cat([local[1], halo[1]])


class PerfectEdgeClassification(nn.Module):
    """Truth-based edge classifier: ``W`` is the edge truth ``y`` as float32,
    with true edges kept with probability ``tpr``, false edges rejected with
    probability ``tnr``, and every edge whose source has ``pt`` below
    ``false_below_pt`` set false (JAX ``edge_classifier.py:133-165``). No
    parameters. Below 1, ``tpr`` / ``tnr`` draw uniforms on the host from
    the module's ``torch.Generator`` (seeded with ``seed``), the ``tpr`` flips
    first and the ``tnr`` draw then acts on every edge that is false after
    them, as in JAX; the JAX module draws from its ``perfect_ec`` stream, so
    only the flip rates agree."""

    def __init__(self, tpr: float = 1.0, tnr: float = 1.0, false_below_pt: float = 0.0,
                 *, seed: int = 0):
        super().__init__()
        if not (0.0 <= tpr <= 1.0 and 0.0 <= tnr <= 1.0):
            msg = f"tpr={tpr}, tnr={tnr}: both must lie in [0, 1]"
            raise ValueError(msg)
        self.tpr, self.tnr, self.false_below_pt = tpr, tnr, false_below_pt
        self.model_config = {"tpr": tpr, "tnr": tnr, "false_below_pt": false_below_pt, "seed": seed}
        self.generator = torch.Generator().manual_seed(seed)

    def _uniform(self, n: int, device: torch.device) -> torch.Tensor:
        return torch.rand(n, generator=self.generator).to(device)

    def forward(self, data: EventGraph, exchange=None) -> dict[str, torch.Tensor]:
        if exchange is not None and self.false_below_pt > 0.0:
            # the pt cut reads the sources' pt, which a shard's view does not carry
            msg = "false_below_pt is not supported under graph sharding"
            raise NotImplementedError(msg)
        r = data.y.to(torch.bool)
        if not math.isclose(self.tpr, 1.0):
            r = torch.where(r, self._uniform(r.shape[0], r.device) <= self.tpr, r)
        if not math.isclose(self.tnr, 1.0):
            r = torch.where(~r, ~(self._uniform(r.shape[0], r.device) <= self.tnr), r)
        if self.false_below_pt > 0.0:
            r = r & ~(data.pt[data.edge_index[0].long()] < self.false_below_pt)
        return {"W": r.to(torch.float32)}
