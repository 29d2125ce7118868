"""Interaction network — the core message-passing op (counterpart of the JAX
``models/interaction_network.py`` with ``segment_impl="fused"``).

The relational half (gather endpoints -> 3-layer MLP -> masked segment-add
at the target) is one call of the differentiable
:func:`ops.fused_relational.fused_relational`;
the object model is ``MLP([x, agg])``. Parameters use the fused layout
(``relational_w1..b3``) in PyTorch's ``[out, in]`` order. Masked edges'
``e_tilde`` are zero (the JAX XLA path leaves them intact; everything
observable through the mask is the same). bf16 inputs and weights (the
``bf16`` precision policy) take the op's bf16 route; ``fused_save_acts``
(the JAX option of that name) keeps its gathered endpoint rows for the
backward. ``aggr="mean"`` / ``"max"`` aggregate with
``ops.segment.scatter_edges_to_nodes`` after the relational MLP in plain
tensor code, as the JAX module takes its XLA path for them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gnn_tracking_tpu_torch.models.mlp import MLP
from gnn_tracking_tpu_torch.ops.fused_relational import fused_relational, fused_relational_plain
from gnn_tracking_tpu_torch.ops.segment import scatter_edges_to_nodes

AGGREGATIONS = ("add", "mean", "max")


def _uniform(shape, fan_in, generator):
    bound = 1.0 / math.sqrt(fan_in)
    return nn.Parameter((torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound)


class InteractionNetwork(nn.Module):
    """Message ``e' = MLP_R([x_dst, x_src, e])``, aggregation at the target,
    update ``x' = MLP_O([x, agg])``. Returns ``(x', e')``."""

    def __init__(
        self,
        node_indim: int,
        edge_indim: int,
        node_outdim: int = 3,
        edge_outdim: int = 4,
        node_hidden_dim: int | None = 40,
        edge_hidden_dim: int | None = 40,
        fused_save_acts: bool = False,
        aggr: str = "add",
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if aggr not in AGGREGATIONS:
            msg = f"Unknown aggregation: {aggr}"
            raise ValueError(msg)
        self.fused_save_acts = fused_save_acts
        self.aggr = aggr
        fan1 = 2 * node_indim + edge_indim
        h = edge_hidden_dim or max(fan1, edge_outdim)
        self.relational_w1 = _uniform((h, fan1), fan1, generator)
        self.relational_b1 = _uniform((h,), fan1, generator)
        self.relational_w2 = _uniform((h, h), h, generator)
        self.relational_b2 = _uniform((h,), h, generator)
        self.relational_w3 = _uniform((edge_outdim, h), h, generator)
        self.relational_b3 = _uniform((edge_outdim,), h, generator)
        self.object_model = MLP(
            node_indim + edge_outdim, node_outdim, node_hidden_dim, L=3,
            generator=generator,
        )

    def relational_weights(self) -> dict[str, torch.Tensor]:
        return {
            "w1": self.relational_w1, "b1": self.relational_b1,
            "w2": self.relational_w2, "b2": self.relational_b2,
            "w3": self.relational_w3, "b3": self.relational_b3,
        }

    def forward(
        self,
        x: torch.Tensor,
        edge_index: torch.Tensor,
        edge_attr: torch.Tensor,
        edge_mask: torch.Tensor,
        *,
        csr: dict[str, torch.Tensor] | None = None,
        relu_edge: bool = False,
        exchange=None,
        halo_split: int = 0,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``csr``: the target-sorted graph's CSR arrays (``EventGraph.csr()``,
        needed on CUDA); ``relu_edge`` applies a ReLU to ``edge_attr`` inside
        the op, gradient included.

        ``exchange`` (``parallel.halo.HaloExchange``) is the graph-parallel
        hook: ``x`` holds the shard's own rows and the edge sources index the
        extended array ``[x; halo rows]`` that it fetches; the op then runs on
        that array with the exchange's CSR arrays, and the update covers the
        shard's rows. ``halo_split`` (the partition's ``e_split``, edges
        before it with local sources): the local block's edges run on ``x``
        while the exchange is in flight, the rest on the extended array after
        it, each block with its own CSR, their aggregations summed."""
        kw = {"relu_edge": relu_edge, "save_acts": self.fused_save_acts}
        w = self.relational_weights()
        if self.aggr != "add":
            if halo_split:
                msg = "halo_split supports add aggregation only"
                raise ValueError(msg)
            x_ext = x if exchange is None else exchange(x)
            e_tilde, _ = fused_relational_plain(x_ext, edge_attr, edge_index, edge_mask, w, relu_edge=relu_edge)
            agg = scatter_edges_to_nodes(e_tilde, edge_index.long(), x_ext.shape[0], edge_mask,
                                         aggr=self.aggr)[: x.shape[0]]
        elif exchange is None:
            e_tilde, agg = fused_relational(x, edge_attr, edge_index, edge_mask, w, csr=csr, **kw)
        elif not halo_split:
            e_tilde, agg = fused_relational(exchange(x), edge_attr, edge_index, edge_mask, w,
                                            csr=exchange.csr, **kw)
            agg = agg[: x.shape[0]]
        else:
            if halo_split != exchange.e_split:
                msg = f"halo_split={halo_split} is not the partition's e_split={exchange.e_split}"
                raise ValueError(msg)
            s = halo_split
            ei_local, ei_halo = exchange.block_edges()
            started = exchange.start(x)
            e_local, agg = fused_relational(x, edge_attr[:s], ei_local, edge_mask[:s], w,
                                            csr=exchange.block_csr("local"), **kw)
            e_halo, agg_halo = fused_relational(exchange.finish(started, x), edge_attr[s:], ei_halo,
                                                edge_mask[s:], w, csr=exchange.block_csr("halo"), **kw)
            e_tilde, agg = torch.cat([e_local, e_halo]), agg + agg_halo[: x.shape[0]]
        x_tilde = self.object_model(torch.cat([x, agg], dim=1))
        return x_tilde, e_tilde
