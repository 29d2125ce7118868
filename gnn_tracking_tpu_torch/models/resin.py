"""Stacked interaction networks with residual connections (counterpart of
the JAX ``models/resin.py``: ``MaskedBatchNorm``, ``sqconvex_combination``
and ``ResIN`` with its three residual schemes ``skip1``, ``skip2`` and
``skip_top``)."""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gnn_tracking_tpu_torch.models.interaction_network import InteractionNetwork


class MaskedBatchNorm(nn.Module):
    """Batch normalization over the valid (unmasked) rows only; masked rows
    pass through unchanged (the JAX ``MaskedBatchNorm``, in place of the
    reference's ``nn.BatchNorm1d``, whose statistics would count them).

    In training mode it normalizes with the batch's statistics and updates
    the running averages (buffers ``mean`` / ``var``: momentum 0.1, the
    unbiased variance ``n / max(n - 1, 1)`` of the ``n`` valid rows); in
    eval mode it normalizes with the running averages. The running averages
    are updated in float32, as the JAX module keeps its ``batch_stats``, and
    read in the input's dtype. Parameters ``scale`` and ``bias``.
    """

    def __init__(self, num_features: int, epsilon: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if mask is None:
            mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        if self.training:
            w = mask.to(x.dtype)[:, None]
            n = torch.clamp(w.sum(), min=1.0)
            mean = torch.sum(x * w, dim=0, keepdim=True) / n
            var = torch.sum(w * (x - mean) ** 2, dim=0, keepdim=True) / n
            with torch.no_grad():
                m = self.momentum
                unbiased = var[0] * n / torch.clamp(n - 1.0, min=1.0)
                new_mean = (1 - m) * self.mean.float() + m * mean[0].float()
                new_var = (1 - m) * self.var.float() + m * unbiased.float()
                self.mean.copy_(new_mean)
                self.var.copy_(new_var)
        else:
            mean = self.mean[None].to(x.dtype)
            var = self.var[None].to(x.dtype)
        y = (x - mean) * torch.rsqrt(var + self.epsilon) * self.scale + self.bias
        return torch.where(mask[:, None], y, x)


def sqconvex_combination(
    *, delta: torch.Tensor, residue: torch.Tensor | None, alpha_residue: float
) -> torch.Tensor:
    """``sqrt(alpha)*residue + sqrt(1-alpha)*delta``."""
    if residue is None or math.isclose(alpha_residue, 0.0):
        return delta
    assert 0 <= alpha_residue <= 1
    return math.sqrt(alpha_residue) * residue + math.sqrt(1 - alpha_residue) * delta


class ResIN(nn.Module):
    """Stack of identical interaction networks with residual connections;
    ``fused_save_acts`` is handed to each layer.

    * ``skip1``: every layer's node output is mixed with its input;
    * ``skip2``: blocks of two layers, the block's output mixed with its
      input; ``n_layers`` must be even. ``add_bn`` puts a
      :class:`MaskedBatchNorm` on the nodes (under ``node_mask``) and on the
      edges (under the edge mask) before each layer, in front of its ReLU.
      ``compat_overlap`` reproduces the reference's overlapping blocks
      (``resin.py:157``): ``n_layers - 1`` blocks ``(i, i + 1)`` that share
      their layers and batch norms with the neighbouring blocks;
    * ``skip_top``: the input of layer ``connect_to`` is mixed with the
      output of every layer from there on.

    Layers after the first see ``relu(x)`` and ``relu(e)``; the edge ReLU
    runs inside the fused op. ``remat`` recomputes each interaction layer in
    the backward pass (``torch.utils.checkpoint``, JAX's ``nn.remat``): a
    layer keeps only its inputs, the same gradients. Returns ``(node
    embedding, last edge embedding, list of edge embeddings from all levels
    including the input, or None)``. ``halo_edge_split`` is the partition's ``e_split`` for the
    graph-parallel hook (see :meth:`forward`). ``model_config`` holds the
    constructor arguments.
    """

    def __init__(
        self,
        node_dim: int,
        edge_dim: int,
        object_hidden_dim: int | None = 40,
        relational_hidden_dim: int | None = 40,
        alpha: float = 0.5,
        n_layers: int = 1,
        residual_type: str = "skip1",
        collect_hidden_edge_embeds: bool = True,
        connect_to: int = 1,
        add_bn: bool = False,
        compat_overlap: bool = False,
        fused_save_acts: bool = False,
        halo_edge_split: int = 0,
        remat: bool = False,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if residual_type not in ("skip1", "skip2", "skip_top"):
            msg = f"Unknown residual type: {residual_type}"
            raise ValueError(msg)
        if residual_type == "skip2" and n_layers % 2 != 0:
            msg = "skip2 requires an even number of layers"
            raise ValueError(msg)
        if residual_type == "skip_top" and connect_to > n_layers:
            msg = f"connect_to={connect_to} exceeds n_layers={n_layers}"
            raise ValueError(msg)
        self.model_config = {
            "node_dim": node_dim, "edge_dim": edge_dim, "object_hidden_dim": object_hidden_dim,
            "relational_hidden_dim": relational_hidden_dim, "alpha": alpha, "n_layers": n_layers,
            "residual_type": residual_type,
            "collect_hidden_edge_embeds": collect_hidden_edge_embeds, "connect_to": connect_to,
            "add_bn": add_bn, "compat_overlap": compat_overlap, "fused_save_acts": fused_save_acts,
            "halo_edge_split": halo_edge_split, "remat": remat,
        }
        self.alpha = alpha
        self.remat = remat
        self.residual_type = residual_type
        self.collect_hidden_edge_embeds = collect_hidden_edge_embeds
        self.connect_to = connect_to
        self.compat_overlap = compat_overlap
        self.halo_edge_split = halo_edge_split
        self.layers = nn.ModuleList(
            InteractionNetwork(
                node_dim, edge_dim, node_outdim=node_dim, edge_outdim=edge_dim,
                node_hidden_dim=object_hidden_dim,
                edge_hidden_dim=relational_hidden_dim, fused_save_acts=fused_save_acts,
                generator=generator,
            )
            for _ in range(n_layers)
        )
        # batch norms only where the JAX module makes them (skip2), under its
        # names node_bn_i / edge_bn_i
        self.add_bn = add_bn and residual_type == "skip2"
        if self.add_bn:
            for i in range(n_layers):
                self.add_module(f"node_bn_{i}", MaskedBatchNorm(node_dim))
                self.add_module(f"edge_bn_{i}", MaskedBatchNorm(edge_dim))
        self.edge_dim = edge_dim

    @property
    def concat_edge_embeddings_length(self) -> int:
        """Width of the concatenated per-level edge embeddings (JAX
        ``resin.py:284-290``)."""
        n_layers = len(self.layers)
        if self.residual_type == "skip2":
            if self.compat_overlap:
                return self.edge_dim * max(n_layers, 2)
            return self.edge_dim * (n_layers // 2 + 1)
        return self.edge_dim * (n_layers + 1)

    def forward(
        self,
        x: torch.Tensor,
        edge_index: torch.Tensor,
        edge_attr: torch.Tensor,
        edge_mask: torch.Tensor,
        *,
        node_mask: torch.Tensor | None = None,
        csr: dict[str, torch.Tensor] | None = None,
        exchange=None,
    ) -> tuple[torch.Tensor, torch.Tensor, list[torch.Tensor] | None]:
        """``node_mask`` selects the rows of the nodes' batch statistics
        (``add_bn``; None: every row). ``exchange`` is the graph-parallel
        hook (``parallel.halo.HaloExchange``; see ``InteractionNetwork``): every
        layer fetches the halo rows of its input, and its output covers the
        shard's own rows; ``halo_edge_split`` then overlaps the fetch with the
        local edges. The batch norms' statistics are the shard's own, as in
        JAX."""
        edge_attrs = [edge_attr] if self.collect_hidden_edge_embeds else None
        split = {"exchange": exchange, "halo_split": self.halo_edge_split} if exchange is not None else {}

        def run(i, x_in, e_in, relu_in):
            # the node relu in autograd, the edge relu in the fused op (its
            # gradient too)
            args = (torch.relu(x_in) if relu_in else x_in, edge_index, e_in, edge_mask)
            kw = {"csr": csr, "relu_edge": relu_in, **split}
            if self.remat and torch.is_grad_enabled():
                return checkpoint(self.layers[i], *args, use_reentrant=False, **kw)
            return self.layers[i](*args, **kw)

        def bn(i, x_in, e_in):
            if not self.add_bn:
                return x_in, e_in
            node_bn, edge_bn = getattr(self, f"node_bn_{i}"), getattr(self, f"edge_bn_{i}")
            return node_bn(x_in, node_mask), edge_bn(e_in, edge_mask)

        n_layers = len(self.layers)
        if self.residual_type == "skip1":
            for i in range(n_layers):
                delta_x, edge_attr = run(i, x, edge_attr, i > 0)
                x = sqconvex_combination(delta=delta_x, residue=x, alpha_residue=self.alpha)
                if edge_attrs is not None:
                    edge_attrs.append(edge_attr)
        elif self.residual_type == "skip2":
            if self.compat_overlap:
                blocks = [(i, i + 1) for i in range(n_layers - 1)]
            else:
                blocks = [(2 * b, 2 * b + 1) for b in range(n_layers // 2)]
            for i0, i1 in blocks:
                hidden_x, hidden_e = run(i0, *bn(i0, x, edge_attr), i0 > 0)
                delta_x, edge_attr = run(i1, *bn(i1, hidden_x, hidden_e), True)
                x = sqconvex_combination(delta=delta_x, residue=x, alpha_residue=self.alpha)
                if edge_attrs is not None:
                    edge_attrs.append(edge_attr)
        else:  # skip_top
            x_residue = None
            for i in range(n_layers):
                if i == self.connect_to:
                    x_residue = x
                delta_x, edge_attr = run(i, x, edge_attr, i > 0)
                x = sqconvex_combination(delta=delta_x, residue=x_residue, alpha_residue=self.alpha)
                if edge_attrs is not None:
                    edge_attrs.append(edge_attr)
        return x, edge_attr, edge_attrs
