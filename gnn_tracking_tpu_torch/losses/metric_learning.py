"""Hinge embedding loss for metric-learning graph construction (counterpart
of the JAX ``losses/metric_learning.py``: ``_hinge_loss_components`` and
``GraphConstructionHingeEmbeddingLoss``).

The attractive term pulls the hits of one particle together along the true
edges; the repulsive term pushes hits of different particles apart along a
radius graph of the embedding (``ops/knn.py:radius_graph``, at most
``max_num_neighbors`` neighbours per hit). Selection is detached; the loss
differentiates through distances recomputed from the live ``x``.
``OldGraphConstructionHingeEmbeddingLoss`` is not ported yet.
"""

from __future__ import annotations

from typing import Any

import torch

from gnn_tracking_tpu_torch.losses import MultiLossFct, MultiLossFctReturn
from gnn_tracking_tpu_torch.ops.knn import radius_graph
from gnn_tracking_tpu_torch.utils.graph_masks import get_good_node_mask_tensors

_EPS = 1e-9
NORMALIZATIONS = ("n_rep_edges", "n_hits_oi", "n_att_edges")


def _hinge_loss_components(
    *,
    x: torch.Tensor,
    att_edges: torch.Tensor,
    att_mask: torch.Tensor,
    rep_mask: torch.Tensor,
    rep_dists: torch.Tensor,
    r_emb_hinge: float,
    p_attr: float,
    p_rep: float,
    n_hits_oi: torch.Tensor,
    normalization: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked attractive and repulsive potentials."""
    src, dst = att_edges.long()
    diff = x[src] - x[dst]
    d2 = (diff * diff).sum(-1)
    # safe norm: padded (0, 0) self-pairs have zero distance, whose sqrt
    # gradient would be NaN; both wheres are needed
    safe = att_mask & (d2 > 0)
    d_att = torch.where(safe, torch.sqrt(torch.where(safe, d2, 1.0)), 0.0)
    norm_att = att_mask.sum() + _EPS
    v_att = torch.where(att_mask, d_att**p_attr, 0.0).sum() / norm_att

    if normalization == "n_rep_edges":
        norm_rep = rep_mask.sum() + _EPS
    elif normalization == "n_hits_oi":
        norm_rep = n_hits_oi + _EPS
    elif normalization == "n_att_edges":
        norm_rep = att_mask.sum() + _EPS
    else:
        msg = f"Normalization {normalization} not recognized."
        raise ValueError(msg)
    hinge = torch.relu(r_emb_hinge - rep_dists**p_rep)
    v_rep = torch.where(rep_mask, hinge, 0.0).sum() / norm_rep
    return v_att, v_rep


class GraphConstructionHingeEmbeddingLoss(MultiLossFct):
    """Hinge embedding loss (reference ``metric_learning.py:57-178``)."""

    def __init__(
        self,
        *,
        lw_repulsive: float = 1.0,
        r_emb: float = 1.0,
        max_num_neighbors: int = 256,
        pt_thld: float = 0.9,
        max_eta: float = 4.0,
        p_attr: float = 1.0,
        p_rep: float = 1.0,
        rep_normalization: str = "n_hits_oi",
        rep_oi_only: bool = True,
    ):
        if rep_normalization not in NORMALIZATIONS:
            msg = f"Normalization {rep_normalization} not recognized."
            raise ValueError(msg)
        self.lw_repulsive = lw_repulsive
        self.r_emb = r_emb
        self.max_num_neighbors = max_num_neighbors
        self.pt_thld = pt_thld
        self.max_eta = max_eta
        self.p_attr = p_attr
        self.p_rep = p_rep
        self.rep_normalization = rep_normalization
        self.rep_oi_only = rep_oi_only

    def __call__(
        self,
        *,
        x: torch.Tensor,
        particle_id: torch.Tensor,
        batch: torch.Tensor | None = None,
        true_edge_index: torch.Tensor,
        pt: torch.Tensor,
        eta: torch.Tensor,
        reconstructable: torch.Tensor,
        node_mask: torch.Tensor | None = None,
        true_edge_mask: torch.Tensor | None = None,
        **kwargs: Any,
    ) -> MultiLossFctReturn:
        if true_edge_index is None:
            msg = (
                "true_edge_index must be given and not be None. Are you trying "
                "to use this loss for OC training? Double check that you are "
                "properly passing on the true edges."
            )
            raise ValueError(msg)
        mask = get_good_node_mask_tensors(
            pt=pt, particle_id=particle_id, reconstructable=reconstructable,
            eta=eta, pt_thld=self.pt_thld, max_eta=self.max_eta,
        )
        if node_mask is not None:
            mask = mask & node_mask
        n_hits_oi = mask.sum()

        # attractive edges: true edges that start at a hit of interest
        att_mask = mask[true_edge_index[0].long()]
        if true_edge_mask is not None:
            att_mask = att_mask & true_edge_mask

        # repulsive edges: radius-graph neighbours of another particle
        rep_edges, rep_mask, rep_dists = radius_graph(
            x, self.r_emb, max_num_neighbors=self.max_num_neighbors,
            node_mask=node_mask, batch=batch, loop=False,
        )
        src, dst = rep_edges.long()
        if self.rep_oi_only:
            rep_mask = rep_mask & mask[src]
        rep_mask = rep_mask & (particle_id[src] != particle_id[dst])

        attr, rep = _hinge_loss_components(
            x=x, att_edges=true_edge_index, att_mask=att_mask, rep_mask=rep_mask,
            rep_dists=rep_dists, r_emb_hinge=self.r_emb, p_attr=self.p_attr,
            p_rep=self.p_rep, n_hits_oi=n_hits_oi, normalization=self.rep_normalization,
        )
        return MultiLossFctReturn(
            loss_dct={"attractive": attr, "repulsive": rep},
            weight_dct={"attractive": 1.0, "repulsive": self.lw_repulsive},
            extra_metrics={
                "n_hits_oi": n_hits_oi,
                "n_edges_att": att_mask.sum(),
                "n_edges_rep": rep_mask.sum(),
            },
        )
