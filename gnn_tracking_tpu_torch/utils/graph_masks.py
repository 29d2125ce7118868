"""Good-node masks (counterpart of the JAX ``utils/graph_masks.py``): hits of
"interesting" particles, above a pt threshold, not noise, reconstructable,
inside the eta acceptance."""

from __future__ import annotations

import torch


def get_good_node_mask_tensors(
    *,
    pt: torch.Tensor,
    particle_id: torch.Tensor,
    reconstructable: torch.Tensor,
    eta: torch.Tensor,
    pt_thld: float = 0.9,
    max_eta: float = 4.0,
) -> torch.Tensor:
    """Mask of hits from interesting particles (pt, noise, reco, eta cuts)."""
    return (
        (pt > pt_thld)
        & (particle_id > 0)
        & (reconstructable > 0)
        & (torch.abs(eta) < max_eta)
    )


def get_good_node_mask(data, *, pt_thld: float = 0.9, max_eta: float = 4.0) -> torch.Tensor:
    """`get_good_node_mask_tensors` applied to an ``EventGraph``, and its node mask."""
    return (
        get_good_node_mask_tensors(
            pt=data.pt,
            particle_id=data.particle_id,
            reconstructable=data.reconstructable,
            eta=data.eta,
            pt_thld=pt_thld,
            max_eta=max_eta,
        )
        & data.node_mask
    )


def get_edge_mask_from_node_mask(
    node_mask: torch.Tensor, edge_index: torch.Tensor
) -> torch.Tensor:
    """Mask of edges whose both endpoints pass the node mask."""
    return node_mask[edge_index[0]] & node_mask[edge_index[1]]
