"""Edge efficiency and purity of a built graph (counterpart of the JAX
``metrics/graph_construction.py``; the port keeps its own copy)."""

from __future__ import annotations

import numpy as np

from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.utils.graph_masks import get_good_node_mask


def get_efficiency_purity_edges(
    data: EventGraph, pt_thld: float = 0.9, max_eta: float = 4.0
) -> dict[str, float]:
    """Efficiency and purity of the candidate edges with respect to
    ``true_edge_index``, restricted to edges that touch a good hit."""

    def host(t):
        return t.detach().cpu().numpy()

    hit_mask = host(get_good_node_mask(data, pt_thld=pt_thld, max_eta=max_eta))
    ei = host(data.edge_index)
    te = host(data.true_edge_index)
    edge_mask = (hit_mask[ei[0]] | hit_mask[ei[1]]) & host(data.edge_mask)
    true_edge_mask = hit_mask[te[0]] & hit_mask[te[1]] & host(data.true_edge_mask)
    y = host(data.y)
    n_true_found = float(y[edge_mask].sum())
    # factor 2: candidate edges are directed both ways, true edges are not
    denom_eff = 2.0 * true_edge_mask.sum()
    denom_pur = float(edge_mask.sum())
    return {
        "efficiency": n_true_found / denom_eff if denom_eff else float("nan"),
        "purity": n_true_found / denom_pur if denom_pur else float("nan"),
    }
