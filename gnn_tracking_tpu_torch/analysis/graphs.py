"""Graph-level analysis of tracking graphs (counterpart of the JAX
``analysis/graphs.py``: ``get_cc_labels`` and ``get_largest_segment_fracs``,
the k-scanner's per-k work). Both run on the graph's device, on the
edge-list connected components of ``ops/cc.py``. The networkx diagnostics
(``get_track_graph_info*``, orphan and basic counts) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.ops.cc import compact_labels, connected_components
from gnn_tracking_tpu_torch.ops.segment import segment_max, segment_sum
from gnn_tracking_tpu_torch.ops.unique import dense_index_of, dense_unique
from gnn_tracking_tpu_torch.utils.graph_masks import get_good_node_mask


def get_cc_labels(
    edge_index: torch.Tensor,
    *,
    num_nodes: int,
    edge_mask: torch.Tensor | None = None,
    node_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Connected-component labels numbered consecutively by their smallest
    node; masked nodes get -1."""
    labels = connected_components(edge_index, num_nodes, edge_mask=edge_mask, node_mask=node_mask)
    return compact_labels(labels, valid=node_mask, noise_value=-1)


def _largest_segment_fracs(data: EventGraph, pt_thld: float, max_eta: float):
    """Per dense particle slot: the largest segment's share of the
    particle's good hits (NaN past the particles), and the slots' validity."""
    n = data.num_nodes
    hit_mask = get_good_node_mask(data, pt_thld=pt_thld, max_eta=max_eta)
    ei = data.edge_index.long()
    # true edges between good hits only
    keep_edges = data.edge_mask & data.y.bool() & hit_mask[ei[0]] & hit_mask[ei[1]]
    labels = connected_components(ei, n, edge_mask=keep_edges, node_mask=hit_mask)
    hits = hit_mask.to(torch.int64)
    comp_size = segment_sum(hits, labels, n)
    node_comp_size = torch.where(hit_mask, comp_size[labels], 0)
    pid_unique, pid_valid, _ = dense_unique(data.particle_id, hit_mask, n)
    pid_idx = dense_index_of(data.particle_id, pid_unique)
    pid_count = segment_sum(hits, pid_idx, n)
    largest = segment_max(torch.where(hit_mask, node_comp_size, -1), pid_idx, n)
    fracs = torch.where(
        pid_valid, largest.double() / pid_count.clamp(min=1).double(), torch.nan
    )
    return fracs, pid_valid


def get_largest_segment_fracs(
    data: EventGraph,
    *,
    pt_thld: float = 0.9,
    n_particles_sampled: int | None = None,
    max_eta: float = 4.0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Fraction of each good particle's hits in its largest segment, where
    segments are the connected components of the true-edge subgraph among
    good hits (float64, one entry per particle). With
    ``n_particles_sampled``, only that many particles, drawn with ``rng``."""
    if n_particles_sampled is not None:
        rng = rng or np.random.default_rng()
        pid = data.particle_id.cpu().numpy()
        hit_mask = get_good_node_mask(data, pt_thld=pt_thld, max_eta=max_eta).cpu().numpy()
        pids = np.unique(pid[hit_mask])
        keep = rng.permutation(pids)[:n_particles_sampled]
        data = data.mask_nodes(torch.from_numpy(np.isin(pid, keep)).to(data.device))
    fracs, valid = _largest_segment_fracs(data, pt_thld, max_eta)
    return fracs[valid].cpu().numpy()
