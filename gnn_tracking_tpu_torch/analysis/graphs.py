"""Graph-level analysis of tracking graphs (counterpart of the JAX
``analysis/graphs.py``), on the graph's device.

``get_cc_labels`` and ``get_largest_segment_fracs`` are the k-scanner's per-k
work, on the edge-list connected components of ``ops/cc.py``. The per-track
diagnostics that JAX computes with networkx, one particle at a time, take
the port's own undirected graph (:class:`Adjacency`: CSR arrays built from
``edge_index`` and the masks) and run for every particle at once:

* a particle's *segments* are the connected components of the graph's
  edges whose two ends carry its id (the components of networkx's induced
  subgraph), ordered largest first, equal sizes in the order in which
  networkx meets them. That order decides which two segments the distance
  joins where the second and third tie; for those particles only, it is
  taken from the iteration of a Python ``set`` of their hit indices, as
  networkx iterates the induced subgraph's nodes (ascending where the
  particle holds at least half of the graph's nodes);
* its *components* are the connected components of the whole graph, and
  ``n_hits_largest_component`` the largest count of its hits in one of them
  (``n_hits`` where it has one segment);
* ``distance_largest_segments`` is one level-synchronous multi-source
  breadth-first search for all particles with two or more segments, from
  the first segment towards the second, each particle stopped where it
  reaches the second; ``inf`` without a search where the component labels
  put the two in different components.

Records are column tables, ``dict[str, numpy.ndarray]``, in the JAX
DataFrames' column order and dtypes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.ops.cc import compact_labels, connected_components
from gnn_tracking_tpu_torch.ops.segment import node_degrees, segment_max, segment_sum
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


# ----------------------------------------------------------------------
# Per-track diagnostics
# ----------------------------------------------------------------------


class TrackGraphInfo(NamedTuple):
    """Connectivity of one track's hits in the graph."""

    pid: int
    n_hits: int
    n_segments: int
    n_hits_largest_segment: int
    distance_largest_segments: int | float
    n_hits_largest_component: int


#: the visited flags of a breadth-first search take at most this many bytes
#: (particles are searched in groups that fit)
BFS_VISITED_BYTES = 1 << 28
#: (particle, node) pairs expanded at once
BFS_MAX_PAIRS = 1 << 24


class Adjacency(NamedTuple):
    """An undirected graph on nodes ``0 .. N-1``: its edges (``[2, E]``, as
    given, masked ones dropped), which nodes it holds (those of the node
    mask and every edge's ends, as a networkx graph built from them), and
    the CSR arrays of the symmetric, duplicate-free neighbour lists."""

    edge_index: torch.Tensor
    nodes: torch.Tensor
    rowptr: torch.Tensor
    col: torch.Tensor

    @classmethod
    def from_edges(
        cls,
        edge_index: torch.Tensor,
        num_nodes: int,
        *,
        edge_mask: torch.Tensor | None = None,
        node_mask: torch.Tensor | None = None,
    ) -> "Adjacency":
        ei = edge_index.long()
        if edge_mask is not None:
            ei = ei[:, edge_mask.bool()]
        dev = ei.device
        nodes = torch.zeros(num_nodes, dtype=torch.bool, device=dev)
        if node_mask is not None:
            nodes |= node_mask.bool()
        nodes[ei.reshape(-1)] = True
        keys = torch.unique(torch.cat([ei[0] * num_nodes + ei[1], ei[1] * num_nodes + ei[0]]))
        row = keys // num_nodes
        rowptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=dev)
        rowptr[1:] = torch.cumsum(torch.bincount(row, minlength=num_nodes), 0)
        return cls(ei, nodes, rowptr, keys % num_nodes)

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    def components(self) -> torch.Tensor:
        """Connected-component labels (the smallest node of each)."""
        return connected_components(self.edge_index, self.num_nodes)


def _check_nodes(adj: Adjacency, nodes: torch.Tensor) -> None:
    if not bool(adj.nodes[nodes].all()):
        missing = nodes[~adj.nodes[nodes]].tolist()
        msg = f"nodes {missing} are not in the graph"
        raise ValueError(msg)


def _neighbours(adj: Adjacency, q: torch.Tensor, v: torch.Tensor):
    """The ``(q, u)`` pairs for every neighbour ``u`` of each ``v``, in
    slices of at most :data:`BFS_MAX_PAIRS` pairs."""
    start = adj.rowptr[v]
    deg = adj.rowptr[v + 1] - start
    ends = torch.cumsum(deg, 0)
    lo = 0
    while lo < len(v):
        # the pairs up to the slice's end, at least one frontier entry a slice
        base = int(ends[lo - 1]) if lo else 0
        hi = max(lo + 1, int(torch.searchsorted(ends, base + BFS_MAX_PAIRS, right=True)))
        d = deg[lo:hi]
        rep = torch.repeat_interleave(torch.arange(hi - lo, device=v.device), d)
        offset = torch.arange(int(ends[hi - 1]) - base, device=v.device) - (ends[lo:hi] - d - base)[rep]
        yield q[lo:hi][rep], adj.col[start[lo:hi][rep] + offset]
        lo = hi


def _bfs_distances(adj: Adjacency, q_src, v_src, n_queries: int, is_target) -> torch.Tensor:
    """Breadth-first search from each query's sources (pairs ``(q, v)``)
    until ``is_target(q, u)`` holds for a reached node: ``[n_queries]``
    float64 levels, ``inf`` where none is reached. The queries run
    together, level by level, in groups whose visited flags fit in
    :data:`BFS_VISITED_BYTES`."""
    n, dev = adj.num_nodes, adj.nodes.device
    dist = torch.full((n_queries,), math.inf, dtype=torch.float64, device=dev)
    group = max(1, BFS_VISITED_BYTES // max(n, 1))
    for g0 in range(0, n_queries, group):
        sel = (q_src >= g0) & (q_src < g0 + group)
        q, v = q_src[sel] - g0, v_src[sel]
        n_q = min(group, n_queries - g0)
        visited = torch.zeros((n_q, n), dtype=torch.bool, device=dev)
        visited[q, v] = True
        done = torch.zeros(n_q, dtype=torch.bool, device=dev)
        level = 0
        while len(q):
            found = torch.zeros(n_q, dtype=torch.bool, device=dev)
            hit = is_target(q + g0, v)
            found[q[hit]] = True
            dist[g0:g0 + n_q][found] = float(level)
            done |= found
            q, v = q[~done[q]], v[~done[q]]
            if not len(q):
                break
            nq, nv = [], []
            for qq, uu in _neighbours(adj, q, v):
                new = ~visited[qq, uu]
                qq, uu = qq[new], uu[new]
                keys = torch.unique(qq * n + uu)
                qq, uu = keys // n, keys % n
                visited[qq, uu] = True
                nq.append(qq)
                nv.append(uu)
            q, v = torch.cat(nq), torch.cat(nv)
            level += 1
    return dist


def get_n_reachable(g: Adjacency, source: int, targets: Sequence[int]) -> int:
    """The number of distinct ``targets`` in ``source``'s component, the
    source itself not counted."""
    dev = g.nodes.device
    source_t = torch.as_tensor([int(source)], device=dev)
    _check_nodes(g, source_t)
    labels = g.components()
    t = torch.unique(torch.as_tensor(np.asarray(targets, dtype=np.int64), device=dev))
    return int((labels[t] == labels[source_t]).sum()) - 1


def shortest_path_length_multi(g: Adjacency, sources, targets) -> int | float:
    """The shortest path length between two node sets (``inf`` if no path
    joins them): one breadth-first search from all sources at once."""
    dev = g.nodes.device
    src = torch.unique(torch.as_tensor(np.asarray(list(sources), dtype=np.int64), device=dev))
    _check_nodes(g, src)
    is_tgt = torch.zeros(g.num_nodes, dtype=torch.bool, device=dev)
    t = torch.as_tensor(np.asarray(list(targets), dtype=np.int64), device=dev)
    is_tgt[t[(t >= 0) & (t < g.num_nodes)]] = True
    d = float(_bfs_distances(g, torch.zeros_like(src), src, 1, lambda q, v: is_tgt[v])[0])
    return d if math.isinf(d) else int(d)


def _networkx_meeting_ranks(adj: Adjacency, member, slot, seg, roots, tied) -> torch.Tensor:
    """Per segment root, the position among its particle's nodes at which
    networkx's ``connected_components`` of the induced subgraph first meets
    the segment, for the particles that ``tied`` marks; the root's own index
    for the others. networkx iterates a Python ``set`` of the particle's
    nodes, built in ascending order, where they are fewer than half of the
    graph's nodes, else the graph's nodes (here taken in ascending order).
    Only these particles are visited in Python."""
    rank = roots.clone()
    nodes = (member & tied[slot]).nonzero().flatten()
    segment = dict(zip(nodes.tolist(), seg[nodes].tolist()))
    at = {r: i for i, r in enumerate(roots.tolist())}
    n_graph = int(adj.nodes.sum())
    hits: dict[int, list[int]] = {}  # each particle's nodes, ascending
    for o, v in zip(slot[nodes].tolist(), segment):
        hits.setdefault(o, []).append(v)
    for vs in hits.values():
        seen = set()
        for pos, v in enumerate(set(vs) if 2 * len(vs) < n_graph else vs):
            if segment[v] not in seen:
                seen.add(segment[v])
                rank[at[segment[v]]] = pos
    return rank


def _track_graph_columns(adj: Adjacency, particle_ids: torch.Tensor, pids: torch.Tensor) -> dict:
    """The :class:`TrackGraphInfo` of every particle in ``pids`` (sorted,
    unique) as columns (tensors on the graph's device)."""
    n, dev = adj.num_nodes, adj.nodes.device
    p = len(pids)
    arange = torch.arange(n, device=dev)
    slot = torch.searchsorted(pids, particle_ids).clamp(max=max(p - 1, 0))
    is_p = pids[slot] == particle_ids if p else torch.zeros(n, dtype=torch.bool, device=dev)
    n_hits = torch.bincount(slot[is_p], minlength=p)
    member = is_p & adj.nodes
    ei = adj.edge_index
    seg = connected_components(ei, n, edge_mask=particle_ids[ei[0]] == particle_ids[ei[1]])
    comp = connected_components(ei, n)

    # segments, one root (smallest node) each: by particle, largest first, then by root
    roots = (member & (seg == arange)).nonzero().flatten()
    size = torch.bincount(seg[member], minlength=n)[roots]
    order = torch.argsort(-size, stable=True)
    order = order[torch.argsort(slot[roots][order], stable=True)]
    roots, size = roots[order], size[order]
    n_segments = torch.bincount(slot[roots], minlength=p)
    first = torch.cumsum(n_segments, 0) - n_segments
    largest = size[first]
    # where the second and third segments tie, networkx's order decides the second
    last = max(len(size) - 1, 0)
    tied = (n_segments >= 3) & (size[(first + 1).clamp(max=last)] == size[(first + 2).clamp(max=last)])
    if bool(tied.any()):
        rank = _networkx_meeting_ranks(adj, member, slot, seg, roots, tied)
        order = torch.argsort(rank, stable=True)
        order = order[torch.argsort(-size[order], stable=True)]
        order = order[torch.argsort(slot[roots][order], stable=True)]
        roots, size = roots[order], size[order]

    # the largest count of a particle's hits in one component
    keys, counts = torch.unique(slot[member] * n + comp[member], return_counts=True)
    in_comp = segment_max(counts, keys // n, p)
    n_hits_largest_component = torch.where(n_segments == 1, n_hits, in_comp)

    # distances between the two largest segments
    dist = torch.zeros(p, dtype=torch.float64, device=dev)
    multi = (n_segments > 1).nonzero().flatten()
    s0, s1 = roots[first[multi]], roots[first[multi] + 1]
    joined = comp[s0] == comp[s1]
    dist[multi[~joined]] = math.inf
    search = multi[joined]
    query = torch.full((p,), -1, dtype=torch.int64, device=dev)
    query[search] = torch.arange(len(search), device=dev)
    seg0 = torch.full((p,), -1, dtype=torch.int64, device=dev)
    seg0[search] = s0[joined]
    src = (member & (seg == seg0[slot])).nonzero().flatten()
    target = s1[joined]
    dist[search] = _bfs_distances(adj, query[slot[src]], src, len(search),
                                  lambda q, v: seg[v] == target[q])
    return {
        "pid": pids,
        "n_hits": n_hits,
        "n_segments": n_segments,
        "n_hits_largest_segment": largest,
        "distance_largest_segments": dist,
        "n_hits_largest_component": n_hits_largest_component,
    }


def _to_numpy_columns(cols: dict) -> dict[str, np.ndarray]:
    out = {k: v.cpu().numpy() for k, v in cols.items()}
    d = out["distance_largest_segments"]
    # an integer column unless a row is inf, as in the JAX DataFrame
    if np.isfinite(d).all():
        out["distance_largest_segments"] = d.astype(np.int64)
    return out


def get_track_graph_info(graph: Adjacency, particle_ids, pid: int) -> TrackGraphInfo:
    """Segments and components of one track's hits (``particle_ids``: the
    particle id of every node)."""
    ids = torch.as_tensor(np.asarray(particle_ids), device=graph.nodes.device).long()
    extra = len(ids) - graph.num_nodes
    if extra < 0:  # nodes past the ids belong to another particle
        ids = torch.cat([ids, torch.full((-extra,), int(pid) - 1, device=ids.device)])
    elif extra > 0:  # ids past the graph's nodes are hits outside it
        graph = graph._replace(
            nodes=torch.cat([graph.nodes, graph.nodes.new_zeros(extra)]),
            rowptr=torch.cat([graph.rowptr, graph.rowptr[-1:].repeat(extra)]),
        )
    cols = _to_numpy_columns(_track_graph_columns(graph, ids, torch.as_tensor([int(pid)], device=ids.device)))
    assert cols["n_hits"][0] > 0
    return TrackGraphInfo(*(c[0].item() for c in cols.values()))


def _graph_of(data: EventGraph, w=None, threshold: float | None = None) -> Adjacency:
    """The graph of ``data``'s node mask and masked edges, after the cut
    ``w > threshold`` where ``w`` is given."""
    edge_mask = data.edge_mask
    if w is not None:
        edge_mask = edge_mask & (torch.as_tensor(w, device=data.device) > threshold)
    return Adjacency.from_edges(data.edge_index, data.num_nodes, edge_mask=edge_mask, node_mask=data.node_mask)


def get_track_graph_info_from_data(
    data: EventGraph,
    *,
    w=None,
    pt_thld: float = 0.9,
    threshold: float | None = None,
    max_eta: float = 4.0,
) -> dict[str, np.ndarray]:
    """:class:`TrackGraphInfo` of every good particle (ascending id), as a
    column table, optionally after the edge-classifier cut ``w >
    threshold``. ``n_hits`` counts every node with the particle's id."""
    adj = _graph_of(data, w, threshold)
    good = get_good_node_mask(data, pt_thld=pt_thld, max_eta=max_eta)
    pids = torch.unique(data.particle_id[good])
    if not len(pids):
        return {}
    return _to_numpy_columns(_track_graph_columns(adj, data.particle_id, pids))


def summarize_track_graph_info(tgi: dict[str, np.ndarray]) -> dict[str, float]:
    """Shares of tracks whose largest segment / component holds all, half or
    three quarters of their hits, and the means of the segment counts and
    of those fractions."""
    if not tgi or len(tgi["pid"]) == 0:
        return {}
    n = len(tgi["pid"])
    seg_frac = tgi["n_hits_largest_segment"] / tgi["n_hits"]
    comp_frac = tgi["n_hits_largest_component"] / tgi["n_hits"]
    return {
        "frac_segment100": float((seg_frac == 1).sum() / n),
        "frac_component100": float((comp_frac == 1).sum() / n),
        "frac_segment50": float((seg_frac >= 0.5).sum() / n),
        "frac_component50": float((comp_frac >= 0.5).sum() / n),
        "frac_segment75": float((seg_frac >= 0.75).sum() / n),
        "frac_component75": float((comp_frac >= 0.75).sum() / n),
        "n_segments": float(tgi["n_segments"].mean()),
        "frac_hits_largest_segment": float(seg_frac.mean()),
        "frac_hits_largest_component": float(comp_frac.mean()),
    }


class OrphanCount(NamedTuple):
    """Nodes without an edge: of noise or uninteresting particles
    (correct), of good particles (incorrect), and all."""

    n_orphan_correct: int
    n_orphan_incorrect: int
    n_orphan_total: int


def get_orphan_counts(data: EventGraph, *, pt_thld: float = 0.9, max_eta: float = 4.0) -> OrphanCount:
    """Count the unmasked nodes that no masked edge touches."""
    orphan = (node_degrees(data.edge_index.long(), data.num_nodes, data.edge_mask) == 0) & data.node_mask
    good = get_good_node_mask(data, pt_thld=pt_thld, max_eta=max_eta)
    counts = torch.stack([(orphan & ~good).sum(), (orphan & good).sum(), orphan.sum()]).cpu().tolist()
    return OrphanCount(*counts)


def get_basic_counts(data: EventGraph, *, pt_thld: float = 0.9, max_eta: float = 4.0) -> dict[str, int]:
    """Node, noise, good-hit, edge, track and true-edge counts
    (``n_true_edges_thld`` counts the false edges that start at a good hit,
    as the JAX function does)."""
    good = get_good_node_mask(data, pt_thld=pt_thld, max_eta=max_eta)
    node_mask, edge_mask, y = data.node_mask, data.edge_mask, data.y.bool()
    pid = data.particle_id
    counts = torch.stack([
        node_mask.sum(),
        ((pid <= 0) & node_mask).sum(),
        good.sum(),
        edge_mask.sum(),
        torch.tensor(len(torch.unique(pid[node_mask])), device=data.device),
        (y & edge_mask).sum(),
        (~y & edge_mask & good[data.edge_index[0].long()]).sum(),
    ]).cpu().tolist()
    keys = ("n_hits", "n_hits_noise", "n_hits_thld", "n_edges", "n_tracks", "n_true_edges", "n_true_edges_thld")
    return dict(zip(keys, counts))


def get_all_graph_construction_stats(
    data: EventGraph, pt_thld: float = 0.9, max_eta: float = 4.0
) -> dict[str, float]:
    """Orphan counts, the track-graph summary and the basic counts of one
    graph."""
    return (
        get_orphan_counts(data, pt_thld=pt_thld, max_eta=max_eta)._asdict()
        | summarize_track_graph_info(
            get_track_graph_info_from_data(data, pt_thld=pt_thld, max_eta=max_eta)
        )
        | get_basic_counts(data, pt_thld=pt_thld, max_eta=max_eta)
    )
