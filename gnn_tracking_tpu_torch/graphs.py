"""Masked event graphs — the port's data container.

Counterpart of ``gnn_tracking_tpu/graphs.py``: the same fields and
conventions, as a plain dataclass of tensors.

* ``edge_index`` is ``[2, E]`` int32, row 0 = source, row 1 = target
  (messages flow source -> target).
* ``node_mask`` / ``edge_mask`` mark the valid nodes and edges; every
  consumer honours them.
* Padding buckets (``PaddingConfig``) are a TPU static-shape device and are
  not part of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

PAD_PARTICLE_ID = -1

NODE_FIELDS = (
    "x", "particle_id", "pt", "eta", "reconstructable", "node_mask",
    "layer", "sector", "batch",
)
EDGE_FIELDS = ("edge_index", "edge_attr", "y", "edge_mask")
TRUE_EDGE_FIELDS = ("true_edge_index", "true_edge_mask")
ARRAY_FIELDS = NODE_FIELDS + EDGE_FIELDS + TRUE_EDGE_FIELDS
#: CSR arrays of a target-sorted graph that the fused interaction-network op takes
CSR_KEYS = ("dst_rowptr", "src_perm", "src_rowptr")
#: extras that ``sort_edges_by_target`` derives from the edge order
DERIVED_KEYS = (*CSR_KEYS, "src_sorted", "edge_unsort")


@dataclasses.dataclass
class EventGraph:
    """One event's hit graph (fields as in the JAX ``EventGraph``)."""

    # --- nodes ---
    x: torch.Tensor  # [N, F] node features
    particle_id: torch.Tensor  # [N]; 0 = noise, <0 = padding
    pt: torch.Tensor  # [N]
    eta: torch.Tensor  # [N]
    reconstructable: torch.Tensor  # [N]
    node_mask: torch.Tensor  # [N] bool
    layer: torch.Tensor  # [N] int32 detector layer
    sector: torch.Tensor  # [N] int32 azimuthal sector
    batch: torch.Tensor  # [N] int32 graph id
    # --- candidate edges ---
    edge_index: torch.Tensor  # [2, E] int32
    edge_attr: torch.Tensor  # [E, Fe]
    y: torch.Tensor  # [E] edge truth
    edge_mask: torch.Tensor  # [E] bool
    # --- truth edges ---
    true_edge_index: torch.Tensor  # [2, Et] int32
    true_edge_mask: torch.Tensor  # [Et] bool
    # --- optional extras (e.g. baked EC scores, the CSR row pointer) ---
    extras: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_index.shape[1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def replace(self, **changes) -> "EventGraph":
        return dataclasses.replace(self, **changes)

    def to(
        self, device: str | torch.device, dtype: torch.dtype | None = None
    ) -> "EventGraph":
        """Move every tensor to ``device``; with ``dtype``, also cast the
        floating-point ones."""

        def move(t):
            if dtype is not None and t.is_floating_point():
                return t.to(device=device, dtype=dtype)
            return t.to(device)

        fields = {f: move(getattr(self, f)) for f in ARRAY_FIELDS}
        extras = {k: move(v) for k, v in self.extras.items()}
        return EventGraph(**fields, extras=extras)

    @classmethod
    def from_arrays(
        cls,
        *,
        x: Any,
        edge_index: Any = None,
        edge_attr: Any = None,
        y: Any = None,
        particle_id: Any = None,
        pt: Any = None,
        eta: Any = None,
        reconstructable: Any = None,
        layer: Any = None,
        sector: Any = None,
        true_edge_index: Any = None,
        extras: dict[str, Any] | None = None,
        dtype: torch.dtype = torch.float32,
    ) -> "EventGraph":
        """Build an unmasked graph from host arrays (CPU tensors); node
        fields not given are zeros, and so are the true edges."""
        x = torch.as_tensor(np.asarray(x), dtype=dtype)
        n = x.shape[0]
        if edge_index is None:
            edge_index = np.zeros((2, 0), dtype=np.int32)
        edge_index = torch.as_tensor(np.asarray(edge_index), dtype=torch.int32)
        e = edge_index.shape[1]
        edge_attr = (
            torch.zeros((e, 0), dtype=dtype)
            if edge_attr is None
            else torch.as_tensor(np.asarray(edge_attr), dtype=dtype)
        )
        pid = (
            torch.zeros(n, dtype=torch.int64)
            if particle_id is None
            else torch.as_tensor(np.asarray(particle_id), dtype=torch.int64)
        )

        def node_field(v, field_dtype=dtype):
            if v is None:
                return torch.zeros(n, dtype=field_dtype)
            return torch.as_tensor(np.asarray(v), dtype=field_dtype)

        if true_edge_index is None:
            true_edge_index = np.zeros((2, 0), dtype=np.int32)
        true_edge_index = torch.as_tensor(np.asarray(true_edge_index), dtype=torch.int32)

        return cls(
            x=x,
            particle_id=pid,
            pt=node_field(pt),
            eta=node_field(eta),
            reconstructable=node_field(reconstructable),
            node_mask=torch.ones(n, dtype=torch.bool),
            layer=node_field(layer, torch.int32),
            sector=node_field(sector, torch.int32),
            batch=torch.zeros(n, dtype=torch.int32),
            edge_index=edge_index,
            edge_attr=edge_attr,
            y=(
                torch.zeros(e, dtype=torch.bool)
                if y is None
                else torch.as_tensor(np.asarray(y)).to(torch.bool)
            ),
            edge_mask=torch.ones(e, dtype=torch.bool),
            true_edge_index=true_edge_index,
            true_edge_mask=torch.ones(true_edge_index.shape[1], dtype=torch.bool),
            extras={
                k: torch.as_tensor(np.asarray(v)) for k, v in (extras or {}).items()
            },
        )

    def mask_nodes(self, keep: torch.Tensor) -> "EventGraph":
        """Mask the nodes outside ``keep`` and every edge that touches one
        (JAX ``EventGraph.mask_nodes``, PyG's ``Data.subgraph``)."""
        node_mask = self.node_mask & keep
        ei = self.edge_index.long()
        edge_keep = node_mask[ei[0]] & node_mask[ei[1]]
        return self.replace(node_mask=node_mask, edge_mask=self.edge_mask & edge_keep)

    def csr(self) -> dict[str, torch.Tensor]:
        """The CSR arrays of a target-sorted graph (those of ``CSR_KEYS``
        that ``sort_edges_by_target`` stored), as the fused
        interaction-network op takes them."""
        return {k: self.extras[k] for k in CSR_KEYS if k in self.extras}

    def sort_edges_by_target(self, *, with_unsort: bool = False) -> "EventGraph":
        """Reorder edges so ``edge_index[1]`` is non-decreasing, valid edges
        first (JAX ``EventGraph.sort_edges_by_target``, ``graphs.py:204``).

        Masked edges go last and are re-pointed at the last node. Stored in
        ``extras``, computed on the sorted edges (``[N + 1]`` and ``[E]``
        int32):

        * ``dst_rowptr``: CSR row pointer of the targets; the edges of node
          ``i`` are ``rowptr[i]:rowptr[i+1]``;
        * ``src_perm``: stable argsort of the sources, and ``src_sorted``,
          the sources in that order (as the JAX version stores them);
        * ``src_rowptr``: CSR row pointer of ``src_sorted``; the edges
          whose source is ``i`` are ``src_perm[src_rowptr[i]:src_rowptr[i+1]]``.

        The fused interaction-network kernels need the three of
        ``CSR_KEYS``. With ``with_unsort=True`` the inverse permutation is
        in ``extras["edge_unsort"]``: ``out[edge_unsort]`` maps a per-edge
        output back to the caller's edge order.
        """
        n, e = self.num_nodes, self.num_edges
        dst = self.edge_index[1].to(torch.int64)
        key = torch.where(self.edge_mask, dst, torch.full_like(dst, n))
        order = torch.argsort(key, stable=True)
        ei = self.edge_index[:, order]
        mask = self.edge_mask[order]
        last = torch.full_like(ei[1], n - 1)
        ei = torch.stack([ei[0], torch.where(mask, ei[1], last)]).contiguous()
        # per-edge extras follow the edges; the derived arrays are rebuilt
        # below (a [N + 1] pointer must never be permuted as an edge array)
        extras = {
            k: (v[order] if v.shape[0] == e else v)
            for k, v in self.extras.items()
            if k not in DERIVED_KEYS
        }
        extras.update(target_csr(ei, n))
        if with_unsort:
            extras["edge_unsort"] = torch.argsort(order)
        return self.replace(
            edge_index=ei,
            edge_attr=self.edge_attr[order].contiguous(),
            y=self.y[order],
            edge_mask=mask,
            extras=extras,
        )

    def mask_edges(self, keep: torch.Tensor) -> "EventGraph":
        """Mask the edges outside ``keep`` (JAX ``EventGraph.mask_edges``,
        PyG's ``Data.edge_subgraph``)."""
        return self.replace(edge_mask=self.edge_mask & keep)

    def compact(self) -> "EventGraph":
        """Drop the masked nodes and edges (JAX ``EventGraph.compact``):
        node indices are renumbered, ``extras`` of node length follow the
        nodes and the others the edges. The derived CSR arrays of
        ``sort_edges_by_target`` do not describe the kept edges and are
        dropped."""
        node_mask, edge_mask = self.node_mask, self.edge_mask
        new_index = torch.cumsum(node_mask.to(torch.int64), 0) - 1
        ei = new_index[self.edge_index[:, edge_mask].long()].to(self.edge_index.dtype)
        te = new_index[self.true_edge_index[:, self.true_edge_mask].long()].to(
            self.true_edge_index.dtype
        )
        n = self.num_nodes
        nodes = {f: getattr(self, f)[node_mask] for f in NODE_FIELDS if f != "node_mask"}
        return EventGraph(
            **nodes,
            node_mask=torch.ones(int(node_mask.sum()), dtype=torch.bool, device=self.device),
            edge_index=ei,
            edge_attr=self.edge_attr[edge_mask],
            y=self.y[edge_mask],
            edge_mask=torch.ones(ei.shape[1], dtype=torch.bool, device=self.device),
            true_edge_index=te,
            true_edge_mask=torch.ones(te.shape[1], dtype=torch.bool, device=self.device),
            extras={
                k: v[node_mask] if v.shape[0] == n else v[edge_mask]
                for k, v in self.extras.items()
                if k not in DERIVED_KEYS
            },
        )


def target_csr(edge_index: torch.Tensor, num_nodes: int) -> dict[str, torch.Tensor]:
    """The derived arrays of :meth:`EventGraph.sort_edges_by_target` for an
    ``edge_index`` whose targets (row 1) are already non-decreasing, such as
    the query-major graphs of ``ops/knn.py``: ``dst_rowptr``, ``src_perm``,
    ``src_sorted`` and ``src_rowptr`` (those of ``CSR_KEYS`` are what the
    fused interaction-network op takes as ``csr``)."""
    nodes = torch.arange(num_nodes + 1, device=edge_index.device, dtype=edge_index.dtype)
    src_perm = torch.argsort(edge_index[0], stable=True)
    src_sorted = edge_index[0][src_perm].contiguous()
    return {
        "dst_rowptr": torch.searchsorted(edge_index[1].contiguous(), nodes).to(torch.int32),
        "src_perm": src_perm.to(torch.int32),
        "src_sorted": src_sorted,
        "src_rowptr": torch.searchsorted(src_sorted, nodes).to(torch.int32),
    }


def pad_sizes(n: int, bucket: int = 1024) -> int:
    """``n`` rounded up to the next multiple of ``bucket`` (JAX
    ``graphs.pad_sizes``)."""
    return int(-(-n // bucket) * bucket)


def batch_graphs(graphs: list[EventGraph]) -> EventGraph:
    """Disjoint union of ``graphs`` (JAX ``graphs.batch_graphs``, PyG's
    ``Batch``): node and edge fields concatenated, ``edge_index`` and
    ``true_edge_index`` offset by the nodes before each graph, ``batch`` the
    graph's position. ``extras`` that every graph has are concatenated,
    except the derived CSR arrays, which describe each graph's own edges
    (``sort_edges_by_target`` the union to get its own)."""
    offsets = np.cumsum([0] + [g.num_nodes for g in graphs[:-1]]).tolist()

    def cat(field: str) -> torch.Tensor:
        return torch.cat([getattr(g, field) for g in graphs])

    def cat_index(field: str) -> torch.Tensor:
        return torch.cat([getattr(g, field) + off for g, off in zip(graphs, offsets)], dim=1)

    dev = graphs[0].device
    batch = torch.cat([
        torch.full((g.num_nodes,), i, dtype=torch.int32, device=dev) for i, g in enumerate(graphs)
    ])
    keys = [k for k in graphs[0].extras if k not in DERIVED_KEYS and all(k in g.extras for g in graphs)]
    return EventGraph(
        **{f: cat(f) for f in NODE_FIELDS if f != "batch"},
        batch=batch,
        edge_index=cat_index("edge_index"),
        edge_attr=cat("edge_attr"),
        y=cat("y"),
        edge_mask=cat("edge_mask"),
        true_edge_index=cat_index("true_edge_index"),
        true_edge_mask=cat("true_edge_mask"),
        extras={k: torch.cat([g.extras[k] for g in graphs]) for k in keys},
    )
