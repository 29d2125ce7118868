"""Two-level parallelism: events over the ``data`` axis, each event sharded
over the ``graph`` axis (counterpart of the JAX ``parallel/mesh2d.py``).

Usage (every rank runs it; rank ``r`` trains shard ``r % n_graph`` of event
``r // n_graph``)::

    mesh = make_data_graph_mesh(n_data=2, n_graph=2)
    buckets = sharded_buckets(events, 2, sort_edges=True)
    sgs = stack_sharded([partition_event(g, 2, sort_edges=True, pad_to=buckets) for g in events])
    cds = stack_sharded([partition_condensation(g, sg, max_n_objects=K) for ...])
    trainer = DataGraphTCNTrainer(mesh, model=GraphTCN(...))
    trainer.init(sgs)
    losses = trainer.training_step(sgs, cds)

The per-event condensation and edge losses reduce over ``graph``; the step
averages them over ``data`` (gradient convention: ``parallel/sharded_model.py``).
On a 1 x 1 mesh without a process group the step takes the fast path: the
model without an exchange, the losses without collectives.
"""

from __future__ import annotations

import dataclasses

import torch

from gnn_tracking_tpu_torch.parallel.halo import partition_event
from gnn_tracking_tpu_torch.parallel.mesh import all_gather, make_mesh
from gnn_tracking_tpu_torch.parallel.sharded_model import ShardedGraphTCNTrainer


def make_data_graph_mesh(n_data: int, n_graph: int, *, device: str | torch.device = "cuda"):
    """A ``(data, graph)`` mesh, ``graph`` innermost, over the world's
    ``n_data * n_graph`` ranks."""
    return make_mesh(n_data, n_graph, device=device)


def sharded_buckets(graphs: list, n_shards: int, **partition_kwargs) -> dict:
    """Common ``pad_to`` sizes so that every event of ``graphs`` partitions
    to the same per-shard shapes (each event partitioned once to probe)."""
    sizes = {"n_local": 0, "e_local": 0, "halo": 0, "halo_pair": 0}
    for g in graphs:
        sg = partition_event(g, n_shards, **partition_kwargs)
        sizes["n_local"] = max(sizes["n_local"], sg.x.shape[1])
        sizes["e_local"] = max(sizes["e_local"], sg.edge_index.shape[2])
        sizes["halo"] = max(sizes["halo"], sg.halo_mask.shape[1])
        sizes["halo_pair"] = max(sizes["halo_pair"], sg.send_local.shape[2])
    return sizes


def stack_sharded(items: list):
    """Per-event partitions (``ShardedGraph`` / ``ShardedCondensationData``)
    stacked on a new leading event axis; their padded shapes must agree."""
    first = items[0]
    names = [f.name for f in dataclasses.fields(first)]

    def shapes(item):
        return {n: tuple(v.shape) for n in names if isinstance(v := getattr(item, n), torch.Tensor)} | {
            f"csr.{k}": tuple(v.shape) for k, v in getattr(item, "csr", {}).items()}

    if any(shapes(i) != shapes(first) or getattr(i, "e_split", 0) != getattr(first, "e_split", 0)
           for i in items[1:]):
        msg = ("stack_sharded requires equal padded shapes across events; "
               "pad events to a common bucket before partitioning")
        raise ValueError(msg)
    fields = {}
    for n in names:
        v = getattr(first, n)
        if isinstance(v, torch.Tensor):
            fields[n] = torch.stack([getattr(i, n) for i in items])
        elif n == "csr":
            fields[n] = {k: torch.stack([i.csr[k] for i in items]) for k in v}
        else:
            fields[n] = v
    return type(first)(**fields)


class DataGraphTCNTrainer(ShardedGraphTCNTrainer):
    """The full GraphTCN over a ``(data, graph)`` mesh (JAX
    ``DataGraphTCNTrainer``): this rank trains its shard of its event; the
    condensation and edge losses reduce over ``graph``, the batch averages
    over ``data``. Inputs are stacks (:func:`stack_sharded`), ``[S, P,
    ...]``. ``precision="bf16"`` runs the model on bf16 copies of the
    parameters and the shard (f32 masters, losses in f32). A 1 x 1 mesh
    without a process group takes the fast path (no exchange, no
    collectives)."""

    stacked = True

    def __init__(self, mesh, *, model=None, q_min: float = 0.01, max_n_objects: int = 1024,
                 loss_weights: dict[str, float] | None = None, optimizer=None, precision: str = "f32"):
        super().__init__(mesh, model=model, q_min=q_min, max_n_objects=max_n_objects,
                         loss_weights=loss_weights, optimizer=optimizer, axis_name="graph",
                         precision=precision)

    def _build_step(self, sgs=None):
        return self._build_step_single(sgs) if self.single else self._build_step_sharded(sgs)

    @torch.no_grad()
    def forward(self, sgs) -> tuple[torch.Tensor, ...]:
        """Per-event, per-shard outputs ``(h [S, P, N_loc, D], beta [S, P,
        N_loc], w [S, P, E_loc], ec_edge_mask [S, P, E_loc])`` on every rank
        (unpartition each event with ``halo.unpartition_nodes`` /
        ``unpartition_edges``)."""
        sg_l = self.place(sgs)
        self.model.eval()
        out = self._apply(sg_l, exchange=not self.single)
        shape = (self.mesh.n_data, self.mesh.n_graph)
        return tuple(
            all_gather(out[k], self.mesh.world).reshape(shape + tuple(out[k].shape))
            for k in self.forward_keys
        )
