"""Track-condensation training over one event partitioned across the ranks
of a ``graph`` group (counterpart of the JAX ``parallel/sharded_model.py``).

The single-device model modules train sharded unchanged: :class:`ShardedTCN`
presents the rank's shard as an ``EventGraph`` and hands the model a
:class:`~gnn_tracking_tpu_torch.parallel.halo.HaloExchange` as its
``exchange`` hook, the one seam of the model stack (``ResIN``, the
interaction networks, the edge classifiers, ``ModularGraphTCN`` and its
subclasses take it). Its parameters are the wrapped model's under
``model.``, so single-device weights load verbatim (``load_jax_params(
sharded, {"model": jax_params})`` for JAX's).

**Gradient convention** (where JAX's ``shard_map`` transpose gives each
replicated parameter the single-device gradient): every rank holds the same
loss (psums of its shards' parts); each rank backpropagates ``1 / (number of
ranks of the mesh)`` of its total; the psums' and the halo fetches'
backward are their transposes (all-reduces of the cotangents, halo
gradients sent home); then each parameter's gradient is summed over every
rank. So a 1-D mesh gives exactly the single-device gradient of the event,
and a ``(data, graph)`` mesh that of the mean over its events.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.func import functional_call

from gnn_tracking_tpu_torch.graphs import CSR_KEYS, EventGraph
from gnn_tracking_tpu_torch.models.track_condensation_networks import (
    GraphTCN,
    GraphTCNForMLGCPipeline,
)
from gnn_tracking_tpu_torch.parallel.halo import HALO_IMPLS, HaloExchange, ShardedGraph
from gnn_tracking_tpu_torch.parallel.mesh import (
    all_gather,
    all_reduce_,
    broadcast_module,
    psum,
    reduce_gradients,
)
from gnn_tracking_tpu_torch.parallel.sharded_tc import sharded_condensation_loss
from gnn_tracking_tpu_torch.training.module import to_floats
from gnn_tracking_tpu_torch.training.optim import adam, as_chain
from gnn_tracking_tpu_torch.training.precision import get_policy
from gnn_tracking_tpu_torch.utils.device import resolve_device


def shard_as_eventgraph(sg_local: ShardedGraph, *, local_csr: bool = False) -> EventGraph:
    """One shard's view as an ``EventGraph``: its rows, its edges with
    sources in extended local coordinates (dereferenced only after the
    model's exchange), zeros for the per-hit truth (the sharded losses read
    theirs from ``ShardedCondensationData``). ``local_csr`` puts the CSR
    arrays over the shard's own rows into ``extras``, for a model run without
    an exchange (the 1 x 1 fast path; every source must be local)."""
    n = sg_local.n_local
    dev = sg_local.x.device
    zi = torch.zeros(n, dtype=torch.int32, device=dev)
    zf = torch.zeros(n, dtype=sg_local.x.dtype, device=dev)
    extras = {}
    if local_csr and all(k in sg_local.csr for k in CSR_KEYS):
        extras = {
            "dst_rowptr": sg_local.csr["dst_rowptr"][:n + 1].contiguous(),
            "src_perm": sg_local.csr["src_perm"],
            "src_rowptr": sg_local.csr["src_rowptr"][:n + 1].contiguous(),
        }
    return EventGraph(
        x=sg_local.x, particle_id=zi.long(), pt=zf, eta=zf, reconstructable=zf,
        node_mask=sg_local.node_mask, layer=sg_local.layer, sector=zi, batch=zi,
        edge_index=sg_local.edge_index, edge_attr=sg_local.edge_attr, y=sg_local.y,
        edge_mask=sg_local.edge_mask,
        true_edge_index=torch.zeros((2, 1), dtype=torch.int32, device=dev),
        true_edge_mask=torch.zeros(1, dtype=torch.bool, device=dev),
        extras=extras,
    )


class ShardedTCN(nn.Module):
    """Any single-device TCN module run on one shard with the halo hook.
    ``halo_impl``: ``"a2a"`` (default, always exact), ``"ring"`` (exact
    where ``halo.ring_halo_distance(sg) <= ring_max_dist``) or
    ``"all_gather"``. ``device`` moves it; ``generator`` is taken for the
    CLI's calling convention and unused (the wrapped model holds the
    weights). ``model_config`` holds the constructor arguments."""

    def __init__(self, model: nn.Module, axis_name: str = "graph", halo_impl: str = "a2a",
                 ring_max_dist: int = 1, *, device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if halo_impl not in HALO_IMPLS:
            msg = f"unknown halo_impl {halo_impl!r}; expected one of {sorted(HALO_IMPLS)}"
            raise ValueError(msg)
        self.model = model
        self.axis_name, self.halo_impl, self.ring_max_dist = axis_name, halo_impl, ring_max_dist
        self.model_config = {"model": model, "axis_name": axis_name, "halo_impl": halo_impl,
                             "ring_max_dist": ring_max_dist}
        if device is not None:
            self.to(resolve_device(device))

    def forward(self, sg_local: ShardedGraph, n_local: int, group=None) -> dict[str, Any]:
        """The wrapped model's outputs for this rank's shard; ``group`` is the
        mesh's group of ``axis_name`` (None: one shard, no collectives)."""
        exchange = HaloExchange(sg_local, group, self.halo_impl, self.ring_max_dist)
        return self.model(shard_as_eventgraph(sg_local), exchange=exchange)


def sharded_edge_bce(w: torch.Tensor, y: torch.Tensor, edge_mask: torch.Tensor, group=None) -> torch.Tensor:
    """Masked binary cross-entropy of the edge weights, its sums reduced
    over ``group``: exactly the unsharded masked mean (the EC loss term of
    the full GraphTCN). ``group=None``: one shard."""
    m = edge_mask.to(w.dtype)
    bce = -(y * torch.log(w) + (1.0 - y) * torch.log(1.0 - w))
    s, c = psum(torch.stack([torch.sum(bce * m), torch.sum(m)]), group=group)[0]
    return s / torch.clamp(c, min=1.0)


def _shard_of(obj, mesh, *, event: bool):
    """This rank's view of a partition (``[P, ...]``) or of a stack of them
    (``[S, P, ...]``, ``event=True``: first the rank's event). As JAX's
    ``shard_map`` hands each data coordinate a block of ``S / n_data``
    events and its trainer takes the block's first, a data rank trains
    event ``data_rank * S / n_data`` (only event 0 of two on a 1 x 1 mesh)."""
    if obj.is_shard:
        return obj
    if event:  # a graph's every table is per shard, so its first axis is indexed as one
        n_events = obj.x.shape[0] if isinstance(obj, ShardedGraph) else obj.obj_valid.shape[0]
        if n_events % mesh.n_data:
            msg = f"a stack of {n_events} events does not split over {mesh.n_data} data ranks"
            raise ValueError(msg)
        i = mesh.data_rank * (n_events // mesh.n_data)
        obj = obj.shard(i) if isinstance(obj, ShardedGraph) else obj.event(i)
    return obj.shard(mesh.graph_rank)


class ShardedTCTrainer:
    """Train a TCN on one event sharded over the mesh's ``axis_name`` group
    with the condensation loss (JAX ``ShardedTCTrainer``). ``model`` is a
    single-device module (default, built by :meth:`init` from the graph's
    widths: ``GraphTCNForMLGCPipeline(h 8, e 8, out 4, hidden 40)``),
    wrapped in :class:`ShardedTCN`; ``optimizer`` a ``training/optim``
    description (default ``adam(1e-3)``, optax's). Each rank takes its own
    shard of what it is given (a whole partition, or a shard's view)."""

    loss_keys: tuple[str, ...] = ("attractive", "repulsive", "coward", "noise")
    use_ec_loss: bool = False
    #: output keys :meth:`forward` returns, in order
    forward_keys: tuple[str, ...] = ("H", "B")
    #: inputs hold a stack of events ([S, P, ...]), one per data coordinate
    stacked: bool = False

    def __init__(self, mesh, *, model: nn.Module | None = None, q_min: float = 0.01,
                 max_n_objects: int = 1024, loss_weights: dict[str, float] | None = None,
                 optimizer=None, axis_name: str = "graph", halo_impl: str = "a2a",
                 ring_max_dist: int = 1, precision: str = "f32"):
        self.mesh = mesh
        self.axis_name, self.halo_impl, self.ring_max_dist = axis_name, halo_impl, ring_max_dist
        self.model = None if model is None else self._wrap(model)
        self.q_min, self.max_n_objects = q_min, max_n_objects
        self.loss_weights = loss_weights or {"attractive": 1.0, "repulsive": 1.0, "coward": 0.0, "noise": 0.0}
        self.tx = as_chain(optimizer if optimizer is not None else adam(1e-3))
        if precision not in ("f32", "bf16"):
            msg = f"precision must be 'f32' or 'bf16', got {precision!r}"
            raise ValueError(msg)
        self.precision, self.policy = precision, get_policy(precision)
        self.optimizer = None
        self._step = None

    @property
    def group(self):
        return self.mesh.group(self.axis_name)

    def _wrap(self, model: nn.Module) -> ShardedTCN:
        return ShardedTCN(model, self.axis_name, self.halo_impl, self.ring_max_dist).to(self.mesh.device)

    def _default_model(self, node_indim: int, edge_indim: int, generator) -> nn.Module:
        return GraphTCNForMLGCPipeline(node_indim, edge_indim, h_dim=8, e_dim=8, h_outdim=4,
                                       hidden_dim=40, device="cpu", generator=generator)

    def init(self, sg, generator: torch.Generator | None = None) -> None:
        """Build the default model where none was given (from ``sg``'s
        widths, weights from ``generator``), make every rank's weights
        rank 0's, and build the optimizer."""
        if self.model is None:
            gen = generator or torch.Generator().manual_seed(0)
            self.model = self._wrap(self._default_model(sg.x.shape[-1], sg.edge_attr.shape[-1], gen))
        broadcast_module(self.model, self.mesh.world)
        self.optimizer = self.tx.build([p for p in self.model.parameters() if p.requires_grad])

    def place(self, sg, cd=None):
        """This rank's shard of ``sg`` (and ``cd``) on its device (a view that
        is already one passes through)."""
        dev = self.mesh.device
        sg_l = _shard_of(sg, self.mesh, event=self.stacked).to(dev)
        if cd is None:
            return sg_l
        return sg_l, _shard_of(cd, self.mesh, event=self.stacked).to(dev)

    # ------------------------------------------------------------------
    @property
    def single(self) -> bool:
        """One rank and no group: the fast path (no exchange, no collectives)."""
        return self.mesh.size == 1 and self.group is None

    def _apply(self, sg_l: ShardedGraph, *, exchange: bool) -> dict[str, Any]:
        """The model on the shard: with the halo hook (``exchange``), or as on
        one device (the fast path). Under ``precision="bf16"`` on a copy of
        the parameters and of the shard's floats in bf16, the outputs cast
        back to f32 (the JAX trainer's mixed precision)."""
        if self.precision == "bf16":
            sg_l = sg_l._map(lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)
        if exchange:
            fn, args, kw = self.model, (sg_l, sg_l.n_local), {"group": self.group}
        else:
            fn, args, kw = self.model.model, (shard_as_eventgraph(sg_l, local_csr=True),), {}
        if self.precision == "f32":
            return fn(*args, **kw)
        params = self.policy.cast_to_compute(dict(fn.named_parameters()))
        return self.policy.cast_to_output(functional_call(fn, params, args, kw))

    def _shard_losses(self, out, sg_l, cd_l, group) -> dict[str, torch.Tensor]:
        losses = sharded_condensation_loss(out["B"], out["H"], cd_l, q_min=self.q_min,
                                           max_n_objects=self.max_n_objects, group=group)
        if self.use_ec_loss:
            losses["edge"] = sharded_edge_bce(out["W"], sg_l.y.to(out["W"].dtype), sg_l.edge_mask, group)
        return losses

    def _train(self, sg_l, cd_l, *, exchange: bool) -> dict[str, torch.Tensor]:
        """Forward, losses, backward of ``1 / mesh size`` of the total, the
        gradients summed over every rank, one optimizer step; the losses
        (``total`` too) averaged over the data group."""
        if self.optimizer is None:
            self.init(sg_l)
        self.model.train()
        group = self.group if exchange else None
        losses = self._shard_losses(self._apply(sg_l, exchange=exchange), sg_l, cd_l, group)
        total = sum(self.loss_weights.get(k, 0.0) * v for k, v in losses.items())
        self.optimizer.zero_grad(set_to_none=True)
        (total / self.mesh.size).backward()
        reduce_gradients([p for g in self.optimizer.param_groups for p in g["params"]], self.mesh.world)
        self.optimizer.step()
        losses["total"] = total
        keys = list(losses)
        stacked = torch.stack([losses[k].detach() for k in keys])
        if self.mesh.group("data") is not None:
            all_reduce_(stacked, self.mesh.group("data"))
            stacked = stacked / self.mesh.n_data
        return dict(zip(keys, stacked))

    def _build_step_single(self, sg=None):
        """The fast path: the model without an exchange, the losses without
        collectives (a 1 x 1 mesh; JAX ``_build_step_single``)."""
        return lambda sg_l, cd_l: self._train(sg_l, cd_l, exchange=False)

    def _build_step_sharded(self, sg=None):
        return lambda sg_l, cd_l: self._train(sg_l, cd_l, exchange=True)

    def _build_step(self, sg=None):
        return self._build_step_sharded(sg)

    def training_step(self, sg, cd) -> dict[str, float]:
        """One optimizer step on this rank's shard; the losses as floats."""
        sg_l, cd_l = self.place(sg, cd)
        if self._step is None:
            self._step = self._build_step(sg)
        return to_floats(self._step(sg_l, cd_l))

    @torch.no_grad()
    def forward(self, sg) -> tuple[torch.Tensor, ...]:
        """The outputs of :attr:`forward_keys`, each with a leading shard axis
        (``H [P, N_loc, D]``, ``B [P, N_loc]``, ...) on every rank."""
        sg_l = self.place(sg)
        self.model.eval()
        out = self._apply(sg_l, exchange=not self.single)
        return tuple(all_gather(out[k], self.group) for k in self.forward_keys)


class ShardedGraphTCNTrainer(ShardedTCTrainer):
    """The full GraphTCN trained sharded: condensation and edge-classifier
    losses, both reduced over the graph group (JAX
    ``ShardedGraphTCNTrainer``; default model ``GraphTCN`` at its default
    widths)."""

    use_ec_loss = True
    forward_keys = ("H", "B", "W", "ec_edge_mask")

    def __init__(self, mesh, *, model: nn.Module | None = None, loss_weights: dict[str, float] | None = None,
                 **kwargs):
        loss_weights = loss_weights or {"attractive": 1.0, "repulsive": 1.0, "coward": 0.0, "noise": 0.0,
                                        "edge": 1.0}
        super().__init__(mesh, model=model, loss_weights=loss_weights, **kwargs)

    def _default_model(self, node_indim: int, edge_indim: int, generator) -> nn.Module:
        return GraphTCN(node_indim, edge_indim, device="cpu", generator=generator)
