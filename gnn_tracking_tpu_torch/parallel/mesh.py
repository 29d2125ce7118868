"""Meshes of ranks and their collectives (counterpart of the JAX
``parallel/mesh.py``; ``parallel/mesh2d.make_data_graph_mesh`` builds the
same mesh).

A :class:`Mesh` lays the ranks of the default process group out as
``(data, graph)``, ``graph`` innermost: rank ``r`` sits at data coordinate
``r // n_graph`` and graph coordinate ``r % n_graph``. The ranks that share
a data coordinate hold the shards of one event (the ``graph`` group: halo
exchange, the sharded losses' reductions); the ranks that share a graph
coordinate hold different events (the ``data`` group: the mean over
events). Where JAX shards a stacked batch over devices, each rank here holds
only its own events (:func:`shard_batch`).

Groups: an axis whose size is the world size uses the default group, an
axis of size 1 in a larger world has none, and every other axis has a group
of its own (``dist.new_group``, made by every rank for every row and column
in the same order). At world size 1 no process group is made: without an
initialized default group both axes have none, and with one (an NCCL group
of one rank, say) both use it. A group of None makes every collective an
identity, as JAX's ``axis_name=None`` does.

**Transport.** Every collective goes through :func:`collective`, which runs
it on the tensors themselves or, where the group's backend does not take
them (gloo and CUDA tensors, :data:`GLOO_CUDA_OPS`), through copies in
pinned host memory: a fixed table decides, the same way every call, and
:func:`transport` names the route for the logs. NCCL refuses two ranks of
one communicator on one card, so ranks that share a card use gloo.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from gnn_tracking_tpu_torch.utils.device import resolve_device

#: the collectives that gloo runs on CUDA tensors itself (each accepted, with
#: the right result, by torch 2.11's gloo on an H100); point-to-point sends
#: of CUDA tensors abort the process ("writev ... Bad address"), so they are
#: staged through pinned host memory
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather", "all_to_all"})


def _local_rank() -> int:
    for var in ("LOCAL_RANK", "SLURM_LOCALID"):
        if var in os.environ:
            return int(os.environ[var])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` for this rank: a bare ``"cuda"`` becomes the card of the
    rank's local index (ranks beyond the card count share cards)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank() % torch.cuda.device_count())
    return dev


@dataclasses.dataclass
class Mesh:
    """This rank's place in a ``(data, graph)`` layout of the ranks."""

    n_data: int
    n_graph: int
    rank: int
    device: torch.device
    #: ``{"data": group, "graph": group}``; None: the axis's collectives are identities
    groups: dict

    @property
    def size(self) -> int:
        return self.n_data * self.n_graph

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_graph

    @property
    def graph_rank(self) -> int:
        return self.rank % self.n_graph

    def coord(self, axis: str) -> int:
        return {"data": self.data_rank, "graph": self.graph_rank}[axis]

    def group(self, axis: str):
        return self.groups[axis]

    @property
    def world(self):
        """The group of every rank of the mesh (None in one process)."""
        return dist.group.WORLD if dist.is_initialized() else None


def make_mesh(n_data: int | None = None, n_graph: int = 1, *,
              device: str | torch.device = "cuda") -> Mesh:
    """A ``(data, graph)`` mesh over every rank of the default process group
    (one rank when none is initialized). ``n_data`` defaults to the world
    size over ``n_graph``; their product must be the world size."""
    init = dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if init else (1, 0)
    if n_data is None:
        n_data = world // n_graph
    if n_data * n_graph != world:
        msg = f"a {n_data} x {n_graph} mesh needs {n_data * n_graph} ranks, the world has {world}"
        raise ValueError(msg)
    rows = [list(range(d * n_graph, (d + 1) * n_graph)) for d in range(n_data)]
    cols = [list(range(g, world, n_graph)) for g in range(n_graph)]
    groups = {}
    for axis, members in (("graph", rows), ("data", cols)):
        size = len(members[0])
        if not init or (size == 1 and world > 1):
            groups[axis] = None
        elif size == world:
            groups[axis] = dist.group.WORLD
        else:  # every rank makes every group, in the same order
            made = [dist.new_group(m) for m in members]
            groups[axis] = next(g for g, m in zip(made, members) if rank in m)
    return Mesh(n_data, n_graph, rank, rank_device(device), groups)


def shard_batch(batch: list, mesh: Mesh) -> list:
    """This rank's events of a global batch: the ``len(batch) / n_data``
    consecutive events at its data coordinate (JAX shards the stacked
    batch's leading axis the same way)."""
    per = len(batch) // mesh.n_data
    if per * mesh.n_data != len(batch):
        msg = f"{len(batch)} events do not split over {mesh.n_data} data ranks"
        raise ValueError(msg)
    return list(batch[mesh.data_rank * per:(mesh.data_rank + 1) * per])


# ---------------------------------------------------------------------------
# collectives


def backend(group) -> str | None:
    return None if group is None else str(dist.get_backend(group))


def transport(group, op: str, device: torch.device) -> str:
    """How :func:`collective` runs ``op`` on ``device``'s tensors over
    ``group``: ``"identity"`` (no group), ``"direct"`` or
    ``"host-staged"`` (copies in pinned host memory)."""
    if group is None:
        return "identity"
    if torch.device(device).type == "cuda" and backend(group) == "gloo" and op not in GLOO_CUDA_OPS:
        return "host-staged"
    return "direct"


class Pending:
    """An asynchronous collective: :meth:`wait` waits for its works and
    copies the host-staged outputs back to their device tensors."""

    def __init__(self, works=(), copies=()):
        self.works, self.copies = list(works), list(copies)

    def wait(self) -> None:
        for w in self.works:
            w.wait()
        for dst, src in self.copies:
            dst.copy_(src, non_blocking=True)
        self.works, self.copies = [], []


def _pinned(t: torch.Tensor, copy: bool) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if copy:
        host.copy_(t)  # synchronous: the device's value is on the host before the send
    return host


def collective(op: str, group, outs: list[torch.Tensor], ins: list[torch.Tensor], *,
               reduce_op=None, src: int = 0, peers=None) -> Pending:
    """Start ``op`` over ``group`` (asynchronous; ``.wait()`` the result).

    * ``"all_reduce"`` / ``"broadcast"``: in place on ``ins[0]`` (``outs``
      unused; ``reduce_op``, default SUM; ``src``, a global rank);
    * ``"all_gather"``: ``outs`` a list of one tensor per group rank;
    * ``"all_to_all"``: ``all_to_all_single(outs[0], ins[0])``, equal
      splits over the leading axis;
    * ``"p2p"``: ``ins[i]`` sent to and ``outs[i]`` received from the
      group ranks ``peers[i] = (to, from)``, tag ``i``.

    Without a group each is an identity (``all_gather`` and ``all_to_all``
    copy ``ins`` to ``outs``; ``p2p`` needs none)."""
    if group is None:
        if op in ("all_gather", "all_to_all"):
            outs[0].copy_(ins[0])
        elif op == "p2p" and ins:
            msg = "p2p without a group"
            raise ValueError(msg)
        return Pending()
    staged = transport(group, op, ins[0].device) == "host-staged"
    copies = []
    if staged:
        in_place = op in ("all_reduce", "broadcast")
        h_ins = [_pinned(t, True) for t in ins]
        h_outs = h_ins if in_place else [_pinned(t, False) for t in outs]
        copies = list(zip(ins if in_place else outs, h_outs))
        ins, outs = h_ins, h_outs
    if op == "all_reduce":
        works = [dist.all_reduce(ins[0], op=reduce_op or dist.ReduceOp.SUM, group=group, async_op=True)]
    elif op == "broadcast":
        works = [dist.broadcast(ins[0], src=src, group=group, async_op=True)]
    elif op == "all_gather":
        works = [dist.all_gather(outs, ins[0], group=group, async_op=True)]
    elif op == "all_to_all":
        works = [dist.all_to_all_single(outs[0], ins[0], group=group, async_op=True)]
    elif op == "p2p":
        ops = []
        for i, ((to, frm), t_in, t_out) in enumerate(zip(peers, ins, outs)):
            ops.append(dist.P2POp(dist.isend, t_in, dist.get_global_rank(group, to), group, tag=i))
            ops.append(dist.P2POp(dist.irecv, t_out, dist.get_global_rank(group, frm), group, tag=i))
        works = dist.batch_isend_irecv(ops) if ops else []
    else:
        msg = f"unknown collective {op!r}"
        raise ValueError(msg)
    return Pending(works, copies)


def all_reduce_(t: torch.Tensor, group, reduce_op=None) -> torch.Tensor:
    """``t`` reduced in place over ``group`` (SUM by default), waited for."""
    collective("all_reduce", group, [], [t], reduce_op=reduce_op).wait()
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``[group size, *t.shape]``: every rank's ``t`` in group-rank order
    (bool tensors travel as uint8)."""
    size = 1 if group is None else dist.get_world_size(group)
    src = t.contiguous() if t.dtype != torch.bool else t.to(torch.uint8).contiguous()
    outs = [torch.empty_like(src) for _ in range(size)]
    collective("all_gather", group, outs, [src]).wait()
    return torch.stack(outs).to(t.dtype)


class _PSum(torch.autograd.Function):
    """Sum over the group of several tensors in one all-reduce; its
    transpose sums the cotangents over the group the same way (the output
    is used on every rank)."""

    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        ctx.shapes = [t.shape for t in ts]
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce_(flat, group)
        return tuple(p.view(s) for p, s in zip(torch.split(flat, [s.numel() for s in ctx.shapes]), ctx.shapes))

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1) for g in gs])
        all_reduce_(flat, ctx.group)
        parts = torch.split(flat, [s.numel() for s in ctx.shapes])
        return (None, *(p.view(s) for p, s in zip(parts, ctx.shapes)))


def psum(*ts: torch.Tensor, group=None) -> tuple[torch.Tensor, ...]:
    """JAX ``psum`` of each tensor (one dtype), differentiable. Gradient
    convention: every rank holds the same result; when every rank
    backpropagates ``1 / group size`` of a replicated total, each rank's
    inputs get exactly their single-device gradient. Identity without a
    group."""
    if group is None:
        return ts
    return _PSum.apply(group, *ts)


def pmax(t: torch.Tensor, group=None) -> torch.Tensor:
    """JAX ``pmax`` (no gradient)."""
    return all_reduce_(t.detach().clone(), group, dist.ReduceOp.MAX) if group is not None else t


def pmin(t: torch.Tensor, group=None) -> torch.Tensor:
    """JAX ``pmin`` (no gradient)."""
    return all_reduce_(t.detach().clone(), group, dist.ReduceOp.MIN) if group is not None else t


def broadcast_module(module: torch.nn.Module, group=None, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` set to global rank ``src``'s
    (one broadcast per dtype), so that replicas start equal."""
    if group is None:
        return
    tensors = [t for t in (*module.parameters(), *module.buffers())]
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        part = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in part])
        collective("broadcast", group, [], [flat], src=src).wait()
        with torch.no_grad():
            for t, v in zip(part, torch.split(flat, [t.numel() for t in part])):
                t.copy_(v.view(t.shape))


def reduce_gradients(params: list[torch.Tensor], group) -> None:
    """Each parameter's gradient summed over ``group``, in one all-reduce
    per dtype. A parameter that no rank has a gradient for keeps ``grad is
    None`` (Adam then skips it, as on one device); one that some rank lacks
    counts zero there."""
    if group is None:
        return
    by_dtype: dict = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    for part in by_dtype.values():
        flat = torch.cat([
            torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                       for p in part]),
            torch.tensor([float(p.grad is not None) for p in part], dtype=part[0].dtype,
                         device=part[0].device),
        ])
        all_reduce_(flat, group)
        sizes = [p.numel() for p in part]
        grads, has = flat[:sum(sizes)], flat[sum(sizes):].tolist()
        for p, g, h in zip(part, torch.split(grads, sizes), has):
            p.grad = g.view(p.shape) if h > 0 else None
