"""One event's graph partitioned over the ranks of a ``graph`` group, with
halo exchange (counterpart of the JAX ``parallel/halo.py``).

* Hits are sorted (by default by azimuth, the second feature column) and
  split into P contiguous shards; each edge lives on the shard that owns
  its target, so the aggregation is local.
* A source hit owned by another shard is a *halo* row: before each
  interaction layer the shard fetches the halo rows' features from their
  owners and appends them to its own rows (``[N_loc + H, F]``); edge
  sources index that extended array.
* Three fetches, each differentiable with its exact transpose as the
  backward (each halo row's gradient goes home and is added into its
  owner's row): :func:`gather_halo` (``all_gather`` of every shard's rows),
  :func:`gather_halo_a2a` (``all_to_all_single`` over the ``[P, Hp, F]``
  pair tables: only boundary rows travel) and :func:`gather_halo_ring`
  (``batch_isend_irecv``, one ring distance a step; exact only where every
  halo row's owner lies within ``max_dist`` hops, rows beyond are dropped).

:func:`partition_event` builds the tables on the host, vectorized (JAX's
loops edge by edge), bitwise JAX's; with ``sort_edges`` it also stores the
CSR arrays that the fused interaction-network op takes on the card
(``graphs.CSR_KEYS``), over the extended node array (halo rows have no
incoming edges), one CSR for each block with ``halo_edges_last``.
:class:`HaloExchange` is the models' ``exchange`` hook.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from gnn_tracking_tpu_torch.graphs import CSR_KEYS
from gnn_tracking_tpu_torch.parallel.mesh import collective, transport

#: the [P, ...] tables of a partition (a shard's view has them without P)
TABLES = (
    "x", "node_mask", "global_index", "layer", "halo_shard", "halo_local", "halo_mask",
    "send_local", "send_mask", "recv_slot", "recv_mask", "edge_index", "edge_attr", "edge_mask",
    "y", "edge_global",
)


@dataclasses.dataclass
class ShardedGraph:
    """One event partitioned into P shards (leading axis), or one shard's
    view of it (:meth:`shard`: the leading axis taken away).

    Edge sources are in *extended local* coordinates: below ``n_local`` the
    shard's own hits, from ``n_local`` on its halo slots. ``send_local`` /
    ``send_mask`` ``[P(owner), P(requester), Hp]``: the local rows each
    owner sends each requester; ``recv_slot`` / ``recv_mask``
    ``[P(requester), P(owner), Hp]``: the halo slots where a requester puts
    them. ``e_split`` (``halo_edges_last``): every edge before it, in every
    shard, has a local source; 0 = no such guarantee. ``csr``: the CSR
    arrays of the target-sorted edges over the extended node array
    (``sort_edges``); with ``halo_edges_last`` they are per block, under the
    prefixes ``local_`` (the first ``e_split`` edges, ``N_loc`` rows) and
    ``halo_`` (the rest, ``N_loc + H`` rows). Empty without ``sort_edges``."""

    x: torch.Tensor
    node_mask: torch.Tensor
    global_index: torch.Tensor
    layer: torch.Tensor
    halo_shard: torch.Tensor
    halo_local: torch.Tensor
    halo_mask: torch.Tensor
    send_local: torch.Tensor
    send_mask: torch.Tensor
    recv_slot: torch.Tensor
    recv_mask: torch.Tensor
    edge_index: torch.Tensor
    edge_attr: torch.Tensor
    edge_mask: torch.Tensor
    y: torch.Tensor
    edge_global: torch.Tensor
    e_split: int = 0
    csr: dict = dataclasses.field(default_factory=dict)

    @property
    def is_shard(self) -> bool:
        """A shard's view (no leading shard axis)."""
        return self.node_mask.dim() == 1

    @property
    def n_shards(self) -> int:
        return self.send_local.shape[-3] if not self.is_shard else self.send_local.shape[0]

    @property
    def n_local(self) -> int:
        return self.x.shape[-2]

    @property
    def n_halo(self) -> int:
        return self.halo_mask.shape[-1]

    def _map(self, fn) -> "ShardedGraph":
        fields = {k: fn(getattr(self, k)) for k in TABLES}
        return ShardedGraph(**fields, e_split=self.e_split, csr={k: fn(v) for k, v in self.csr.items()})

    def shard(self, p: int) -> "ShardedGraph":
        """Shard ``p``'s view (what JAX's ``shard_map`` body sees)."""
        return self._map(lambda t: t[p])

    def to(self, device) -> "ShardedGraph":
        return self._map(lambda t: t.to(device))

    def block_csr(self, block: str) -> dict[str, torch.Tensor]:
        """The CSR arrays (``CSR_KEYS``) of block ``"local"`` or ``"halo"``."""
        return {k: self.csr[f"{block}_{k}"] for k in CSR_KEYS if f"{block}_{k}" in self.csr}


def _csr(dst: np.ndarray, src: np.ndarray, rows: int) -> dict[str, np.ndarray]:
    """``graphs.target_csr`` in numpy, for target-sorted ``dst``."""
    nodes = np.arange(rows + 1)
    perm = np.argsort(src, kind="stable")
    return {
        "dst_rowptr": np.searchsorted(dst, nodes).astype(np.int32),
        "src_perm": perm.astype(np.int32),
        "src_rowptr": np.searchsorted(src[perm], nodes).astype(np.int32),
    }


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def partition_event(
    graph,
    n_shards: int,
    *,
    sort_key: np.ndarray | None = None,
    sort_edges: bool = False,
    halo_edges_last: bool = False,
    pad_to: dict | None = None,
) -> ShardedGraph:
    """Host-side partitioner of an ``EventGraph`` (JAX ``partition_event``):
    sort the hits (default: the second feature column, azimuth; padding
    last), split them into P contiguous shards, build the halo and pair
    tables. ``sort_edges`` orders each shard's edges by local target
    (padding edges point at the last local node) and stores the CSR arrays;
    ``pad_to`` (``n_local``, ``e_local``, ``halo``, ``halo_pair``,
    ``e_halo``) sets minimum sizes so that several events partition to one
    shape; ``halo_edges_last`` orders each shard's edges ``[local-source
    block | halo-source block]`` at a boundary ``e_split`` common to all
    shards. Returns CPU tensors."""
    pad_to = pad_to or {}
    x = _np(graph.x)
    node_mask = _np(graph.node_mask).astype(bool)
    ei = _np(graph.edge_index).astype(np.int64)
    ea = _np(graph.edge_attr)
    em = _np(graph.edge_mask).astype(bool)
    n, P_ = x.shape[0], n_shards

    if sort_key is None:
        sort_key = x[:, 1] if x.shape[1] > 1 else np.arange(n, dtype=float)
    order = np.lexsort((np.asarray(sort_key), ~node_mask))
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    per = -(-n // P_)
    n_loc = max(per, int(pad_to.get("n_local", 0)))
    shard_of, local_of = rank // per, rank % per

    src_all, dst_all = ei
    dst_shard, src_shard = shard_of[dst_all], shard_of[src_all]
    per_edges, per_halo_edges = [], []
    for s in range(P_):
        idx = np.nonzero(em & (dst_shard == s))[0]
        if halo_edges_last:
            idx_h = idx[src_shard[idx] != s]
            idx = idx[src_shard[idx] == s]
            if sort_edges:
                idx_h = idx_h[np.argsort(local_of[dst_all[idx_h]], kind="stable")]
            per_halo_edges.append(idx_h)
        if sort_edges:
            idx = idx[np.argsort(local_of[dst_all[idx]], kind="stable")]
        per_edges.append(idx)
    if halo_edges_last:
        e_split = max(max((len(e) for e in per_edges), default=1), 1, int(pad_to.get("e_local", 0)))
        e_halo = max(max((len(e) for e in per_halo_edges), default=1), 1, int(pad_to.get("e_halo", 0)))
        e_loc = e_split + e_halo
    else:
        e_split = 0
        e_loc = max(max((len(e) for e in per_edges), default=1), 1, int(pad_to.get("e_local", 0)))

    halos = []
    for s in range(P_):
        idx = per_edges[s] if not halo_edges_last else np.concatenate([per_edges[s], per_halo_edges[s]])
        src = src_all[idx]
        halos.append(np.unique(src[shard_of[src] != s]))
    h_max = max(max((len(h) for h in halos), default=1), 1, int(pad_to.get("halo", 0)))

    # pair tables: the rows owner p sends requester s, in the requester's halo order
    pairs = {(p, s): halos[s][shard_of[halos[s]] == p] for s in range(P_) for p in range(P_)}
    hp_max = max(max((len(v) for v in pairs.values()), default=1), 1, int(pad_to.get("halo_pair", 0)))
    send_local = np.zeros((P_, P_, hp_max), np.int32)
    send_mask = np.zeros((P_, P_, hp_max), bool)
    recv_slot = np.zeros((P_, P_, hp_max), np.int32)
    recv_mask = np.zeros((P_, P_, hp_max), bool)
    for (p, s), rows in pairs.items():
        k = len(rows)
        send_local[p, s, :k] = local_of[rows]
        send_mask[p, s, :k] = True
        recv_slot[s, p, :k] = np.searchsorted(halos[s], rows)
        recv_mask[s, p, :k] = True

    glayer = _np(graph.layer)
    ey = None if graph.y is None else _np(graph.y).astype(np.float32)
    sx = np.zeros((P_, n_loc) + x.shape[1:], x.dtype)
    smask = np.zeros((P_, n_loc), bool)
    sglobal = np.zeros((P_, n_loc), np.int32)
    slayer = np.zeros((P_, n_loc), np.int32)
    halo_shard = np.zeros((P_, h_max), np.int32)
    halo_local = np.zeros((P_, h_max), np.int32)
    halo_mask = np.zeros((P_, h_max), bool)
    sei = np.zeros((P_, 2, e_loc), np.int32)
    sea = np.zeros((P_, e_loc) + ea.shape[1:], ea.dtype)
    sem = np.zeros((P_, e_loc), bool)
    sy = np.zeros((P_, e_loc), np.float32)
    seg = np.zeros((P_, e_loc), np.int32)

    for s in range(P_):
        own = order[s * per:(s + 1) * per]
        k = len(own)
        sx[s, :k], smask[s, :k], sglobal[s, :k], slayer[s, :k] = x[own], node_mask[own], own, glayer[own]
        halo = halos[s]
        halo_shard[s, :len(halo)], halo_local[s, :len(halo)] = shard_of[halo], local_of[halo]
        halo_mask[s, :len(halo)] = True

        def fill(idx, off, cap, s=s, halo=halo):
            src, dst = src_all[idx], dst_all[idx]
            remote = shard_of[src] != s
            sei[s, 0, off:off + len(idx)] = np.where(
                remote, n_loc + np.searchsorted(halo, src), local_of[src])
            sei[s, 1, off:off + len(idx)] = local_of[dst]
            if sort_edges:  # the padding keeps the targets non-decreasing
                sei[s, 1, off + len(idx):off + cap] = n_loc - 1
            sea[s, off:off + len(idx)] = ea[idx]
            sem[s, off:off + len(idx)] = True
            if ey is not None and len(ey):
                sy[s, off:off + len(idx)] = ey[idx]
            seg[s, off:off + len(idx)] = idx

        if halo_edges_last:
            fill(per_edges[s], 0, e_split)
            fill(per_halo_edges[s], e_split, e_loc - e_split)
        else:
            fill(per_edges[s], 0, e_loc)

    csr: dict[str, np.ndarray] = {}
    if sort_edges:
        blocks = ([("local_", 0, e_split, n_loc), ("halo_", e_split, e_loc, n_loc + h_max)]
                  if halo_edges_last else [("", 0, e_loc, n_loc + h_max)])
        for prefix, lo, hi, rows in blocks:
            per_shard = [_csr(sei[s, 1, lo:hi], sei[s, 0, lo:hi], rows) for s in range(P_)]
            for key in CSR_KEYS:
                csr[prefix + key] = np.stack([c[key] for c in per_shard])

    t = torch.from_numpy
    return ShardedGraph(
        x=t(sx), node_mask=t(smask), global_index=t(sglobal), layer=t(slayer),
        halo_shard=t(halo_shard), halo_local=t(halo_local), halo_mask=t(halo_mask),
        send_local=t(send_local), send_mask=t(send_mask), recv_slot=t(recv_slot),
        recv_mask=t(recv_mask), edge_index=t(sei), edge_attr=t(sea), edge_mask=t(sem), y=t(sy),
        edge_global=t(seg), e_split=e_split, csr={k: t(v) for k, v in csr.items()},
    )


# ---------------------------------------------------------------------------
# the halo fetches: start (asynchronous collective on detached rows) and
# finish (the extended array, differentiable)


def _group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _masked_rows(x, idx, mask):
    return torch.where(mask[..., None], x[idx.long()], torch.zeros((), dtype=x.dtype, device=x.device))


def _scatter_rows(n: int, slots, mask, rows, like) -> torch.Tensor:
    """``[n, F]`` zeros with ``rows[mask]`` at ``slots[mask]``."""
    out = torch.zeros((n,) + rows.shape[-1:], dtype=like.dtype, device=like.device)
    flat_mask = mask.reshape(-1)
    return out.index_add_(0, slots.reshape(-1)[flat_mask].long(), rows.reshape(-1, rows.shape[-1])[flat_mask])


class _AllGather:
    """All-gather of every shard's rows; the halo rows are picked from them."""

    op = "all_gather"

    def __init__(self, sg, group):
        self.sg, self.group = sg, group
        self.p = 1 if group is None else dist.get_world_size(group)

    def start(self, x):
        outs = [torch.empty_like(x) for _ in range(self.p)]
        return collective("all_gather", self.group, outs, [x.contiguous()]), outs

    def rows(self, started, x):
        work, outs = started
        work.wait()
        all_x = torch.stack(outs)
        sg = self.sg
        return torch.where(sg.halo_mask[:, None], all_x[sg.halo_shard.long(), sg.halo_local.long()],
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def home(self, g_halo, n):
        """The transpose: each shard's halo gradients summed into their
        owners' rows (a reduce-scatter, as an all-to-all of ``[P, N_loc, F]``)."""
        sg = self.sg
        buf = torch.zeros((self.p, n, g_halo.shape[1]), dtype=g_halo.dtype, device=g_halo.device)
        g = torch.where(sg.halo_mask[:, None], g_halo, torch.zeros((), dtype=g_halo.dtype, device=g_halo.device))
        buf.index_put_((sg.halo_shard.long(), sg.halo_local.long()), g, accumulate=True)
        recv = torch.empty_like(buf)
        collective("all_to_all", self.group, [recv], [buf]).wait()
        return recv.sum(0)


class _AllToAll:
    """One all-to-all over the pair tables: only boundary rows travel."""

    op = "all_to_all"

    def __init__(self, sg, group):
        self.sg, self.group = sg, group

    def start(self, x):
        sg = self.sg
        send = _masked_rows(x, sg.send_local, sg.send_mask).contiguous()
        recv = torch.empty_like(send)
        return collective("all_to_all", self.group, [recv], [send]), recv

    def rows(self, started, x):
        work, recv = started
        work.wait()
        return _scatter_rows(self.sg.n_halo, self.sg.recv_slot, self.sg.recv_mask, recv, x)

    def home(self, g_halo, n):
        sg = self.sg
        g_recv = _masked_rows(g_halo, sg.recv_slot, sg.recv_mask).contiguous()
        g_send = torch.empty_like(g_recv)
        collective("all_to_all", self.group, [g_send], [g_recv]).wait()
        return _scatter_rows(n, sg.send_local, sg.send_mask, g_send, g_halo)


class _Ring:
    """Point-to-point steps, one ring distance each (distances beyond
    ``max_dist`` skipped: their rows stay zero)."""

    op = "p2p"

    def __init__(self, sg, group, max_dist):
        self.sg, self.group = sg, group
        p, me = sg.n_shards, _group_rank(group)
        self.steps = [d for d in range(1, p) if min(d, p - d) <= max_dist]
        # at step d this shard serves requester me + d and hears from owner me - d
        self.req = [(me + d) % p for d in self.steps]
        self.own = [(me - d) % p for d in self.steps]

    def start(self, x):
        sg = self.sg
        bufs = [_masked_rows(x, sg.send_local[r], sg.send_mask[r]).contiguous() for r in self.req]
        got = [torch.empty_like(b) for b in bufs]
        return collective("p2p", self.group, got, bufs, peers=list(zip(self.req, self.own))), got

    def rows(self, started, x):
        work, got = started
        work.wait()
        sg = self.sg
        halo = torch.zeros((sg.n_halo, x.shape[1]), dtype=x.dtype, device=x.device)
        for o, g in zip(self.own, got):
            halo += _scatter_rows(sg.n_halo, sg.recv_slot[o], sg.recv_mask[o], g, x)
        return halo

    def home(self, g_halo, n):
        sg = self.sg
        sends = [_masked_rows(g_halo, sg.recv_slot[o], sg.recv_mask[o]).contiguous() for o in self.own]
        got = [torch.empty_like(b) for b in sends]
        collective("p2p", self.group, got, sends, peers=list(zip(self.own, self.req))).wait()
        g_x = torch.zeros((n, g_halo.shape[1]), dtype=g_halo.dtype, device=g_halo.device)
        for r, g in zip(self.req, got):
            g_x += _scatter_rows(n, sg.send_local[r], sg.send_mask[r], g, g_halo)
        return g_x


class _Extend(torch.autograd.Function):
    """``[x; halo]`` from fetched halo rows; the backward sends the halo
    rows' gradients home (``fetch.home``)."""

    @staticmethod
    def forward(ctx, x, halo, fetch):
        ctx.fetch, ctx.n = fetch, x.shape[0]
        return torch.cat([x, halo])

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return g[:ctx.n] + ctx.fetch.home(g[ctx.n:], ctx.n), None, None


def _fetch(impl: str, sg, group, ring_max_dist: int):
    if impl == "all_gather":
        return _AllGather(sg, group)
    if impl == "a2a":
        return _AllToAll(sg, group)
    if impl == "ring":
        return _Ring(sg, group, ring_max_dist)
    msg = f"unknown halo_impl {impl!r}; expected one of {sorted(HALO_IMPLS)}"
    raise ValueError(msg)


class HaloExchange:
    """The models' ``exchange`` hook for one shard (JAX passes a closure
    over ``gather_halo_*``): ``exchange(x)`` maps the shard's rows ``[N_loc,
    F]`` to the extended array ``[N_loc + H, F]`` that its edge sources
    index. :meth:`start` launches the collective on the rows as they are and
    :meth:`finish` waits for it and returns the extended array (with its
    gradient), so that work independent of the halo can run in between
    (``halo_edge_split``). ``csr`` / :meth:`block_csr` / :meth:`block_edges`
    are the shard's CSR arrays and edge blocks that the fused op takes."""

    def __init__(self, sg_local: ShardedGraph, group=None, impl: str = "a2a", ring_max_dist: int = 1):
        if not sg_local.is_shard:
            msg = "HaloExchange takes one shard's view (ShardedGraph.shard(p))"
            raise ValueError(msg)
        self.sg, self.group, self.impl = sg_local, group, impl
        self.fetch = _fetch(impl, sg_local, group, ring_max_dist)
        self.csr = {k: sg_local.csr[k] for k in CSR_KEYS if k in sg_local.csr}
        self.e_split = sg_local.e_split
        self._blocks = None

    @property
    def transport(self) -> str:
        """How the fetch's collective travels (``mesh.transport``)."""
        return transport(self.group, self.fetch.op, self.sg.x.device)

    def start(self, x: torch.Tensor):
        return self.fetch.start(x.detach())

    def finish(self, started, x: torch.Tensor) -> torch.Tensor:
        return _Extend.apply(x, self.fetch.rows(started, x), self.fetch)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.finish(self.start(x), x)

    def block_csr(self, block: str) -> dict[str, torch.Tensor]:
        return self.sg.block_csr(block)

    def block_edges(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``edge_index`` of the local and the halo block (contiguous)."""
        if self._blocks is None:
            ei, s = self.sg.edge_index, self.e_split
            self._blocks = (ei[:, :s].contiguous(), ei[:, s:].contiguous())
        return self._blocks


def gather_halo(x_local: torch.Tensor, sg: ShardedGraph, group=None) -> torch.Tensor:
    """``[x_local; halo]`` through an all-gather of every shard's rows."""
    return HaloExchange(sg, group, "all_gather")(x_local)


def gather_halo_a2a(x_local: torch.Tensor, sg: ShardedGraph, group=None) -> torch.Tensor:
    """``[x_local; halo]`` through one all-to-all of the pair tables
    (O(halo) traffic); the same result as :func:`gather_halo`."""
    return HaloExchange(sg, group, "a2a")(x_local)


def gather_halo_ring(x_local: torch.Tensor, sg: ShardedGraph, group=None, max_dist: int = 1) -> torch.Tensor:
    """``[x_local; halo]`` through point-to-point steps of ring distance up
    to ``max_dist``; exact only where :func:`ring_halo_distance` is at most
    ``max_dist`` (rows from farther owners stay zero)."""
    return HaloExchange(sg, group, "ring", max_dist)(x_local)


def ring_halo_distance(sg: ShardedGraph) -> int:
    """Largest ring distance a halo row travels (host-side; φ wraps, so
    shards 0 and P-1 are neighbours)."""
    send_mask = _np(sg.send_mask)
    p = send_mask.shape[0]
    owner, requester = np.nonzero(send_mask.any(axis=2))
    d = np.abs(owner - requester)
    d = np.minimum(d, p - d)
    return int(d.max()) if len(d) else 0


HALO_IMPLS: dict[str, Callable] = {
    "all_gather": gather_halo,
    "a2a": gather_halo_a2a,
    "ring": gather_halo_ring,
}


def make_sharded_apply(mesh, n_local: int, layer_fn: Callable, n_layers: int,
                       axis_name: str = "graph", halo_impl: str = "all_gather") -> Callable:
    """A message-passing stack over this rank's shard: ``run(params,
    sg_local) -> (x [N_loc, F], edge_attr)``, the halo exchange before every
    layer (JAX ``make_sharded_apply``: ``"all_gather"``, any other
    ``halo_impl`` the all-to-all). ``layer_fn(params_i, x_ext, edge_index,
    edge_attr, edge_mask, n_local)`` returns ``(x_local_new,
    edge_attr_new)``; ``params`` is a list, one entry a layer, or one entry
    for all."""
    group = mesh.group(axis_name)
    impl = "all_gather" if halo_impl == "all_gather" else "a2a"

    def run(params, sg_local: ShardedGraph):
        ex = HaloExchange(sg_local, group, impl)
        x, edge_attr = sg_local.x, sg_local.edge_attr
        for i in range(n_layers):
            p = params[i] if isinstance(params, (list, tuple)) else params
            x, edge_attr = layer_fn(p, ex(x), sg_local.edge_index, edge_attr, sg_local.edge_mask,
                                    n_local)
        return x, edge_attr

    return run


def unpartition_nodes(values: torch.Tensor, sg: ShardedGraph, num_nodes: int) -> torch.Tensor:
    """Per-shard node values ``[P, N_loc, ...]`` back in global order."""
    out = torch.zeros((num_nodes,) + tuple(values.shape[2:]), dtype=values.dtype, device=values.device)
    mask = sg.node_mask.to(values.device)
    out[sg.global_index.to(values.device)[mask].long()] = values[mask]
    return out


def unpartition_edges(values: torch.Tensor, sg: ShardedGraph, num_edges: int) -> torch.Tensor:
    """Per-shard edge values ``[P, E_loc, ...]`` back in global edge order."""
    out = torch.zeros((num_edges,) + tuple(values.shape[2:]), dtype=values.dtype, device=values.device)
    mask = sg.edge_mask.to(values.device)
    out[sg.edge_global.to(values.device)[mask].long()] = values[mask]
    return out
