"""Object-condensation loss over one event partitioned across the ranks of a
``graph`` group (counterpart of the JAX ``parallel/sharded_tc.py``).

The dense ("tiger") condensation loss needs per-particle reductions over
all of a particle's hits, wherever they live: each object's condensation
point is the argmax of its charge over every shard (``pmax``, ties to the
smallest global hit index by ``pmin``), the points' features and
likelihoods are summed in from the shard that holds them, and the
potentials and normalizations are sums over the shards (``psum``, all of
them ``mesh.psum`` / ``pmax`` / ``pmin``: all-reduces over the group).
Everything static per event (the good-hit mask, each hit's object column,
the counts) is built on the host by :func:`partition_condensation`.

**Gradients.** Every rank holds the same loss. When each rank
backpropagates ``1 / P`` of it (the trainers do, and the test harnesses),
the psums' backward (all-reduces of the cotangents) gives each rank's
``beta`` and ``x`` exactly their single-device gradients. The argmax
carries none. ``group=None`` makes every collective an identity: the same
body runs unsharded (the 1 x 1 fast path).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnn_tracking_tpu_torch.parallel.mesh import pmax, pmin, psum

_EPS = 1e-9
#: the tie-break index of hits that are no condensation candidate (JAX's)
_NO_HIT = 2**30

#: per-hit tables [P, N_loc] (a shard's view: [N_loc]); the rest are per event
HIT_TABLES = ("obj_col", "object_mask", "node_mask", "is_noise", "global_index")


@dataclasses.dataclass
class ShardedCondensationData:
    """Static per-event truth tables, sharded like the hits."""

    #: dense object column of each hit (-1 if its particle is not an object)
    obj_col: torch.Tensor
    #: hits that count toward the attractive normalization (the good-hit mask)
    object_mask: torch.Tensor
    #: valid (non-padding) hits
    node_mask: torch.Tensor
    #: noise hits (particle id 0)
    is_noise: torch.Tensor
    #: global index of each hit (the condensation points' tie-break)
    global_index: torch.Tensor
    #: [K] which object columns are used
    obj_valid: torch.Tensor
    #: scalar counts
    n_objects: torch.Tensor
    n_hits: torch.Tensor
    n_hits_oi: torch.Tensor

    @property
    def is_shard(self) -> bool:
        """A shard's view (hit tables one axis deeper than the per-event ones
        only in a whole partition)."""
        return self.obj_col.dim() == self.obj_valid.dim()

    def _map(self, hit_fn, event_fn) -> "ShardedCondensationData":
        return ShardedCondensationData(**{
            f.name: (hit_fn if f.name in HIT_TABLES else event_fn)(getattr(self, f.name))
            for f in dataclasses.fields(self)
        })

    def shard(self, p: int) -> "ShardedCondensationData":
        """Shard ``p``'s view."""
        return self._map(lambda t: t[p], lambda t: t)

    def event(self, i: int) -> "ShardedCondensationData":
        """Event ``i`` of a stack (``parallel.mesh2d.stack_sharded``)."""
        return self._map(lambda t: t[i], lambda t: t[i])

    def to(self, device) -> "ShardedCondensationData":
        return self._map(lambda t: t.to(device), lambda t: t.to(device))


def partition_condensation(
    graph,
    sg,
    *,
    max_n_objects: int,
    pt_thld: float = 0.9,
    max_eta: float = 4.0,
    subsample_seed: int | None = None,
) -> ShardedCondensationData:
    """Host-side truth tables of the sharded loss for ``graph`` as ``sg``
    partitions it (JAX ``partition_condensation``). Objects are the good
    particles (pt above ``pt_thld``, non-noise, reconstructable, ``|eta| <
    max_eta``); every hit of one attracts. With more than ``max_n_objects``
    of them, ``subsample_seed`` keeps ``max_n_objects`` drawn with numpy's
    ``default_rng(seed).choice`` (the JAX package's draw, so both pick the
    same); without it that raises ``ValueError``."""
    def arr(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    pid = arr(graph.particle_id)
    node_mask = arr(graph.node_mask).astype(bool)
    good = ((arr(graph.pt) > pt_thld) & (pid > 0) & (arr(graph.reconstructable) > 0)
            & (np.abs(arr(graph.eta)) < max_eta) & node_mask)
    unique = np.unique(pid[good])
    if len(unique) > max_n_objects and subsample_seed is not None:
        sel = np.random.default_rng(subsample_seed).choice(unique, size=max_n_objects, replace=False)
        unique = np.sort(sel)
        good = good & np.isin(pid, unique)
    if len(unique) > max_n_objects:
        msg = f"{len(unique)} objects exceed max_n_objects={max_n_objects} (pass subsample_seed)"
        raise ValueError(msg)
    col = np.searchsorted(unique, pid)
    found = col < len(unique)
    found[found] = unique[col[found]] == pid[found]
    col = np.where(found, col, -1)
    obj_valid = np.arange(max_n_objects) < len(unique)

    gi = arr(sg.global_index)
    sm = arr(sg.node_mask).astype(bool)

    def shard_nodes(values, fill):
        out = np.full(gi.shape, fill, dtype=values.dtype)
        out[sm] = values[gi[sm]]
        return torch.from_numpy(out)

    def scalar(v):
        return torch.tensor(int(v), dtype=torch.int32)

    return ShardedCondensationData(
        obj_col=shard_nodes(col.astype(np.int32), -1),
        object_mask=shard_nodes(good, False),
        node_mask=torch.from_numpy(sm.copy()),
        is_noise=shard_nodes((pid == 0) & node_mask, False),
        global_index=torch.from_numpy(gi.astype(np.int32)),
        obj_valid=torch.from_numpy(obj_valid),
        n_objects=scalar(len(unique)),
        n_hits=scalar(node_mask.sum()),
        n_hits_oi=scalar(good.sum()),
    )


def sharded_condensation_loss(
    beta_local: torch.Tensor,
    x_local: torch.Tensor,
    cd_local: ShardedCondensationData,
    *,
    q_min: float = 0.01,
    max_n_objects: int,
    group=None,
) -> dict[str, torch.Tensor]:
    """This shard's part of the tiger condensation loss, reduced over
    ``group`` (every rank returns the whole loss): ``beta_local [N_loc]``,
    ``x_local [N_loc, D]`` and the shard's view of the tables. ``group=None``:
    one shard, every collective an identity."""
    k = max_n_objects
    dev, dtype = x_local.device, x_local.dtype
    zero = torch.zeros((), dtype=dtype, device=dev)
    col = cd_local.obj_col.long()
    member = col >= 0
    col_safe = torch.where(member, col, torch.full_like(col, k))
    col_clip = col_safe.clamp(0, k - 1)

    q = torch.arctanh(beta_local) ** 2 + q_min
    q = torch.where(cd_local.node_mask, q, zero)

    # the condensation point of each object: argmax of q over all its hits
    # (no gradient through the choice, as in the reference)
    q_sel = q.detach()
    neg_inf = torch.full((k + 1,), -torch.inf, dtype=dtype, device=dev)
    local_max = neg_inf.scatter_reduce(
        0, col_safe, torch.where(member, q_sel, neg_inf[0]), "amax", include_self=True)[:k]
    global_max = pmax(local_max, group)
    is_max_hit = member & (q_sel == global_max[col_clip])
    gidx = cd_local.global_index.long()
    cand = torch.where(is_max_hit, gidx, torch.full_like(gidx, _NO_HIT))
    local_best = torch.full((k + 1,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=dev).scatter_reduce(
        0, col_safe, cand, "amin", include_self=True)[:k]
    global_best = pmin(local_best, group)
    is_cp = is_max_hit & (gidx == global_best[col_clip])

    def cp_rows(values):
        vals = torch.where(is_cp.reshape((-1,) + (1,) * (values.dim() - 1)), values, zero)
        out = torch.zeros((k + 1,) + tuple(values.shape[1:]), dtype=dtype, device=dev)
        return out.index_add(0, col_safe, vals)[:k]

    x_k, beta_k = psum(cp_rows(x_local), cp_rows(beta_local), group=group)
    q_k = torch.arctanh(beta_k.clamp(0.0, 1.0 - 1e-12)) ** 2 + q_min
    q_k = torch.where(cd_local.obj_valid, q_k, zero)

    dist_sq = (
        torch.sum(x_local * x_local, dim=1)[:, None]
        + torch.sum(x_k * x_k, dim=1)[None, :]
        - 2.0 * x_local @ x_k.T
    )
    dist_sq = torch.maximum(dist_sq, zero)
    nonzero = dist_sq > 0
    dist = torch.where(nonzero, torch.sqrt(torch.where(nonzero, dist_sq, torch.ones_like(dist_sq))), zero)

    attractive = ((col[:, None] == torch.arange(k, device=dev)[None, :]) & member[:, None]
                  & cd_local.obj_valid[None, :])
    qw = q[:, None] * q_k[None, :]
    att = torch.sum(torch.where(attractive, qw * dist_sq, zero))
    repulsive = ~attractive & (dist < 1) & cd_local.node_mask[:, None] & cd_local.obj_valid[None, :]
    rep = torch.sum(torch.where(repulsive, qw * (1 - dist), zero))
    noise = torch.sum(torch.where(cd_local.is_noise, beta_local, zero))
    n_noise = cd_local.is_noise.sum().to(dtype)
    v_att, v_rep, noise_sum, noise_count = psum(torch.stack([att, rep, noise, n_noise]), group=group)[0]

    n_obj = cd_local.n_objects.to(torch.int64)
    coward = torch.sum(torch.where(cd_local.obj_valid, 1 - beta_k, zero)) / torch.clamp(n_obj, min=1).to(dtype)
    norm_rep = _EPS + ((n_obj - 1) * cd_local.n_hits.to(torch.int64)).to(dtype)
    norm_att = _EPS + (cd_local.n_hits_oi.to(torch.int64) - n_obj).to(dtype)
    return {
        "attractive": v_att / norm_att,
        "repulsive": v_rep / norm_rep,
        "coward": coward,
        "noise": noise_sum / torch.clamp(noise_count, min=1),
    }


def make_sharded_condensation(mesh, *, max_n_objects: int, q_min: float = 0.01,
                              axis_name: str = "graph"):
    """``loss(beta, x, cd) -> dict`` over the mesh's ``axis_name`` group;
    ``beta`` / ``x`` / ``cd`` are this rank's shard (or the whole partition,
    of which the rank takes its shard)."""
    group, p = mesh.group(axis_name), mesh.coord(axis_name)

    def loss(beta, x, cd):
        if not cd.is_shard:
            beta, x, cd = beta[p], x[p], cd.shard(p)
        return sharded_condensation_loss(beta, x, cd, q_min=q_min, max_n_objects=max_n_objects,
                                         group=group)

    return loss
