"""Object-condensation losses (counterpart of the JAX ``losses/oc.py``:
``condensation_loss``, ``radius_graph_condensation_loss``,
``_CondensationLossBase``, ``CondensationLossTiger``, ``CondensationLossRG``,
``object_loss`` and ``ObjectLoss``).

The dense ("tiger") strategy builds hits x objects matrices, blocked over
objects (``object_block_size``) so that at most ``[N, block]`` of them
exist at a time; the objects are the unique particle ids under a static cap
``max_n_objects`` (``dense_unique``). The radius-graph ("rg") strategy
repels only along a fixed-degree radius graph of the clustering
coordinates (``ops/knn.radius_graph``: ``pairwise_topk_filter`` in radius
mode) and attracts each hit to its object's condensation point. Random
draws (repulsive-pair subsampling, ``sample_pids < 1``) come from an
explicit ``torch.Generator`` on the tensors' device; they differ from the
JAX package's bits, not in distribution.
"""

from __future__ import annotations

from typing import Any

import torch

from gnn_tracking_tpu_torch.losses import MultiLossFct, MultiLossFctReturn
from gnn_tracking_tpu_torch.ops.knn import radius_graph
from gnn_tracking_tpu_torch.ops.unique import dense_unique
from gnn_tracking_tpu_torch.utils.graph_masks import get_good_node_mask_tensors

_EPS = 1e-9


def _block_terms(
    *, beta, x, q, object_id, node_mask, uids, valid, generator, sampling_freq
):
    """Partial loss terms for one block of objects (``[N, B]`` matrices):
    attractive and repulsive potentials, repulsive-pair count, coward sum."""
    # hits of object k attract each other, including hits of the object
    # that fail the object mask (JAX oc.py:91-98)
    attractive = (object_id[:, None] == uids[None, :]) & node_mask[:, None] & valid[None, :]
    # condensation point: the member with the largest charge, ties to the
    # first hit (torch.argmax and jnp.argmax agree)
    alphas = torch.argmax(q[:, None] * attractive, dim=0)
    q_k = q[alphas][None, :]
    qw = q[:, None] * q_k
    x_k = x[alphas]
    dist_sq = (
        torch.sum(x * x, dim=1)[:, None]
        + torch.sum(x_k * x_k, dim=1)[None, :]
        - 2.0 * x @ x_k.T
    )
    # torch.maximum splits the gradient at a tie as jnp.maximum does
    dist_sq = torch.maximum(dist_sq, torch.zeros((), dtype=dist_sq.dtype, device=dist_sq.device))
    # safe norm: zero distances (each CP to itself) get a zero gradient, not
    # NaN from sqrt'(0); both wheres are needed
    nonzero = dist_sq > 0
    one = torch.ones((), dtype=dist_sq.dtype, device=dist_sq.device)
    zero = torch.zeros((), dtype=dist_sq.dtype, device=dist_sq.device)
    dist = torch.where(nonzero, torch.sqrt(torch.where(nonzero, dist_sq, one)), zero)

    v_att = torch.sum(torch.where(attractive, qw * dist_sq, zero))
    repulsive = (~attractive) & (dist < 1) & node_mask[:, None] & valid[None, :]
    n_rep = repulsive.sum()
    if sampling_freq is not None:
        sample = torch.rand(
            repulsive.shape, generator=generator, device=repulsive.device, dtype=dist.dtype
        ) < sampling_freq
        repulsive = repulsive & sample
    v_rep = torch.sum(torch.where(repulsive, qw * (1 - dist), zero))
    coward = torch.sum(torch.where(valid, 1 - beta[alphas], zero))
    return v_att, v_rep, n_rep, coward


def condensation_loss(
    *,
    beta: torch.Tensor,
    x: torch.Tensor,
    object_id: torch.Tensor,
    object_mask: torch.Tensor,
    q_min: float,
    max_n_objects: int,
    node_mask: torch.Tensor | None = None,
    noise_threshold: int = 0,
    max_n_rep: int = 0,
    generator: torch.Generator | None = None,
    object_block_size: int | None = None,
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Dense ("tiger") condensation loss (JAX ``condensation_loss``,
    reference ``oc.py:252-347``).

    Args:
        beta: ``[N]`` condensation likelihood in (0, 1)
        x: ``[N, D]`` clustering coordinates
        object_id: ``[N]`` particle id (0 = noise, < 0 = padding)
        object_mask: ``[N]`` hits whose particles define objects
        q_min: minimum charge
        max_n_objects: static cap on the number of objects
        node_mask: ``[N]`` validity mask
        noise_threshold: ids ``<= noise_threshold`` are noise
        max_n_rep: subsample repulsive pairs to about this many (0: all)
        generator: ``torch.Generator`` on ``beta``'s device, required when
            ``max_n_rep > 0``
        object_block_size: objects per block (``None``: one block)

    Returns:
        ``(losses, extra)``: attractive / repulsive / coward / noise, and
        ``n_rep``, the repulsive-pair count before sampling.
    """
    n = beta.shape[0]
    dev, dtype = beta.device, beta.dtype
    if node_mask is None:
        node_mask = torch.ones(n, dtype=torch.bool, device=dev)
    object_mask = object_mask & node_mask
    if max_n_rep > 0 and generator is None:
        msg = "max_n_rep > 0 requires a torch.Generator"
        raise ValueError(msg)
    unique_ids, obj_valid, n_objects = dense_unique(object_id, object_mask, max_n_objects)
    q = torch.arctanh(beta) ** 2 + q_min

    if object_block_size is None or object_block_size >= max_n_objects:
        blocks = [(unique_ids, obj_valid)]
    else:
        if max_n_objects % object_block_size != 0:
            msg = "max_n_objects must be divisible by object_block_size"
            raise ValueError(msg)
        blocks = list(zip(
            unique_ids.split(object_block_size), obj_valid.split(object_block_size)
        ))

    def terms(uids, valid, sampling_freq):
        return _block_terms(
            beta=beta, x=x, q=q, object_id=object_id, node_mask=node_mask,
            uids=uids, valid=valid, generator=generator, sampling_freq=sampling_freq,
        )

    sampling_freq = None
    if max_n_rep > 0:
        # count pass without sampling to set the frequency
        with torch.no_grad():
            n_rep = sum(terms(u, v, None)[2] for u, v in blocks)
        freq = torch.clamp(max_n_rep / torch.clamp(n_rep, min=1).to(dtype), max=1.0)
        sampling_freq = torch.where(n_rep > max_n_rep, freq, torch.ones_like(freq))
    parts = [terms(u, v, sampling_freq) for u, v in blocks]
    v_att = sum(p[0] for p in parts)
    v_rep = sum(p[1] for p in parts)
    if max_n_rep == 0:
        n_rep = sum(p[2] for p in parts)
    coward_sum = sum(p[3] for p in parts)

    n_hits = node_mask.sum()
    n_hits_oi = object_mask.sum()
    # every hit has a repulsive edge to every CP but its own (oc.py:309)
    norm_rep = _EPS + ((n_objects - 1) * n_hits).to(dtype)
    # minus n_objects against double counting (oc.py:311)
    norm_att = _EPS + (n_hits_oi - n_objects).to(dtype)
    if sampling_freq is not None:
        norm_rep = norm_rep * sampling_freq
    zero = torch.zeros((), dtype=dtype, device=dev)
    is_noise = (object_id <= noise_threshold) & (object_id >= 0) & node_mask
    losses = {
        "attractive": v_att / norm_att,
        "repulsive": v_rep / norm_rep,
        "coward": coward_sum / torch.clamp(n_objects, min=1),
        "noise": torch.sum(torch.where(is_noise, beta, zero)) / torch.clamp(is_noise.sum(), min=1),
    }
    return losses, {"n_rep": n_rep}


def radius_graph_condensation_loss(
    *,
    beta: torch.Tensor,
    x: torch.Tensor,
    object_id: torch.Tensor,
    object_mask: torch.Tensor,
    q_min: float,
    radius_threshold: float,
    max_num_neighbors: int,
    max_n_objects: int,
    node_mask: torch.Tensor | None = None,
    noise_threshold: int = 0,
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Radius-graph ("rg") condensation loss (JAX
    ``radius_graph_condensation_loss``, reference ``oc.py:87-161``):
    repulsion only along the edges of ``radius_graph(x, radius_threshold)``
    (no ``batch``, ``loop=False``) whose source is a condensation point of
    another object; attraction of every other member hit to its object's
    condensation point. Arguments as for :func:`condensation_loss`;
    ``max_num_neighbors`` caps the radius graph's degree (the nearest are
    kept). Returns ``(losses, {})``.
    """
    n = beta.shape[0]
    dev, dtype = beta.device, beta.dtype
    if node_mask is None:
        node_mask = torch.ones(n, dtype=torch.bool, device=dev)
    object_mask = object_mask & node_mask
    unique_ids, obj_valid, n_objects = dense_unique(object_id, object_mask, max_n_objects)
    # condensation points among the masked hits only (oc.py:33-43); q is
    # monotone in beta and positive, so the argmax over q * member picks the
    # member with the largest beta, ties to the first hit as in jnp.argmax
    member = (
        (object_id[:, None] == unique_ids[None, :]) & object_mask[:, None] & obj_valid[None, :]
    )
    q = torch.arctanh(beta) ** 2 + q_min
    alphas = torch.argmax(q[:, None] * member, dim=0)
    # invalid columns scatter into a slot past the end (JAX's mode="drop")
    slots = torch.where(obj_valid, alphas, n)
    is_cp = torch.zeros(n + 1, dtype=torch.bool, device=dev).index_fill_(0, slots, True)[:n]
    zero = torch.zeros((), dtype=dtype, device=dev)

    # attraction: every masked hit but the CP to its object's CP
    col = torch.argmax(member.to(torch.uint8), dim=1)
    cp_of_hit = alphas[col]
    d2_att = torch.sum((x - x[cp_of_hit]) ** 2, dim=-1)
    att_mask = member.any(dim=1) & ~is_cp
    va = torch.sum(torch.where(att_mask, d2_att * q * q[cp_of_hit], zero))

    # repulsion along the radius graph (oc.py:46-69); the graph's distances
    # are finite on every slot (zero where masked), so the where below
    # passes no 0 * inf into the gradient
    edge_index, edge_mask, dists = radius_graph(
        x, radius_threshold, max_num_neighbors=max_num_neighbors, node_mask=node_mask, loop=False,
    )
    src, dst = edge_index.long()
    rep_mask = edge_mask & is_cp[src] & (object_id[src] != object_id[dst])
    # sqrt(eps + d^2) guards the gradient at 0 (oc.py:57)
    guarded = torch.sqrt(_EPS + dists**2)
    vr = torch.sum(torch.where(rep_mask, (radius_threshold - guarded) * q[src] * q[dst], zero))
    vr = torch.where(torch.isnan(vr), zero, vr)

    n_hits = node_mask.sum()
    n_hits_oi = object_mask.sum()
    norm_rep = _EPS + ((n_objects - 1) * n_hits).to(dtype)
    norm_att = _EPS + (n_hits_oi - n_objects).to(dtype)
    coward = torch.sum(torch.where(obj_valid, 1 - beta[alphas], zero))
    is_noise = (object_id <= noise_threshold) & (object_id >= 0) & node_mask
    losses = {
        "attractive": va / norm_att,
        "repulsive": vr / norm_rep,
        "coward": coward / torch.clamp(n_objects, min=1),
        "noise": torch.sum(torch.where(is_noise, beta, zero)) / torch.clamp(is_noise.sum(), min=1),
    }
    return losses, {}


class _CondensationLossBase(MultiLossFct):
    def __init__(
        self,
        *,
        lw_repulsive: float = 1.0,
        lw_noise: float = 0.0,
        lw_coward: float = 0.0,
        q_min: float = 0.01,
        pt_thld: float = 0.9,
        max_eta: float = 4.0,
        sample_pids: float = 1.0,
        max_n_objects: int = 1024,
    ):
        self.lw_repulsive = lw_repulsive
        self.lw_noise = lw_noise
        self.lw_coward = lw_coward
        self.q_min = q_min
        self.pt_thld = pt_thld
        self.max_eta = max_eta
        self.sample_pids = sample_pids
        self.max_n_objects = max_n_objects

    def _masks(self, *, pt, particle_id, reconstructable, eta, node_mask, ec_hit_mask, generator):
        """``(node_mask, object_mask)``: a post-EC hit mask folds into the
        validity mask (the reference removes the hits instead,
        ``oc.py:394-401``); the objects are the good hits under it."""
        if ec_hit_mask is not None:
            node_mask = ec_hit_mask if node_mask is None else node_mask & ec_hit_mask
        mask = get_good_node_mask_tensors(
            pt=pt, particle_id=particle_id, reconstructable=reconstructable, eta=eta,
            pt_thld=self.pt_thld, max_eta=self.max_eta,
        )
        if node_mask is not None:
            mask = mask & node_mask
        if self.sample_pids < 1:
            if generator is None:
                msg = "sample_pids < 1 requires a torch.Generator"
                raise ValueError(msg)
            draw = torch.rand(mask.shape, generator=generator, device=mask.device)
            mask = mask & (draw < self.sample_pids)
        return node_mask, mask

    def _weights(self) -> dict[str, float]:
        return {
            "attractive": 1.0,
            "repulsive": self.lw_repulsive,
            "noise": self.lw_noise,
            "coward": self.lw_coward,
        }


class CondensationLossTiger(_CondensationLossBase):
    """Dense condensation loss (reference ``CondensationLossTiger``,
    ``oc.py:350-436``)."""

    def __init__(
        self, *, max_n_rep: int = 0, object_block_size: int | None = None, **kwargs
    ):
        super().__init__(**kwargs)
        self.max_n_rep = max_n_rep
        self.object_block_size = object_block_size

    def __call__(
        self,
        *,
        beta: torch.Tensor,
        x: torch.Tensor,
        particle_id: torch.Tensor,
        reconstructable: torch.Tensor,
        pt: torch.Tensor,
        eta: torch.Tensor,
        node_mask: torch.Tensor | None = None,
        ec_hit_mask: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        **kwargs: Any,
    ) -> MultiLossFctReturn:
        node_mask, mask = self._masks(
            pt=pt, particle_id=particle_id, reconstructable=reconstructable, eta=eta,
            node_mask=node_mask, ec_hit_mask=ec_hit_mask, generator=generator,
        )
        losses, extra = condensation_loss(
            beta=beta, x=x, object_id=particle_id, object_mask=mask, node_mask=node_mask,
            q_min=self.q_min, noise_threshold=0, max_n_rep=self.max_n_rep,
            max_n_objects=self.max_n_objects, generator=generator,
            object_block_size=self.object_block_size,
        )
        return MultiLossFctReturn(loss_dct=losses, weight_dct=self._weights(), extra_metrics=extra)


class CondensationLossRG(_CondensationLossBase):
    """Radius-graph condensation loss (reference ``CondensationLossRG``,
    ``oc.py:164-248``): :func:`radius_graph_condensation_loss` at radius 1
    with ``max_num_neighbors`` neighbours at most."""

    def __init__(self, *, max_num_neighbors: int = 256, **kwargs):
        super().__init__(**kwargs)
        self.max_num_neighbors = max_num_neighbors

    def __call__(
        self,
        *,
        beta: torch.Tensor,
        x: torch.Tensor,
        particle_id: torch.Tensor,
        reconstructable: torch.Tensor,
        pt: torch.Tensor,
        eta: torch.Tensor,
        node_mask: torch.Tensor | None = None,
        ec_hit_mask: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        **kwargs: Any,
    ) -> MultiLossFctReturn:
        node_mask, mask = self._masks(
            pt=pt, particle_id=particle_id, reconstructable=reconstructable, eta=eta,
            node_mask=node_mask, ec_hit_mask=ec_hit_mask, generator=generator,
        )
        losses, extra = radius_graph_condensation_loss(
            beta=beta, x=x, object_id=particle_id, object_mask=mask, node_mask=node_mask,
            q_min=self.q_min, radius_threshold=1.0, max_num_neighbors=self.max_num_neighbors,
            max_n_objects=self.max_n_objects,
        )
        return MultiLossFctReturn(loss_dct=losses, weight_dct=self._weights(), extra_metrics=extra)


def object_loss(
    *,
    pred: torch.Tensor,
    beta: torch.Tensor,
    truth: torch.Tensor,
    particle_id: torch.Tensor,
    mode: str = "efficiency",
    max_n_objects: int = 1024,
    node_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """beta-weighted MSE of predicted per-track properties (JAX
    ``object_loss``, reference ``ObjectLoss.object_loss``, ``oc.py:449-468``).
    ``purity``: the xi-weighted mean over the valid non-noise hits;
    ``efficiency``: per object (the unique positive ids under
    ``max_n_objects``) the xi-weighted mean over its hits, averaged over the
    objects."""
    n = beta.shape[0]
    dev, dtype = beta.device, beta.dtype
    if node_mask is None:
        node_mask = torch.ones(n, dtype=torch.bool, device=dev)
    mse = torch.sum((pred - truth) ** 2, dim=1)
    xi_base = torch.arctanh(beta) ** 2
    zero = torch.zeros((), dtype=dtype, device=dev)
    if mode == "purity":
        xi = torch.where((particle_id != 0) & node_mask, xi_base, zero)
        # the reference's mean over the (boolean-indexed) hits
        n_valid = torch.clamp(node_mask.sum(), min=1)
        return torch.sum(xi * mse) / n_valid / torch.sum(xi)
    if mode == "efficiency":
        unique_ids, obj_valid, n_objects = dense_unique(
            particle_id, (particle_id > 0) & node_mask, max_n_objects
        )
        pid_masks = (
            (particle_id[:, None] == unique_ids[None, :]) & node_mask[:, None] & obj_valid[None, :]
        )
        xi_p = torch.where(pid_masks, xi_base[:, None], zero)
        xi_p_norm = torch.sum(xi_p, dim=0)
        terms = torch.sum(mse[:, None] * xi_p, dim=0)
        one = torch.ones((), dtype=dtype, device=dev)
        ratios = torch.where(obj_valid, terms / torch.where(obj_valid, xi_p_norm, one), zero)
        return torch.sum(ratios) / torch.clamp(n_objects, min=1)
    msg = f"Unknown mode: {mode}"
    raise ValueError(msg)


class ObjectLoss:
    """Loss on predicted object properties (reference ``ObjectLoss``,
    ``oc.py:439-489``); returns one scalar."""

    def __init__(self, mode: str = "efficiency", max_n_objects: int = 1024):
        self.mode = mode
        self.max_n_objects = max_n_objects

    def object_loss(self, *, pred, beta, truth, particle_id, node_mask=None) -> torch.Tensor:
        return object_loss(
            pred=pred, beta=beta, truth=truth, particle_id=particle_id, mode=self.mode,
            max_n_objects=self.max_n_objects, node_mask=node_mask,
        )

    def __call__(
        self, *, beta, pred, particle_id, track_params, reconstructable, node_mask=None, **kwargs
    ) -> torch.Tensor:
        # the reference indexes by reconstructable > 0 (oc.py:483-489); it
        # folds into the validity mask here
        mask = reconstructable > 0
        if node_mask is not None:
            mask = mask & node_mask
        return self.object_loss(
            pred=pred, beta=beta, truth=track_params, particle_id=particle_id, node_mask=mask
        )
