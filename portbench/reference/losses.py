"""The losses of the benchmark's training configurations, written out.

* The dense ("tiger") condensation loss of gnn-tracking
  (``losses/oc.py``, ``CondensationLossTiger``) over the objects that the
  truth makes: particles with ``pt > 0.9``, not noise, reconstructable,
  ``|eta| < 4``; above ``max_objects`` of them a subsample of
  ``max_objects`` drawn by ``numpy.random.default_rng(seed).choice``.
  Each object's condensation point is the hit of the largest charge ``q =
  arctanh(beta)^2 + q_min`` (the lowest index on a tie; no gradient through
  the choice). ``attractive = sum q_i q_k |x_i - x_k|^2`` over each hit and
  its own object, over ``n_hits_oi - n_objects``; ``repulsive = sum q_i q_k
  (1 - |x_i - x_k|)`` over hits and other objects closer than 1, over
  ``(n_objects - 1) n_hits``.
* The edge loss of the full GraphTCN: binary cross-entropy of ``W``
  against the edge truth, the mean over the edges.
* The focal loss of ``ec.yml`` (``alpha`` 0.25, ``gamma`` 2).
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-9


def condensation_objects(ev: dict, *, max_objects: int, subsample_seed: int, pt_thld: float = 0.9,
                         max_eta: float = 4.0) -> dict[str, np.ndarray | int]:
    """Host-side truth of the condensation loss for one event's arrays."""
    pid = ev["particle_id"]
    good = (ev["pt"] > pt_thld) & (pid > 0) & (ev["reconstructable"] > 0) & (np.abs(ev["eta"]) < max_eta)
    unique = np.unique(pid[good])
    if len(unique) > max_objects:
        unique = np.sort(np.random.default_rng(subsample_seed).choice(unique, size=max_objects, replace=False))
        good &= np.isin(pid, unique)
    col = np.searchsorted(unique, pid)
    col = np.where((col < len(unique)) & (unique[np.minimum(col, len(unique) - 1)] == pid), col, -1)
    return {"col": col, "n_objects": len(unique), "n_hits": len(pid), "n_hits_oi": int(good.sum())}


def _points(q: torch.Tensor, col: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each object's condensation point (the hit of largest ``q``, lowest
    index on a tie), its runner-up (the largest of the rest), and the
    relative gap between their charges."""
    member = col >= 0
    safe = torch.where(member, col, k)
    qm = torch.where(member, q, -torch.inf)
    idx = torch.arange(q.shape[0], device=q.device)

    def best_of(values):
        top = torch.full((k + 1,), -torch.inf, dtype=q.dtype, device=q.device).scatter_reduce(
            0, safe, values, "amax", include_self=True)[:k]
        at = member & (values == top[col.clamp(min=0)])
        first = torch.full((k + 1,), q.shape[0], dtype=torch.int64, device=q.device).scatter_reduce(
            0, safe, torch.where(at, idx, q.shape[0]), "amin", include_self=True)[:k]
        return top, first

    best, cp = best_of(qm)
    is_cp = torch.zeros_like(member)
    is_cp[cp] = True
    second, runner = best_of(torch.where(is_cp, -torch.inf, qm))
    return cp, runner, (best - second) / best


def _terms(x, q, col, points, objects):
    """Per object of ``objects`` (its condensation point the hit in
    ``points``): the attractive and the repulsive sums, unnormalised."""
    x_k = x[points]
    q_k = q[points]
    # the expanded square: no [hits, objects, dims] table (rounding far below
    # the comparison's in float64)
    d2 = ((x * x).sum(1)[:, None] + (x_k * x_k).sum(1)[None, :] - 2.0 * x @ x_k.T).clamp(min=0.0)
    own = col[:, None] == objects[None, :]
    qw = q[:, None] * q_k[None, :]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    near = ~own & (d2 < 1)
    d = torch.sqrt(torch.where(near, d2, torch.ones_like(d2)))
    return torch.where(own, qw * d2, zero).sum(0), torch.where(near, qw * (1 - d), zero).sum(0)


def condensation(beta: torch.Tensor, x: torch.Tensor, truth: dict, *, q_min: float = 0.01, tie: float = 1e-6,
                 flip: tuple[int, ...] = ()) -> dict:
    """``attractive`` and ``repulsive``. An object whose two largest charges
    differ by less than ``tie`` (relative) has its condensation point at
    rounding: the program's float32 charges may put it at the runner-up.
    ``unsure`` lists those objects (the closest first), ``alternatives`` how
    much the loss moves where each takes its runner-up, and ``flip`` takes the
    runner-up for the objects it names; ``tie_gap`` is the smallest gap."""
    dev = x.device
    k = truth["n_objects"]
    col = torch.as_tensor(truth["col"], device=dev)
    q = torch.arctanh(beta.clamp(0.0, 1.0 - 1e-12)) ** 2 + q_min
    cp, runner, gap = _points(q.detach(), col, k)
    unsure = torch.nonzero(gap < tie).flatten()
    unsure = unsure[torch.argsort(gap[unsure])]  # the closest first
    if flip:
        flip_t = torch.as_tensor(flip, device=dev)
        cp = cp.index_copy(0, flip_t, runner[flip_t])
    objects = torch.arange(k, device=dev)
    att, rep = (t.sum() for t in _terms(x, q, col, cp, objects))
    norm_att, norm_rep = EPS + truth["n_hits_oi"] - k, EPS + (k - 1) * truth["n_hits"]
    alternatives = []
    if len(unsure) and not flip:
        with torch.no_grad():
            xd, qd = x.detach(), q.detach()
            a0, r0 = _terms(xd, qd, col, cp[unsure], unsure)
            a1, r1 = _terms(xd, qd, col, runner[unsure], unsure)
            alternatives = ((a1 - a0) / norm_att + (r1 - r0) / norm_rep).tolist()
    return {
        "attractive": att / norm_att,
        "repulsive": rep / norm_rep,
        "tie_gap": float(gap.min()) if k else float("inf"),
        "unsure": unsure.tolist(),
        "alternatives": alternatives,
    }


def edge_bce(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -(y * torch.log(w) + (1.0 - y) * torch.log(1.0 - w)).mean()


def focal(w: torch.Tensor, y: torch.Tensor, *, alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    pos = -alpha * (1 - w) ** gamma * y * torch.log(w)
    neg = -(1.0 - alpha) * w**gamma * (1.0 - y) * torch.log(1 - w)
    return (pos + neg).mean()
