"""IVF-certified exact kNN for full-detector point clouds (counterpart of
``gnn_tracking_tpu/ops/ivf_knn.py``, every option of it).

1. coarse quantization: k-means cells (``lloyd_iters`` Lloyd sweeps from
   seeds spread along the principal axis), the assignment in blocks of
   ``block_n`` points;
2. bucketing: points sorted by cell into ``[C, cell_cap]`` query slabs and
   wider ``[C, cand_cap]`` candidate slabs (gather formulation: slot
   ``(c, r)`` reads the cell-sorted stream); points over a cap go to the
   spill set (not a query slot) and the residual set (not a candidate
   slot);
3. probe: every query slot scans the candidate slabs of the ``n_probe``
   cells nearest its own. ``probe_impl="pallas"`` (or None, the default on
   the card and on the CPU) is ``ivf_probe``, the CUDA kernel
   ``csrc/ivf_probe.cu`` (direct distances, sorted); ``"xla"`` is the JAX
   function's other probe, plain tensor code: ``group_cells`` cells at a
   time, each shifted by its centroid, norm-expansion distances and the
   ``k + 8`` smallest (``cand_cap`` then defaults to ``cell_cap``). With
   ``spill_passes`` True or ``"extra"`` the residual set is merged into
   every query (extra pass); with True or ``"probe"`` the spilled queries get
   their own probe (spill probe); each on a size ladder;
3b. exact distances: the ``"xla"`` probe's rows are always re-ranked by the
   direct formula; the kernel probe's are cut to ``k``, and only rows that
   went through a norm-expansion merge are re-ranked (every row after an
   extra pass, else the spilled ones after a spill probe);
4. certification: a query is exact iff its k-th distance beats the
   triangle bound ``|q - c_j| - rad_j`` of every cell it did not visit;
5. fallback: brute force for the uncertified queries, on a cap ladder.

Each ``lax.cond`` of the JAX function is a Python branch on a count read to
the host. One call reads: the spill and residual counts (one transfer),
then the number of uncertified queries once before the fallback ladder and
once after each rung that runs. A fully certified call makes two reads.

``bucket_impl`` and ``fast_assign`` take the JAX function's values and
defaults and are checked. On the TPU they are hints of layout and
precision: the slab build as a gather or a scatter (bitwise equal tables),
and the cell assignment's product at the default or the highest matmul
precision (which moves cells, never the exact result). They have no CUDA
counterpart: every call builds the gather tables and assigns at the
process's float32 matmul setting (PyTorch's default: TF32 off), as the
JAX package does on the CPU.

:func:`record_parts` times each call's steps.
"""

from __future__ import annotations

import contextlib
import math
import time

import torch

from gnn_tracking_tpu_torch.ops.ivf_probe import ivf_probe
from gnn_tracking_tpu_torch.ops.windowed_topk import _fallback_brute, principal_axis

_FAR = 1e30
#: the steps of an ``ivf_knn`` call that :func:`record_parts` times, in order
PARTS = ("quantize_ms", "bucket_ms", "probe_ms", "extra_ms", "spill_ms", "rerank_ms", "certify_ms",
         "fallback_ms")
#: while ``record_parts`` is open, the list each ``ivf_knn`` call appends its record to
_parts: list | None = None


@contextlib.contextmanager
def record_parts():
    """Within the block, each ``ivf_knn`` call appends a record to the
    yielded list: the host time in ms of each of its steps (``PARTS``: the
    coarse quantization, the bucketing with its host read, the probe launch
    (``ivf_probe``), the extra pass, the spill probe, the rerank, the
    certification with its host read, the fallback), each between two
    device synchronisations (0 for a step the call skips), and its
    ``n_probe``. Outside it nothing is synchronised or recorded."""
    global _parts
    outer, _parts = _parts, []
    try:
        yield _parts
    finally:
        _parts = outer


class _Laps:
    """With a record: each ``lap(part)`` adds the time since the last lap
    (both after a device synchronisation) to ``rec[part]``; without one,
    nothing."""

    def __init__(self, rec: dict | None, dev: torch.device):
        self.rec = rec
        self.sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        if rec is not None:
            self.sync()
            self.t = time.perf_counter()

    def lap(self, part: str) -> None:
        if self.rec is None:
            return
        self.sync()
        now = time.perf_counter()
        self.rec[part] += (now - self.t) * 1e3
        self.t = now


def _merge_sorted_pairs(da, ia, db, ib, k_out):
    """Merge two row-wise ascending (dist, idx) lists into the ``k_out``
    smallest, two-pointer style; ties prefer the ``a`` side."""
    n = da.shape[0]
    ai = torch.zeros((n, 1), dtype=torch.int64, device=da.device)
    bi = torch.zeros_like(ai)
    out_d, out_i = [], []
    for _ in range(k_out):
        av = torch.gather(da, 1, ai.clamp(max=da.shape[1] - 1))
        bv = torch.gather(db, 1, bi.clamp(max=db.shape[1] - 1))
        av = torch.where(ai >= da.shape[1], math.inf, av)
        bv = torch.where(bi >= db.shape[1], math.inf, bv)
        take_a = av <= bv
        out_d.append(torch.where(take_a, av, bv))
        out_i.append(torch.where(
            take_a,
            torch.gather(ia, 1, ai.clamp(max=ia.shape[1] - 1)),
            torch.gather(ib, 1, bi.clamp(max=ib.shape[1] - 1)),
        ))
        ai = ai + take_a.long()
        bi = bi + (~take_a).long()
    return torch.cat(out_d, dim=1), torch.cat(out_i, dim=1)


def _pdist2(q, c):
    """Squared distances ``[Q, C]`` by the norm expansion, clamped at 0."""
    qn = (q * q).sum(-1, keepdim=True)
    cn = (c * c).sum(-1)[None, :]
    return torch.clamp(qn + cn - 2.0 * (q @ c.T), min=0.0)


def _assign_blocks(x, centroids, block_n):
    """Nearest-centroid id (first on ties) and squared distance per point,
    blockwise over the points."""
    ids, ds = [], []
    for s in range(0, x.shape[0], block_n):
        d = _pdist2(x[s : s + block_n], centroids)
        dmin, a = torch.min(d, dim=1)
        ids.append(a)
        ds.append(dmin)
    return torch.cat(ids), torch.cat(ds)


def _principal_order(x, valid):
    v = principal_axis(torch.where(valid[:, None], x, 0.0))
    return torch.argsort(torch.where(valid, x @ v, math.inf), stable=True)


def _topk_stable(d, k):
    """The ``k`` smallest per row, ascending, ties to the lower column
    (``lax.top_k`` of ``-d``); rows shorter than ``k`` are padded with
    ``(+inf, 0)``."""
    sd, si = torch.sort(d, dim=1, stable=True)
    sd, si = sd[:, :k], si[:, :k]
    if sd.shape[1] < k:
        pad = k - sd.shape[1]
        sd = torch.nn.functional.pad(sd, (0, pad), value=math.inf)
        si = torch.nn.functional.pad(si, (0, pad))
    return sd, si


def _first_true(mask, size):
    """``jnp.nonzero(mask, size=size)``: positions of the first ``size``
    True entries ascending, and which of the ``size`` slots hold one. The
    remaining slots hold False positions (the JAX function fills 0); every
    consumer masks them. No read to the host."""
    pos = torch.argsort((~mask).to(torch.uint8), stable=True)[:size]
    return pos, torch.arange(size, device=mask.device) < mask.sum()


def _ladder(count, rungs):
    """The smallest rung that holds ``count`` (the last one otherwise)."""
    return next((c for c in rungs if count <= c), rungs[-1])


def _probe_xla(xb3, ib2, xc3, ic2, vc2, nbr, centroids, *, kw, loop, group_cells):
    """The JAX function's ``probe_impl="xla"``: ``group_cells`` cells at a
    time, each cell's query slots and its probed candidate slabs shifted by
    its centroid (distances are shift-invariant; the local frame keeps the
    norm expansion precise), the ``kw`` smallest of the norm-expansion
    distances per slot (ties to the first candidate in ``nbr`` order).
    Returns ``[C * cell_cap, kw]`` distances and ids; an unfilled column
    keeps the id of the candidate that it sorted to."""
    n_cells, cell_cap, d = xb3.shape
    width = nbr.shape[1] * xc3.shape[1]
    pd, pi = [], []
    for s in range(0, n_cells, group_cells):
        cells = torch.arange(s, min(s + group_cells, n_cells), device=xb3.device)
        g = len(cells)
        shift = centroids[cells][:, None, :]
        q = xb3[cells] - shift
        cc = nbr[cells]
        cx = xc3[cc].reshape(g, width, d) - shift
        cid = ic2[cc].reshape(g, width).long()
        qn = (q * q).sum(-1, keepdim=True)
        cn = (cx * cx).sum(-1)[:, None, :]
        dd = torch.clamp(qn + cn - 2.0 * torch.bmm(q, cx.transpose(1, 2)), min=0.0)
        bad = ~vc2[cc].reshape(g, 1, width)
        if not loop:
            bad = bad | (cid[:, None, :] == ib2[cells].long()[:, :, None])
        sd, si = _topk_stable(torch.where(bad, math.inf, dd).reshape(g * cell_cap, width), kw)
        pd.append(sd)
        pi.append(torch.gather(cid.repeat_interleave(cell_cap, dim=0), 1, si))
    return torch.cat(pd), torch.cat(pi)


def ivf_knn(
    x: torch.Tensor,
    *,
    k: int,
    node_mask: torch.Tensor | None = None,
    loop: bool = False,
    n_cells: int | None = None,
    cell_cap: int | None = None,
    n_probe: int = 8,
    extra_cap: int = 8192,
    fallback_cap: int = 8192,
    lloyd_iters: int = 2,
    block_n: int = 4096,
    group_cells: int = 32,
    certify: bool = True,
    fallback: bool = True,
    spill_passes: bool | str = True,
    probe_impl: str | None = None,
    cand_cap: int | None = None,
    fast_assign: bool = True,
    bucket_impl: str = "gather",
    return_stats: bool = False,
):
    """Exact kNN via certified IVF probing (the JAX function's arguments,
    the same defaults, except that ``probe_impl=None`` takes the kernel
    probe on the CPU too).

    Returns ``(dists_sq [N, k], idx [N, k] int64, n_uncertified [])`` in the
    input's indexing (and a dict of bucketing statistics with
    ``return_stats``). Infinite distances mark missing neighbours;
    ``n_uncertified`` is 0 when every query is proven exact (-1 with
    ``certify=False``). ``spill_passes`` False, ``"probe"`` or ``"extra"``
    leave out the extra pass, the spill probe or both (their rows stay
    uncertified, or are certified as the JAX function certifies them).
    """
    if probe_impl is None:
        probe_impl = "pallas"
    if probe_impl not in ("pallas", "xla"):
        raise ValueError(f"probe_impl must be 'pallas' or 'xla', got {probe_impl!r}")
    if fast_assign not in (True, False):
        raise ValueError(f"fast_assign must be True or False, got {fast_assign!r}")
    if bucket_impl not in ("gather", "scatter"):
        raise ValueError(f"bucket_impl must be 'gather' or 'scatter', got {bucket_impl!r}")
    if spill_passes not in (True, False, "probe", "extra"):
        raise ValueError(f"spill_passes must be True, False, 'probe' or 'extra', got {spill_passes!r}")
    extra_on = spill_passes in (True, "extra")
    spill_on = spill_passes in (True, "probe")
    n, d = x.shape
    dev = x.device
    rec = None
    if _parts is not None:
        rec = {"n_probe": n_probe, **dict.fromkeys(PARTS, 0.0)}
        _parts.append(rec)
    laps = _Laps(rec, dev)
    if node_mask is None:
        node_mask = torch.ones(n, dtype=torch.bool, device=dev)
    xf = torch.where(node_mask[:, None], x.float(), 0.0)
    # center the cloud (the norm expansion loses mantissa to any offset)
    w = node_mask.float()
    mean = (xf * w[:, None]).sum(0) / torch.clamp(w.sum(), min=1.0)
    xf = torch.where(node_mask[:, None], xf - mean[None, :], _FAR)

    if n_cells is None:
        n_cells = max(8, min(8192, n // 32))
    if cell_cap is None:
        cell_cap = max(8, (3 * n) // n_cells)
    n_probe = min(n_probe, n_cells)
    fallback_cap = min(fallback_cap, n)
    extra_cap = min(extra_cap, n)
    if cand_cap is None:
        # the kernel probe scans a wider candidate table almost for free
        cand_cap = cell_cap * 8 // 3 if probe_impl == "pallas" else cell_cap
    cand_cap = max(cand_cap, cell_cap)
    kw = k + 8

    # --- 1. coarse quantization -------------------------------------------
    order0 = _principal_order(xf, node_mask)
    stride = max(1, n // n_cells)
    centroids = xf[order0[(torch.arange(n_cells, device=dev) * stride) % n]]
    for _ in range(lloyd_iters):
        a, _ = _assign_blocks(xf, centroids, block_n)
        sums = torch.zeros_like(centroids).index_add_(0, a, xf * w[:, None])
        cnts = torch.zeros(n_cells, device=dev).index_add_(0, a, w)
        centroids = torch.where(
            cnts[:, None] > 0, sums / torch.clamp(cnts, min=1.0)[:, None], centroids
        )
    assign, _ = _assign_blocks(xf, centroids, block_n)
    assign = torch.where(node_mask, assign, n_cells - 1)
    # cell radius over all assigned valid points (spilled ones too)
    dist_own = torch.sqrt(torch.clamp(((xf - centroids[assign]) ** 2).sum(1), min=0.0))
    rad = torch.full((n_cells,), -math.inf, device=dev).scatter_reduce_(
        0, assign, torch.where(node_mask, dist_own, 0.0), "amax"
    )
    laps.lap("quantize_ms")

    # --- 2. bucketing ------------------------------------------------------
    order = torch.argsort(assign, stable=True)
    sa = assign[order]
    first = torch.searchsorted(sa, torch.arange(n_cells, device=dev))
    rank = torch.arange(n, device=dev) - first[sa]
    count = torch.cat([first[1:], first.new_tensor([n])]) - first

    def build_table(cap):
        """Slab tables ``[C * cap]``: coordinates, ids, validity; slot
        ``(c, r)`` reads the cell-sorted stream at ``first[c] + r``."""
        r = torch.arange(cap, device=dev)[None, :]
        take = order[torch.clamp(first[:, None] + r, max=n - 1)]
        valid = (r < count[:, None]) & node_mask[take]
        xt = torch.where(valid[..., None], xf[take], _FAR).reshape(-1, d)
        it = torch.where(valid, take, 0).to(torch.int32).reshape(-1)
        return xt, it, valid.reshape(-1)

    xb, ib, vb = build_table(cell_cap)
    xcb, icb, vcb = (xb, ib, vb) if cand_cap == cell_cap else build_table(cand_cap)

    # spill: valid points absent from the query slabs (they need their own
    # probe); resid: valid points absent from the candidate slabs (merged
    # into every query by the extra pass). Conflating the two would count
    # ranks in [cell_cap, cand_cap) twice.
    valid_o = node_mask[order]
    spill = (rank >= cell_cap) & valid_o
    resid = (rank >= cand_cap) & valid_o
    spill_pos, spill_valid = _first_true(spill, extra_cap)
    spill_ids = order[spill_pos]
    x_spill = torch.where(spill_valid[:, None], xf[spill_ids], _FAR)
    resid_pos, resid_valid = _first_true(resid, extra_cap)
    resid_ids = order[resid_pos]
    x_resid = torch.where(resid_valid[:, None], xf[resid_ids], _FAR)
    n_spill, n_resid = torch.stack([spill.sum(), resid.sum()]).tolist()  # host read
    spill_lost = max(n_resid - extra_cap, 0)
    stats = {"n_spill": n_spill, "n_resid": n_resid, "spill_lost": spill_lost,
             "n_cells": n_cells, "cell_cap": cell_cap, "cand_cap": cand_cap}

    # --- 3. probe ----------------------------------------------------------
    nbr = _topk_stable(_pdist2(centroids, centroids), n_probe)[1]  # [C, T], self first
    laps.lap("bucket_ms")
    xb3 = xb.reshape(n_cells, cell_cap, d)
    ib2 = ib.reshape(n_cells, cell_cap)
    xc3 = xcb.reshape(n_cells, cand_cap, d)
    ic2 = icb.reshape(n_cells, cand_cap)
    vc2 = vcb.reshape(n_cells, cand_cap)
    if probe_impl == "pallas":
        pd, pi = ivf_probe(xb3, ib2, xc3, ic2, nbr.to(torch.int32), kw=kw, loop=loop)
        pi = pi.long()
    else:
        pd, pi = _probe_xla(xb3, ib2, xc3, ic2, vc2, nbr, centroids, kw=kw, loop=loop,
                            group_cells=group_cells)
    # slot results back to the input's indexing through the inverse map
    n_slots = pd.shape[0]
    slot_of = torch.full((n + 1,), n_slots, dtype=torch.int64, device=dev)
    slot_of[torch.where(vb, ib.long(), n)] = torch.arange(n_slots, device=dev)
    slot_of = slot_of[:n]
    has_slot = slot_of < n_slots
    take = torch.clamp(slot_of, max=n_slots - 1)
    dists = torch.where(has_slot[:, None], pd[take], math.inf)
    idx = torch.where(has_slot[:, None], pi[take], 0)
    rungs = [c for c in (256, 2048) if c < extra_cap] + [extra_cap]
    laps.lap("probe_ms")

    extra_ran = extra_on and n_resid > 0
    if extra_ran:
        # extra pass: every query merges the residual set's top-kw (ids
        # disjoint from every candidate slab) into its probe result
        cap = _ladder(n_resid, rungs)
        x_r, ids_r, valid_r = x_resid[:cap], resid_ids[:cap], resid_valid[:cap]
        de, ie = [], []
        for s in range(0, n, block_n):
            dd = _pdist2(xf[s : s + block_n], x_r)
            bad = ~valid_r[None, :]
            if not loop:
                bad = bad | (ids_r[None, :] == torch.arange(s, s + dd.shape[0], device=dev)[:, None])
            sd, si = _topk_stable(torch.where(bad, math.inf, dd), kw)
            de.append(sd)
            ie.append(ids_r[si])
        dists, idx = _merge_sorted_pairs(dists, idx, torch.cat(de), torch.cat(ie), kw)
        laps.lap("extra_ms")

    if spill_on and n_spill > 0:
        # spill probe: the spilled queries scan their own cell's probe list
        cap = _ladder(n_spill, rungs)
        ids_c, x_c, valid_c = spill_ids[:cap], x_spill[:cap], spill_valid[:cap]
        own = assign[ids_c]
        dp, ip = [], []
        for s in range(0, cap, 1024):
            cc = nbr[own[s : s + 1024]]
            shift = centroids[own[s : s + 1024]]  # local frame per query
            q = x_c[s : s + 1024] - shift
            b = q.shape[0]
            cx = xc3[cc].reshape(b, n_probe * cand_cap, d) - shift[:, None, :]
            cid = ic2[cc].reshape(b, n_probe * cand_cap).long()
            cv = vc2[cc].reshape(b, n_probe * cand_cap)
            dd = torch.clamp(
                (q * q).sum(-1)[:, None] + (cx * cx).sum(-1)
                - 2.0 * torch.einsum("bd,bjd->bj", q, cx), min=0.0,
            )
            bad = ~cv | ~valid_c[s : s + 1024, None]
            if not loop:
                bad = bad | (cid == ids_c[s : s + 1024, None])
            sd, si = _topk_stable(torch.where(bad, math.inf, dd), kw)
            dp.append(sd)
            ip.append(torch.gather(cid, 1, si))
        dm, im = _merge_sorted_pairs(dists[ids_c], idx[ids_c], torch.cat(dp), torch.cat(ip), kw)
        keep = valid_c[:, None]
        dists[ids_c] = torch.where(keep, dm, dists[ids_c])
        idx[ids_c] = torch.where(keep, im, idx[ids_c])
        laps.lap("spill_ms")

    # --- 3b. exact distances -------------------------------------------------
    # The kernel probe's distances are already direct and sorted, so its
    # rows are cut to k, and only rows that went through a norm-expansion
    # merge are re-ranked by the direct formula: all rows after an extra
    # pass, else the spilled ones. The "xla" probe's rows all are.
    def rerank(rows):
        dn, ix = dists[rows], idx[rows]
        dr = ((xf[rows][:, None, :] - xf[ix]) ** 2).sum(-1)
        sd, si = _topk_stable(torch.where(torch.isfinite(dn), dr, math.inf), k)
        return sd, torch.gather(ix, 1, si)

    if probe_impl == "xla" or extra_ran:
        step = min(block_n, 8192)
        out = [rerank(torch.arange(s, min(s + step, n), device=dev)) for s in range(0, n, step)]
        dists, idx = torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])
    else:
        dk, ik = dists[:, :k].clone(), idx[:, :k].clone()
        if spill_on and n_spill > 0:
            dm, im = rerank(spill_ids)
            keep = spill_valid[:, None]
            dk[spill_ids] = torch.where(keep, dm, dk[spill_ids])
            ik[spill_ids] = torch.where(keep, im, ik[spill_ids])
        dists, idx = dk, ik
    laps.lap("rerank_ms")

    def ret(unc):
        unc = torch.tensor(unc, device=dev)
        return (dists, idx, unc, stats) if return_stats else (dists, idx, unc)

    if not certify:
        return ret(-1)

    # --- 4. certification --------------------------------------------------
    last = dists[:, -1]
    kth = torch.sqrt(torch.where(torch.isfinite(last), last, math.inf))
    found_all = torch.isfinite(dists).all(dim=1)
    visited = nbr[assign]  # [N, T]
    cert = []
    step = min(block_n, 2048)
    for s in range(0, n, step):
        q = xf[s : s + step]
        bound = torch.sqrt(_pdist2(q, centroids)) - rad[None, :]
        bound = bound.scatter(1, visited[s : s + step], math.inf)
        r = kth[s : s + step]
        # margin: never let rounding certify a borderline query
        cert.append(r <= bound.amin(dim=1) - 1e-5 * torch.clamp(r, min=1.0))
    certified = (torch.cat(cert) & found_all & (spill_lost == 0)) | ~node_mask

    # --- 5. fallback ----------------------------------------------------------
    n_viol = int((~certified).sum())  # host read
    laps.lap("certify_ms")
    if not fallback:
        return ret(n_viol)
    for cap in [c for c in (256, 1024) if c < fallback_cap] + [fallback_cap]:
        if n_viol == 0:
            break
        # the first cap violators (fill rows are certified ones, left as
        # they are): brute force with the direct formula
        viol_idx, _ = _first_true(~certified, cap)
        fb_d, fb_i = _fallback_brute(
            xf[viol_idx], xf, node_mask, k=k, loop=loop, self_ids=viol_idx,
        )
        take_fb = ~certified[viol_idx][:, None]
        dists[viol_idx] = torch.where(take_fb, fb_d, dists[viol_idx])
        idx[viol_idx] = torch.where(take_fb, fb_i, idx[viol_idx])
        certified[viol_idx] = True
        n_viol = int((~certified).sum())  # host read
    laps.lap("fallback_ms")
    return ret(n_viol)
