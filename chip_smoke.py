#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py [--seed 0] [--events 32] [--train-steps 10] [--ml-steps 10] [--profile]

Phases, in order (any failure exits nonzero; nothing is swallowed):

1. build the CUDA kernels from ``gnn_tracking_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel) and print the card's name and power limit;
2. small-input reference: a narrow GraphTCN served on the CPU (plain
   versions) and on the card (kernels) must agree;
3. one phase per kernel at the serving shapes (32,768 hits, 262,144 edges,
   GraphTCN 32/32/8/128): the kernel against its plain PyTorch version on
   the same inputs, with its median time, the plain version's time, the
   time of one library call that computes the same function where there is
   one, and its analytic bound. The training kernels (the fused relational
   backward, the sorted segment-sum and the sorted gather) run at the HC
   layer's shapes and must give the same bits on a second launch;
4. the main path: ``TrackingPredictor(device="cuda").predict_dir`` over
   synthetic full-width events (locality-structured graphs; GraphTCN with
   seeded random weights plus a particle-structured latent offset, so that
   DBSCAN sees ~2k tracks of ~16 hits). Every kernel's launch count must be
   positive, the labels must equal those of the plain path on the same
   card, and the track count must be close to 2048. It prints events/s and
   the forward / radius graph / DBSCAN split;
5. the training path: ``TCModule`` steps of the same GraphTCN under
   ``CondensationLossTiger(max_n_objects=2048, object_block_size=256)``
   and Adam on a bench-style event (``bench.py:548-563``). Step 0's
   parameter gradients through the kernels must agree with the plain path's
   on the same card; then ``--train-steps`` timed steps print steps/s, the
   forward / loss / backward / optimizer split, peak memory and the launches
   per step of every kernel on the path;
6. ``Trainer.fit`` for one epoch over 4 npz events with an EMA of the
   weights; ``TrackingPredictor`` serves one event from the epoch
   checkpoint (with the latent offset of phase 4), with beta and edge
   weights within 1e-5 of the plain path's and labels equal to them, ~2048
   tracks;
7. metric-learning training at ``examples/configs/ml.yml``'s width
   (``GraphConstructionFCNN(14, 256, 8, depth 5)``, the hinge loss with
   ``max_num_neighbors=256``, Adam 1e-3) with ``MLModule`` on a seeded
   32,768-hit point cloud (2048 particles, true edges between consecutive
   hits): step 0's gradients through the kernels against the plain path;
   the first step timed alone (the random model's compact latent, on which
   the top-k filter fills all 256 slots of most rows); ``ML_WARMUP`` steps
   in all, after which a step's cost is steady; then ``--ml-steps`` timed
   steps (steps/s, each step's time, peak memory, the top-k filter's
   launches per step) and the forward / loss / backward / Adam split of
   the 5 steps that follow them;
8. graph construction at 262,144 points, on three inputs: a hit cloud of
   16,384 particles embedded by the FCNN that phase 7 trained, its hits'
   3-d spatial coordinates, and the JAX package's kNN benchmark cloud
   (``bench.py:484-509``: 4,096 8-d clusters of 64 points). The briefly
   trained model's latent is not yet clustered, and on such a cloud the
   IVF's certification fails for most queries (the JAX package's notes say
   so of uniform 8-d clouds), so the IVF builds over the benchmark's cloud. Each
   cloud's cluster RMS radius and nearest-centroid distance are printed.
   (a) The kernels of the two exact full-detector builders, the IVF probe
   (benchmark cloud) and the banded top-k (spatial coordinates, d = 3, and
   the trained latent, d = 8), at the inputs that a build gives them: each
   against its plain version, bitwise equal on a second launch, timed
   beside its bound; the queries each certification leaves before its
   fallback. (c) Builds with ``MLGraphConstruction(max_num_neighbors=8,
   max_radius=1.0)`` over the trained latent (the resident top-k filter),
   ``knn_graph_ivf(k=8)`` over the benchmark cloud (certified: it widens
   the probe until ``n_uncert == 0``, and raises after 3 attempts) and
   ``knn_graph_windowed(k=8)`` over the spatial coordinates (where the
   principal-axis band certifies), the last two at their defaults, with
   their attempt counts. Each exact builder's neighbour sets must agree
   with the resident top-k's on the same input (ties aside) and a seeded
   sample of 4,096 queries of each input must match a plain brute force;
   it prints ms per build (the resident top-k on the benchmark cloud too)
   and the built graph's edge efficiency and purity;
9. a JSON line of per-kernel results, the ``nvidia-smi`` name/power line,
   and last the device JSON line.

Without CUDA, or without the package beside this script, it prints no
result and exits with code 2.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# serving configuration (GraphTCN at full width, DBSCAN as served)
N_NODES, N_EDGES, NODE_DIM, EDGE_DIM, LOCALITY = 32768, 262144, 14, 4, 1024
MODEL = {
    "node_indim": NODE_DIM, "edge_indim": EDGE_DIM, "h_dim": 32, "e_dim": 32,
    "h_outdim": 8, "hidden_dim": 128, "L_ec": 6, "L_hc": 3,
}
EPS, MIN_SAMPLES, CAP, N_TRACKS = 0.3, 1, 64, 2048
# H100 SXM data-sheet peaks (dense): f32 on the CUDA cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# training configuration (bench.py:538-591, extra_graphtcn): the same model
LOSS = {"max_n_objects": 2048, "object_block_size": 256}
LR = 1e-3
# metric-learning configuration (examples/configs/ml.yml): model, loss, Adam
ML_MODEL = {"in_dim": NODE_DIM, "hidden_dim": 256, "out_dim": 8, "depth": 5}
ML_LOSS = {"lw_repulsive": 0.5, "max_num_neighbors": 256}
ML_HITS, ML_PARTICLES = 32768, 2048
# graph construction at full-detector scale (bench.py:484-509, extra_knn)
# steps before phase 7's timed window: the random model's compact latent
# makes the first steps ~20x dearer, and by then it has spread
ML_WARMUP = 30
GC_HITS, GC_PARTICLES, GC_K, GC_RADIUS = 262144, 16384, 8, 1.0
LAYER_RADII = np.linspace(0.03, 1.0, 16)
TPU_KERNELS = {
    "fused_relational_fwd": "gnn_tracking_tpu/ops/pallas/fused_relational.py:373",
    "fused_relational_bwd": "gnn_tracking_tpu/ops/pallas/fused_relational.py:415",
    "sorted_segment_sum": "gnn_tracking_tpu/ops/pallas/csr_segment.py:162",
    "sorted_gather": "gnn_tracking_tpu/ops/pallas/csr_segment.py:212",
    "pairwise_topk_filter": "gnn_tracking_tpu/ops/pallas/pairwise_topk.py:466",
    "cc_neighbors": "gnn_tracking_tpu/ops/pallas/cc_kernel.py:93",
    "banded_topk_sorted": "gnn_tracking_tpu/ops/pallas/windowed_topk.py:173",
    "ivf_probe": "gnn_tracking_tpu/ops/pallas/ivf_probe.py:161",
}
SOURCES = {
    "fused_relational_fwd": "gnn_tracking_tpu_torch/csrc/fused_relational.cu",
    "fused_relational_bwd": "gnn_tracking_tpu_torch/csrc/fused_relational.cu",
    "sorted_segment_sum": "gnn_tracking_tpu_torch/csrc/csr_segment.cu",
    "sorted_gather": "gnn_tracking_tpu_torch/csrc/csr_segment.cu",
    "pairwise_topk_filter": "gnn_tracking_tpu_torch/csrc/pairwise_topk.cu",
    "cc_neighbors": "gnn_tracking_tpu_torch/csrc/cc_neighbors.cu",
    "banded_topk_sorted": "gnn_tracking_tpu_torch/csrc/banded_topk.cu",
    "ivf_probe": "gnn_tracking_tpu_torch/csrc/ivf_probe.cu",
}


def log(*parts):
    print(*parts, flush=True)


def make_event(seed: int):
    """Locality-structured candidate graph plus a particle-structured latent
    offset (``extras["serving_centers"]``): ~2048 tracks of ~16 hits."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N_NODES, NODE_DIM)).astype(np.float32)
    dst = np.sort(rng.integers(0, N_NODES, size=N_EDGES)).astype(np.int32)
    src = np.clip(dst + rng.integers(-LOCALITY, LOCALITY, size=N_EDGES), 0, N_NODES - 1)
    far = rng.random(N_EDGES) < 0.02
    src = np.where(far, rng.integers(0, N_NODES, size=N_EDGES), src).astype(np.int32)
    edge_attr = rng.normal(size=(N_EDGES, EDGE_DIM)).astype(np.float32)
    pid = rng.integers(0, N_TRACKS, size=N_NODES)
    centers = rng.normal(size=(N_TRACKS, 8)).astype(np.float32)
    latent = (centers[pid] + 0.02 * rng.normal(size=(N_NODES, 8))).astype(np.float32)
    return {
        "x": x, "edge_index": np.stack([src, dst]), "edge_attr": edge_attr,
        "y": pid[src] == pid[dst], "particle_id": pid,
        "extras": {"serving_centers": latent},
    }


def make_train_event(seed: int):
    """The bench's GraphTCN training event (``bench.py:548-563``): the
    serving event's graph with particle ids in [0, 2048) and per-particle
    pt, eta, all hits reconstructable."""
    ev = make_event(seed)
    rng = np.random.default_rng(seed + 1)
    pid = ev["particle_id"]
    src, dst = ev["edge_index"]
    return {
        "x": ev["x"], "edge_index": ev["edge_index"], "edge_attr": ev["edge_attr"],
        "y": (pid[src] == pid[dst]) & (pid[src] > 0), "particle_id": pid,
        "pt": (2 * rng.random(N_TRACKS))[pid], "eta": (8 * (rng.random(N_TRACKS) - 0.5))[pid],
        "reconstructable": np.ones(N_NODES),
    }


def make_point_cloud(seed: int, n_hits: int, n_particles: int):
    """Hits of straight tracks from the origin in a 16-layer barrel (radii
    0.03-1 m): particle ids in [0, n_particles) (0 = noise, each noise hit
    its own direction), per-particle pt in [0, 2) and eta in [-4, 4) as in
    the training phase; 14 node features (position, radius, direction,
    pseudorapidity, then noise); true edges between consecutive hits of each
    particle (point-cloud layout: ``edge_index``, no edge features). Extra:
    ``xyz``, the spatial coordinates."""
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, n_particles, size=n_hits)
    pt, eta, phi = 2 * rng.random(n_particles), 8 * (rng.random(n_particles) - 0.5), 2 * np.pi * rng.random(n_particles)
    noise = pid == 0
    eta_h = np.where(noise, 8 * (rng.random(n_hits) - 0.5), eta[pid])
    phi_h = np.where(noise, 2 * np.pi * rng.random(n_hits), phi[pid]) + 0.002 * rng.normal(size=n_hits)
    r = LAYER_RADII[rng.integers(0, len(LAYER_RADII), size=n_hits)]
    z = r * np.sinh(eta_h) + 0.001 * rng.normal(size=n_hits)
    xyz = np.stack([r * np.cos(phi_h), r * np.sin(phi_h), z], axis=1).astype(np.float32)
    x = np.concatenate([
        xyz, np.stack([r, np.cos(phi_h), np.sin(phi_h), np.arcsinh(z / r)], axis=1),
        rng.normal(size=(n_hits, NODE_DIM - 7)),
    ], axis=1).astype(np.float32)
    order = np.lexsort((r, pid))
    same = (pid[order][1:] == pid[order][:-1]) & (pid[order][1:] > 0)
    return {
        "x": x, "edge_index": np.stack([order[:-1][same], order[1:][same]]).astype(np.int32),
        "particle_id": pid, "pt": pt[pid], "eta": eta_h, "reconstructable": np.ones(n_hits),
        "extras": {"xyz": xyz},
    }


def make_bench_latent(seed: int, n: int) -> np.ndarray:
    """The JAX package's full-detector kNN benchmark cloud
    (``bench.py:484-509``, ``extra_knn``): ``n / 64`` unit-normal 8-d
    centres, each point a random centre plus 0.05 of unit-normal noise.
    Returns the points and their centres' ids, from 1."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n // 64, 8)).astype(np.float32)
    ids = rng.integers(0, n // 64, size=n)
    return centers[ids] + 0.05 * rng.normal(size=(n, 8)).astype(np.float32), ids + 1


def all_pairs(pid: np.ndarray) -> np.ndarray:
    """Every intra-particle hit pair once, noise (id 0) excluded: the true
    edges that the edge efficiency counts against (the JAX
    ``get_truth_edge_index``)."""
    order = np.argsort(pid, kind="stable")
    starts = np.flatnonzero(np.r_[True, pid[order][1:] != pid[order][:-1]])
    edges = []
    for a, b in zip(starts, np.r_[starts[1:], len(pid)]):
        if pid[order[a]] != 0 and b - a > 1:
            members = np.sort(order[a:b])
            iu = np.triu_indices(b - a, k=1)
            edges.append(np.stack([members[iu[0]], members[iu[1]]]))
    return np.concatenate(edges, axis=1).astype(np.int32)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time on the card (ms) and what bounds it: f32 operations at
    the CUDA-core peak, or bytes at the HBM rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def calibrate_ec_threshold(model, g) -> float:
    """Set the EC cut near the median edge weight of ``g``, so that about
    half of the edges reach the condensation layers. With random weights
    every edge weight falls below the default 0.5 and the cut would remove
    them all; a trained EC passes a share of them. The cut sits in the
    middle of the widest gap between adjacent weights of the middle tenth,
    so that rounding differences between the kernels and the plain path
    move no edge across it. The threshold goes into ``model_config``, so a
    checkpoint serves with it."""
    import torch

    with torch.no_grad():
        w = torch.sort(model.ec(g)["W"][g.edge_mask]).values
    lo, hi = int(0.45 * len(w)), int(0.55 * len(w))
    i = lo + int(torch.argmax(w[lo + 1 : hi + 1] - w[lo:hi]))
    threshold = float((w[i] + w[i + 1]) / 2)
    model.ec_threshold = threshold
    model.model_config["ec_threshold"] = threshold
    return threshold


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cuda_ms(fn, *, reps: int = 5, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` calls (CUDA
    events), after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_ms(fn, *, rounds: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def plain_path():
    """Route the port's kernel call sites to their plain versions: the
    fused relational forward and backward (which hold the sorted segment-sum
    and gather launches), the top-k filter, connected components, the banded
    top-k and the IVF probe."""
    from gnn_tracking_tpu_torch.ops import cc, fused_relational, ivf_knn, knn, windowed_topk
    from gnn_tracking_tpu_torch.ops.cc_kernel import cc_neighbors_plain
    from gnn_tracking_tpu_torch.ops.ivf_probe import ivf_probe_plain
    from gnn_tracking_tpu_torch.ops.pairwise_topk import pairwise_topk_filter_plain

    saved = (
        fused_relational.fused_relational_fwd, fused_relational.fused_relational_bwd,
        knn.pairwise_topk_filter, cc.cc_neighbors, windowed_topk.banded_topk_sorted,
        ivf_knn.ivf_probe,
    )
    fused_relational.fused_relational_fwd = (
        lambda *a, rowptr=None, **kw: fused_relational.fused_relational_plain(*a, **kw)
    )
    fused_relational.fused_relational_bwd = (
        lambda *a, **kw: fused_relational.fused_relational_bwd_plain(*a[:7], **kw)
    )
    knn.pairwise_topk_filter = pairwise_topk_filter_plain
    cc.cc_neighbors = cc_neighbors_plain
    windowed_topk.banded_topk_sorted = windowed_topk.banded_topk_sorted_plain
    ivf_knn.ivf_probe = ivf_probe_plain
    try:
        yield
    finally:
        (fused_relational.fused_relational_fwd, fused_relational.fused_relational_bwd,
         knn.pairwise_topk_filter, cc.cc_neighbors, windowed_topk.banded_topk_sorted,
         ivf_knn.ivf_probe) = saved


def compare_topk(kd, ki, pd, pi, boundary2):
    """Kernel vs plain top-k. Squared distances in the slots both fill agree
    within 1e-5 * max(boundary, max plain d^2); indices are identical except
    (a) rows whose differing entries lie within 1e-5 * boundary of a
    selection boundary (the radius; the k-th distance in kNN mode, and in
    radius mode on a row whose k slots are all filled) and (b) swaps of
    equal-distance neighbours. Returns (max_abs_err, n_boundary_rows,
    n_tie_rows)."""
    import torch

    fin_k, fin_p = torch.isfinite(kd), torch.isfinite(pd)
    assert torch.equal(fin_k, fin_p) or boundary2 is not None, "filled slots differ"
    both = fin_k & fin_p
    err = (kd - pd).abs()[both].max().item() if both.any() else 0.0
    scale = max(boundary2 or 0.0, pd[fin_p].abs().max().item() if fin_p.any() else 0.0)
    assert err <= 1e-5 * scale, f"squared distances: max|err| {err} > {1e-5 * scale}"
    bad_rows = ((ki != pi) | (fin_k != fin_p)).any(dim=1).nonzero().flatten().tolist()
    n_boundary = n_tie = 0
    for r in bad_rows:
        dk, dp = kd[r], pd[r]
        bounds = [] if boundary2 is None else [boundary2]
        if boundary2 is None or bool(fin_p[r].all()):
            bounds.append(pd[r][fin_p[r]].max().item())
        sk = set(ki[r][fin_k[r]].tolist())
        sp = set(pi[r][fin_p[r]].tolist())
        if sk == sp:
            assert torch.allclose(dk[fin_k[r]], dp[fin_p[r]], rtol=1e-5, atol=1e-7), r
            n_tie += 1
            continue
        # the differing members must sit on the boundary
        diff_d = [dk[j].item() for j in range(kd.shape[1]) if fin_k[r, j] and ki[r, j].item() not in sp]
        diff_d += [dp[j].item() for j in range(pd.shape[1]) if fin_p[r, j] and pi[r, j].item() not in sk]
        assert all(any(abs(d - b) <= 1e-5 * max(b, 1e-30) for b in bounds) for d in diff_d), (
            f"row {r}: {sorted(sk ^ sp)} at {diff_d}, boundaries {bounds}")
        n_boundary += 1
    return err, n_boundary, n_tie


def profile_run(fn, name: str):
    """``torch.profiler`` over ``fn()``: device time by kernel name, and the
    device's busy and idle share of the wall time. The Chrome trace goes to
    ``<name>_trace.json`` in the output directory beside this script."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    # device busy time = union of the device-side intervals (kernels, copies)
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in spans:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    device_ms = busy_us / 1e3
    log(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=20, max_name_column_width=60))
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / f"{name}_trace.json"))
    log(f"profile {name}: " + json.dumps({
        "wall_ms": wall_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms, "device_idle_share": 1 - device_ms / wall_ms,
    }))


def compare_grads(gk: dict, gp: dict):
    """Step-0 parameter gradients through the kernels (``gk``) against the
    plain path's (``gp``): per tensor, |g_kernel - g_plain| <= 1e-4
    |g_plain|, plus a floor of 1e-7 of the whole gradient's norm (an exact
    zero gradient, such as a bias the loss cannot see, is computed as
    rounding noise, and noise has no relative error). Returns the worst
    relative tensor, its error, the tensors within the floor only, the
    parameters without a gradient in both, and the total norm."""
    import torch

    no_grad = [n for n in gp if gp[n] is None]
    total = math.sqrt(sum(gp[n].square().sum().item() for n in gp if gp[n] is not None))
    worst_name, worst, at_floor = None, 0.0, []
    for name in gk:
        if gp[name] is None:
            assert gk[name] is None, f"{name}: a gradient through the kernels only"
            continue
        assert gk[name] is not None, f"{name}: no gradient through the kernels"
        assert torch.isfinite(gk[name]).all(), f"{name}: non-finite gradient"
        diff = (gk[name] - gp[name]).norm().item()
        ref = gp[name].norm().item()
        assert diff <= 1e-4 * ref + 1e-7 * total, (
            f"{name}: |g_kernel - g_plain| {diff:.3e} > 1e-4 x {ref:.3e} + 1e-7 x {total:.3e}")
        if diff > 1e-4 * ref:
            at_floor.append(f"{name} ({ref:.1e})")
        elif ref > 0 and diff / ref >= worst:
            worst_name, worst = name, diff / ref
    return worst_name, worst, at_floor, no_grad, total


def step_split(module, g, rounds: int = 5) -> dict:
    """Median forward / loss / backward / optimizer times (ms) of one
    training step, each stage ended by a synchronise."""
    import torch

    def once():
        times = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        module.model.train()
        out = module.model(g)
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        loss, _ = module.get_losses(out, g)
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        module.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        module.optimizer.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        return [(b - a) * 1e3 for a, b in zip([t, *times[:-1]], times)]

    splits = [once() for _ in range(rounds)]
    return {k: statistics.median(s[i] for s in splits)
            for i, k in enumerate(("forward_ms", "loss_ms", "backward_ms", "optimizer_ms"))}


def training_kernel_phases(tcn, g, seed: int) -> list[dict]:
    """Rows #2, #9 and #10 at the HC layer's shapes, each against its plain
    version on the card; rows #2 and #9 must repeat bit for bit."""
    import torch

    from gnn_tracking_tpu_torch.ops import csr_segment
    from gnn_tracking_tpu_torch.ops import fused_relational as fr

    dev = g.x.device
    csr = g.csr()
    rowptr, dst = csr["dst_rowptr"], g.edge_index[1]
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    results = []
    with torch.no_grad():
        # HC layer 1: relu'd node encodings, raw edge encodings (so that the
        # in-kernel ReLU of relu_edge has negative inputs to cut)
        x = torch.relu(tcn.hc_node_encoder(g.x)).contiguous()
        ea = tcn.hc_edge_encoder(g.edge_attr).contiguous()
        weights = {k: v.detach() for k, v in tcn.hc_in.layers[1].relational_weights().items()}
        mask = torch.from_numpy(np.random.default_rng(seed + 3).random(N_EDGES) < 0.8).to(dev)
        fo = weights["w3"].shape[0]
        g_e = torch.randn((N_EDGES, fo), generator=gen, device=dev)
        g_a = torch.randn((N_NODES, fo), generator=gen, device=dev)
        args = (x, ea, g.edge_index, mask, weights, g_e, g_a)
        args64 = (x.double(), ea.double(), g.edge_index, mask,
                  {k: v.double() for k, v in weights.items()}, g_e.double(), g_a.double())

        def named(out):
            return {"g_x": out[0], "g_edge_attr": out[1], **out[2]}

        err2 = 0.0
        for relu_edge in (False, True):
            k_out = named(fr.fused_relational_bwd(*args, csr, relu_edge=relu_edge))
            k_again = named(fr.fused_relational_bwd(*args, csr, relu_edge=relu_edge))
            p_out = named(fr.fused_relational_bwd_plain(*args, relu_edge=relu_edge))
            r_out = named(fr.fused_relational_bwd_plain(*args64, relu_edge=relu_edge))
            torch.cuda.synchronize()
            worst = []
            for name, kt in k_out.items():
                assert torch.equal(kt, k_again[name]), f"fused_relational_bwd {name}: second launch differs"
                ek = (kt.double() - r_out[name]).abs().max().item()
                ep = (p_out[name].double() - r_out[name]).abs().max().item()
                assert math.isfinite(ek) and ek <= 4 * ep, (
                    f"fused_relational_bwd {name} relu_edge={relu_edge}: kernel err {ek:.3e} "
                    f"> 4 x plain f32 err {ep:.3e} (against float64)")
                worst.append(f"{name} {ek:.2e}/{ep:.2e}")
                err2 = max(err2, ek)
            log(f"  fused_relational_bwd relu_edge={relu_edge}: max|err| vs float64, kernel/plain f32: "
                + ", ".join(worst))
        ms2 = cuda_ms(lambda: fr.fused_relational_bwd(*args, csr))
        plain2 = cuda_ms(lambda: fr.fused_relational_bwd_plain(*args))
        fx, fe, hid = x.shape[1], ea.shape[1], weights["w2"].shape[0]
        n_valid = int(mask.sum())
        # per unmasked edge: recompute of h1 and h2 (the output layer is
        # linear, its value unused), input gradients of the three layers and
        # their weight gradients
        k2 = 2 * fx + fe
        flops2 = 2.0 * n_valid * (3 * k2 * hid + 3 * hid * hid + 2 * hid * fo)
        outs2 = named(fr.fused_relational_bwd(*args, csr))
        bytes2 = nbytes(*args[:4], *weights.values(), g_e, g_a, *csr.values(), *outs2.values())
        bound2, by2 = bound(flops2, bytes2)
        results.append({"name": "fused_relational_bwd", "max_abs_err": err2, "ms": ms2,
                        "plain_ms": plain2, "bound_ms": bound2, "bound_by": by2, "library_ms": None})
        log(f"kernel fused_relational_bwd: OK (each output within 4x the plain f32 error against "
            f"float64, repeat bitwise); {ms2:.3f} ms (plain {plain2:.3f} ms, bound {bound2:.4f} ms, "
            f"{flops2 / 1e9:.1f} GFLOP f32 at {n_valid} unmasked edges)")

        # row #9: target side (contiguous rows) and source side (through src_perm)
        msgs = torch.randn((N_EDGES, fo), generator=gen, device=dev)
        k9 = csr_segment.sorted_segment_sum(msgs, dst, N_NODES, rowptr=rowptr)
        k9b = csr_segment.sorted_segment_sum(msgs, dst, N_NODES, rowptr=rowptr)
        p9 = csr_segment.sorted_segment_sum_plain(msgs, dst, N_NODES)
        k9s = csr_segment.segment_sum_csr(msgs, csr["src_rowptr"], perm=csr["src_perm"])
        p9s = csr_segment.sorted_segment_sum_plain(msgs, g.edge_index[0], N_NODES)
        offsets = rowptr.long()
        lib9_out = torch.segment_reduce(msgs, "sum", offsets=offsets, unsafe=True)
        torch.cuda.synchronize()
        assert torch.equal(k9, k9b), "sorted_segment_sum: second launch differs"
        err9 = (k9 - p9).abs().max().item()
        lim9 = 1e-6 * p9.abs().max().item()
        assert err9 <= lim9, f"sorted_segment_sum: {err9} > {lim9}"
        # the source side has segments of ~4000 edges (the generator clips
        # sources at nodes 0 and N-1), where f32 sums in any order miss by
        # more than 1e-6 of the largest sum: hold each node to the bound of
        # recursive summation against float64, (count - 1) * 2^-24 * sum |m|
        src_long = g.edge_index[0].long()
        ref9s = torch.zeros((N_NODES, fo), dtype=torch.float64, device=dev).index_add_(
            0, src_long, msgs.double())
        abs9s = torch.zeros_like(ref9s).index_add_(0, src_long, msgs.double().abs())
        count = torch.bincount(src_long, minlength=N_NODES).double()[:, None]
        slack = (k9s.double() - ref9s).abs() - (count - 1).clamp(min=0) * 2.0**-24 * abs9s
        assert slack.max().item() <= 0, f"sorted_segment_sum (source side): beyond the bound by {slack.max().item()}"
        err9s = (k9s - p9s).abs().max().item()
        ms9 = cuda_ms(lambda: csr_segment.sorted_segment_sum(msgs, dst, N_NODES, rowptr=rowptr))
        ms9s = cuda_ms(lambda: csr_segment.segment_sum_csr(
            msgs, csr["src_rowptr"], perm=csr["src_perm"]))
        plain9 = cuda_ms(lambda: csr_segment.sorted_segment_sum_plain(msgs, dst, N_NODES))
        lib9 = cuda_ms(lambda: torch.segment_reduce(msgs, "sum", offsets=offsets, unsafe=True))
        bound9, by9 = bound(float(N_EDGES * fo), nbytes(msgs, rowptr, p9))
        results.append({"name": "sorted_segment_sum", "max_abs_err": max(err9, err9s), "ms": ms9,
                        "plain_ms": plain9, "bound_ms": bound9, "bound_by": by9, "library_ms": lib9})
        log(f"kernel sorted_segment_sum: OK max|err| {err9:.3e} (source side through src_perm "
            f"{err9s:.3e}), repeat bitwise; {ms9:.4f} ms (source side, random row reads: "
            f"{ms9s:.4f} ms; plain {plain9:.4f} ms; torch.segment_reduce {lib9:.4f} ms, "
            f"max|diff| {(lib9_out - p9).abs().max().item():.3e}; bound {bound9:.4f} ms)")

        # row #10
        vals = torch.randn((N_NODES, fo), generator=gen, device=dev)
        k10 = csr_segment.sorted_gather(vals, dst, rowptr=rowptr)
        p10 = csr_segment.sorted_gather_plain(vals, dst)
        torch.cuda.synchronize()
        assert torch.equal(k10, p10), "sorted_gather differs from index_select"
        ms10 = cuda_ms(lambda: csr_segment.sorted_gather(vals, dst, rowptr=rowptr))
        plain10 = cuda_ms(lambda: csr_segment.sorted_gather_plain(vals, dst))
        lib10 = cuda_ms(lambda: torch.index_select(vals, 0, dst))
        bound10, by10 = bound(0.0, nbytes(vals, dst, p10))
        results.append({"name": "sorted_gather", "max_abs_err": 0.0, "ms": ms10,
                        "plain_ms": plain10, "bound_ms": bound10, "bound_by": by10,
                        "library_ms": lib10})
        log(f"kernel sorted_gather: OK bitwise equal to index_select; {ms10:.4f} ms (plain "
            f"{plain10:.4f} ms, torch.index_select {lib10:.4f} ms, bound {bound10:.4f} ms)")
    return results


def training_path(seed: int, steps: int, counters: dict, profile: bool) -> tuple[dict, dict]:
    """The GraphTCN training step at full width: step 0's gradients against
    the plain path on this card, then ``steps`` timed steps. Returns the
    summary and the kernel launches over the timed steps."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.losses.oc import CondensationLossTiger
    from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN
    from gnn_tracking_tpu_torch.training.module import TCModule

    dev = torch.device("cuda")
    g = EventGraph.from_arrays(**make_train_event(seed + 5)).sort_edges_by_target().to(dev)
    model = GraphTCN(**MODEL, device="cpu", generator=torch.Generator().manual_seed(seed + 2))
    module = TCModule(model=model, loss_fct=CondensationLossTiger(**LOSS), lr=LR, device="cuda")
    module.setup_params(g)
    threshold = calibrate_ec_threshold(model, g)

    def step0():
        model.train()
        model.zero_grad(set_to_none=True)
        out = model(g)
        loss, _ = module.get_losses(out, g)
        loss.backward()
        loss = loss.detach()
        grads = {n: None if p.grad is None else p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return grads, out["ec_edge_mask"].detach().clone(), loss.item()

    for fn in counters.values():
        fn.launches = 0
    gk, mk, lk = step0()
    step0_launches = {name: fn.launches for name, fn in counters.items()}
    with plain_path():
        gp, mp, lp = step0()
    n_cut_diff = int((mk != mp).sum())
    worst_name, worst, at_floor, no_grad, total = compare_grads(gk, gp)
    assert no_grad and all(n.startswith("ec.") for n in no_grad), no_grad
    assert all(step0_launches[k] > 0 for k in step0_launches), step0_launches
    log(f"training step 0: loss {lk:.6f} (plain {lp:.6f}); {len(gk) - len(no_grad)} parameter "
        f"gradients agree with the plain path (worst {worst_name}: {worst:.3e} relative; within "
        f"the floor of 1e-7 x {total:.3e} only: {at_floor or 'none'}); "
        f"{len(no_grad)} EC parameters without gradient in both; EC cut at {threshold:.6f} keeps "
        f"{int(mk.sum())} of {int(mk.numel())} edges; mask entries that differ between the "
        f"paths: {n_cut_diff}")

    for _ in range(2):
        module.training_step(g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = module.training_step(g)
    dt = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, n in launches.items():
        assert n > 0, f"training path never launched {name}"
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert all(math.isfinite(v) for v in metrics.values()), metrics

    split = step_split(module, g)
    summary = {
        "steps": steps, "steps_per_s": steps / dt, "step_ms": dt / steps * 1e3, **split,
        "peak_mem_gib": peak, "launches_per_step": {k: v / steps for k, v in launches.items()},
        "total": metrics["total"],
    }
    log("training: " + json.dumps(summary))
    if profile:
        profile_run(lambda: [module.training_step(g) for _ in range(3)], "training")
    return summary, launches


def fit_and_serve(seed: int, tmp: Path, condensed) -> None:
    """``Trainer.fit`` for one epoch over 4 npz events with an EMA of the
    weights, then serve the first event from the epoch checkpoint, on the
    kernels and on the plain path. Its beta and edge weights must agree
    within 1e-5 of their largest value. The briefly trained latent is not
    yet separated, so for labels the served model gets the event's
    particle-structured latent offset (``condensed``); they must equal the
    plain path's and hold many tracks."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.inference import TrackingPredictor
    from gnn_tracking_tpu_torch.losses.oc import CondensationLossTiger
    from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN
    from gnn_tracking_tpu_torch.training.module import TCModule
    from gnn_tracking_tpu_torch.training.trainer import Trainer
    from gnn_tracking_tpu_torch.utils.loading import TrackingDataModule, load_graph, save_graph

    train_dir = tmp / "train"
    train_dir.mkdir()
    for i in range(4):
        save_graph(EventGraph.from_arrays(**make_train_event(seed + 60 + i)), train_dir / f"ev{i:02d}.npz")
    model = GraphTCN(**MODEL, device="cpu", generator=torch.Generator().manual_seed(seed + 4))
    module = TCModule(model=model, loss_fct=CondensationLossTiger(**LOSS), lr=LR, device="cuda")
    calibrate_ec_threshold(model, load_graph(train_dir / "ev00.npz", device="cuda").sort_edges_by_target())
    dm = TrackingDataModule(train={"dirs": [train_dir]}, val={"dirs": [train_dir], "stop": 1}, seed=seed)
    trainer = Trainer(max_epochs=1, log_dir=tmp / "runs", name="smoke", ema_decay=0.998,
                      print_validation_results=False)
    t0 = time.perf_counter()
    val = trainer.fit(module, dm)
    fit_s = time.perf_counter() - t0
    assert module.step == 4 and len(trainer.checkpoints) == 1, (module.step, trainer.checkpoints)
    assert math.isfinite(val["total"]), val
    params = dict(model.named_parameters())
    assert any(not torch.equal(e, params[k]) for k, e in trainer.ema_params.items()), "EMA == raw"
    predictor = TrackingPredictor(trainer.checkpoints[-1], eps=EPS, min_samples=MIN_SAMPLES,
                                  max_num_neighbors=CAP, device="cuda")
    predictor.model = condensed(predictor.model).eval()
    # ev00's graph, with its latent offset in extras
    graph = EventGraph.from_arrays(**make_event(seed + 60))
    got = predictor.predict(graph)
    with plain_path():
        want = predictor.predict(graph)
    errs = {}
    for key in ("beta", "w"):
        assert np.isfinite(got[key]).all(), key
        errs[key] = float(np.abs(got[key] - want[key]).max())
        lim = 1e-5 * float(np.abs(want[key]).max())
        assert errs[key] <= lim, f"checkpoint {key}: max|kernel - plain| {errs[key]:.3e} > {lim:.3e}"
    assert np.array_equal(got["labels"], want["labels"]), "checkpoint labels differ from the plain path"
    n_clusters = int(got["labels"].max()) + 1
    assert got["labels"].shape == (N_NODES,) and 0.9 * N_TRACKS <= n_clusters <= N_TRACKS, n_clusters
    log(f"Trainer.fit: {module.step} steps in {fit_s:.1f} s (EMA 0.998, validation on the EMA "
        f"weights: total {val['total']:.6f}); {trainer.checkpoints[-1].name} served on the card: "
        f"max|kernel - plain| beta {errs['beta']:.3e}, w {errs['w']:.3e}; labels equal to the "
        f"plain path's ({n_clusters} clusters)")


def cluster_geometry(h, pid) -> dict:
    """How tight the particles' clusters are in the latent ``h``: for each
    particle of at least 2 hits (noise, id 0, excluded), the RMS distance of
    its hits to their centroid and the distance from that centroid to the
    nearest other particle's; their medians, and the median of the ratio."""
    import torch

    keep = pid > 0
    hk = h[keep].float()
    ids, inv, counts = torch.unique(pid[keep], return_inverse=True, return_counts=True)
    cnt = counts.float()
    cent = torch.zeros((len(ids), h.shape[1]), device=h.device).index_add_(0, inv, hk) / cnt[:, None]
    sq = ((hk - cent[inv]) ** 2).sum(dim=1)
    rms = torch.sqrt(torch.zeros(len(ids), device=h.device).index_add_(0, inv, sq) / cnt)
    nearest = []
    for s in range(0, len(ids), 2048):
        d = torch.cdist(cent[s : s + 2048], cent)
        rows = torch.arange(d.shape[0], device=h.device)
        d[rows, s + rows] = math.inf
        nearest.append(d.amin(dim=1))
    nearest = torch.cat(nearest)
    multi = counts > 1
    return {"rms_radius_median": rms[multi].median().item(),
            "nearest_centroid_median": nearest[multi].median().item(),
            "rms_over_nearest_median": (rms / nearest)[multi].median().item()}


def ml_training_path(seed: int, steps: int, profile: bool):
    """Metric-learning training at ``ml.yml``'s width on a 32,768-hit point
    cloud (see the module docstring, phase 7); row #12 (radius mode, k =
    256) against its plain version and timed at step 0 and after the timed
    window. Returns the summary and the trained model."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.losses.metric_learning import GraphConstructionHingeEmbeddingLoss
    from gnn_tracking_tpu_torch.models.graph_construction import GraphConstructionFCNN
    from gnn_tracking_tpu_torch.ops import pairwise_topk
    from gnn_tracking_tpu_torch.training.module import MLModule

    topk = pairwise_topk.pairwise_topk_filter
    g = EventGraph.from_arrays(**make_point_cloud(seed + 80, ML_HITS, ML_PARTICLES)).to("cuda")
    model = GraphConstructionFCNN(**ML_MODEL, device="cpu", generator=torch.Generator().manual_seed(seed + 81))
    module = MLModule(model=model, loss_fct=GraphConstructionHingeEmbeddingLoss(**ML_LOSS), lr=LR,
                      device="cuda")
    module.setup_params(g)

    def step0():
        model.train()
        model.zero_grad(set_to_none=True)
        loss, metrics = module.get_losses(model(g), g)
        loss.backward()
        grads = {n: None if p.grad is None else p.grad.detach().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return grads, loss.item(), int(metrics["n_edges_rep"])

    topk.launches = 0
    gk, lk, rep_k = step0()
    assert topk.launches == 1, topk.launches
    with plain_path():
        gp, lp, rep_p = step0()
    worst_name, worst, at_floor, no_grad, total = compare_grads(gk, gp)
    assert not no_grad, no_grad
    log(f"ML step 0: loss {lk:.6f} (plain {lp:.6f}); {len(gk)} parameter gradients agree with the "
        f"plain path (worst {worst_name}: {worst:.3e} relative; within the floor of 1e-7 x "
        f"{total:.3e} only: {at_floor or 'none'}); repulsive edges {rep_k} (plain {rep_p})")

    def radius_topk(when: str) -> dict:
        """Row #12 in the loss's radius mode on the model's current latent:
        kernel against plain, and both timed."""
        with torch.no_grad():
            h = model(g)["H"].detach().contiguous()
        k, r2 = ML_LOSS["max_num_neighbors"], ML_LOSS.get("r_emb", 1.0) ** 2 * (1.0 + 1e-3)
        kd, ki = topk(h, k=k, radius2=r2)
        pd, pi = pairwise_topk.pairwise_topk_filter_plain(h, k=k, radius2=r2)
        torch.cuda.synchronize()
        err, nb, nt = compare_topk(kd, ki, pd, pi, r2)
        filled = torch.isfinite(kd).sum(dim=1).float()
        ms = cuda_ms(lambda: topk(h, k=k, radius2=r2), reps=1, rounds=5)
        plain = cuda_ms(lambda: pairwise_topk.pairwise_topk_filter_plain(h, k=k, radius2=r2),
                        reps=1, rounds=3)
        log(f"  pairwise_topk_filter, radius mode at k = {k} on the ML latent {when} ({ML_HITS} "
            f"hits): agrees with the plain version (max|err| {err:.3e}, {nb} boundary rows, {nt} "
            f"tie rows); filled slots per hit mean {filled.mean().item():.1f}, max "
            f"{int(filled.max())}; {ms:.3f} ms (plain {plain:.3f} ms)")
        return {"ms": ms, "plain_ms": plain, "filled_mean": filled.mean().item(),
                "full_rows": int((filled == k).sum()), "clusters": cluster_geometry(h, g.particle_id)}

    topk_step0 = radius_topk("at step 0")
    # each step ends in its metrics' transfer to the host, so the host clock
    # times it whole; the first steps pay for the compact latent
    warmup_ms = []
    while module.step < ML_WARMUP:
        t = time.perf_counter()
        module.training_step(g)
        warmup_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.reset_peak_memory_stats()
    topk.launches = 0
    ticks = [time.perf_counter()]
    for _ in range(steps):
        metrics = module.training_step(g)
        ticks.append(time.perf_counter())
    dt = ticks[-1] - ticks[0]
    launches = topk.launches
    assert launches > 0, "ML training never launched pairwise_topk_filter"
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    peak = torch.cuda.max_memory_allocated() / 2**30
    each = [(b - a) * 1e3 for a, b in zip(ticks, ticks[1:])]
    summary = {
        "first_step_ms": warmup_ms[0], "warmup_step_ms": warmup_ms,
        "window": f"steps {ML_WARMUP + 1}-{ML_WARMUP + steps}", "steps": steps,
        "steps_per_s": steps / dt, "step_ms": dt / steps * 1e3, "step_ms_each": each,
        "window_max_over_min": max(each) / min(each), "peak_mem_gib": peak,
        "pairwise_topk_filter_launches_per_step": launches / steps,
    }
    # step_split's 5 rounds are optimizer steps outside module.step's count
    done = module.step
    summary.update({
        "split_window": f"steps {done + 1}-{done + 5}", **step_split(module, g),
        "radius_topk_step0": topk_step0, "radius_topk_trained": radius_topk(f"after {done + 5} steps"),
        "total": metrics["total"], "n_edges_rep": metrics["n_edges_rep"],
        "n_edges_att": metrics["n_edges_att"],
    })
    log("ml training: " + json.dumps(summary))
    if profile:
        profile_run(lambda: [module.training_step(g) for _ in range(3)], "ml_training")
    return summary, model


def capture(module, name: str):
    """Wrap ``module.name`` to record the arguments of its calls (and
    still call it); returns the record and an undo function."""
    calls = []
    fn = getattr(module, name)

    def recording(*a, **kw):
        calls.append((a, kw))
        return fn(*a, **kw)

    # the wrapper counts a launch on whatever its module's name holds,
    # which is this recorder while it is in place
    recording.launches = 0
    setattr(module, name, recording)
    return calls, lambda: setattr(module, name, fn)


def compare_neighbours(what: str, a, b, k: int) -> int:
    """Two exact kNN graphs (``(edge_index, mask, dists)``, query-major with
    ``k`` slots) agree: the same slots are filled, each row's sorted
    distances agree within 1e-5 relative, and a row whose neighbour set
    differs has the same distances (a tie). Returns the number of tie rows."""
    import torch

    (ea, ma, da), (eb, mb, db) = a, b
    assert torch.equal(ma, mb), f"{what}: filled slots differ"
    n = ma.numel() // k
    da = torch.sort(torch.where(ma, da, 0.0).view(n, k), dim=1).values
    db = torch.sort(torch.where(mb, db, 0.0).view(n, k), dim=1).values
    err = (da - db).abs().max().item()
    assert err <= 1e-5 * db.max().item(), f"{what}: distances differ by {err}"
    ia = torch.sort(torch.where(ma, ea[0], -1).view(n, k), dim=1).values
    ib = torch.sort(torch.where(mb, eb[0], -1).view(n, k), dim=1).values
    return int((ia != ib).any(dim=1).sum())


def brute_sample(x, ei, mask, dists, k: int, seed: int, n_sample: int = 4096) -> int:
    """A seeded sample of queries against a plain brute force on the card
    (direct float32 distances, stable sort): the built graph's sorted
    distances within 1e-5 relative, its neighbour sets equal up to ties.
    Returns the number of tie rows."""
    import torch

    n = x.shape[0]
    rows = torch.from_numpy(np.random.default_rng(seed).choice(n, n_sample, replace=False)).to(x.device)
    want_d, want_i = [], []
    for s in range(0, n_sample, 512):
        q = rows[s : s + 512]
        dist = torch.zeros((len(q), n), device=x.device)
        for j in range(x.shape[1]):
            dist += (x[q, j, None] - x[None, :, j]) ** 2
        dist[torch.arange(len(q), device=x.device), q] = math.inf
        sd, si = torch.sort(dist, dim=1, stable=True)
        want_d.append(torch.sqrt(sd[:, :k]))
        want_i.append(si[:, :k])
    want_d, want_i = torch.cat(want_d), torch.cat(want_i)
    m = mask.view(n, k)[rows]
    assert m.all(), "a sampled query has fewer than k neighbours"
    got_d = torch.sort(dists.view(n, k)[rows], dim=1).values
    err = (got_d - want_d).abs().max().item()
    assert err <= 1e-5 * want_d.max().item(), f"brute-force sample: distances differ by {err}"
    got_i = torch.sort(ei[0].view(n, k)[rows].long(), dim=1).values
    return int((got_i != torch.sort(want_i, dim=1).values).any(dim=1).sum())


def graph_construction_phase(seed: int, fcnn) -> tuple[list[dict], dict]:
    """Kernel phases of rows #14 and #15 at the inputs a full-detector build
    gives them, then the three builders at 262,144 points (see the module
    docstring); ``fcnn`` is phase 7's trained model. Returns the two
    kernels' results and the summary."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.metrics.graph_construction import get_efficiency_purity_edges
    from gnn_tracking_tpu_torch.models.graph_construction import MLGraphConstruction
    from gnn_tracking_tpu_torch.ops import ivf_knn, ivf_probe, knn, pairwise_topk, windowed_topk

    cloud = make_point_cloud(seed + 90, GC_HITS, GC_PARTICLES)
    del cloud["edge_index"]
    te = torch.from_numpy(all_pairs(cloud["particle_id"]))
    g = EventGraph.from_arrays(**cloud).replace(
        true_edge_index=te, true_edge_mask=torch.ones(te.shape[1], dtype=torch.bool)).to("cuda")
    fcnn = fcnn.eval()
    gc = MLGraphConstruction(fcnn, max_num_neighbors=GC_K, max_radius=GC_RADIUS).eval()
    with torch.no_grad():
        latent = fcnn(g)["H"].contiguous()
    xyz = g.extras["xyz"].contiguous()
    bench, bench_ids = (torch.from_numpy(a).to("cuda") for a in make_bench_latent(seed + 92, GC_HITS))
    geometry = {"trained": cluster_geometry(latent, g.particle_id),
                "bench": cluster_geometry(bench, bench_ids)}
    log(f"graph construction latents ({GC_HITS} points): phase 7's FCNN on hits of {GC_PARTICLES} "
        f"particles, and the JAX benchmark's cloud of 64-point clusters: " + json.dumps(geometry))

    # ---- (a) rows #15 and #14 at the inputs of one build each ---------------
    # (first attempts at the default widths, without their fallbacks: the
    # kernel checks need no certification; the counts are the queries each
    # certification would leave to its fallback)
    probe_calls, undo = capture(ivf_knn, "ivf_probe")
    _, _, n_unc_ivf, stats = ivf_knn.ivf_knn(bench, k=GC_K, fallback=False, return_stats=True)
    undo()
    band_calls, undo = capture(windowed_topk, "banded_topk_sorted")
    uncertified = {
        "ivf_probe8_bench": int(n_unc_ivf),
        "ivf_probe8_trained": int(ivf_knn.ivf_knn(latent, k=GC_K, fallback=False)[2]),
        "band_radius4_spatial": int(windowed_topk.windowed_knn(xyz, k=GC_K, fallback_cap=0)[2]),
        "band_radius4_trained": int(windowed_topk.windowed_knn(latent, k=GC_K, fallback_cap=0)[2]),
    }
    undo()
    assert len(probe_calls) == 1 and len(band_calls) == 2
    results = []

    pa, pkw = probe_calls[0]
    xb, ib, xc, ic, nbr = pa
    kd, ki = ivf_probe.ivf_probe(*pa, **pkw)
    kd2, ki2 = ivf_probe.ivf_probe(*pa, **pkw)
    pd, pi = ivf_probe.ivf_probe_plain(*pa, **pkw)
    torch.cuda.synchronize()
    assert torch.equal(kd, kd2) and torch.equal(ki, ki2), "ivf_probe: second launch differs"
    err15, nb15, nt15 = compare_topk(kd, ki, pd, pi, None)
    ms15 = cuda_ms(lambda: ivf_probe.ivf_probe(*pa, **pkw))
    plain15 = cuda_ms(lambda: ivf_probe.ivf_probe_plain(*pa, **pkw), reps=1, rounds=3)
    # the pairs this table needs: valid query slots x valid candidate slots
    # of the probed cells, at 3 flops per dimension
    nq = (xb[..., 0].abs() < 1e29).sum(dim=1).double()
    nc = (xc[..., 0].abs() < 1e29).sum(dim=1).double()
    pairs15 = float((nq * nc[nbr.long()].sum(dim=1)).sum())
    d = xb.shape[2]
    bound15, by15 = bound(3.0 * d * pairs15, nbytes(*pa, kd, ki))
    results.append({"name": "ivf_probe", "max_abs_err": err15, "ms": ms15, "plain_ms": plain15,
                    "bound_ms": bound15, "bound_by": by15, "library_ms": None})
    log(f"kernel ivf_probe: OK max|err| {err15:.3e} ({nb15} k-th boundary rows, {nt15} tie-order "
        f"rows), repeat bitwise; C={xb.shape[0]} cap={xb.shape[1]} capc={xc.shape[1]} T={nbr.shape[1]} "
        f"kw={pkw['kw']}; {ms15:.3f} ms (plain {plain15:.3f} ms, bound {bound15:.4f} ms by {by15}, "
        f"{pairs15:.3e} valid pairs of {float(xb.shape[0] * xb.shape[1] * nbr.shape[1] * xc.shape[1]):.3e} "
        f"in the table); IVF stats {stats}")

    band = {}
    for what, (ba, bkw) in zip(("spatial", "trained"), band_calls):
        kd, ki = windowed_topk.banded_topk_sorted(*ba, **bkw)
        kd2, ki2 = windowed_topk.banded_topk_sorted(*ba, **bkw)
        pd, pi = windowed_topk.banded_topk_sorted_plain(*ba, **bkw)
        torch.cuda.synchronize()
        assert torch.equal(kd, kd2) and torch.equal(ki, ki2), f"banded_topk_sorted ({what}): second launch differs"
        err, nb, nt = compare_topk(kd, ki, pd, pi, None)
        ms = cuda_ms(lambda: windowed_topk.banded_topk_sorted(*ba, **bkw))
        plain = cuda_ms(lambda: windowed_topk.banded_topk_sorted_plain(*ba, **bkw), reps=1, rounds=3)
        xs, valid = ba[0], bkw["valid"]
        lo, hi = windowed_topk._band(xs.shape[0], bkw["block_q"], bkw["block_c"], bkw["radius"],
                                     torch.arange(xs.shape[0], device=xs.device))
        pairs = float(((hi - lo) * valid).sum())
        bnd, by = bound(3.0 * xs.shape[1] * pairs, nbytes(xs, valid, kd, ki))
        band[what] = {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
                      "d": xs.shape[1], "pairs": pairs}
        log(f"kernel banded_topk_sorted ({what}): OK max|err| {err:.3e} ({nb} k-th boundary rows, "
            f"{nt} tie-order rows), repeat bitwise; N={xs.shape[0]} d={xs.shape[1]} "
            f"radius={bkw['radius']} block_q={bkw['block_q']} block_c={bkw['block_c']}; {ms:.3f} ms "
            f"(plain {plain:.3f} ms, bound {bnd:.4f} ms by {by}, {pairs:.3e} pairs)")
    # the line's entry is the shape the windowed build runs (spatial, d = 3)
    results.append({"name": "banded_topk_sorted", **{k: band["spatial"][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
        "max_abs_err": max(b["max_abs_err"] for b in band.values())})

    # ---- (c) the builders, at their defaults ----------------------------------
    counters = {"pairwise_topk_filter": pairwise_topk.pairwise_topk_filter,
                "banded_topk_sorted": windowed_topk.banded_topk_sorted,
                "ivf_probe": ivf_probe.ivf_probe}
    for fn in counters.values():
        fn.launches = 0
    with torch.no_grad():
        built = gc(g)
        resident = knn.knn_graph(latent, GC_K)
        ivf = knn.knn_graph_ivf(bench, GC_K)  # raises unless every query is certified
        windowed = knn.knn_graph_windowed(xyz, GC_K)  # the same
        resident_bench = knn.knn_graph(bench, GC_K)
        resident_xyz = knn.knn_graph(xyz, GC_K)
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, n in launches.items():
        assert n > 0, f"graph construction never launched {name}"
    # one probe or band launch per attempt
    attempts = {"ivf": launches["ivf_probe"], "windowed": launches["banded_topk_sorted"]}
    assert torch.equal(built.edge_index, resident[0])
    assert torch.equal(built.edge_mask, resident[1] & (resident[2] <= GC_RADIUS))
    ties = {
        "ivf_vs_resident": compare_neighbours("IVF vs resident top-k (bench)", ivf, resident_bench, GC_K),
        "windowed_vs_resident": compare_neighbours(
            "banded vs resident top-k (spatial)", windowed, resident_xyz, GC_K),
        "brute_sample_trained": brute_sample(latent, *resident, GC_K, seed),
        "brute_sample_bench": brute_sample(bench, *ivf, GC_K, seed + 1),
        "brute_sample_spatial": brute_sample(xyz, *windowed, GC_K, seed + 2),
    }
    eff = get_efficiency_purity_edges(built)
    with torch.no_grad():
        times = {
            "mlgc_ms": host_ms(lambda: gc(g), rounds=3),
            "knn_resident_ms": host_ms(lambda: knn.knn_graph(latent, GC_K), rounds=3),
            "knn_ivf_bench_ms": host_ms(lambda: knn.knn_graph_ivf(bench, GC_K), rounds=3),
            "knn_resident_bench_ms": host_ms(lambda: knn.knn_graph(bench, GC_K), rounds=3),
            "knn_windowed_ms": host_ms(lambda: knn.knn_graph_windowed(xyz, GC_K), rounds=3),
            "topk_262k_ms": cuda_ms(lambda: pairwise_topk.pairwise_topk_filter(latent, k=GC_K),
                                    reps=1, rounds=3),
        }
    summary = {
        "hits": GC_HITS, "k": GC_K, **times, **eff, "launches": launches, "attempts": attempts,
        "uncertified_before_fallback": uncertified, "clusters": geometry,
        "banded_topk_sorted": band, "edges_kept_by_radius": int(built.edge_mask.sum()),
        "tie_rows": ties, "ivf_stats": stats,
    }
    log("graph construction: " + json.dumps(summary))
    for r in results:
        r["launches"] = launches[r["name"]]
    return results, summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--events", type=int, default=32,
                   help="events served; the first is warm-up, and the rest's "
                   "events/s includes the loop's fill and drain")
    p.add_argument("--train-steps", type=int, default=10,
                   help="timed training steps (after 2 warm-up steps)")
    p.add_argument("--ml-steps", type=int, default=10,
                   help=f"timed metric-learning steps (after {ML_WARMUP} warm-up steps)")
    p.add_argument("--profile", action="store_true",
                   help="also trace one predict_dir, 3 training steps and 3 metric-learning "
                   "steps with torch.profiler")
    args = p.parse_args(argv)
    if args.events < 3:
        p.error("--events must be at least 3")
    if args.train_steps < 1 or args.ml_steps < 1:
        p.error("--train-steps and --ml-steps must be at least 1")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no GPU, no result", file=sys.stderr)
        return 2
    if not (REPO / "gnn_tracking_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the gnn_tracking_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from gnn_tracking_tpu_torch import _build
    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.inference import TrackingPredictor
    from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN
    from gnn_tracking_tpu_torch.ops import cc_kernel, csr_segment, fused_relational, pairwise_topk
    from gnn_tracking_tpu_torch.ops.dbscan import dbscan_from_graph
    from gnn_tracking_tpu_torch.ops.knn import radius_graph
    from gnn_tracking_tpu_torch.utils.loading import load_graph, save_graph

    # ---- 1. build + card ------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build(ptxas_verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'nothing (cached)'}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {torch.cuda.get_device_name(0)} ({torch.cuda.device_count()} visible), torch {torch.__version__}, CUDA {torch.version.cuda}")

    class CondensedGraphTCN(torch.nn.Module):
        """GraphTCN + particle-structured latent offset (random weights give
        an unclustered latent; this keeps DBSCAN's work representative)."""

        def __init__(self, tcn):
            super().__init__()
            self.tcn = tcn

        def forward(self, data):
            out = self.tcn(data)
            out["H"] = data.extras["serving_centers"].float() + 0.02 * out["H"]
            return out

    # ---- 2. small-input reference: plain on the CPU vs kernels on the card
    rng = np.random.default_rng(args.seed + 100)
    small = make_event(args.seed + 100)
    keep_n = 600
    sel = (small["edge_index"] < keep_n).all(axis=0).nonzero()[0]
    pid = rng.integers(0, 40, size=keep_n)
    latent = rng.normal(size=(40, 8))[pid] + 0.05 * rng.normal(size=(keep_n, 8))
    g_small = EventGraph.from_arrays(
        x=small["x"][:keep_n], edge_index=small["edge_index"][:, sel],
        edge_attr=small["edge_attr"][sel], extras={"serving_centers": latent.astype(np.float32)},
    )
    tiny = CondensedGraphTCN(GraphTCN(
        NODE_DIM, EDGE_DIM, h_dim=8, e_dim=8, h_outdim=8, hidden_dim=16, L_ec=2, L_hc=2,
        device="cpu", generator=torch.Generator().manual_seed(args.seed + 1)))
    ref = TrackingPredictor(tiny, eps=EPS, max_num_neighbors=CAP, device="cpu").predict(g_small)
    got = TrackingPredictor(copy.deepcopy(tiny), eps=EPS, max_num_neighbors=CAP, device="cuda").predict(g_small)
    assert np.array_equal(got["labels"], ref["labels"]), "small-input labels differ CPU vs GPU"
    assert np.allclose(got["beta"], ref["beta"], rtol=1e-4, atol=1e-6), "small-input beta"
    assert np.allclose(got["w"], ref["w"], rtol=1e-4, atol=1e-6), "small-input W"
    log(f"small reference: OK ({keep_n} hits, {len(sel)} edges, {ref['labels'].max() + 1} tracks)")

    # ---- model at full width + events on disk ----------------------------
    gen = torch.Generator().manual_seed(args.seed)
    model = CondensedGraphTCN(GraphTCN(**MODEL, device="cpu", generator=gen)).to(dev).eval()
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = Path(tmp_dir.name)
    indir, outdir = tmp / "events", tmp / "labels"
    indir.mkdir()
    for i in range(args.events):
        save_graph(EventGraph.from_arrays(**make_event(args.seed + 10 + i)), indir / f"ev{i:02d}.npz")
    g0 = load_graph(indir / "ev00.npz", device=dev).sort_edges_by_target(with_unsort=True)

    # ---- 3. kernel phases at the serving shapes ---------------------------
    results = []
    with torch.no_grad():
        tcn = model.tcn
        h_ec = torch.relu(tcn.ec.ec_node_encoder(g0.x))
        e_ec = torch.relu(tcn.ec.ec_edge_encoder(g0.edge_attr))
        weights = tcn.ec.ec_resin.layers[0].relational_weights()
        mask_rng = np.random.default_rng(args.seed)
        mask = torch.from_numpy(mask_rng.random(N_EDGES) < 0.8).to(dev)
        rowptr = g0.extras["dst_rowptr"]
        err1 = 0.0
        for relu_edge in (False, True):
            k_out = fused_relational.fused_relational_fwd(
                h_ec, e_ec, g0.edge_index, mask, weights, rowptr=rowptr, relu_edge=relu_edge)
            p_out = fused_relational.fused_relational_plain(
                h_ec, e_ec, g0.edge_index, mask, weights, relu_edge=relu_edge)
            torch.cuda.synchronize()
            for name, k_t, p_t in zip(("e_tilde", "agg"), k_out, p_out):
                err = (k_t - p_t).abs().max().item()
                lim = 1e-4 * p_t.abs().max().item()
                assert err <= lim, f"fused_relational {name} relu_edge={relu_edge}: {err} > {lim}"
                err1 = max(err1, err)
        ms1 = cuda_ms(lambda: fused_relational.fused_relational_fwd(
            h_ec, e_ec, g0.edge_index, mask, weights, rowptr=rowptr))
        plain1 = cuda_ms(lambda: fused_relational.fused_relational_plain(
            h_ec, e_ec, g0.edge_index, mask, weights))
        fx, fe, hid, fo = h_ec.shape[1], e_ec.shape[1], weights["w2"].shape[0], weights["w3"].shape[0]
        n_valid = int(mask.sum())
        flops1 = 2.0 * n_valid * ((2 * fx + fe) * hid + hid * hid + hid * fo)
        bytes1 = 4 * (N_NODES * fx + N_EDGES * fe + 2 * N_EDGES + (N_NODES + 1)
                      + sum(w.numel() for w in weights.values())
                      + N_EDGES * fo + N_NODES * fo) + N_EDGES
        bound1 = max(flops1 / PEAK_F32_FLOPS, bytes1 / PEAK_BYTES_PER_S) * 1e3
        results.append({
            "name": "fused_relational_fwd", "max_abs_err": err1, "ms": ms1, "plain_ms": plain1,
            "bound_ms": bound1, "library_ms": None,
            "bound_by": "operations" if flops1 / PEAK_F32_FLOPS >= bytes1 / PEAK_BYTES_PER_S else "bytes",
        })
        log(f"kernel fused_relational_fwd: OK max|err| {err1:.3e}; {ms1:.3f} ms (plain {plain1:.3f} ms, "
            f"bound {bound1:.4f} ms, {flops1 / 1e9:.1f} GFLOP f32)")

        # latent of event 0 -> kernel 2
        H = model(g0)["H"].float().contiguous()
        r2 = EPS * EPS * (1.0 + 1e-3)
        kd, ki = pairwise_topk.pairwise_topk_filter(H, k=CAP, radius2=r2)
        pd, pi = pairwise_topk.pairwise_topk_filter_plain(H, k=CAP, radius2=r2)
        torch.cuda.synchronize()
        err2, nb2, nt2 = compare_topk(kd, ki, pd, pi, r2)
        kdn, kin = pairwise_topk.pairwise_topk_filter(H, k=CAP)
        pdn, pin = pairwise_topk.pairwise_topk_filter_plain(H, k=CAP)
        err2n, nb2n, nt2n = compare_topk(kdn, kin, pdn, pin, None)
        filled = int(torch.isfinite(kd).sum())
        assert filled > 0 and int(torch.isfinite(kd).sum(dim=1).max()) < CAP, "cap must exceed eps-neighbourhoods"
        ms2 = cuda_ms(lambda: pairwise_topk.pairwise_topk_filter(H, k=CAP, radius2=r2))
        plain2 = cuda_ms(lambda: pairwise_topk.pairwise_topk_filter_plain(H, k=CAP, radius2=r2), reps=1, rounds=3)
        d = H.shape[1]
        flops2 = 3.0 * d * N_NODES * N_NODES
        bytes2 = 4 * (N_NODES * d + 2 * N_NODES) + 8 * N_NODES * CAP
        bound2 = max(flops2 / PEAK_F32_FLOPS, bytes2 / PEAK_BYTES_PER_S) * 1e3
        results.append({
            "name": "pairwise_topk_filter", "max_abs_err": max(err2, err2n), "ms": ms2, "plain_ms": plain2,
            "bound_ms": bound2, "library_ms": None,
            "bound_by": "operations" if flops2 / PEAK_F32_FLOPS >= bytes2 / PEAK_BYTES_PER_S else "bytes",
        })
        log(f"kernel pairwise_topk_filter: OK radius mode max|err| {err2:.3e} ({filled} filled slots, "
            f"{nb2} boundary rows, {nt2} tie-order rows); kNN mode max|err| {err2n:.3e} "
            f"({nb2n} k-th boundary rows, {nt2n} tie-order rows); {ms2:.3f} ms (plain {plain2:.3f} ms, "
            f"bound {bound2:.4f} ms)")

        # DBSCAN's core-core table of event 0 -> kernel 3
        ei, em, dists = radius_graph(H, EPS, max_num_neighbors=CAP)
        src2d = ei[0].reshape(N_NODES, CAP).contiguous()
        within = (em & (dists <= EPS)).reshape(N_NODES, CAP)
        core = (within.sum(dim=1) + 1) >= MIN_SAMPLES
        core_edges = (within & core[src2d.long()] & core[:, None]).contiguous()
        k_lab = cc_kernel.cc_neighbors(src2d, core_edges)
        sweeps = cc_kernel.cc_neighbors.last_sweeps
        p_lab = cc_kernel.cc_neighbors_plain(src2d, core_edges)
        torch.cuda.synchronize()
        n_diff = int((k_lab != p_lab).sum())
        assert n_diff == 0, f"cc_neighbors: {n_diff} labels differ from the plain version"
        ms3 = cuda_ms(lambda: cc_kernel.cc_neighbors(src2d, core_edges))
        plain3 = cuda_ms(lambda: cc_kernel.cc_neighbors_plain(src2d, core_edges), reps=1, rounds=3)
        bytes3 = N_NODES * CAP * (4 + 1) + 4 * N_NODES
        bound3 = bytes3 / PEAK_BYTES_PER_S * 1e3
        results.append({
            "name": "cc_neighbors", "max_abs_err": float(n_diff), "ms": ms3, "plain_ms": plain3,
            "bound_ms": bound3, "bound_by": "bytes", "library_ms": None,
        })
        log(f"kernel cc_neighbors: OK labels identical ({len(torch.unique(k_lab))} components, "
            f"{sweeps} sweeps); {ms3:.3f} ms (plain {plain3:.3f} ms, bound {bound3:.4f} ms)")
    results += training_kernel_phases(model.tcn, g0, args.seed)

    # ---- 4. main path -------------------------------------------------------
    counters = {
        "fused_relational_fwd": fused_relational.fused_relational_fwd,
        "pairwise_topk_filter": pairwise_topk.pairwise_topk_filter,
        "cc_neighbors": cc_kernel.cc_neighbors,
    }
    serving_extra = {"sorted_segment_sum": csr_segment.sorted_segment_sum}
    predictor = TrackingPredictor(model, eps=EPS, min_samples=MIN_SAMPLES, max_num_neighbors=CAP, device="cuda")
    for fn in (*counters.values(), *serving_extra.values()):
        fn.launches = 0
    stats = predictor.predict_dir(indir, outdir)
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, n in launches.items():
        assert n > 0, f"main path never launched {name}"
    for r in results:
        if r["name"] in launches:
            r["launches"] = launches[r["name"]]
    log(f"main path: {stats['n_events']} events, launches {launches}, and "
        f"{serving_extra['sorted_segment_sum'].launches} of sorted_segment_sum (the forward's aggregation)")
    for r in results:
        if r["name"] not in launches:
            continue
        log(f"  {r['name']}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}), {r['launches']} launches "
            f"in {stats['n_events']} events")

    tracks = []
    with plain_path():
        for i in range(args.events):
            got = np.load(outdir / f"ev{i:02d}_labels.npz")
            g = load_graph(indir / f"ev{i:02d}.npz", device=dev)
            want = predictor.predict(g)
            assert np.array_equal(got["labels"], want["labels"]), f"event {i}: labels differ from the plain path"
            assert got["labels"].shape == (N_NODES,) and got["w"].shape == (N_EDGES,)
            for key in ("beta", "w"):
                assert np.isfinite(got[key]).all(), key
                assert np.allclose(got[key], want[key], rtol=1e-3, atol=1e-5), key
            tracks.append(int(got["labels"].max()) + 1)
    assert all(0.9 * N_TRACKS <= t <= N_TRACKS for t in tracks), f"track counts {tracks}"
    log(f"main path: labels equal to the plain path on this card; tracks per event {tracks}")

    # stage split on event 0 (host clock around synchronised stages)
    with torch.no_grad():
        t_fwd = host_ms(lambda: model(g0))
        H = model(g0)["H"].float()
        t_rg = host_ms(lambda: radius_graph(H, EPS, max_num_neighbors=CAP))
        ei, em, dists = radius_graph(H, EPS, max_num_neighbors=CAP)
        t_db = host_ms(lambda: dbscan_from_graph(
            ei, dists, N_NODES, eps=EPS, min_samples=MIN_SAMPLES, neighbor_cap=CAP, edge_mask=em))
        t_event = host_ms(lambda: predictor.predict(g0), rounds=3)
    # the same events served serially (load, predict, write one after the
    # other; event 0 untimed, as in predict_dir), for comparison with
    # predict_dir's overlapped host IO
    serial_dir = tmp / "serial"
    serial_dir.mkdir()
    t_serial = None
    for i in range(args.events):
        res = predictor.predict(load_graph(indir / f"ev{i:02d}.npz", device="cpu"))
        np.savez_compressed(serial_dir / f"ev{i:02d}_labels.npz", **res)
        if i == 0:
            t_serial = time.perf_counter()
    serial_eps = (args.events - 1) / (time.perf_counter() - t_serial)
    serving = {
        "events_per_s": stats["events_per_s"], "serial_events_per_s": serial_eps,
        "events": stats["n_events"],
        "load_ms": stats["load_ms"], "write_ms": stats["write_ms"],
        "predict_dir_predict_ms": stats["predict_ms"],
        "predict_ms": t_event, "forward_ms": t_fwd, "radius_ms": t_rg, "dbscan_ms": t_db,
        "n_tracks": tracks, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log("serving: " + json.dumps(serving))
    assert math.isfinite(stats["events_per_s"]) and stats["events_per_s"] > 0
    if args.profile:
        profile_run(lambda: predictor.predict_dir(indir, tmp / "profiled"), "serving")

    # ---- 5. training path -------------------------------------------------
    train_counters = {
        "fused_relational_fwd": fused_relational.fused_relational_fwd,
        "fused_relational_bwd": fused_relational.fused_relational_bwd,
        "sorted_segment_sum": csr_segment.sorted_segment_sum,
        "sorted_gather": csr_segment.sorted_gather,
    }
    training, train_launches = training_path(args.seed, args.train_steps, train_counters, args.profile)
    for r in results:
        if r["name"] not in launches:
            r["launches"] = train_launches[r["name"]]
            log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}), "
                f"{r['launches']} launches in {training['steps']} training steps")

    # ---- 6. Trainer.fit, then serve its checkpoint ---------------------------
    fit_and_serve(args.seed, tmp, CondensedGraphTCN)

    # ---- 7. metric-learning training ----------------------------------------
    _, ml_model = ml_training_path(args.seed, args.ml_steps, args.profile)

    # ---- 8. graph construction ---------------------------------------------
    gc_results, _ = graph_construction_phase(args.seed, ml_model)
    results += gc_results

    # ---- 9. results -------------------------------------------------------
    kernels = [
        {
            "name": r["name"], "route": "cuda", "source": SOURCES[r["name"]],
            "replaces": TPU_KERNELS[r["name"]], "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        }
        for r in results
    ]
    tmp_dir.cleanup()
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
