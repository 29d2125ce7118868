#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py [--seed 0] [--events 32] [--train-steps 10] [--ml-steps 10]
                          [--ec-steps 10] [--val-epochs 75] [--profile]
    python3 chip_smoke.py --split-only [--package-root DIR]   # (or another *-only mode)
    python3 chip_smoke.py --band-only [--package-root DIR] [--band-digests FILE]

Phases, in order (any failure exits nonzero; nothing is swallowed):

1. build the CUDA kernels from ``gnn_tracking_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel) and print the card's name and power limit;
2. small-input reference: a narrow GraphTCN served on the CPU (plain
   versions) and on the card (kernels) must agree;
3. one phase per kernel at the serving shapes (32,768 hits, 262,144 edges,
   GraphTCN 32/32/8/128): the kernel against its plain PyTorch version on
   the same inputs, with its median time, the plain version's time, the
   time of one library call that computes the same function where there is
   one, and its analytic bound. The fused relational forward (row #1) must
   repeat bitwise and stay within 4x the plain f32 version's error against
   float64. The training kernels (the fused relational backward, the sorted
   segment-sum and the sorted gather) run at the HC layer's shapes and must
   give the same bits on a second launch; the saving forward and the
   saved-rows backward (C32 / D32, rows #7 / #8 in f32) run there too
   (``f32_saved_pair``: bitwise rows #1 / #2); the sorted segment-sum is
   timed on the device (``graph_ms``) beside ``torch.segment_reduce``, at
   that input and on a masked tail (``segment_sum_timings``: 20 % of the
   training event's edges masked, ~52k rows at the last node); connected
   components (row #16) on DBSCAN's core-core table of event 0 and on
   ``cc_tables`` (a permuted chain of 32,768 nodes, k = 6, k = 0, a fully
   masked table, N = 1), labels bitwise the plain version's, a bad index
   refused, one launch and one copy a call, timed as a call and on the
   device, with its sweeps and bound (``cc_checks``);
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
   (benchmark cloud) and the banded top-k (spatial coordinates, d = 3, at
   radius 4 and at the retry's radius 8, and the trained latent, d = 8), at
   the inputs that a build gives them, and above 32 dimensions and at
   large k: the band at k = 256 and on a 65,536-point 40-d cloud, and on
   the spatial input with each point repeated 6 times (every distance
   tied) at k = 8, 32, 64 with ``loop`` both ways, each bitwise its own
   arithmetic (``banded_topk_fma_plain``); rows #13 / #11 at k = 8 on
   65,536 points in 40 and 64 dimensions (``resident_wide_checks``: bitwise
   row #12 on unmasked rows, the plain version, timed); the probe on that cloud and at k = 128 (kw = 136, the probe of
   ``knn_graph_ivf(k=128)`` over 32,768 benchmark points, whose graph must
   equal the plain build's and row #11's up to ties) and k = 256 on those
   points: each against its
   plain version, bitwise equal on a second launch, timed beside its bound
   (and the band beside its instruction floor); the queries each
   certification leaves before its fallback. (c) Builds with ``MLGraphConstruction(max_num_neighbors=8,
   max_radius=1.0)`` over the trained latent (the resident top-k, which at
   k = 8 is row #13 where ``knn.SPLIT_MAX_K >= 8`` and row #12 otherwise;
   its graph must equal both kernels' graphs, and the route taken is logged
   beside both kernels' times on that latent),
   ``knn_graph_ivf(k=8)`` over the benchmark cloud (certified: it widens
   the probe until ``n_uncert == 0``, and raises after 3 attempts) and
   ``knn_graph_windowed(k=8)`` over the spatial coordinates (where the
   principal-axis band certifies), the last two at their defaults, with
   their attempt counts. Each exact builder's neighbour sets must agree
   with the resident top-k's on the same input (ties aside), and every
   query of each of the three builds must agree with the exact brute-force
   top-k of ``pairwise_topk_streaming`` (row #11; distances within 1e-5
   relative, neighbour sets equal up to ties), and 4,096 seeded queries of
   each with a plain brute force on the card (direct distances, stable
   sort); it prints ms per build (the resident top-k on the benchmark cloud
   too), the windowed build split into its band launches, the violators'
   brute force (``_fallback_brute``) and the rest (principal axis, sort,
   certification), with each attempt's radius and violator count, and the
   built graph's edge efficiency and purity;
9. bf16 edge-classifier training at ``examples/configs/ec.yml``'s width
   (``ECForGraphTCN(14, 4, 64, 64, hidden 128, L_ec 6)``, focal loss alpha
   0.25 / gamma 2, Adam 1e-3, ``ECModule(precision="bf16")``) on a
   bench-style event with 30 % true edges (``bench.py:66-79``). (a) Kernels
   A-D of ``csrc/fused_relational_bf16.cu`` (table rows #3-#8) at the EC
   layer's shapes (the model's second layer: bf16, 80 % of the edges
   unmasked, ``relu_edge`` off and on): each output within 2e-2 of its
   plain bf16 version's norm, its error against a float64 evaluation at
   most 2x the plain version's (norms: see ``bf16_check``), bitwise equal on a
   second launch, C/D bitwise equal to A/B, A's and B's masked edges' rows
   zero;
   timed beside its bound at the data sheet's 989 TFLOP/s bf16 and 3.35
   TB/s. (b) Step 0's parameter gradients
   through the kernels against the plain path's (per tensor within 5e-2 of
   its largest magnitude); one step with ``fused_save_acts`` (kernels C/D)
   giving the same loss and gradients bitwise; 2 warm-up steps and
   ``--ec-steps`` timed steps (steps/s, edges/s, the forward / loss /
   backward / Adam split, peak memory, launches per step of A, B and rows
   #9 / #10; one partition of the edge ids a layer, 6 a step). (c) ``Trainer.fit`` for one epoch over 4 npz events, with
   finite ROC AUC from ``ECModule.validation_extra``;
10. metric-learning validation (``examples/configs/ml.yml``'s
   ``gc_scanner``). (a) The split kernel pair of
   ``csrc/pairwise_topk_split.cu``: as row #13 (``pairwise_topk``) on a
   32,768-point clustered 8-d cloud with two batch ids and 10 % masked
   nodes at k = 1, 2, 4, 8, 16, 32, 64 and 256 (row #12's kernel above
   32), against its plain version
   (``compare_topk``) and bitwise equal to row #12's kernel on the unmasked
   queries, each k timed beside row #12; as row #11
   (``pairwise_topk_streaming``) at 262,144 points, k = 8, on the JAX kNN
   benchmark's cloud, against its plain version on every query; each timed
   beside its bound; row #12 above one pass (k = 1,024 and 2,048) and rows
   #13 / #11 above the split kernels' k (k = 300) on 4,096 of those points
   against their plain versions; rows #1/#2 and C32 / D32 at ``ec.yml``'s widths (K =
   192, H = 128, Fo = 64, where W1 stays in device memory) against their
   plain versions with phase 3's tolerances; A-D and rows #1/#2 with C32 /
   D32 at widths they take only zero-padded, (40, 8, 72, 20) in bf16 and
   (14, 3, 50, 18) in f32, through the wrappers and the differentiable op
   (``odd_width_checks``); rows #11-#13 at d = 33, 40 and 64
   (``wide_dim_checks``); the wide layout of ``csrc/fused_relational_wide.cu``
   at (64, 64, 256, 64) in bf16 and f32 (with and without the save flag)
   and at widths whose backward tiles live in device memory
   (``width_checks``), timed on 262,144 edges (``wide_timings``), and its
   own path: an ``ECModule`` step at hidden width 256 in f32 and bf16,
   gradients against the plain path (``wide_ec_steps``, whose f32 step's launches the
   result line reports). (b) ``MLModule`` with phase 7's model and
   ``GraphConstructionKNNScanner(ks=[1..8])`` at the default top-k choice
   (row #13 at k <= ``knn.SPLIT_MAX_K``, row #12 above): ``Trainer.fit`` trains
   ``--val-epochs`` epochs over two
   32,768-hit point clouds (the briefly trained latent of phase 7 does not
   yet gather any particle's hits) and validates 2 more at the end (true
   edges: every intra-particle pair); row #13 must launch once per
   validation event for each of those k; the figures
   of merit must be finite where the JAX rules give a number and equal to
   validations under ``knn._SMALL_TOPK_IMPL = "pallas"`` (row #13) and
   ``"filter"`` (row #12); both validations timed. Then one f32 ``ECModule`` step at ``ec.yml``'s widths: step 0's
   gradients through rows #1/#2 against the plain path (``compare_grads``),
   and the same step with ``fused_save_acts`` (C32 / D32, 6 launches each)
   giving the same loss and gradients bitwise;
11. a JSON line of per-kernel results, the ``nvidia-smi`` name/power line,
   and last the device JSON line.

``--segment-sum-only`` builds, runs ``segment_sum_timings`` and stops;
``--relational-bwd-only`` builds, runs ``relational_bwd_timings`` (row #2
and D32 at both widths and at unmasked shares 1.0, 0.8, 0.5, 0.0 and a
ragged edge count) and stops; ``--topk-only`` builds, runs ``topk_timings``
(row #12 on the ML latent at step 0 and trained, the serving shapes, phase
10 (a)'s input at k = 8, 64, 256, an adversarial order, duplicates, a
ragged N and N < k; each against its plain version and repeat bitwise) and
stops; ``--ec-bwd-only`` builds, runs ``ec_bwd_timings`` (kernels B and D
at phase 9's input, unmasked shares 1.0, 0.8, 0.5, 0.0 and a ragged edge
count, ``relu_edge`` off and on: phase 9's checks, D bitwise B, the masked
edges' rows zero; each timed as a Python call and on the device, the call
by CUDA-graph replay and the edge kernel alone by ``torch.profiler``,
beside the plain version and the bound of the unmasked share), then
``ec_bwd_widths`` (B and D at other widths, checked the same way, and at
a width whose weights exceed shared memory, which takes the wide layout; a
tree from before it may refuse that width) and stops; ``--ec-fwd-only`` does the same for
kernels A and C (``ec_fwd_timings``: A / C against the plain version and
float64, C bitwise A, the masked edges' ``e_tilde`` rows zero, C's saved
rows ``x[dst]`` / ``x[src]`` on every edge; timed as B / D are, beside the
bound of the unmasked share, ``fwd_bound_bytes``; then ``ec_fwd_widths``,
with A and C at ``EC_BWD_BEYOND`` through the wide layout); ``--split-only``
builds, runs ``split_checks`` (rows #13 / #11 at k = 1 to 300, batched and
not, ``loop`` both ways, duplicates, N < k, a masked block: bitwise row #12
on the unmasked rows, the plain version, repeat bitwise) and
``split_timings`` (rows #13 / #11 beside row #12 on phase 10 (a)'s input at
k = 1, 2, 4, 8, 16, 32 and on phase 8's two 262,144-point inputs at k = 8:
the Python call, the call on the device and the two kernels alone, with the
plan (R, S), the bound and the instruction floor; then other plans on two of
them) and stops; these times set ``knn.SPLIT_MAX_K``. ``--band-only``
builds, runs ``band_timings`` (row #14 on phase 8's band inputs, spatial
and trained at radius 4 and spatial at radius 8, at k = 1, 8, 16, 32, 64,
256 and with ``loop`` at k = 8, 64, and on the two radius-4 inputs with
each point repeated 6 times at k = 8, 32, 64 with ``loop`` both ways: repeat
bitwise, bitwise its own arithmetic (``banded_topk_fma_plain``), against its
plain version, in the contract's order; the Python call, the call on the
device and the kernel alone, beside the bound and the instruction floor;
with ``--band-digests FILE`` bitwise equal to another tree's run that wrote
FILE) and stops. ``--cc-only`` builds, runs ``cc_checks`` (row #16 on
phase 3's table and on ``cc_tables``: a permuted chain, a table with k = 6,
k = 0, a fully masked table, N = 1; labels bitwise the plain version's, a
bad index refused; the call, its kernels on the device, the launches and
copies a call, sweeps) and stops. ``--digests
FILE`` builds, runs ``bitwise_digests`` (rows #11-#13 at d <= 32, rows #1 /
#2 with C32 / D32 and A-D at widths their resident kernels take: each
output's digest) and writes FILE, or holds the digests bitwise against
FILE where another tree's run wrote it, and stops. ``--wide-only``
(this tree only) builds, runs ``wide_dim_checks``, ``resident_wide_checks``,
``width_checks`` at ``WIDE_CHECKS``, ``wide_timings`` and ``wide_ec_steps``
and stops. With ``--package-root DIR`` each runs the package in DIR (an
older tree unpacked beside this one) on the same inputs and card.

Without CUDA, or without the package beside this script, it prints no
result and exits with code 2.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
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
# H100 SXM data-sheet peaks (dense): f32 on the CUDA cores, bf16 on the
# tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
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
# (full rows in the hinge loss's radius graph) makes the first steps dearer,
# and by then it has spread
ML_WARMUP = 30
GC_HITS, GC_PARTICLES, GC_K, GC_RADIUS = 262144, 16384, 8, 1.0
LAYER_RADII = np.linspace(0.03, 1.0, 16)
# edge-classifier training (examples/configs/ec.yml; bench.py:107-158 trained it in bf16)
EC_MODEL = {
    "node_indim": NODE_DIM, "edge_indim": EDGE_DIM, "interaction_node_dim": 64,
    "interaction_edge_dim": 64, "hidden_dim": 128, "L_ec": 6,
}
EC_LOSS = {"alpha": 0.25, "gamma": 2.0}
TPU_KERNELS = {
    "fused_relational_fwd": "gnn_tracking_tpu/ops/pallas/fused_relational.py:373",
    "fused_relational_bwd": "gnn_tracking_tpu/ops/pallas/fused_relational.py:415",
    "sorted_segment_sum": "gnn_tracking_tpu/ops/pallas/csr_segment.py:162",
    "sorted_gather": "gnn_tracking_tpu/ops/pallas/csr_segment.py:212",
    "pairwise_topk_filter": "gnn_tracking_tpu/ops/pallas/pairwise_topk.py:466",
    "cc_neighbors": "gnn_tracking_tpu/ops/pallas/cc_kernel.py:93",
    "banded_topk_sorted": "gnn_tracking_tpu/ops/pallas/windowed_topk.py:173",
    "ivf_probe": "gnn_tracking_tpu/ops/pallas/ivf_probe.py:161",
    "fused_relational_bf16_fwd": "gnn_tracking_tpu/ops/pallas/fused_relational.py:721 and "
    "gnn_tracking_tpu/ops/pallas/fused_relational_t.py:308",
    "fused_relational_bf16_bwd": "gnn_tracking_tpu/ops/pallas/fused_relational.py:781 and "
    "gnn_tracking_tpu/ops/pallas/fused_relational_t.py:377",
    "fused_relational_bf16_fwd_save": "gnn_tracking_tpu/ops/pallas/fused_relational_t.py:610",
    "fused_relational_bf16_bwd_saved": "gnn_tracking_tpu/ops/pallas/fused_relational_t.py:680",
    "pairwise_topk": "gnn_tracking_tpu/ops/pallas/pairwise_topk.py:534",
    "pairwise_topk_streaming": "gnn_tracking_tpu/ops/pallas/pairwise_topk.py:230",
    "fused_relational_fwd_save": "gnn_tracking_tpu/ops/pallas/fused_relational_t.py:610",
    "fused_relational_bwd_saved": "gnn_tracking_tpu/ops/pallas/fused_relational_t.py:680",
    "fused_relational_wide_fwd": "gnn_tracking_tpu/ops/pallas/fused_relational.py:373 and :721, "
    "gnn_tracking_tpu/ops/pallas/fused_relational_t.py:308 and :610, beyond shared memory",
    "fused_relational_wide_bwd": "gnn_tracking_tpu/ops/pallas/fused_relational.py:415 and :781, "
    "gnn_tracking_tpu/ops/pallas/fused_relational_t.py:377 and :680, beyond shared memory",
}
SOURCES = {
    "fused_relational_fwd": "gnn_tracking_tpu_torch/csrc/fused_relational.cu",
    "fused_relational_bwd": "gnn_tracking_tpu_torch/csrc/fused_relational.cu",
    "fused_relational_fwd_save": "gnn_tracking_tpu_torch/csrc/fused_relational.cu",
    "fused_relational_bwd_saved": "gnn_tracking_tpu_torch/csrc/fused_relational.cu",
    "sorted_segment_sum": "gnn_tracking_tpu_torch/csrc/csr_segment.cu",
    "sorted_gather": "gnn_tracking_tpu_torch/csrc/csr_segment.cu",
    "pairwise_topk_filter": "gnn_tracking_tpu_torch/csrc/pairwise_topk.cu",
    "cc_neighbors": "gnn_tracking_tpu_torch/csrc/cc_neighbors.cu",
    "banded_topk_sorted": "gnn_tracking_tpu_torch/csrc/banded_topk.cu",
    "ivf_probe": "gnn_tracking_tpu_torch/csrc/ivf_probe.cu",
    **{f"fused_relational_bf16_{k}": "gnn_tracking_tpu_torch/csrc/fused_relational_bf16.cu"
       for k in ("fwd", "bwd", "fwd_save", "bwd_saved")},
    "pairwise_topk": "gnn_tracking_tpu_torch/csrc/pairwise_topk_split.cu",
    "pairwise_topk_streaming": "gnn_tracking_tpu_torch/csrc/pairwise_topk_split.cu",
    "fused_relational_wide_fwd": "gnn_tracking_tpu_torch/csrc/fused_relational_wide.cu",
    "fused_relational_wide_bwd": "gnn_tracking_tpu_torch/csrc/fused_relational_wide.cu",
}
# metric-learning validation (examples/configs/ml.yml's gc_scanner)
VAL_KS = list(range(1, 9))
# k at which phase 10 (a) holds row #13 against its plain version and times it beside row #12
# (1-8: the scanner's; 256: the hinge loss's cap, which GNN_TRACKING_RADIUS_IMPL=topk sends
# through knn_graph; above 32, row #12's kernel serves row #13)
SPLIT_SWEEP_KS = (1, 2, 4, 8, 16, 32, 64, 256)


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


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """Least time on the card (ms) and what bounds it: operations at
    ``peak`` (f32 on the CUDA cores unless given), or bytes at the HBM
    rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
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


def graph_ms(fn, *, reps: int = 20, rounds: int = 5) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed ``rounds`` times between CUDA events; the median per call. The
    host's work per call (checks, allocations, ctypes) is left out, which
    ``cuda_ms`` counts wherever it exceeds the device time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
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
    fused relational forward and backward, f32 and bf16, recomputing and
    saving (which hold the
    sorted segment-sum and gather launches), the top-k filter and the split
    top-k, connected components, the banded top-k and the IVF probe."""
    from gnn_tracking_tpu_torch.ops import cc, ivf_knn, knn, windowed_topk
    from gnn_tracking_tpu_torch.ops import fused_relational as fr
    from gnn_tracking_tpu_torch.ops.cc_kernel import cc_neighbors_plain
    from gnn_tracking_tpu_torch.ops.ivf_probe import ivf_probe_plain
    from gnn_tracking_tpu_torch.ops.pairwise_topk import pairwise_topk_filter_plain, pairwise_topk_plain

    sites = [
        # (the op's partition of the edge ids serves only the kernels)
        (fr, "fused_relational_fwd",
         lambda *a, rowptr=None, partition=None, **kw: fr.fused_relational_plain(*a, **kw)),
        (fr, "fused_relational_bwd",
         lambda *a, partition=None, **kw: fr.fused_relational_bwd_plain(*a[:7], **kw)),
        (fr, "fused_relational_fwd_save",
         lambda *a, rowptr=None, partition=None, **kw: fr.fused_relational_fwd_save_plain(*a, **kw)),
        (fr, "fused_relational_bwd_saved",
         lambda *a, partition=None, **kw: fr.fused_relational_bwd_saved_plain(*a[:8], a[9], **kw)),
        (fr, "fused_relational_bf16_fwd",
         lambda *a, rowptr=None, partition=None, **kw: fr.fused_relational_bf16_plain(*a, **kw)),
        (fr, "fused_relational_bf16_fwd_save",
         lambda *a, rowptr=None, partition=None, **kw: fr.fused_relational_bf16_fwd_save_plain(*a, **kw)),
        (fr, "fused_relational_bf16_bwd",
         lambda *a, partition=None, **kw: fr.fused_relational_bf16_bwd_plain(*a[:7], **kw)),
        (fr, "fused_relational_bf16_bwd_saved",
         lambda *a, partition=None, **kw: fr.fused_relational_bf16_bwd_saved_plain(*a[:8], a[9], **kw)),
        (knn, "pairwise_topk_filter", pairwise_topk_filter_plain),
        (knn, "pairwise_topk", pairwise_topk_plain),
        (cc, "cc_neighbors", cc_neighbors_plain),
        (windowed_topk, "banded_topk_sorted", windowed_topk.banded_topk_sorted_plain),
        (ivf_knn, "ivf_probe", ivf_probe_plain),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    for mod, name, plain in sites:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


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


def assert_key_order(kd, ki, what: str) -> int:
    """The contract's order on a top-k's own values, row by row: filled slots
    first, squared distances ascending, exactly equal ones by rising index
    (ties to the lower index); unfilled slots ``(+inf, 0)``. Holds where
    ``compare_topk`` lets equal-distance neighbours swap. Returns the number
    of exactly tied neighbouring slots."""
    import torch

    fin = torch.isfinite(kd)
    assert not (~fin[:, :-1] & fin[:, 1:]).any(), f"{what}: a filled slot after an unfilled one"
    assert not ki[~fin].any(), f"{what}: an unfilled slot with an index"
    both = fin[:, :-1] & fin[:, 1:]
    assert not (both & (kd[:, 1:] < kd[:, :-1])).any(), f"{what}: squared distances not ascending"
    tie = both & (kd[:, 1:] == kd[:, :-1])
    assert not (tie & (ki[:, 1:] <= ki[:, :-1])).any(), f"{what}: equal distances not by rising index"
    return int(tie.sum())


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
        out, pdata = module.apply_model(g)
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        loss, _ = module.get_losses(out, pdata)
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


def f32_saved_pair(x, ea, ei, mask, weights, csr, g_e, g_a, where: str) -> list[dict]:
    """Kernels C32 / D32 (rows #7 / #8 in f32) on one layer's inputs:
    C32's ``e'`` / ``agg`` bitwise row #1's and its saved rows bitwise
    ``x[dst]`` / ``x[src]``; D32's outputs bitwise row #2's; each within phase
    3's tolerances of its plain version (forward: 1e-4 of the largest value;
    backward: at most 4x the plain f32 error against float64) and repeating
    bitwise; each timed beside its plain version and its bound."""
    import torch

    from gnn_tracking_tpu_torch.ops import fused_relational as fr

    n = x.shape[0]
    rowptr = csr["dst_rowptr"]
    args = (x, ea, ei, mask, weights)
    args64 = (x.double(), ea.double(), ei, mask, {k: v.double() for k, v in weights.items()})
    named = lambda out: [out[0], out[1], *out[2].values()]
    err_c = err_d = 0.0
    for relu_edge in (False, True):
        kw = {"relu_edge": relu_edge}
        a = fr.fused_relational_fwd(*args, rowptr=rowptr, **kw)
        c = fr.fused_relational_fwd_save(*args, rowptr=rowptr, **kw)
        c2 = fr.fused_relational_fwd_save(*args, rowptr=rowptr, **kw)
        pc = fr.fused_relational_fwd_save_plain(*args, **kw)
        b = named(fr.fused_relational_bwd(*args, g_e, g_a, csr, **kw))
        d = named(fr.fused_relational_bwd_saved(c[2], c[3], *args[1:], g_e, g_a, csr, n, **kw))
        d2 = named(fr.fused_relational_bwd_saved(c[2], c[3], *args[1:], g_e, g_a, csr, n, **kw))
        pd = named(fr.fused_relational_bwd_saved_plain(pc[2], pc[3], *args[1:], g_e, g_a, n, **kw))
        rd = named(fr.fused_relational_bwd_plain(*args64, g_e.double(), g_a.double(), **kw))
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(a, c[:2])), f"C32 differs from row #1 ({where})"
        assert all(torch.equal(u, v) for u, v in zip(c, c2)), f"C32: second launch differs ({where})"
        assert torch.equal(c[2], pc[2]) and torch.equal(c[3], pc[3]), f"C32: saved rows ({where})"
        for kt, pt_ in zip(c[:2], pc[:2]):
            err = (kt - pt_).abs().max().item()
            assert err <= 1e-4 * pt_.abs().max().item(), f"C32 ({where}): {err}"
            err_c = max(err_c, err)
        assert all(torch.equal(u, v) for u, v in zip(b, d)), f"D32 differs from row #2 ({where})"
        assert all(torch.equal(u, v) for u, v in zip(d, d2)), f"D32: second launch differs ({where})"
        for kt, pt_, rt in zip(d, pd, rd):
            ek, ep = (kt.double() - rt).abs().max().item(), (pt_.double() - rt).abs().max().item()
            assert math.isfinite(ek) and ek <= 4 * ep, f"D32 ({where}): err {ek:.3e} > 4 x plain {ep:.3e}"
            err_d = max(err_d, ek)
    c = fr.fused_relational_fwd_save(*args, rowptr=rowptr)
    ms_c = cuda_ms(lambda: fr.fused_relational_fwd_save(*args, rowptr=rowptr))
    plain_c = cuda_ms(lambda: fr.fused_relational_fwd_save_plain(*args))
    ms_d = cuda_ms(lambda: fr.fused_relational_bwd_saved(c[2], c[3], *args[1:], g_e, g_a, csr, n))
    plain_d = cuda_ms(lambda: fr.fused_relational_bwd_saved_plain(c[2], c[3], *args[1:], g_e, g_a, n))
    fx, fe, hid, fo = x.shape[1], ea.shape[1], weights["w2"].shape[0], weights["w3"].shape[0]
    k, n_valid = 2 * fx + fe, int(mask.sum())
    outs_d = named(fr.fused_relational_bwd_saved(c[2], c[3], *args[1:], g_e, g_a, csr, n))
    bnd_c, by_c = bound(2.0 * n_valid * (k * hid + hid * hid + hid * fo),
                        nbytes(x, ea, ei, mask, rowptr, *weights.values(), *c))
    bnd_d, by_d = bound(2.0 * n_valid * (3 * k * hid + 3 * hid * hid + 2 * hid * fo),
                        nbytes(c[2], c[3], ea, ei, mask, *weights.values(), g_e, g_a, *csr.values(), *outs_d))
    log(f"kernels fused_relational_fwd_save / bwd_saved (C32 / D32, {where}; K={k}, H={hid}, Fo={fo}): OK "
        f"bitwise rows #1 / #2, saved rows bitwise x[dst] / x[src], repeat bitwise; forward max|err| "
        f"{err_c:.3e} (<= 1e-4 of the largest), backward max|err| vs float64 {err_d:.3e} (<= 4x the plain "
        f"f32 version's); C32 {ms_c:.3f} ms (plain {plain_c:.3f} ms, bound {bnd_c:.4f} ms by {by_c}), D32 "
        f"{ms_d:.3f} ms (plain {plain_d:.3f} ms, bound {bnd_d:.4f} ms by {by_d})")
    return [{"name": "fused_relational_fwd_save", "max_abs_err": err_c, "ms": ms_c, "plain_ms": plain_c,
             "bound_ms": bnd_c, "bound_by": by_c, "library_ms": None},
            {"name": "fused_relational_bwd_saved", "max_abs_err": err_d, "ms": ms_d, "plain_ms": plain_d,
             "bound_ms": bnd_d, "bound_by": by_d, "library_ms": None}]


def core_table(h):
    """DBSCAN's core-core neighbour table of the latent ``h`` as serving
    builds it (radius ``EPS``, ``CAP`` neighbours, ``MIN_SAMPLES``): ``(idx
    [N, CAP] int32, mask [N, CAP] bool)``, row #16's input."""
    from gnn_tracking_tpu_torch.ops.knn import radius_graph

    n = h.shape[0]
    ei, em, dists = radius_graph(h, EPS, max_num_neighbors=CAP)
    src2d = ei[0].reshape(n, CAP).contiguous()
    within = (em & (dists <= EPS)).reshape(n, CAP)
    core = (within.sum(dim=1) + 1) >= MIN_SAMPLES
    return src2d, (within & core[src2d.long()] & core[:, None]).contiguous()


def cc_tables(seed: int, n: int = N_NODES) -> list[tuple]:
    """Row #16's tables beside phase 3's: ``(name, idx, mask)`` on the card. A
    randomly permuted chain of ``n`` nodes (each lists its two chain
    neighbours, k = 4 with two masked slots of garbage: the most sweeps a
    table of that size needs), a 6-wide random table of ~n / 16 components
    (k % 4 != 0: the kernel's scalar row reads), k = 0, a fully masked table
    and N = 1."""
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 160)
    order = rng.permutation(n)
    idx = rng.integers(0, n, size=(n, 4))
    mask = np.zeros((n, 4), dtype=bool)
    idx[order[1:], 0], mask[order[1:], 0] = order[:-1], True
    idx[order[:-1], 1], mask[order[:-1], 1] = order[1:], True
    comp = rng.integers(0, n // 16, size=n)
    members = np.argsort(comp, kind="stable")
    same = comp[members[1:]] == comp[members[:-1]]
    idx6 = rng.integers(0, n, size=(n, 6))
    mask6 = np.zeros((n, 6), dtype=bool)
    a, b = members[:-1][same], members[1:][same]
    idx6[a, 0], mask6[a, 0] = b, True
    idx6[b, 1], mask6[b, 1] = a, True
    on = lambda t: torch.from_numpy(np.ascontiguousarray(t)).to(dev)
    return [
        ("chain", on(idx.astype(np.int32)), on(mask)),
        ("k6_components", on(idx6.astype(np.int32)), on(mask6)),
        ("k0", on(np.zeros((n, 0), dtype=np.int32)), on(np.zeros((n, 0), dtype=bool))),
        ("all_masked", on(rng.integers(0, 1000, size=(1000, 16)).astype(np.int32)), on(np.zeros((1000, 16), dtype=bool))),
        ("n1", on(np.zeros((1, 4), dtype=np.int32)), on(np.array([[True, False, True, False]]))),
    ]


def cc_calls(fn, *, reps: int = 5) -> dict:
    """``torch.profiler`` over ``reps`` calls of ``fn``: the kernels it launches
    on the device and the copies between device and host, per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the trace can come back without device records
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        gpu = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if gpu:
            break
    copies = [e for e in gpu if "Memcpy" in e.name or "memcpy" in e.name]
    return {"kernels_per_call": (len(gpu) - len(copies)) / reps, "copies_per_call": len(copies) / reps}


def cc_checks(idx, mask, seed: int, this_tree: bool) -> dict:
    """Row #16 (``cc_neighbors``) on phase 3's table (event 0's core-core
    radius graph, ``idx``, ``mask``) and on ``cc_tables``: labels bitwise the
    plain version's, sweeps; an unmasked index outside [0, N) raises
    ``ValueError``; the call (``cuda_ms``), its kernels on the device
    (``device_ms_per_call``), the kernels launched and the copies a call
    (``cc_calls``: one launch and one read back for this tree), beside the
    plain version and the bound (the table's bytes once). Returns the kernel
    line's entry."""
    import torch

    from gnn_tracking_tpu_torch.ops import cc_kernel

    names = ("cc_kernel", "sweep_kernel", "iota_kernel")
    out, tables = {}, [("event0", idx, mask), *cc_tables(seed)]
    for name, ti, tm in tables:
        k_lab = cc_kernel.cc_neighbors(ti, tm)
        sweeps = cc_kernel.cc_neighbors.last_sweeps
        p_lab = cc_kernel.cc_neighbors_plain(ti, tm)
        torch.cuda.synchronize()
        n_diff = int((k_lab != p_lab).sum())
        assert n_diff == 0, f"cc_neighbors ({name}): {n_diff} labels differ from the plain version"
        row = {"n": ti.shape[0], "k": ti.shape[1], "sweeps": sweeps, "components": len(torch.unique(k_lab))}
        if name in ("event0", "chain"):
            row["ms"] = cuda_ms(lambda: cc_kernel.cc_neighbors(ti, tm))
            row["device_ms"] = device_ms_per_call(lambda: cc_kernel.cc_neighbors(ti, tm), names)
            row.update(cc_calls(lambda: cc_kernel.cc_neighbors(ti, tm)))
            row["bound_ms"] = nbytes(ti, tm) / PEAK_BYTES_PER_S * 1e3
            if this_tree:
                assert row["kernels_per_call"] == 1 and row["copies_per_call"] <= 1, row
        out[name] = row
    # just past the end, and far outside the buffer (a gather there would fault the context)
    for j in (-1, idx.shape[0], idx.shape[0] + 5, 1 << 30, 2**31 - 1, -(2**31) + 1):
        bad = idx.clone()
        bad[7, 0] = j
        bad_mask = mask.clone()
        bad_mask[7, 0] = True
        try:
            cc_kernel.cc_neighbors(bad, bad_mask)
            torch.cuda.synchronize()
        except ValueError as err:
            out["bad_index"] = f"ValueError: {err}"
        else:
            raise AssertionError(f"cc_neighbors: the unmasked index {j} outside [0, N) was not refused")
    # the context survived: the next call still agrees with the plain version
    assert torch.equal(cc_kernel.cc_neighbors(idx, mask), cc_kernel.cc_neighbors_plain(idx, mask))
    ev = out["event0"]
    plain = cuda_ms(lambda: cc_kernel.cc_neighbors_plain(idx, mask), reps=1, rounds=3)
    log(f"kernel cc_neighbors: OK labels identical on every table, the bad indices refused; event 0 "
        f"({ev['components']} components, {ev['sweeps']} sweeps): {ev['ms']:.4f} ms a call, its kernels "
        f"{ev['device_ms']:.4f} ms on the device, {ev['kernels_per_call']:g} launch(es) and "
        f"{ev['copies_per_call']:g} copy(ies) a call (plain {plain:.3f} ms, bound {ev['bound_ms']:.4f} ms); "
        "cc timings: " + json.dumps(out))
    return {"name": "cc_neighbors", "max_abs_err": 0.0, "ms": ev["ms"], "plain_ms": plain,
            "bound_ms": ev["bound_ms"], "bound_by": "bytes", "library_ms": None}


def segment_sum_timings(seed: int) -> dict:
    """Row #9 on two target-sorted graphs, F = 32 seeded messages: phase 3's
    (the serving event ev00) and the masked tail (the training event with 20 %
    of ``edge_mask`` dropped, then ``sort_edges_by_target``, which points the
    ~52k masked edges at the last node). Each launch repeats bitwise and holds
    every node to the bound of recursive summation against float64; the kernel
    and ``torch.segment_reduce`` are timed on the device (``graph_ms``; the
    kernel's Python call also with ``cuda_ms``), with the bytes bound. It calls only
    ``segment_sum_csr`` and ``EventGraph``, so ``--segment-sum-only
    --package-root`` times another tree's kernel on the same inputs."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.ops.csr_segment import segment_sum_csr

    dev = torch.device("cuda")
    tail = make_train_event(seed + 5)
    tail["edge_mask"] = np.random.default_rng(seed + 6).random(N_EDGES) >= 0.2
    graphs = {
        "phase3": EventGraph.from_arrays(**make_event(seed + 10)),
        "masked_tail": EventGraph.from_arrays(**{k: v for k, v in tail.items() if k != "edge_mask"}).replace(
            edge_mask=torch.from_numpy(tail["edge_mask"])),
    }
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    out = {}
    for name, g in graphs.items():
        g = g.sort_edges_by_target().to(dev)
        rowptr = g.extras["dst_rowptr"]
        msgs = torch.randn((N_EDGES, 32), generator=gen, device=dev)
        got = segment_sum_csr(msgs, rowptr)
        again = segment_sum_csr(msgs, rowptr)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"sorted_segment_sum ({name}): second launch differs"
        ids = g.edge_index[1].long()
        ref = torch.zeros((N_NODES, 32), dtype=torch.float64, device=dev).index_add_(0, ids, msgs.double())
        absum = torch.zeros_like(ref).index_add_(0, ids, msgs.double().abs())
        count = torch.bincount(ids, minlength=N_NODES).double()[:, None]
        slack = (got.double() - ref).abs() - (count - 1).clamp(min=0) * 2.0**-24 * absum
        assert slack.max().item() <= 0, f"sorted_segment_sum ({name}): beyond the bound by {slack.max().item()}"
        offsets = rowptr.long()
        out[name] = {
            "ms": graph_ms(lambda: segment_sum_csr(msgs, rowptr)),
            "call_ms": cuda_ms(lambda: segment_sum_csr(msgs, rowptr)),
            "segment_reduce_ms": graph_ms(lambda: torch.segment_reduce(msgs, "sum", offsets=offsets, unsafe=True)),
            "bound_ms": bound(float(N_EDGES * 32), nbytes(msgs, rowptr, got))[0],
            "largest_segment": int(count.max().item()),
            "max_abs_err_vs_float64": (got.double() - ref).abs().max().item(),
        }
    log("sorted_segment_sum timings: " + json.dumps(out))
    return out


RELATIONAL_BWD_SHARES = (1.0, 0.8, 0.5, 0.0)
RAGGED_EDGES = N_EDGES - 37  # not a multiple of the backward's 64-edge tiles


def relational_bwd_timings(seed: int) -> dict:
    """Row #2 and D32 (rows #2 / #8 in f32) at the GraphTCN HC layer's shapes
    (phase 3's graph and layer: K = 96, H = 128, Fo = 32) and at ``ec.yml``'s
    widths (phase 10's: K = 192, H = 128, Fo = 64), each at the unmasked
    shares ``RELATIONAL_BWD_SHARES`` and at 0.8 on the first
    ``RAGGED_EDGES`` edges. Each run: every output within 4x the plain f32
    version's error against float64, ``relu_edge`` off and on; a second
    launch bitwise equal; D32 bitwise row #2; the masked edges'
    ``g_edge_attr`` rows exact zeros; then row #2, D32 and the plain version
    timed (``cuda_ms``) beside the bound of the unmasked share
    (``bwd_bound_bytes``). It calls only the port's public
    models and ``fused_relational_bwd`` / ``_saved``, so
    ``--relational-bwd-only --package-root`` times another tree's kernel on
    the same inputs."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
    from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN
    from gnn_tracking_tpu_torch.ops import fused_relational as fr

    dev = torch.device("cuda")
    tcn = GraphTCN(**MODEL, device="cpu", generator=torch.Generator().manual_seed(seed)).to(dev)
    ec = ECForGraphTCN(**EC_MODEL, device="cpu", generator=torch.Generator().manual_seed(seed + 143)).to(dev)
    ev_hc, ev_ec = make_event(seed + 10), make_ec_event(seed + 142)
    ragged = lambda ev: {"x": ev["x"], "edge_index": ev["edge_index"][:, :RAGGED_EDGES],
                         "edge_attr": ev["edge_attr"][:RAGGED_EDGES]}
    # (name, model's layer inputs, event arrays, seed of the 0.8 mask as in phases 3 / 10)
    layers = {
        "graphtcn_hc": (lambda g: (torch.relu(tcn.hc_node_encoder(g.x)), tcn.hc_edge_encoder(g.edge_attr),
                                   tcn.hc_in.layers[1].relational_weights()), ev_hc, seed + 3),
        "ec_yml": (lambda g: (torch.relu(ec.ec_node_encoder(g.x)), ec.ec_edge_encoder(g.edge_attr),
                              ec.ec_resin.layers[1].relational_weights()), ev_ec, seed + 145),
    }
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    named = lambda out: [out[0], out[1], *out[2].values()]
    out = {}
    with torch.no_grad():
        for name, (inputs, ev, mask_seed) in layers.items():
            runs = [(f"{share}", share, ev) for share in RELATIONAL_BWD_SHARES]
            runs.append((f"0.8_E{RAGGED_EDGES}", 0.8, ragged(ev)))
            for label, share, arrays in runs:
                g = EventGraph.from_arrays(**arrays).sort_edges_by_target().to(dev)
                e, n, csr = g.edge_index.shape[1], g.x.shape[0], g.csr()
                x, ea, weights = inputs(g)
                x, ea = x.contiguous(), ea.contiguous()
                weights = {k: v.detach() for k, v in weights.items()}
                mask = torch.from_numpy(np.random.default_rng(mask_seed).random(e) < share).to(dev)
                fo = weights["w3"].shape[0]
                g_e = torch.randn((e, fo), generator=gen, device=dev)
                g_a = torch.randn((n, fo), generator=gen, device=dev)
                src, dst = g.edge_index.long()
                gd, gs = x[dst].contiguous(), x[src].contiguous()
                args = (x, ea, g.edge_index, mask, weights, g_e, g_a)
                args64 = (x.double(), ea.double(), g.edge_index, mask,
                          {k: v.double() for k, v in weights.items()}, g_e.double(), g_a.double())
                worst = 0.0
                for relu_edge in (False, True):
                    kw = {"relu_edge": relu_edge}
                    k_out = named(fr.fused_relational_bwd(*args, csr, **kw))
                    k_again = named(fr.fused_relational_bwd(*args, csr, **kw))
                    d_out = named(fr.fused_relational_bwd_saved(gd, gs, *args[1:], csr, n, **kw))
                    p_out = named(fr.fused_relational_bwd_plain(*args, **kw))
                    r_out = named(fr.fused_relational_bwd_plain(*args64, **kw))
                    torch.cuda.synchronize()
                    where = f"fused_relational_bwd ({name}, unmasked share {label}, relu_edge={relu_edge})"
                    assert (k_out[1][~mask] == 0).all(), f"{where}: masked g_edge_attr rows not zero"
                    for kt, k2, dt, pt_, rt in zip(k_out, k_again, d_out, p_out, r_out):
                        assert torch.equal(kt, k2), f"{where}: second launch differs"
                        assert torch.equal(kt, dt), f"{where}: D32 differs from row #2"
                        ek, ep = (kt.double() - rt).abs().max().item(), (pt_.double() - rt).abs().max().item()
                        assert math.isfinite(ek) and ek <= 4 * ep, f"{where}: err {ek:.3e} > 4 x plain {ep:.3e}"
                        worst = max(worst, ek)
                ms = cuda_ms(lambda: fr.fused_relational_bwd(*args, csr))
                ms_d = cuda_ms(lambda: fr.fused_relational_bwd_saved(gd, gs, *args[1:], csr, n))
                plain = cuda_ms(lambda: fr.fused_relational_bwd_plain(*args))
                k2_ = 2 * x.shape[1] + ea.shape[1]
                hid, n_valid = weights["w2"].shape[0], int(mask.sum())
                outs = named(fr.fused_relational_bwd(*args, csr))
                # only what the unmasked edges need, as for B / D
                flops = 2.0 * n_valid * (3 * k2_ * hid + 3 * hid * hid + 2 * hid * fo)
                bnd, by = bound(flops, bwd_bound_bytes(x, *args[1:], outs))
                bnd_d, by_d = bound(flops, bwd_bound_bytes((gd, gs), *args[1:], outs))
                out[f"{name}/{label}"] = {
                    "edges": e, "unmasked": n_valid, "ms": ms, "d32_ms": ms_d, "plain_ms": plain,
                    "bound_ms": bnd, "bound_by": by, "d32_bound_ms": bnd_d, "d32_bound_by": by_d,
                    "max_abs_err_vs_float64": worst,
                }
                log(f"  fused_relational_bwd {name} (K={k2_}, H={hid}, Fo={fo}) unmasked {label} "
                    f"({n_valid} of {e} edges): OK; {ms:.3f} ms, D32 {ms_d:.3f} ms (plain {plain:.3f} ms, "
                    f"bound {bnd:.4f} ms by {by}, D32's {bnd_d:.4f} ms by {by_d})")
    log("fused_relational_bwd timings: " + json.dumps(out))
    return out


EC_BWD_SHARES = (1.0, 0.8, 0.5, 0.0)


def kernel_device_ms(fn, name: str, *, reps: int = 10, tries: int = 3) -> tuple[float, int]:
    """``torch.profiler`` over ``reps`` calls of ``fn`` (after one warm-up),
    each of which launches the kernel whose name holds ``name`` once: the
    mean device time of one of its launches, over the launches the trace
    recorded, and their number. The trace can drop records, so up to
    ``tries`` traces are taken until one holds all ``reps``. The host's work
    is left out, which ``cuda_ms`` counts wherever it exceeds the device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        mine = [e for e in prof.events() if e.device_type == DeviceType.CUDA and name in e.name]
        if len(mine) == reps:
            break
    assert mine, f"profiler: no launch of {name!r} in {reps} calls"
    return sum(e.time_range.end - e.time_range.start for e in mine) / len(mine) / 1e3, len(mine)


def device_ms_per_call(fn, names, *, reps: int = 5, tries: int = 3) -> float:
    """``torch.profiler`` over ``reps`` calls of ``fn`` (after one warm-up):
    the device time of every kernel whose name holds one of ``names``, per
    call (a call that launches several kernels, or one several times). The
    trace can come back without device records: up to ``tries`` traces."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        mine = [e for e in prof.events() if e.device_type == DeviceType.CUDA and any(n in e.name for n in names)]
        if mine:
            break
    assert mine, f"profiler: no launch of {names} in {reps} calls"
    return sum(e.time_range.end - e.time_range.start for e in mine) / reps / 1e3


def bwd_bound_bytes(rows, edge_attr, edge_index, mask, weights, g_e, g_agg, outs) -> int:
    """The bytes the fused backward must move at this mask, each input read
    once and each output written once: the mask; the unmasked edges'
    endpoints, ``edge_attr`` and ``g_e`` rows; the node rows they read (each
    node's ``x`` row once, or with ``rows = (x[dst], x[src])`` their own saved
    rows) and their targets' ``g_agg`` rows; the weights; every output row
    (``outs``: g_x, g_edge_attr and the weight gradients)."""
    import torch

    on = mask.nonzero().squeeze(1)
    src, dst = edge_index[0, on].long(), edge_index[1, on].long()
    width = lambda t: t.shape[1] * t.element_size()
    if isinstance(rows, tuple):
        node_rows = on.numel() * (width(rows[0]) + width(rows[1]))
    else:
        node_rows = torch.unique(torch.cat([src, dst])).numel() * width(rows)
    return (nbytes(mask) + on.numel() * (2 * edge_index.element_size() + width(edge_attr) + width(g_e))
            + node_rows + torch.unique(dst).numel() * width(g_agg) + nbytes(*weights.values(), *outs))


def fwd_bound_bytes(x, edge_attr, edge_index, mask, weights, rowptr, outs, *, save=False) -> int:
    """The bytes the fused forward must move at this mask, each input read
    once and each output written once: the mask; the unmasked edges'
    endpoints and ``edge_attr`` rows; each node's ``x`` row that they touch,
    once; the weights; ``rowptr``; every output row (``outs``: all E rows of
    e_tilde, agg and, with ``save``, the saved endpoint rows, whose copies
    read every edge's endpoints and touch every endpoint's ``x`` row)."""
    import torch

    on = mask.nonzero().squeeze(1)
    ends = edge_index if save else edge_index[:, on]
    nodes = torch.unique(ends.reshape(-1)).numel()
    return (nbytes(mask, rowptr, *weights.values(), *outs) + ends.numel() * edge_index.element_size()
            + on.numel() * edge_attr.shape[1] * edge_attr.element_size()
            + nodes * x.shape[1] * x.element_size())


def ec_bwd_inputs(seed: int) -> list[tuple]:
    """Phase 9's inputs of kernels B and D (``ec.yml``'s model, the EC event,
    the second layer's weights and inputs, the cotangents) for each case of
    ``ec_bwd_timings``: ``(label, args, csr, num_nodes, gd, gs)`` with
    ``args = (x, edge_attr, edge_index, mask, weights, g_e, g_agg)``, bf16 on
    the card."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN

    dev, bf = torch.device("cuda"), torch.bfloat16
    model = ECForGraphTCN(**EC_MODEL, device="cpu", generator=torch.Generator().manual_seed(seed + 121)).to(dev)
    ev = make_ec_event(seed + 120)
    ragged = {"x": ev["x"], "edge_index": ev["edge_index"][:, :RAGGED_EDGES],
              "edge_attr": ev["edge_attr"][:RAGGED_EDGES]}
    runs = [(f"{share}", share, ev) for share in EC_BWD_SHARES]
    runs.append((f"0.8_E{RAGGED_EDGES}", 0.8, ragged))
    cases = []
    with torch.no_grad():
        for label, share, arrays in runs:
            g = EventGraph.from_arrays(**{k: arrays[k] for k in ("x", "edge_index", "edge_attr")})
            g = g.sort_edges_by_target().to(dev)
            e, n = g.edge_index.shape[1], g.x.shape[0]
            gen = torch.Generator(device=dev).manual_seed(seed + 9)
            x = torch.relu(model.ec_node_encoder(g.x)).to(bf).contiguous()
            ea = model.ec_edge_encoder(g.edge_attr).to(bf).contiguous()
            weights = {k: v.detach().to(bf).contiguous()
                       for k, v in model.ec_resin.layers[1].relational_weights().items()}
            mask = torch.from_numpy(np.random.default_rng(seed + 3).random(e) < share).to(dev)
            fo = weights["w3"].shape[0]
            g_e = torch.randn((e, fo), generator=gen, device=dev).to(bf)
            g_a = torch.randn((n, fo), generator=gen, device=dev).to(bf)
            src, dst = g.edge_index.long()
            cases.append((label, (x, ea, g.edge_index, mask, weights, g_e, g_a), g.csr(), n,
                          x[dst].contiguous(), x[src].contiguous()))
    return cases


def ec_bwd_timings(seed: int) -> dict:
    """Kernels B and D (rows #4/#6 and #8 in bf16) at phase 9's input at the
    unmasked shares ``EC_BWD_SHARES`` and at 0.8 on the first
    ``RAGGED_EDGES`` edges (``ec_bwd_inputs``). Each case, ``relu_edge`` off
    and on: phase 9's ``bf16_check`` of B and D against the plain bf16
    version and float64 (repeat bitwise), D bitwise B, the masked edges'
    ``g_edge_attr`` rows zero. Timed with ``relu_edge`` (as layers 2-6 run
    it): B and D as Python calls (``cuda_ms``) and on the device (the call
    by CUDA-graph replay, ``graph_ms``; the edge kernel alone,
    ``kernel_device_ms``), beside the plain version and the bound of the
    unmasked share (``bwd_bound_bytes``). It calls only the port's public
    model and the ``fused_relational_bf16_bwd`` / ``_saved`` wrappers, so
    ``--ec-bwd-only --package-root`` times another tree's kernels on the
    same inputs."""
    import torch

    from gnn_tracking_tpu_torch.ops import fused_relational as fr

    bwd = lambda out: {"g_x": out[0], "g_edge_attr": out[1], **out[2]}
    out = {}
    with torch.no_grad():
        for label, args, csr, n, gd, gs in ec_bwd_inputs(seed):
            mask, weights = args[3], args[4]
            b_call = lambda **kw: fr.fused_relational_bf16_bwd(*args, csr, **kw)
            d_call = lambda **kw: fr.fused_relational_bf16_bwd_saved(gd, gs, *args[1:], csr, n, **kw)
            args64 = (*(t.double() for t in args[:2]), *args[2:4], {k: v.double() for k, v in weights.items()},
                      *(t.double() for t in args[5:]))
            worst = 0.0
            for relu_edge in (False, True):
                kw = {"relu_edge": relu_edge}
                where = f"ec bwd (unmasked share {label}, relu_edge={relu_edge})"
                b, b2 = bwd(b_call(**kw)), bwd(b_call(**kw))
                d, d2 = bwd(d_call(**kw)), bwd(d_call(**kw))
                pb = bwd(fr.fused_relational_bf16_bwd_plain(*args, **kw))
                ref = bwd(fr.fused_relational_bwd_plain(*args64, **kw))
                torch.cuda.synchronize()
                errs = bf16_check(f"fused_relational_bf16_bwd, {where}", b, b2, pb, ref)
                bf16_check(f"fused_relational_bf16_bwd_saved, {where}", d, d2, pb, ref)
                assert all(torch.equal(b[k], d[k]) for k in b), f"{where}: D differs from B"
                assert not b["g_edge_attr"][~mask].any(), f"{where}: masked g_edge_attr rows not zero"
                worst = max(worst, max(err[1] for err in errs))
            kw = {"relu_edge": True}
            ms, ms_d = cuda_ms(lambda: b_call(**kw)), cuda_ms(lambda: d_call(**kw))
            plain = cuda_ms(lambda: fr.fused_relational_bf16_bwd_plain(*args, **kw))
            call, call_d = graph_ms(lambda: b_call(**kw)), graph_ms(lambda: d_call(**kw))
            kern, records = kernel_device_ms(lambda: b_call(**kw), "bwd_kernel")
            kern_d, records_d = kernel_device_ms(lambda: d_call(**kw), "bwd_kernel")
            x, ea, e = args[0], args[1], args[1].shape[0]
            fo, hid, n_valid = weights["w3"].shape[0], weights["w2"].shape[0], int(mask.sum())
            k_ = 2 * x.shape[1] + ea.shape[1]
            g_x, g_ea, grads = b_call(**kw)
            bnd, by = bound(2.0 * n_valid * (3 * k_ * hid + 3 * hid * hid + 2 * hid * fo),
                            bwd_bound_bytes(x, *args[1:], (g_x, g_ea, *grads.values())),
                            peak=PEAK_BF16_FLOPS)
            out[label] = {
                "edges": e, "unmasked": n_valid, "ms": ms, "d_ms": ms_d, "kernel_device_ms": kern,
                "kernel_records": records, "call_device_ms": call, "d_kernel_device_ms": kern_d,
                "d_kernel_records": records_d, "d_call_device_ms": call_d,
                "plain_ms": plain, "bound_ms": bnd, "bound_by": by, "max_abs_err": worst,
            }
            log(f"  fused_relational_bf16_bwd unmasked {label} ({n_valid} of {e} edges): OK; B {ms:.4f} ms "
                f"a call ({call:.4f} on the device, edge kernel {kern:.4f}), D {ms_d:.4f} ({call_d:.4f}, "
                f"{kern_d:.4f}); plain {plain:.4f} ms, bound {bnd:.4f} ms by {by}")
    log("fused_relational_bf16_bwd timings: " + json.dumps(out))
    return out


def ec_fwd_timings(seed: int) -> dict:
    """Kernels A and C (rows #3/#5 and #7 in bf16) at phase 9's input at the
    unmasked shares ``EC_BWD_SHARES`` and at 0.8 on the first
    ``RAGGED_EDGES`` edges (``ec_bwd_inputs``). Each case, ``relu_edge`` off
    and on: phase 9's ``bf16_check`` of A and C against the plain bf16
    version and float64 (repeat bitwise), C bitwise A, the masked edges'
    ``e_tilde`` rows exactly zero, C's saved rows equal to ``x[dst]`` /
    ``x[src]`` on every edge. Timed with ``relu_edge`` (as layers 2-6 run
    it): A and C as Python calls (``cuda_ms``) and on the device (the call by
    CUDA-graph replay, ``graph_ms``; the edge kernel alone,
    ``kernel_device_ms``), beside the plain version and the bound of the
    unmasked share (``fwd_bound_bytes``). It calls only the port's public
    model and the ``fused_relational_bf16_fwd`` / ``_save`` wrappers, so
    ``--ec-fwd-only --package-root`` times another tree's kernels on the
    same inputs."""
    import torch

    from gnn_tracking_tpu_torch.ops import fused_relational as fr

    names = ("e_tilde", "agg")
    fwd = lambda out: dict(zip(names, out))
    out = {}
    with torch.no_grad():
        for label, args, csr, _, gd, gs in ec_bwd_inputs(seed):
            x, ea, ei, mask, weights = fa = args[:5]
            rowptr = csr["dst_rowptr"]
            a_call = lambda **kw: fr.fused_relational_bf16_fwd(*fa, rowptr=rowptr, **kw)
            c_call = lambda **kw: fr.fused_relational_bf16_fwd_save(*fa, rowptr=rowptr, **kw)
            args64 = (x.double(), ea.double(), ei, mask, {k: v.double() for k, v in weights.items()})
            worst = 0.0
            for relu_edge in (False, True):
                kw = {"relu_edge": relu_edge}
                where = f"ec fwd (unmasked share {label}, relu_edge={relu_edge})"
                a, a2 = fwd(a_call(**kw)), fwd(a_call(**kw))
                c, c2 = c_call(**kw), c_call(**kw)
                pa = fwd(fr.fused_relational_bf16_plain(*fa, **kw))
                ref = fwd(fr.fused_relational_plain(*args64, **kw))
                torch.cuda.synchronize()
                errs = bf16_check(f"fused_relational_bf16_fwd, {where}", a, a2, pa, ref)
                bf16_check(f"fused_relational_bf16_fwd_save, {where}", fwd(c), fwd(c2), pa, ref)
                assert all(torch.equal(a[k], t) for k, t in zip(names, c)), f"{where}: C differs from A"
                assert torch.equal(c[2], gd) and torch.equal(c[3], gs), f"{where}: C's saved rows differ"
                assert torch.equal(c2[2], gd) and torch.equal(c2[3], gs), f"{where}: C's saved rows differ"
                assert not a["e_tilde"][~mask].any(), f"{where}: masked e_tilde rows not zero"
                worst = max(worst, max(err[1] for err in errs))
            kw = {"relu_edge": True}
            ms, ms_c = cuda_ms(lambda: a_call(**kw)), cuda_ms(lambda: c_call(**kw))
            plain = cuda_ms(lambda: fr.fused_relational_bf16_plain(*fa, **kw))
            call, call_c = graph_ms(lambda: a_call(**kw)), graph_ms(lambda: c_call(**kw))
            kern, records = kernel_device_ms(lambda: a_call(**kw), "fwd_kernel")
            kern_c, records_c = kernel_device_ms(lambda: c_call(**kw), "fwd_kernel")
            e, fo, hid, n_valid = ea.shape[0], weights["w3"].shape[0], weights["w2"].shape[0], int(mask.sum())
            k_ = 2 * x.shape[1] + ea.shape[1]
            flops = 2.0 * n_valid * (k_ * hid + hid * hid + hid * fo)
            c = c_call(**kw)
            bnd, by = bound(flops, fwd_bound_bytes(*fa, rowptr, c[:2]), peak=PEAK_BF16_FLOPS)
            bnd_c, by_c = bound(flops, fwd_bound_bytes(*fa, rowptr, c, save=True), peak=PEAK_BF16_FLOPS)
            out[label] = {
                "edges": e, "unmasked": n_valid, "ms": ms, "c_ms": ms_c, "kernel_device_ms": kern,
                "kernel_records": records, "call_device_ms": call, "c_kernel_device_ms": kern_c,
                "c_kernel_records": records_c, "c_call_device_ms": call_c, "plain_ms": plain,
                "bound_ms": bnd, "bound_by": by, "c_bound_ms": bnd_c, "c_bound_by": by_c,
                "max_abs_err": worst,
            }
            log(f"  fused_relational_bf16_fwd unmasked {label} ({n_valid} of {e} edges): OK; A {ms:.4f} ms "
                f"a call ({call:.4f} on the device, edge kernel {kern:.4f}), C {ms_c:.4f} ({call_c:.4f}, "
                f"{kern_c:.4f}); plain {plain:.4f} ms, bound {bnd:.4f} ms by {by} (C {bnd_c:.4f})")
    log("fused_relational_bf16_fwd timings: " + json.dumps(out))
    return out


# (Fx, Fe, H, Fo, edges, unmasked share): narrower than ec.yml's (two m buffers), two whose
# second m buffer does not fit one block's shared memory (one m buffer), one edge, all masked
EC_BWD_WIDTHS = [(32, 32, 64, 32, 16000, 0.8), (32, 64, 96, 64, 5000, 0.5), (64, 64, 128, 128, 16000, 0.8),
                 (128, 32, 128, 32, 3000, 0.9), (64, 64, 128, 64, 1, 1.0), (64, 64, 128, 64, 1000, 0.0)]
EC_BWD_BEYOND = (64, 64, 256, 64)  # weights alone exceed one block's shared memory: the wide layout


def ec_width_case(seed, fx, fe, h, fo, e, share, n=2000):
    """A random target-sorted graph of ``n`` nodes and ``e`` edges on the card
    and the bf16 inputs of kernels A-D at widths (Fx, Fe, H, Fo): ``(graph,
    (x, edge_attr, edge_index, mask, weights, g_e, g_agg))``."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph

    dev, bf = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, size=e)
    src = np.clip(dst + rng.integers(-200, 200, size=e), 0, n - 1)
    g = EventGraph.from_arrays(x=rng.normal(size=(n, fx)), edge_index=np.stack([src, dst]),
                               edge_attr=rng.normal(size=(e, fe))).sort_edges_by_target().to(dev)
    mask = torch.from_numpy(rng.random(e) < share).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev) * scale).to(bf)
    w = {"w1": r(h, 2 * fx + fe, scale=0.1), "b1": r(h), "w2": r(h, h, scale=0.1), "b2": r(h),
         "w3": r(fo, h, scale=0.1), "b3": r(fo)}
    return g, (g.x.to(bf), g.edge_attr.to(bf), g.edge_index, mask, w, r(e, fo), r(n, fo))


def ec_fwd_widths(seed: int) -> dict:
    """Kernels A and C at the widths ``EC_BWD_WIDTHS`` (``ec_width_case``),
    ``relu_edge`` off and on: ``bf16_check`` against the plain bf16 version
    and float64 (repeat bitwise), C bitwise A, the masked edges' ``e_tilde``
    rows zero, C's saved rows ``x[dst]`` / ``x[src]``. Then A and C at
    ``EC_BWD_BEYOND``, through the wide layout (``beyond_shared_memory``)."""
    import torch

    from gnn_tracking_tpu_torch.ops import fused_relational as fr

    names = ("e_tilde", "agg")
    fwd = lambda o: dict(zip(names, o))
    out = {}
    with torch.no_grad():
        for fx, fe, h, fo, e, share in EC_BWD_WIDTHS:
            g, args = ec_width_case(seed, fx, fe, h, fo, e, share)
            fa, rowptr, (src, dst) = args[:5], g.csr()["dst_rowptr"], g.edge_index.long()
            args64 = (args[0].double(), args[1].double(), *args[2:4], {k: v.double() for k, v in args[4].items()})
            label, worst = f"(Fx, Fe, H, Fo) = ({fx}, {fe}, {h}, {fo}), E = {e}, unmasked {share}", 0.0
            for relu_edge in (False, True):
                kw = {"relu_edge": relu_edge}
                a = fwd(fr.fused_relational_bf16_fwd(*fa, rowptr=rowptr, **kw))
                a2 = fwd(fr.fused_relational_bf16_fwd(*fa, rowptr=rowptr, **kw))
                c = fr.fused_relational_bf16_fwd_save(*fa, rowptr=rowptr, **kw)
                pa = fwd(fr.fused_relational_bf16_plain(*fa, **kw))
                ref = fwd(fr.fused_relational_plain(*args64, **kw))
                torch.cuda.synchronize()
                where = f"ec fwd {label}, relu_edge={relu_edge}"
                errs = bf16_check(f"fused_relational_bf16_fwd, {where}", a, a2, pa, ref)
                assert all(torch.equal(a[k], t) for k, t in zip(names, c)), f"{where}: C differs from A"
                assert torch.equal(c[2], args[0][dst]) and torch.equal(c[3], args[0][src]), (
                    f"{where}: C's saved rows differ from x[dst], x[src]")
                assert not a["e_tilde"][~args[3]].any(), f"{where}: masked e_tilde rows not zero"
                worst = max(worst, max(err[1] for err in errs))
            out[label] = worst
            log(f"  fused_relational_bf16_fwd {label}: OK (max |kernel - plain| {worst:.3e})")
        out["beyond"] = beyond_shared_memory(seed, forward=True, this_tree=True)
    return out


def ec_bwd_widths(seed: int, this_tree: bool = True) -> dict:
    """Kernels B and D at the widths ``EC_BWD_WIDTHS`` (``ec_width_case``),
    ``relu_edge`` off and on: ``bf16_check`` against the plain bf16 version
    and float64, D bitwise B, the masked edges' ``g_edge_attr`` rows zero.
    Then B and D at ``EC_BWD_BEYOND`` (``beyond_shared_memory``; a tree
    from before the wide layout may refuse them)."""
    import torch

    from gnn_tracking_tpu_torch.ops import fused_relational as fr

    bwd = lambda o: {"g_x": o[0], "g_edge_attr": o[1], **o[2]}
    case = lambda *a, **kw: ec_width_case(seed, *a, **kw)
    out = {}
    with torch.no_grad():
        for fx, fe, h, fo, e, share in EC_BWD_WIDTHS:
            g, args = case(fx, fe, h, fo, e, share)
            csr, (src, dst) = g.csr(), g.edge_index.long()
            gd, gs = args[0][dst].contiguous(), args[0][src].contiguous()
            args64 = (*(t.double() for t in args[:2]), *args[2:4], {k: v.double() for k, v in args[4].items()},
                      *(t.double() for t in args[5:]))
            label, worst = f"(Fx, Fe, H, Fo) = ({fx}, {fe}, {h}, {fo}), E = {e}, unmasked {share}", 0.0
            for relu_edge in (False, True):
                kw = {"relu_edge": relu_edge}
                b = bwd(fr.fused_relational_bf16_bwd(*args, csr, **kw))
                b2 = bwd(fr.fused_relational_bf16_bwd(*args, csr, **kw))
                d = bwd(fr.fused_relational_bf16_bwd_saved(gd, gs, *args[1:], csr, g.num_nodes, **kw))
                pb = bwd(fr.fused_relational_bf16_bwd_plain(*args, **kw))
                ref = bwd(fr.fused_relational_bwd_plain(*args64, **kw))
                torch.cuda.synchronize()
                where = f"ec bwd {label}, relu_edge={relu_edge}"
                errs = bf16_check(f"fused_relational_bf16_bwd, {where}", b, b2, pb, ref)
                assert all(torch.equal(b[k], d[k]) for k in b), f"{where}: D differs from B"
                assert not b["g_edge_attr"][~args[3]].any(), f"{where}: masked g_edge_attr rows not zero"
                worst = max(worst, max(err[1] for err in errs))
            out[label] = worst
            log(f"  fused_relational_bf16_bwd {label}: OK (max |kernel - plain| {worst:.3e})")
        out["beyond"] = beyond_shared_memory(seed, forward=False, this_tree=this_tree)
    return out


def beyond_shared_memory(seed: int, *, forward: bool, this_tree: bool) -> str:
    """A and C (``forward``) or B and D at ``EC_BWD_BEYOND``, whose weights
    exceed one block's shared memory: since the wide layout they run there,
    within 2e-2 of the plain version's norm (C / D bitwise A / B); a tree
    from before it (``this_tree`` False) may refuse them, and the refusal is
    reported. Any other failure fails the run."""
    import torch

    from gnn_tracking_tpu_torch.ops import fused_relational as fr

    g, args = ec_width_case(seed, *EC_BWD_BEYOND, 500, 0.8, n=100)
    csr = g.csr()
    try:
        if forward:
            k = fr.fused_relational_bf16_fwd(*args[:5], rowptr=csr["dst_rowptr"], relu_edge=True)
            kc = fr.fused_relational_bf16_fwd_save(*args[:5], rowptr=csr["dst_rowptr"], relu_edge=True)[:2]
            p = fr.fused_relational_bf16_plain(*args[:5], relu_edge=True)
        else:
            src, dst = g.edge_index.long()
            gd, gs = args[0][dst].contiguous(), args[0][src].contiguous()
            flat = lambda o: [o[0], o[1], *o[2].values()]
            k = flat(fr.fused_relational_bf16_bwd(*args, csr, relu_edge=True))
            kc = flat(fr.fused_relational_bf16_bwd_saved(gd, gs, *args[1:], csr, g.num_nodes, relu_edge=True))
            p = flat(fr.fused_relational_bf16_bwd_plain(*args, relu_edge=True))
        torch.cuda.synchronize()
    except (ValueError, RuntimeError) as err:
        if this_tree:
            raise
        said = f"refused ({type(err).__name__}: {err})"
    else:
        worst = 0.0
        for k_t, c_t, p_t in zip(k, kc, p):
            assert torch.equal(k_t, c_t), f"bf16 at {EC_BWD_BEYOND}: the saving / saved-rows kernel differs"
            rel = ((k_t.double() - p_t.double()).norm() / p_t.double().norm().clamp(min=1e-30)).item()
            assert rel <= 2e-2, f"bf16 at {EC_BWD_BEYOND}: {rel:.3e} of the plain norm"
            worst = max(worst, rel)
        said = f"ran, within {worst:.3e} of the plain norm"
    which = "A / C" if forward else "B / D"
    log(f"  {which} at (Fx, Fe, H, Fo) = {EC_BWD_BEYOND}: {said}")
    return said


TOPK_TRAIN_STEPS = ML_WARMUP + 15  # optimizer steps behind phase 7's trained latent (30 + 10 + 5)


def filter_bound(x, k: int, mask, batch) -> tuple[float, str]:
    """Row #12's bound: 3 flops per dimension for each pair of a query (every
    point, masked ones too) and a valid candidate of its batch; bytes of the
    points, mask, batch ids and the [N, k] outputs."""
    import torch

    ids = batch.long()
    queries = torch.bincount(ids).double()
    valid = torch.bincount(ids[mask], minlength=queries.numel()).double()
    return bound(3.0 * x.shape[1] * float((queries * valid).sum()),
                 nbytes(x, mask, batch) + 8 * x.shape[0] * k)


def trained_ml(seed: int):
    """Phase 7's model trained as phase 7 trains it (``TOPK_TRAIN_STEPS``
    ``MLModule`` steps on its cloud): ``(cloud, model, latent at step 0,
    trained latent, seconds of training)``."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.losses.metric_learning import GraphConstructionHingeEmbeddingLoss
    from gnn_tracking_tpu_torch.models.graph_construction import GraphConstructionFCNN
    from gnn_tracking_tpu_torch.training.module import MLModule

    g = EventGraph.from_arrays(**make_point_cloud(seed + 80, ML_HITS, ML_PARTICLES)).to("cuda")
    model = GraphConstructionFCNN(**ML_MODEL, device="cpu", generator=torch.Generator().manual_seed(seed + 81))
    module = MLModule(model=model, loss_fct=GraphConstructionHingeEmbeddingLoss(**ML_LOSS), lr=LR, device="cuda")
    module.setup_params(g)
    with torch.no_grad():
        h_step0 = model(g)["H"].detach().contiguous()
    t0 = time.perf_counter()
    while module.step < TOPK_TRAIN_STEPS:
        module.training_step(g)
    train_s = time.perf_counter() - t0
    with torch.no_grad():
        h_trained = model(g)["H"].detach().contiguous()
    return g, model, h_step0, h_trained, train_s


def topk_inputs(seed: int, condensed) -> tuple[list, float]:
    """The inputs of ``topk_timings``: ``(name, points, keyword arguments of
    pairwise_topk_filter)`` each, and the seconds the ML training took."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN
    from gnn_tracking_tpu_torch.ops import pairwise_topk as pt

    dev = torch.device("cuda")
    r2_ml = ML_LOSS.get("r_emb", 1.0) ** 2 * (1.0 + 1e-3)
    r2_serve = EPS * EPS * (1.0 + 1e-3)
    g, _, h_step0, h_trained, train_s = trained_ml(seed)
    tcn = condensed(GraphTCN(**MODEL, device="cpu", generator=torch.Generator().manual_seed(seed))).to(dev).eval()
    ev = EventGraph.from_arrays(**make_event(seed + 10)).to(dev).sort_edges_by_target(with_unsort=True)
    with torch.no_grad():
        h_serve = tcn(ev)["H"].float().contiguous()
    x10, mask10, batch10 = phase10_input(seed)
    rng = np.random.default_rng(seed + 150)
    direction = rng.normal(size=8)
    line = (1e-3 * np.arange(ML_HITS)[:, None] * direction / np.linalg.norm(direction)).astype(np.float32)
    dup = np.repeat(rng.normal(size=(1024, 8)).astype(np.float32), ML_HITS // 1024, axis=0)
    ragged = rng.normal(size=(ML_HITS - 37, 8)).astype(np.float32)
    small = rng.normal(size=(100, 8)).astype(np.float32)
    wide = rng.normal(size=(ML_HITS, 20)).astype(np.float32)
    on = lambda a: torch.from_numpy(a).to(dev)
    # (name, points, keyword arguments)
    runs = [
        ("ml_step0_radius_k256", h_step0, {"k": 256, "radius2": r2_ml}),
        ("ml_trained_radius_k256", h_trained, {"k": 256, "radius2": r2_ml}),
        ("serving_radius_k64", h_serve, {"k": CAP, "radius2": r2_serve}),
        ("serving_knn_k64", h_serve, {"k": CAP}),
        *[(f"phase10_knn_k{k}", x10, {"k": k, "node_mask": mask10, "batch": batch10}) for k in (8, 64, 256)],
        ("adversarial_line_knn_k256", on(line), {"k": 256}),
        ("adversarial_line_radius_k256", on(line), {"k": 256, "radius2": 1.0}),
        ("duplicates_knn_k64", on(dup), {"k": 64}),
        ("duplicates_radius_k256", on(dup), {"k": 256, "radius2": 0.5}),
        ("ragged_n32731_knn_k256", on(ragged), {"k": 256}),
        ("small_n100_knn_k256", on(small), {"k": 256}),
        # the other padded widths (D = 3, 14 and 20: 4, 16 and 32 columns) and `loop`
        ("hits_xyz_d3_knn_k64", g.extras["xyz"].contiguous(), {"k": 64}),
        ("features_d14_knn_k16_loop", g.x.contiguous(), {"k": 16, "loop": True}),
        ("random_d20_knn_k32", on(wide), {"k": 32}),
    ]
    if getattr(pt, "MAX_K_FILTER", 0) >= 512:
        runs.append(("k512_radius", h_trained, {"k": 512, "radius2": r2_ml}))
    if hasattr(pt, "_topk_passes"):  # k above one pass of the kernel
        runs.append(("k1024_radius", h_trained, {"k": 1024, "radius2": r2_ml}))
    return runs, train_s


def topk_timings(seed: int, condensed) -> dict:
    """Row #12 (``pairwise_topk_filter``) on the inputs of ``--topk-only``:
    radius mode at k = 256 on phase 7's cloud embedded by the random FCNN
    (step 0: full rows) and by the FCNN after ``TOPK_TRAIN_STEPS``
    ``MLModule`` steps (as phase 7 trains it); the serving shapes (phase 3's
    latent of ``condensed``, r = 0.3 with phase 3's inflation, k = 64, and
    kNN mode); phase 10 (a)'s input (two batches, 10 % masked) in kNN mode at
    k = 8, 64 and 256, bitwise equal to row #13 on the unmasked queries; an
    adversarial order (points on a line: each query's candidates below it
    arrive by decreasing distance, so every one improves the running set);
    exact duplicates (1,024 points 32 times each: ties); N = 32,731 (a
    ragged last block and tile) and N = 100 < k; the ML cloud's 3-d hit
    coordinates, its 14 node features (``loop=True``) and a 20-d normal
    cloud, the kernel's other padded widths; k = 512 and k = 1,024 (passes
    above a key floor) where the package takes them. Each run: ``compare_topk`` against the plain version, a second
    launch bitwise the first; the kernel (``cuda_ms``) and the plain version
    timed beside the bound. It calls only the package's public functions, so
    ``--topk-only --package-root`` times another tree's kernel on the same
    inputs (the trained latent up to the training's own nondeterminism)."""
    import torch

    from gnn_tracking_tpu_torch.ops import pairwise_topk as pt

    dev = torch.device("cuda")
    runs, train_s = topk_inputs(seed, condensed)
    out = {}
    for name, x, kw in runs:
        k, r2, mask, batch = kw["k"], kw.get("radius2"), kw.get("node_mask"), kw.get("batch")
        kd, ki = pt.pairwise_topk_filter(x, **kw)
        kd2, ki2 = pt.pairwise_topk_filter(x, **kw)
        pd, pi = pt.pairwise_topk_filter_plain(x, **kw)
        torch.cuda.synchronize()
        assert torch.equal(kd, kd2) and torch.equal(ki, ki2), f"pairwise_topk_filter ({name}): second launch differs"
        err, nb, nt = compare_topk(kd, ki, pd, pi, r2)
        ties = assert_key_order(kd, ki, f"pairwise_topk_filter ({name})")
        extra = ""
        if batch is not None:
            sd, si = pt.pairwise_topk(x, k=k, node_mask=mask, batch=batch)
            torch.cuda.synchronize()
            assert torch.equal(sd[mask], kd[mask]) and torch.equal(si[mask], ki[mask]), (
                f"pairwise_topk_filter ({name}): unmasked rows differ from row #13's")
            extra = ", unmasked rows bitwise row #13's"
        filled = torch.isfinite(kd).sum(dim=1).float()
        first = cuda_ms(lambda: pt.pairwise_topk_filter(x, **kw), reps=1, rounds=1)
        fast = first < 50.0
        ms = cuda_ms(lambda: pt.pairwise_topk_filter(x, **kw), reps=5 if fast else 1, rounds=5 if fast else 3)
        plain = cuda_ms(lambda: pt.pairwise_topk_filter_plain(x, **kw), reps=1, rounds=3)
        n = x.shape[0]
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        bnd, by = filter_bound(x, k, ones if mask is None else mask,
                               torch.zeros(n, dtype=torch.int32, device=dev) if batch is None else batch)
        out[name] = {"n": n, "k": k, "radius2": r2, "ms": ms, "plain_ms": plain, "bound_ms": bnd,
                     "bound_by": by, "max_abs_err": err, "filled_mean": filled.mean().item(),
                     "full_rows": int((filled == k).sum())}
        log(f"  pairwise_topk_filter {name} (N={n}, D={x.shape[1]}, k={k}, radius2={r2}): OK max|err| "
            f"{err:.3e} ({nb} boundary rows, {nt} tie rows), key order ({ties} exact ties by rising "
            f"index), repeat bitwise{extra}; filled slots per row mean "
            f"{filled.mean().item():.1f}, {int((filled == k).sum())} full rows; {ms:.3f} ms (plain "
            f"{plain:.3f} ms, bound {bnd:.4f} ms by {by})")
    out["ml_training_s"] = train_s
    log("pairwise_topk_filter timings: " + json.dumps(out))
    return out


def phase10_input(seed: int):
    """Phase 10 (a)'s input: 32,768 points of the JAX kNN benchmark's
    clustered 8-d cloud, 10 % masked, two batch ids (first half 0)."""
    import torch

    dev = torch.device("cuda")
    x = torch.from_numpy(make_bench_latent(seed + 140, ML_HITS)[0]).to(dev)
    mask = torch.from_numpy(np.random.default_rng(seed + 141).random(ML_HITS) >= 0.1).to(dev)
    batch = torch.from_numpy((np.arange(ML_HITS) >= ML_HITS // 2).astype(np.int32)).to(dev)
    return x, mask, batch


def check_split(what, fn, x, kw, *, plain=True) -> dict:
    """Rows #13 / #11 (``fn``: ``pairwise_topk`` or ``pairwise_topk_streaming``)
    against row #12 on the same input: the unmasked rows bitwise equal,
    masked queries ``(+inf, 0)``, a second call bitwise the first, the
    contract's order; with ``plain``, ``compare_topk`` against the plain
    version too. Returns the error and tie counts."""
    import torch

    from gnn_tracking_tpu_torch.ops import pairwise_topk as pt

    kd, ki = fn(x, **kw)
    kd2, ki2 = fn(x, **kw)
    fd, fi = pt.pairwise_topk_filter(x, **kw)
    torch.cuda.synchronize()
    mask = kw.get("node_mask")
    keep = torch.ones(x.shape[0], dtype=torch.bool, device=x.device) if mask is None else mask
    assert torch.equal(kd, kd2) and torch.equal(ki, ki2), f"{what}: second call differs"
    assert torch.equal(kd[keep], fd[keep]) and torch.equal(ki[keep], fi[keep]), (
        f"{what}: unmasked rows differ from row #12's")
    assert torch.isinf(kd[~keep]).all() and (ki[~keep] == 0).all(), f"{what}: masked queries not (+inf, 0)"
    out = {"exact_ties": assert_key_order(kd, ki, what)}
    if plain:
        ref = pt.pairwise_topk_plain if fn is pt.pairwise_topk else pt.pairwise_topk_streaming_plain
        pd, pi = ref(x, **kw)
        out["max_abs_err"], out["boundary_rows"], out["tie_rows"] = compare_topk(kd, ki, pd, pi, None)
    return out


def split_checks(seed: int) -> dict:
    """The cases of ``test_cuda_split_topk_matches_plain_and_filter`` (whose
    module imports JAX, absent on the card's machine): rows #13 / #11 at k =
    1, 2, 8, 16, 32, 33, 64 and 300 on 4,096 points (15 % masked, two batch
    ids and 3 points of a third), batched and not, ``loop`` both ways; 512
    points each repeated 8 times (ties by index); 20 points (fewer than k);
    a block of 1,024 fully masked candidates. Each through ``check_split``."""
    import torch

    from gnn_tracking_tpu_torch.ops import pairwise_topk as pt

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 7)
    n = 4096
    x = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32)).to(dev)
    mask = rng.random(n) > 0.15
    batch = (np.arange(n) >= n // 2).astype(np.int32)
    batch[:3] = 2
    dup = x[:512].repeat_interleave(8, dim=0).contiguous()
    blocked = mask.copy()
    blocked[1024:2048] = False
    on = lambda a: torch.from_numpy(a).to(dev)
    cases = []
    for k in (1, 2, 8, 16, 32, 33, 64, 300):
        for loop in (False, True):
            cases.append((f"k{k}_batched_loop{int(loop)}", pt.pairwise_topk, x,
                          {"k": k, "node_mask": on(mask), "batch": on(batch), "loop": loop}))
            cases.append((f"k{k}_streaming_loop{int(loop)}", pt.pairwise_topk_streaming, x,
                          {"k": k, "node_mask": on(mask), "loop": loop}))
    for k in (1, 8, 32):
        cases.append((f"k{k}_duplicates", pt.pairwise_topk, dup, {"k": k, "batch": on(batch)}))
        cases.append((f"k{k}_masked_block", pt.pairwise_topk, x, {"k": k, "node_mask": on(blocked), "batch": on(batch)}))
    for k in (21, 32, 64):
        cases.append((f"k{k}_n20", pt.pairwise_topk_streaming, x[:20].contiguous(), {"k": k}))
    out = {}
    for name, fn, xs, kw in cases:
        out[name] = check_split(f"{fn.__name__} {name}", fn, xs, kw)
    log(f"split top-k checks: {len(out)} cases OK (bitwise row #12 on unmasked rows, masked (+inf, 0), "
        f"repeat bitwise, key order, plain version): " + json.dumps(out))
    return out


SPLIT_TIMING_KS = (1, 2, 4, 8, 16, 32)


def instruction_floor_ms(x, mask, batch) -> float:
    """The direct difference's instruction floor: 2 D + 1 FP32-pipe
    instructions (D subtractions, D FMAs, one compare) for each pair of a
    valid query and a valid candidate of its batch, issued by every lane of
    the card (SMs x 128) at its largest SM clock (``nvidia-smi``)."""
    import torch

    counts = torch.bincount(batch[mask].long()).double()
    return pairs_floor_ms(float((counts * counts).sum()), x.shape[1])


def pairs_floor_ms(pairs: float, d: int) -> float:
    """The direct difference's instruction floor of ``pairs`` pairs at ``d``
    dimensions: 2 d + 1 FP32-pipe instructions a pair on every lane of the
    card (SMs x 128) at its largest SM clock (``nvidia-smi``)."""
    import torch

    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                               check=True, capture_output=True, text=True).stdout.split()[0])
    lanes = torch.cuda.get_device_properties(0).multi_processor_count * 128
    return pairs * (2 * d + 1) / (lanes * mhz * 1e6) * 1e3


def split_timings(seed: int) -> dict:
    """Rows #13 / #11 beside row #12 on the inputs of ``--split-only``:
    phase 10 (a)'s input and phase 8's 262,144-point latent (the FCNN
    trained as phase 7 trains it, on phase 8's cloud; as ``knn_graph`` calls
    it) at k = 1, 2, 4, 8, 16, 32 (row #13: the crossover that sets
    ``knn.SPLIT_MAX_K``), and the JAX kNN benchmark's cloud at k = 8 (row
    #11). Each: ``check_split`` (the plain
    version at 32,768 points only), then the Python call (``cuda_ms``), the
    call on the device (``graph_ms``) and P / M alone (``kernel_device_ms``)
    beside row #12's, with the plan (R, S) and the bound and instruction
    floor. Then, for the package beside this script, other plans (R, S) on
    two inputs, each bitwise the default's. ``--split-only --package-root``
    times another tree's kernels on the same inputs."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.ops import knn
    from gnn_tracking_tpu_torch.ops import pairwise_topk as pt

    dev = torch.device("cuda")
    x10, mask10, batch10 = phase10_input(seed)
    _, model, _, _, _ = trained_ml(seed)
    cloud = make_point_cloud(seed + 90, GC_HITS, GC_PARTICLES)
    with torch.no_grad():
        latent = model.eval()(EventGraph.from_arrays(**cloud).to(dev))["H"].contiguous()
    bench = torch.from_numpy(make_bench_latent(seed + 92, GC_HITS)[0]).to(dev)
    runs = [(f"phase10_k{k}", pt.pairwise_topk, x10, {"k": k, "node_mask": mask10, "batch": batch10})
            for k in SPLIT_TIMING_KS]
    runs += [(f"trained_262k_k{k}", pt.pairwise_topk, latent, {"k": k}) for k in SPLIT_TIMING_KS]
    runs += [("bench_262k_k8", pt.pairwise_topk_streaming, bench, {"k": GC_K})]
    out = {}
    for name, fn, x, kw in runs:
        big = x.shape[0] > ML_HITS
        checked = check_split(f"{fn.__name__} {name}", fn, x, kw, plain=not big)
        call = lambda: fn(x, **kw)
        filt = lambda: pt.pairwise_topk_filter(x, **kw)
        plan = getattr(fn, "last_plan", None) or getattr(fn, "last_splits", None)
        reps, rounds = (1, 3) if big else (5, 5)
        n = x.shape[0]
        mask = kw.get("node_mask", torch.ones(n, dtype=torch.bool, device=dev))
        batch = kw.get("batch", torch.zeros(n, dtype=torch.int32, device=dev))
        bnd, by = topk_bound(x, kw["k"], mask, batch)
        r = {
            "n": n, "k": kw["k"], "plan": plan, **checked,
            "ms": cuda_ms(call, reps=reps, rounds=rounds),
            "graph_ms": graph_ms(call, reps=2 if big else 20, rounds=3 if big else 5),
            "p_ms": kernel_device_ms(call, "topk_partial_kernel", reps=3 if big else 10),
            "m_ms": kernel_device_ms(call, "topk_merge_kernel", reps=3 if big else 10),
            "filter_ms": cuda_ms(filt, reps=reps, rounds=rounds),
            "filter_graph_ms": graph_ms(filt, reps=2 if big else 20, rounds=3 if big else 5),
            "filter_kernel_ms": kernel_device_ms(filt, "topk_select_kernel", reps=3 if big else 10),
            "bound_ms": bnd, "bound_by": by, "instruction_floor_ms": instruction_floor_ms(x, mask, batch),
        }
        out[name] = r
        log(f"  {fn.__name__} {name} (N={n}, k={kw['k']}, plan {plan}): {r['ms']:.3f} ms a call, "
            f"{r['graph_ms']:.3f} on the device, P {r['p_ms'][0]:.3f} + M {r['m_ms'][0]:.4f}; row #12 "
            f"{r['filter_ms']:.3f} / {r['filter_graph_ms']:.3f} / kernel {r['filter_kernel_ms'][0]:.3f} ms; "
            f"bound {bnd:.4f} ms by {by}, instruction floor {r['instruction_floor_ms']:.3f} ms")
    wins = [k for k in SPLIT_TIMING_KS
            if all(out[f"{w}_k{k}"]["ms"] < out[f"{w}_k{k}"]["filter_ms"] for w in ("phase10", "trained_262k"))]
    out["split_max_k"] = max(wins, default=0)
    log(f"row #13 beats row #12 (Python call) on phase 10 (a)'s input and the trained 262k latent at k in "
        f"{wins}: knn.SPLIT_MAX_K should be {out['split_max_k']} (it is "
        f"{knn.SPLIT_MAX_K})")
    if hasattr(pt, "_split_plan"):
        out["plans"] = {}
        for name, fn, x, kw in (runs[3], runs[9]):  # phase 10 (a) and the trained latent at k = 8
            what = fn.__name__
            ref = fn(x, **kw)
            default = fn.last_plan
            tiles = -(-x.shape[0] // pt.CAND_ALIGN) * pt.CAND_ALIGN // pt.SPLIT_TILE
            for r_ in (1, 2):
                for s_ in (1, 2, 4, 8, 16):
                    span = -(-tiles // s_)
                    plan = (r_, -(-tiles // span), span)
                    call = lambda: pt._split_topk(what, x, kw["k"], kw.get("node_mask"), kw.get("batch"), False, plan)
                    try:
                        got = call()
                    except RuntimeError as err:  # R not built for this k and width
                        log(f"  plan {plan} for {name}: {err}")
                        continue
                    torch.cuda.synchronize()
                    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), f"{name}: plan {plan} differs"
                    big = x.shape[0] > ML_HITS
                    ms = cuda_ms(call, reps=1, rounds=3) if big else graph_ms(call, reps=10, rounds=3)
                    out["plans"][f"{name} R{plan[0]} S{plan[1]}"] = ms
                    log(f"  plan {plan} for {name}: {ms:.3f} ms{' (default)' if plan == default else ''}, bitwise the default's")
    log("split top-k timings: " + json.dumps(out))
    return out


# k at which --band-only checks and times row #14 (8: the windowed build's; 256: the
# hinge loss's cap, above the register path's 32), and those it also runs with `loop`;
# on the inputs of repeated points, DUP_KS both ways
BAND_KS = (1, 8, 16, 32, 64, 256)
BAND_LOOP_KS = (8, 64)
DUP_KS = (8, 32, 64)
# the copies of each point in row #14's tie-heavy inputs
DUP_COPIES = 6


def duplicated(args, kw) -> tuple:
    """Row #14's input with every distance tied ``DUP_COPIES`` ways: the
    first ``n / DUP_COPIES`` of the key-sorted points of ``args``, each
    repeated ``DUP_COPIES`` times (still in key order), cut to ``n``."""
    n = args[0].shape[0]
    m = -(-n // DUP_COPIES)

    def rep(t):
        return t[:m].repeat_interleave(DUP_COPIES, dim=0)[:n].contiguous()

    return (rep(args[0]), *args[1:]), {**kw, "valid": rep(kw["valid"])}


def band_inputs(seed: int) -> list[tuple]:
    """The inputs a 262,144-point windowed build gives row #14 in phase 8:
    the hits' spatial coordinates (d = 3) and the latent of the FCNN
    trained as phase 7 trains it (d = 8), each sorted along its principal
    axis by ``windowed_knn``, at radius 4, the spatial input at radius 8
    (the build's retry), and the two radius-4 inputs ``duplicated``.
    ``(name, args, kwargs)`` of ``banded_topk_sorted``."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.ops import windowed_topk

    g = EventGraph.from_arrays(**make_point_cloud(seed + 90, GC_HITS, GC_PARTICLES)).to("cuda")
    _, model, _, _, _ = trained_ml(seed)
    with torch.no_grad():
        latent = model.eval()(g)["H"].contiguous()
    calls, undo = capture(windowed_topk, "banded_topk_sorted")
    try:
        for x in (g.extras["xyz"].contiguous(), latent):
            windowed_topk.windowed_knn(x, k=GC_K, fallback_cap=0)
    finally:
        undo()
    (sa, skw), (ta, tkw) = calls
    return [("spatial_r4", sa, skw), ("trained_r4", ta, tkw), ("spatial_r8", sa, {**skw, "radius": 8}),
            (f"spatial_dup{DUP_COPIES}_r4", *duplicated(sa, skw)),
            (f"trained_dup{DUP_COPIES}_r4", *duplicated(ta, tkw))]


def banded_topk_fma_plain(x, *, k, radius, valid, block_q=256, block_c=1024, loop=False):
    """Row #14's output by the kernel's own arithmetic: per query block, the
    squared distances to its band as ``fmaf`` chains in dimension order
    (each step in float64, where ``df * df`` is exact, rounded once to
    float32), the exclusions, a stable sort. The kernel equals it bit for
    bit; the plain version (a square, then an add) may differ from it in
    the last bit of a distance, and so in the order of two near-equal
    ones."""
    import torch

    from gnn_tracking_tpu_torch.ops import windowed_topk

    n, d = x.shape
    xf = torch.where(valid[:, None], x, 1e30)
    out_d = torch.full((n, k), torch.inf, device=x.device)
    out_i = torch.zeros((n, k), dtype=torch.int32, device=x.device)
    for s in range(0, n, block_q):
        e = min(s + block_q, n)
        c0, c1 = windowed_topk._band(n, block_q, block_c, radius, s)
        acc = torch.zeros((e - s, c1 - c0), device=x.device)
        for j in range(d):
            df = (xf[s:e, j, None] - xf[None, c0:c1, j]).double()
            acc = (acc.double() + df * df).float()
        if not loop:
            acc[torch.arange(s, e, device=x.device)[:, None] == torch.arange(c0, c1, device=x.device)] = torch.inf
        sd, si = torch.sort(acc, dim=1, stable=True)
        w = min(k, c1 - c0)
        out_d[s:e, :w], out_i[s:e, :w] = sd[:, :w], (si[:, :w] + c0).int()
    ok = torch.isfinite(out_d) & valid[:, None]
    return torch.where(ok, out_d, torch.inf), torch.where(ok, out_i, 0)


def band_plan(x, k: int):
    """Row #14's launch plan for ``x`` and ``k`` (path, queries a block, tile
    rows, flags), as its wrapper cached it; None for a package that keeps
    none."""
    from gnn_tracking_tpu_torch.ops import windowed_topk

    plan = getattr(windowed_topk, "_plans", {}).get((x.shape[1], k, x.device))
    return None if plan is None else list(plan[:4])


def refused_before_redesign(d: int, k: int) -> bool:
    """Whether row #14 as it was before its Hopper redesign fails to launch
    at ``(d, k)``, d <= 32: a block held a tile of 256 candidates padded to
    4, 8, 16 or 32 columns beside 128 lists of k slots, and the launch
    failed where they exceed a block's shared memory."""
    import torch

    dp = next(p for p in (4, 8, 16, 32) if d <= p)
    return 256 * dp * 4 + k * 128 * 8 > torch.cuda.get_device_properties(0).shared_memory_per_block_optin


def band_pairs(args, kw) -> float:
    """The pairs of valid queries and their band's candidates that row #14
    scans on this input."""
    import torch

    from gnn_tracking_tpu_torch.ops import windowed_topk

    xs, valid = args[0], kw["valid"]
    lo, hi = windowed_topk._band(xs.shape[0], kw["block_q"], kw["block_c"], kw["radius"],
                                 torch.arange(xs.shape[0], device=xs.device))
    return float(((hi - lo) * valid).sum())


def digest(*tensors) -> str:
    import torch

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16: the same bytes as int16
            t = t.view(torch.int16)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def band_timings(seed: int, digests: Path | None, this_tree: bool) -> dict:
    """Row #14 on ``band_inputs`` at k in ``BAND_KS`` (and ``BAND_LOOP_KS``
    with ``loop``; on the duplicated inputs ``DUP_KS`` both ways): each case
    repeat bitwise, against its plain version (``compare_topk``) and in the
    contract's order, and bitwise ``banded_topk_fma_plain`` (a mismatch
    fails the run for this tree's package, and is logged for another's);
    timed as a Python call (``cuda_ms``), on the device (``graph_ms``) and
    the kernel alone (``kernel_device_ms``), beside the bound and the
    instruction floor. Another tree's package may refuse only a case that
    ``refused_before_redesign`` names; every other failure fails the run.
    With ``digests``: a file of the outputs' digests from another tree's
    run is compared case by case (bitwise equal), or written where there is
    none."""
    import torch

    from gnn_tracking_tpu_torch.ops import windowed_topk as wt

    out, sums = {}, {}
    inputs = band_inputs(seed)
    for name, args, kw in inputs:
        pairs = band_pairs(args, kw)
        xs = args[0]
        if "_dup" in name:
            cases = [(k, loop) for k in DUP_KS for loop in (False, True)]
        else:
            cases = [(k, False) for k in BAND_KS] + [(k, True) for k in BAND_LOOP_KS]
        for k, loop in cases:
            kwk = {**kw, "k": k, "loop": loop}
            case = f"{name}_k{k}" + ("_loop" if loop else "")
            call = lambda: wt.banded_topk_sorted(*args, **kwk)
            try:
                kd, ki = call()
                torch.cuda.synchronize()
            except RuntimeError as err:
                if this_tree or not refused_before_redesign(xs.shape[1], k):
                    raise
                out[case] = {"refused": str(err)}
                log(f"  banded_topk_sorted {case}: refused ({err}), as the kernel before the redesign does")
                continue
            kd2, ki2 = call()
            pd, pi = wt.banded_topk_sorted_plain(*args, **kwk)
            fd, fi = banded_topk_fma_plain(*args, **kwk)
            torch.cuda.synchronize()
            assert torch.equal(kd, kd2) and torch.equal(ki, ki2), f"{case}: second call differs"
            fma_bitwise = torch.equal(kd, fd) and torch.equal(ki, fi)
            assert fma_bitwise or not this_tree, f"{case}: differs from banded_topk_fma_plain"
            err, nb, nt = compare_topk(kd, ki, pd, pi, None)
            ties = assert_key_order(kd, ki, case)
            sums[case] = [digest(xs, kw["valid"]), digest(kd, ki)]  # the input's, the output's
            bnd, by = bound(3.0 * xs.shape[1] * pairs, nbytes(xs, kw["valid"], kd, ki))
            reps = 1 if cuda_ms(call, reps=1, rounds=1) > 20.0 else 3  # calls of 0.1 s and more: fewer
            r = {
                "n": xs.shape[0], "d": xs.shape[1], "k": k, "radius": kw["radius"], "loop": loop,
                "plan": band_plan(xs, k), "max_abs_err": err,
                "boundary_rows": nb, "tie_rows": nt, "exact_ties": ties, "fma_bitwise": fma_bitwise,
                # rows where the plain version's bits differ (its square-then-add rounding)
                "plain_rows_differ": int(((kd != pd) | (ki != pi)).any(dim=1).sum()),
                "ms": cuda_ms(call, reps=reps, rounds=3), "graph_ms": graph_ms(call, reps=reps, rounds=3),
                "kernel_ms": kernel_device_ms(call, "band", reps=reps),
                "bound_ms": bnd, "bound_by": by, "pairs": pairs,
                "instruction_floor_ms": pairs_floor_ms(pairs, xs.shape[1]),
            }
            out[case] = r
            log(f"  banded_topk_sorted {case} (d={r['d']}, plan {r['plan']}): {r['ms']:.3f} ms a call, "
                f"{r['graph_ms']:.3f} on the device, kernel {r['kernel_ms'][0]:.3f} ms; bound "
                f"{bnd:.4f} ms by {by}, instruction floor {r['instruction_floor_ms']:.3f} ms; max|err| "
                f"{err:.3e} vs plain ({r['plain_rows_differ']} rows differ in bits), repeat bitwise, "
                f"bitwise banded_topk_fma_plain: {fma_bitwise}")
    if digests is not None:
        out["bitwise_other_tree"] = compare_digests("banded_topk_sorted", sums, digests)
    log("band top-k timings: " + json.dumps(out))
    return out


def compare_digests(what: str, sums: dict, path: Path) -> list[str] | None:
    """``sums`` (case -> [input digest, output digest]) against the file
    ``path`` that another tree's run wrote: every case both ran on bitwise the
    same input must give bitwise the same output (returns those cases); where
    there is no file yet, write one (returns None)."""
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(sums))
        log(f"  {what}: digests of {len(sums)} cases written to {path}")
        return None
    ref = json.loads(path.read_text())
    # cases both trees ran on bitwise the same input (a trained latent may differ)
    both = sorted(c for c in set(ref) & set(sums) if ref[c][0] == sums[c][0])
    differ = [c for c in both if ref[c][1] != sums[c][1]]
    assert not differ, f"{what} differs bitwise from the other tree's on {differ}"
    log(f"  {what}: bitwise equal to the digests in {path} on {len(both)} cases (of {len(sums)}; the "
        f"rest ran on other inputs or were refused there): {both}")
    return both


def probe_pairs(xb, xc, nbr) -> tuple[float, float]:
    """Row #15's pairs on a table: real query slots x real candidate slots
    of the probed cells (real: every coordinate below 2^62 in magnitude, the
    kernel's class; an empty slot holds 1e30), and every query slot x every
    candidate slot of the probed cells (the table's)."""
    real = lambda x: (x.abs() < 2.0**62).all(dim=-1)
    nq, nc = real(xb).sum(dim=1).double(), real(xc).sum(dim=1).double()
    table = float(xb.shape[0] * xb.shape[1] * nbr.shape[1] * xc.shape[1])
    return float((nq * nc[nbr.long()].sum(dim=1)).sum()), table


def probe_inputs(seed: int) -> list[tuple]:
    """Row #15's cases as ``(name, args, kwargs)``: the probes of phase 8
    (a)'s four first attempts (the benchmark cloud at k = 8, its first 32,768
    points at k = 128 and 256, the 40-d cloud at k = 8), the benchmark
    cloud's build with 10 % of the points masked (holes inside the filled
    prefixes), and the k = 8 tables with ``loop``, with every slab's slots
    shuffled (empty slots anywhere), and with "other" slots (huge and NaN
    coordinates: their cells take every slot) and empty slots whose ids
    differ (the slab's ids scanned for an empty query's row), ``loop`` both
    ways. The k-means sums run deterministically, so every run builds the
    same tables; only ``ivf_knn`` and ``ivf_probe``'s signature are used, so
    ``--probe-only --package-root`` runs another tree on the same inputs."""
    import torch

    from gnn_tracking_tpu_torch.ops import ivf_knn

    dev = torch.device("cuda")
    bench = torch.from_numpy(make_bench_latent(seed + 92, GC_HITS)[0]).to(dev)
    small = bench[:ML_HITS].contiguous()
    wide = torch.from_numpy(make_wide_cloud(seed + 94, WIDE_HITS, WIDE_DIM)).to(dev)
    mask = torch.from_numpy(np.random.default_rng(seed + 95).random(GC_HITS) > 0.1).to(dev)
    calls, undo = capture(ivf_knn, "ivf_probe")
    # deterministic k-means sums (index_add_), so that two runs build the same tables
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for x, k, m in ((bench, GC_K, None), (small, IVF_WIDE_K, None), (small, BAND_WIDE_K, None),
                            (wide, GC_K, None), (bench, GC_K, mask)):
                ivf_knn.ivf_knn(x, k=k, node_mask=m, fallback=False)
    finally:
        torch.use_deterministic_algorithms(was)
        undo()
    names = ["bench_k8", f"bench32k_k{IVF_WIDE_K}", f"bench32k_k{BAND_WIDE_K}", f"d{WIDE_DIM}_k8", "bench_k8_holes"]
    cases = [(name, a, kw) for name, (a, kw) in zip(names, calls)]
    (xb, ib, xc, ic, nbr), kw8 = calls[0]
    cases.append(("bench_k8_loop", calls[0][0], {**kw8, "loop": True}))
    gen = torch.Generator(device=dev).manual_seed(seed + 96)
    pb = torch.argsort(torch.rand(xb.shape[:2], generator=gen, device=dev), dim=1)
    pc = torch.argsort(torch.rand(xc.shape[:2], generator=gen, device=dev), dim=1)
    take = lambda t, perm: torch.gather(t, 1, perm if t.dim() == 2 else perm[..., None].expand(-1, -1, t.shape[2]))
    shuffled = (take(xb, pb).contiguous(), take(ib, pb).contiguous(), take(xc, pc).contiguous(),
                take(ic, pc).contiguous(), nbr)
    xc2, ic2, xb2 = xc.clone(), ic.clone(), xb.clone()
    cells = torch.arange(0, xc.shape[0], 97, device=dev)
    xc2[cells, -1, 0] = 1e25
    xc2[cells + 1, -2, 1] = math.nan
    xb2[cells + 2, -1, 0] = -1e21
    empty = xc2[..., 0] == 1e30
    ic2[empty] = (torch.cumsum(empty.reshape(-1), 0).reshape(empty.shape)[empty] % 3).to(torch.int32)
    other = (xb2, ib, xc2, ic2, nbr)
    for loop in (False, True):
        suffix = "_loop" if loop else ""
        cases.append(("bench_k8_shuffled" + suffix, shuffled, {**kw8, "loop": loop}))
        cases.append(("bench_k8_other_ids" + suffix, other, {**kw8, "loop": loop}))
    return cases


def probe_timings(seed: int) -> dict:
    """Row #15 on ``probe_inputs``: each case repeat bitwise and against its
    plain version (``compare_topk``), timed as a Python call (``cuda_ms``) and
    on the device (``graph_ms``: the whole call, every kernel it launches),
    beside the bound (the tables once, the outputs once, 3 flops a dimension
    for every real pair) and the instruction floor (``pairs_floor_ms``) of the
    real pairs and of the table's pairs."""
    import torch

    from gnn_tracking_tpu_torch.ops import ivf_probe

    out = {}
    for name, args, kw in probe_inputs(seed):
        call = lambda: ivf_probe.ivf_probe(*args, **kw)
        kd, ki = call()
        kd2, ki2 = call()
        pd, pi = ivf_probe.ivf_probe_plain(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(kd, kd2) and torch.equal(ki, ki2), f"ivf_probe ({name}): second call differs"
        err, nb, nt = compare_topk(kd, ki, pd, pi, None)
        xb, _, xc, _, nbr = args
        d = xb.shape[2]
        pairs, table = probe_pairs(xb, xc, nbr)
        bnd, by = bound(3.0 * d * pairs, nbytes(*args, kd, ki))
        reps = 5 if cuda_ms(call, reps=1, rounds=1) > 2.0 else 20  # calls of 2 ms and more: fewer
        r = {"C": xb.shape[0], "cap": xb.shape[1], "capc": xc.shape[1], "T": nbr.shape[1], "d": d,
             "kw": kw["kw"], "loop": kw.get("loop", False), "max_abs_err": err, "boundary_rows": nb,
             "tie_rows": nt, "ms": cuda_ms(call, reps=reps), "graph_ms": graph_ms(call, reps=reps),
             "plain_ms": cuda_ms(lambda: ivf_probe.ivf_probe_plain(*args, **kw), reps=1, rounds=3),
             "bound_ms": bnd, "bound_by": by, "pairs": pairs, "table_pairs": table,
             "pairs_floor_ms": pairs_floor_ms(pairs, d), "table_floor_ms": pairs_floor_ms(table, d)}
        out[name] = r
        log(f"  ivf_probe {name} (C={r['C']} cap={r['cap']} capc={r['capc']} T={r['T']} d={d} kw={r['kw']} "
            f"loop={r['loop']}): {r['ms']:.4f} ms a call, {r['graph_ms']:.4f} on the device (plain "
            f"{r['plain_ms']:.3f}); bound {bnd:.4f} ms by {by}, floor {r['pairs_floor_ms']:.4f} ms on "
            f"{pairs:.3e} real pairs ({r['table_floor_ms']:.4f} on the table's {table:.3e}); max|err| "
            f"{err:.3e} vs plain ({nb} boundary, {nt} tie rows), repeat bitwise")
    log("ivf_probe timings: " + json.dumps(out))
    return out


def gather_inputs(seed: int) -> list[tuple]:
    """Row #10's cases as ``(name, values, index)`` on phase 3's graph (the
    serving event ev00, target-sorted: 262,144 edges, 32,768 nodes): F = 32
    in f32 (phase 3's shape), F = 3 and 33 (rows that are not whole 16-byte
    vectors), bf16 at F = 64 (the EC step's node width) and 32, and F = 32
    through the source ids (not sorted: the other endpoint's gather)."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph

    dev = torch.device("cuda")
    g = EventGraph.from_arrays(**make_event(seed + 10)).sort_edges_by_target().to(dev)
    src, dst = g.edge_index[0].contiguous(), g.edge_index[1].contiguous()
    gen = torch.Generator(device=dev).manual_seed(seed + 97)
    vals = lambda f, dtype: torch.randn((N_NODES, f), generator=gen, device=dev).to(dtype)
    f32, bf16 = torch.float32, torch.bfloat16
    return [("f32_F32", vals(32, f32), dst), ("f32_F3", vals(3, f32), dst), ("f32_F33", vals(33, f32), dst),
            ("bf16_F64", vals(64, bf16), dst), ("bf16_F32", vals(32, bf16), dst),
            ("f32_F32_src", vals(32, f32), src)]


def gather_timings(seed: int) -> dict:
    """Row #10 on ``gather_inputs``: bitwise ``index_select`` and repeat
    bitwise; on the device (``graph_ms``) beside ``index_select`` and the
    bytes bound (values, index and output once each), and as a Python call
    (``cuda_ms``)."""
    import torch

    from gnn_tracking_tpu_torch.ops import csr_segment

    out = {}
    for name, v, idx in gather_inputs(seed):
        call = lambda: csr_segment.gather_rows(v, idx)
        got, again = call(), call()
        want = torch.index_select(v, 0, idx)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and torch.equal(got, want), f"sorted_gather ({name}): not index_select"
        bnd, by = bound(0.0, nbytes(v, idx, got))
        r = {"E": idx.shape[0], "F": v.shape[1], "dtype": str(v.dtype).split(".")[-1],
             "ms": graph_ms(call), "call_ms": cuda_ms(call),
             "index_select_ms": graph_ms(lambda: torch.index_select(v, 0, idx)), "bound_ms": bnd, "bound_by": by}
        out[name] = r
        log(f"  sorted_gather {name}: {r['ms']:.4f} ms on the device, {r['call_ms']:.4f} a call; "
            f"index_select {r['index_select_ms']:.4f} ms; bound {bnd:.4f} ms by {by}; bitwise index_select")
    log("sorted_gather timings: " + json.dumps(out))
    return out


def bitwise_digests(seed: int, path: Path) -> None:
    """Kernel outputs on fixed inputs, as digests held against another
    tree's (``compare_digests``): row #15 on ``probe_inputs`` and row #10 on
    ``gather_inputs`` (redesigned to the parent's bits), and rows #12
    and #13 / #11 at d <= 32 (phase 10 (a)'s input at k = 1, 8, 16, 32, 64,
    256, 300 and 1,024, radius mode, and 3-, 14- and 20-d clouds: the
    kernels' 4, 16 and 32 padded columns), and rows #1 / #2 with C32 / D32
    (f32) and A-D (bf16) at widths they took before the wide layout (the
    GraphTCN's, ``ec.yml``'s, odd ones), each output of a second launch
    equal to the first's."""
    import torch

    from gnn_tracking_tpu_torch.ops import fused_relational as fr
    from gnn_tracking_tpu_torch.ops import pairwise_topk as pt

    dev = torch.device("cuda")
    sums = {}

    def record(case, inputs, fn):
        out = fn()
        again = fn()
        torch.cuda.synchronize()
        flat = lambda o: [t for t in (o if isinstance(o, (tuple, list)) else [o]) for t in
                          (t.values() if isinstance(t, dict) else [t])]
        assert all(torch.equal(a, b) for a, b in zip(flat(out), flat(again))), f"{case}: second launch differs"
        sums[case] = [digest(*inputs), digest(*flat(out))]

    x, mask, batch = phase10_input(seed)
    for k in (1, 8, 16, 32, 64, 256, 300):
        kw = {"k": k, "node_mask": mask, "batch": batch}
        record(f"row13_k{k}", (x, mask, batch), lambda: pt.pairwise_topk(x, **kw))
        record(f"row12_k{k}", (x, mask, batch), lambda: pt.pairwise_topk_filter(x, **kw))
        record(f"row11_k{k}", (x, mask), lambda: pt.pairwise_topk_streaming(x, k=k, node_mask=mask))
    record("row12_radius_k64", (x,), lambda: pt.pairwise_topk_filter(x, k=64, radius2=0.5))
    small = x[:4096].contiguous()
    record("row12_k1024", (small,), lambda: pt.pairwise_topk_filter(small, k=1024))
    rng = np.random.default_rng(seed + 185)
    for d in (3, 14, 20):
        xd = torch.from_numpy(rng.normal(size=(8192, d)).astype(np.float32)).to(dev)
        for k in (8, 32):
            record(f"row13_d{d}_k{k}", (xd,), lambda: pt.pairwise_topk(xd, k=k))
            record(f"row12_d{d}_k{k}", (xd,), lambda: pt.pairwise_topk_filter(xd, k=k))
    widths = {"f32": [(32, 32, 128, 32), (64, 64, 128, 64), (14, 3, 50, 18)],
              "bf16": [(64, 64, 128, 64), (32, 32, 64, 32), (40, 8, 72, 20)]}
    for route, cases in widths.items():
        bf16 = route == "bf16"
        dtype = torch.bfloat16 if bf16 else torch.float32
        fwd, fwd_save, bwd, bwd_saved = (
            (fr.fused_relational_bf16_fwd, fr.fused_relational_bf16_fwd_save, fr.fused_relational_bf16_bwd,
             fr.fused_relational_bf16_bwd_saved) if bf16 else
            (fr.fused_relational_fwd, fr.fused_relational_fwd_save, fr.fused_relational_bwd,
             fr.fused_relational_bwd_saved))
        for fx, fe, h, fo in cases:
            g, (xe, ea, ei, em, w, g_e, g_a) = ec_width_case(seed + 186, fx, fe, h, fo, 16000, 0.8)
            xe, ea, g_e, g_a = (t.to(dtype) for t in (xe, ea, g_e, g_a))
            w = {k: v.to(dtype) for k, v in w.items()}
            csr, args = g.csr(), (xe, ea, ei, em, w)
            inputs = (xe, ea, ei, em, *w.values(), g_e, g_a)
            name = f"{route}_{fx}_{fe}_{h}_{fo}"
            record(f"{name}_fwd", inputs, lambda: fwd(*args, rowptr=csr["dst_rowptr"], relu_edge=True))
            record(f"{name}_fwd_save", inputs, lambda: fwd_save(*args, rowptr=csr["dst_rowptr"], relu_edge=True))
            record(f"{name}_bwd", inputs, lambda: bwd(*args, g_e, g_a, csr, relu_edge=True))
            src, dst = ei.long()
            gd, gs = xe[dst].contiguous(), xe[src].contiguous()
            record(f"{name}_bwd_saved", inputs,
                   lambda: bwd_saved(gd, gs, *args[1:], g_e, g_a, csr, g.num_nodes, relu_edge=True))
    from gnn_tracking_tpu_torch.ops import csr_segment, ivf_probe

    for name, args, kw in probe_inputs(seed):
        record(f"row15_{name}", args, lambda: ivf_probe.ivf_probe(*args, **kw))
    for name, v, idx in gather_inputs(seed):
        record(f"row10_{name}", (v, idx), lambda: csr_segment.gather_rows(v, idx))
    compare_digests("rows #11-#13 (d <= 32), rows #1 / #2, C32 / D32, A-D (resident widths), row #15 and "
                    "row #10", sums, path)



def training_kernel_phases(tcn, g, seed: int) -> list[dict]:
    """Rows #2, #9 and #10 at the HC layer's shapes, each against its plain
    version on the card; rows #2 and #9 must repeat bit for bit; C32 / D32
    (rows #7 / #8 in f32) at the same shapes; row #9 also on the masked
    tail (``segment_sum_timings``)."""
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
        results += f32_saved_pair(x, ea, g.edge_index, mask, weights, csr, g_e, g_a, "GraphTCN widths")

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
        # device times (CUDA graph): at ~0.02 ms a call, a Python call's host work is longer
        ms9 = graph_ms(lambda: csr_segment.sorted_segment_sum(msgs, dst, N_NODES, rowptr=rowptr))
        call9 = cuda_ms(lambda: csr_segment.sorted_segment_sum(msgs, dst, N_NODES, rowptr=rowptr))
        ms9s = graph_ms(lambda: csr_segment.segment_sum_csr(
            msgs, csr["src_rowptr"], perm=csr["src_perm"]))
        plain9 = graph_ms(lambda: csr_segment.sorted_segment_sum_plain(msgs, dst, N_NODES))
        lib9 = graph_ms(lambda: torch.segment_reduce(msgs, "sum", offsets=offsets, unsafe=True))
        call_lib9 = cuda_ms(lambda: torch.segment_reduce(msgs, "sum", offsets=offsets, unsafe=True))
        bound9, by9 = bound(float(N_EDGES * fo), nbytes(msgs, rowptr, p9))
        results.append({"name": "sorted_segment_sum", "max_abs_err": max(err9, err9s), "ms": ms9,
                        "plain_ms": plain9, "bound_ms": bound9, "bound_by": by9, "library_ms": lib9})
        log(f"kernel sorted_segment_sum: OK max|err| {err9:.3e} (source side through src_perm "
            f"{err9s:.3e}), repeat bitwise; device time {ms9:.4f} ms (source side, random row reads: "
            f"{ms9s:.4f} ms; plain {plain9:.4f} ms; torch.segment_reduce {lib9:.4f} ms, "
            f"max|diff| {(lib9_out - p9).abs().max().item():.3e}; bound {bound9:.4f} ms); a call "
            f"from Python {call9:.4f} ms (torch.segment_reduce {call_lib9:.4f} ms)")
        tail = segment_sum_timings(seed)["masked_tail"]
        log(f"kernel sorted_segment_sum on the masked tail ({tail['largest_segment']} rows at the last node): "
            f"repeat bitwise, within the float64 bound; {tail['ms']:.4f} ms (torch.segment_reduce "
            f"{tail['segment_reduce_ms']:.4f} ms, bound {tail['bound_ms']:.4f} ms)")

        # row #10
        vals = torch.randn((N_NODES, fo), generator=gen, device=dev)
        k10 = csr_segment.sorted_gather(vals, dst, rowptr=rowptr)
        p10 = csr_segment.sorted_gather_plain(vals, dst)
        torch.cuda.synchronize()
        assert torch.equal(k10, p10), "sorted_gather differs from index_select"
        # device times (CUDA graph), as row #9's; the Python calls beside them
        ms10 = graph_ms(lambda: csr_segment.sorted_gather(vals, dst, rowptr=rowptr))
        call10 = cuda_ms(lambda: csr_segment.sorted_gather(vals, dst, rowptr=rowptr))
        plain10 = graph_ms(lambda: csr_segment.sorted_gather_plain(vals, dst))
        lib10 = graph_ms(lambda: torch.index_select(vals, 0, dst))
        call_lib10 = cuda_ms(lambda: torch.index_select(vals, 0, dst))
        bound10, by10 = bound(0.0, nbytes(vals, dst, p10))
        results.append({"name": "sorted_gather", "max_abs_err": 0.0, "ms": ms10,
                        "plain_ms": plain10, "bound_ms": bound10, "bound_by": by10,
                        "library_ms": lib10})
        log(f"kernel sorted_gather: OK bitwise equal to index_select; device time {ms10:.4f} ms "
            f"(plain {plain10:.4f} ms, torch.index_select {lib10:.4f} ms, bound {bound10:.4f} ms); "
            f"a call from Python {call10:.4f} ms (torch.index_select {call_lib10:.4f} ms)")
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
        assert_key_order(kd, ki, f"pairwise_topk_filter (ML latent {when})")
        filled = torch.isfinite(kd).sum(dim=1).float()
        ms = cuda_ms(lambda: topk(h, k=k, radius2=r2), reps=1, rounds=5)
        plain = cuda_ms(lambda: pairwise_topk.pairwise_topk_filter_plain(h, k=k, radius2=r2),
                        reps=1, rounds=3)
        ones = torch.ones(h.shape[0], dtype=torch.bool, device=h.device)
        bnd, by = topk_bound(h, k, ones, torch.zeros(h.shape[0], dtype=torch.int32, device=h.device))
        log(f"  pairwise_topk_filter, radius mode at k = {k} on the ML latent {when} ({ML_HITS} "
            f"hits): agrees with the plain version (max|err| {err:.3e}, {nb} boundary rows, {nt} "
            f"tie rows); filled slots per hit mean {filled.mean().item():.1f}, max "
            f"{int(filled.max())}; {ms:.3f} ms (plain {plain:.3f} ms, bound {bnd:.4f} ms by {by})")
        return {"ms": ms, "plain_ms": plain, "bound_ms": bnd, "filled_mean": filled.mean().item(),
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


# phase 8 (a)'s cases above 32 dimensions and at large k
WIDE_HITS, WIDE_DIM, IVF_WIDE_K, BAND_WIDE_K = 65536, 40, 128, 256
# (Fx, Fe, H, Fo) that the fused relational kernels take only zero-padded (phase 10 (a))
ODD_WIDTHS = {"bf16": (40, 8, 72, 20), "f32": (14, 3, 50, 18)}
# the wide layout (csrc/fused_relational_wide.cu): weights beyond one block's shared memory in the
# resident kernels' layouts (A / C 356,864 bytes, B / D 397,568; rows #1 / #2: W2 alone 256 KiB)
WIDE_WIDTHS = (64, 64, 256, 64)
WIDE_EC_MODEL = {**EC_MODEL, "hidden_dim": 256, "L_ec": 2}
# (route, widths, edges): the wide layout in both dtypes, and widths whose backward tiles exceed
# shared memory even at 4 edges a tile (its tiles in device memory)
WIDE_CHECKS = {"wide bf16": ("bf16", WIDE_WIDTHS, 16000), "wide f32": ("f32", WIDE_WIDTHS, 16000),
               "wide f32 (backward tiles in device memory)": ("f32", (8, 8, 2432, 8), 600)}


def make_wide_cloud(seed: int, n: int, d: int) -> np.ndarray:
    """The benchmark cloud's recipe in ``d`` dimensions: ``n / 64``
    unit-normal centres, each point a random centre plus 0.05 of unit-normal
    noise."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n // 64, d)).astype(np.float32)
    return centers[rng.integers(0, n // 64, size=n)] + 0.05 * rng.normal(size=(n, d)).astype(np.float32)


def windowed_build_split(x, k: int, rounds: int = 3) -> dict:
    """``knn_graph_windowed(x, k)`` in three parts, as ``windowed_topk.record_parts``
    records each attempt: the band launches (row #14), ``_fallback_brute``
    (the violators' brute force, plain tensor code), each between two
    synchronisations, and the rest (principal axis, sort, certification,
    gathers); medians of ``rounds`` builds after one warm-up, and each
    attempt's radius, violators and fallback rows."""
    import torch

    from gnn_tracking_tpu_torch.ops import knn, windowed_topk

    runs = []
    with windowed_topk.record_parts() as parts, torch.no_grad():
        for _ in range(rounds + 1):
            first = len(parts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            knn.knn_graph_windowed(x, k)
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
            attempts = parts[first:]
            runs.append({"total_ms": total, "attempts": attempts,
                         "band_ms": sum(a["band_ms"] for a in attempts),
                         "fallback_ms": sum(a["fallback_ms"] for a in attempts)})
    runs = runs[1:]
    for r in runs:
        r["rest_ms"] = r["total_ms"] - r["band_ms"] - r["fallback_ms"]
    out = {key: statistics.median(r[key] for r in runs) for key in ("total_ms", "band_ms", "fallback_ms", "rest_ms")}
    out["attempts"] = [{key: a[key] for key in ("radius", "fallback_cap", "fallback_rows", "uncertified_after",
                                                "violators")} for a in runs[0]["attempts"]]
    log(f"windowed build split (medians of {rounds}, synchronised parts): {json.dumps(out)}")
    return out


def ivf_build_split(x, k: int, rounds: int = 3) -> dict:
    """``knn_graph_ivf(x, k)`` in the parts ``ivf_knn.record_parts`` records
    for each attempt (``ivf_knn.PARTS``: the coarse quantization, the
    bucketing, the probe launch (row #15), the extra pass, the spill probe,
    the rerank, the certification, the fallback), each between two
    synchronisations, and the rest (the graph's edges, the retry loop);
    medians of ``rounds`` builds after one warm-up, and the attempts."""
    import torch

    from gnn_tracking_tpu_torch.ops import ivf_knn, knn

    runs = []
    with ivf_knn.record_parts() as parts, torch.no_grad():
        for _ in range(rounds + 1):
            first = len(parts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            knn.knn_graph_ivf(x, k)
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
            attempts = parts[first:]
            runs.append({"total_ms": total, "attempts": len(attempts),
                         **{q: sum(a[q] for a in attempts) for q in ivf_knn.PARTS}})
    runs = runs[1:]
    for r in runs:
        r["rest_ms"] = r["total_ms"] - sum(r[q] for q in ivf_knn.PARTS)
    out = {key: statistics.median(r[key] for r in runs) for key in ("total_ms", *ivf_knn.PARTS, "rest_ms")}
    out["attempts"] = runs[0]["attempts"]
    log(f"IVF build split (medians of {rounds}, synchronised parts): {json.dumps(out)}")
    return out


def graph_construction_phase(seed: int, fcnn) -> tuple[list[dict], dict, dict]:
    """Kernel phases of rows #14 and #15 at the inputs a full-detector build
    gives them, then the three builders at 262,144 points, each held against
    row #11 (see the module docstring); ``fcnn`` is phase 7's trained model.
    Returns the two kernels' results, the summary and the builds' launches
    (the resident top-k's route, rows #14 / #15, row #11's checks)."""
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
    # certification would leave to its fallback). Beside them, cases above 32
    # dimensions and at large k: a 40-d cloud, k = 128 (row #15, on 32,768
    # benchmark points) and k = 256 (row #14), and the band's radius 8
    wide = torch.from_numpy(make_wide_cloud(seed + 94, WIDE_HITS, WIDE_DIM)).to("cuda")
    bench_small = bench[:ML_HITS].contiguous()
    probe_calls, undo = capture(ivf_knn, "ivf_probe")
    _, _, n_unc_ivf, stats = ivf_knn.ivf_knn(bench, k=GC_K, fallback=False, return_stats=True)
    n_unc_wide_ivf = int(ivf_knn.ivf_knn(wide, k=GC_K, fallback=False)[2])
    undo()
    band_calls, undo = capture(windowed_topk, "banded_topk_sorted")
    uncertified = {
        "ivf_probe8_bench": int(n_unc_ivf),
        "ivf_probe8_trained": int(ivf_knn.ivf_knn(latent, k=GC_K, fallback=False)[2]),
        f"ivf_probe8_d{WIDE_DIM}": n_unc_wide_ivf,
        "band_radius4_spatial": int(windowed_topk.windowed_knn(xyz, k=GC_K, fallback_cap=0)[2]),
        "band_radius4_trained": int(windowed_topk.windowed_knn(latent, k=GC_K, fallback_cap=0)[2]),
        "band_radius8_spatial": int(windowed_topk.windowed_knn(xyz, k=GC_K, radius=8, fallback_cap=0)[2]),
        f"band_radius4_d{WIDE_DIM}": int(windowed_topk.windowed_knn(wide, k=GC_K, fallback_cap=0)[2]),
    }
    undo()
    assert len(probe_calls) == 2 and len(band_calls) == 4
    # the IVF graph at k = 128 (kw = 136) through its kernels and through the plain versions,
    # each held against row #11's exact graph; its probe is the k = 128 case of row #15
    ivf128_calls, undo = capture(ivf_knn, "ivf_probe")
    with torch.no_grad():
        ivf128 = knn.knn_graph_ivf(bench_small, IVF_WIDE_K)
    undo()
    probe256_calls, undo = capture(ivf_knn, "ivf_probe")  # the probe alone at k = 256 (kw = 264)
    ivf_knn.ivf_knn(bench_small, k=BAND_WIDE_K, fallback=False)
    undo()
    with torch.no_grad(), plain_path():
        ivf128_plain = knn.knn_graph_ivf(bench_small, IVF_WIDE_K)
        exact128 = knn._edges_from_exact(*pairwise_topk.pairwise_topk_streaming(bench_small, k=IVF_WIDE_K), None)
    ivf128_ties = {
        "kernels_vs_plain": compare_neighbours("knn_graph_ivf k=128: kernels vs plain", ivf128, ivf128_plain, IVF_WIDE_K),
        "kernels_vs_row11": compare_neighbours("knn_graph_ivf k=128 vs row #11", ivf128, exact128, IVF_WIDE_K),
    }
    log(f"knn_graph_ivf at k = {IVF_WIDE_K} on {ML_HITS} benchmark points: {len(ivf128_calls)} attempt(s), "
        f"equal to the plain build's and row #11's graphs up to ties {ivf128_ties}")
    resident_wide_checks(seed)
    results = []

    probe_cases = [("bench_k8", *probe_calls[0]), (f"bench32k_k{IVF_WIDE_K}", *ivf128_calls[0]),
                   (f"bench32k_k{BAND_WIDE_K}", *probe256_calls[0]), (f"d{WIDE_DIM}_k8", *probe_calls[1])]
    probe = {}
    for what, pa, pkw in probe_cases:
        xb, ib, xc, ic, nbr = pa
        kd, ki = ivf_probe.ivf_probe(*pa, **pkw)
        kd2, ki2 = ivf_probe.ivf_probe(*pa, **pkw)
        pd, pi = ivf_probe.ivf_probe_plain(*pa, **pkw)
        torch.cuda.synchronize()
        assert torch.equal(kd, kd2) and torch.equal(ki, ki2), f"ivf_probe ({what}): second launch differs"
        err15, nb15, nt15 = compare_topk(kd, ki, pd, pi, None)
        ms15 = cuda_ms(lambda: ivf_probe.ivf_probe(*pa, **pkw))
        dev15 = graph_ms(lambda: ivf_probe.ivf_probe(*pa, **pkw), reps=5, rounds=3)
        plain15 = cuda_ms(lambda: ivf_probe.ivf_probe_plain(*pa, **pkw), reps=1, rounds=3)
        # the pairs this table needs (real query slots x real candidate slots of the probed
        # cells, at 3 flops per dimension) and the table's
        pairs15, table15 = probe_pairs(xb, xc, nbr)
        d = xb.shape[2]
        bound15, by15 = bound(3.0 * d * pairs15, nbytes(*pa, kd, ki))
        probe[what] = {"max_abs_err": err15, "ms": ms15, "graph_ms": dev15, "plain_ms": plain15,
                       "bound_ms": bound15, "bound_by": by15, "d": d, "kw": pkw["kw"],
                       "pairs_floor_ms": pairs_floor_ms(pairs15, d), "table_floor_ms": pairs_floor_ms(table15, d)}
        log(f"kernel ivf_probe ({what}): OK max|err| {err15:.3e} ({nb15} k-th boundary rows, {nt15} tie-order "
            f"rows), repeat bitwise; C={xb.shape[0]} cap={xb.shape[1]} capc={xc.shape[1]} T={nbr.shape[1]} "
            f"d={d} kw={pkw['kw']}; {ms15:.3f} ms a call, {dev15:.3f} on the device (plain {plain15:.3f} ms, "
            f"bound {bound15:.4f} ms by {by15}, instruction floor {probe[what]['pairs_floor_ms']:.4f} ms on "
            f"{pairs15:.3e} real pairs, {probe[what]['table_floor_ms']:.4f} on the table's {table15:.3e})")
    log(f"IVF stats (benchmark cloud, k = {GC_K}): {stats}")
    # the line's entry is the shape the IVF build runs (the benchmark cloud, k = 8)
    results.append({"name": "ivf_probe", **{k: probe["bench_k8"][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
        "max_abs_err": max(b["max_abs_err"] for b in probe.values())})

    (sa, skw), (ta, tkw), (ra, rkw), (wa, wkw) = band_calls
    band_cases = [("spatial", sa, skw), ("trained", ta, tkw), ("spatial_radius8", ra, rkw),
                  (f"spatial_k{BAND_WIDE_K}", sa, {**skw, "k": BAND_WIDE_K}), (f"d{WIDE_DIM}", wa, wkw)]
    # the spatial input with every distance tied DUP_COPIES ways, at k = 8, 32, 64, `loop` both ways
    da, dkw = duplicated(sa, skw)
    band_cases += [(f"spatial_dup{DUP_COPIES}_k{k}" + ("_loop" if loop else ""), da, {**dkw, "k": k, "loop": loop})
                   for k in DUP_KS for loop in (False, True)]
    band = {}
    for what, ba, bkw in band_cases:
        kd, ki = windowed_topk.banded_topk_sorted(*ba, **bkw)
        kd2, ki2 = windowed_topk.banded_topk_sorted(*ba, **bkw)
        pd, pi = windowed_topk.banded_topk_sorted_plain(*ba, **bkw)
        fd, fi = banded_topk_fma_plain(*ba, **bkw)
        torch.cuda.synchronize()
        assert torch.equal(kd, kd2) and torch.equal(ki, ki2), f"banded_topk_sorted ({what}): second launch differs"
        assert torch.equal(kd, fd) and torch.equal(ki, fi), f"banded_topk_sorted ({what}): not its own arithmetic's bits"
        err, nb, nt = compare_topk(kd, ki, pd, pi, None)
        assert_key_order(kd, ki, f"banded_topk_sorted ({what})")
        ms = cuda_ms(lambda: windowed_topk.banded_topk_sorted(*ba, **bkw))
        plain = cuda_ms(lambda: windowed_topk.banded_topk_sorted_plain(*ba, **bkw), reps=1, rounds=3)
        xs, valid = ba[0], bkw["valid"]
        pairs = band_pairs(ba, bkw)
        bnd, by = bound(3.0 * xs.shape[1] * pairs, nbytes(xs, valid, kd, ki))
        band[what] = {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
                      "d": xs.shape[1], "k": bkw["k"], "radius": bkw["radius"], "pairs": pairs,
                      "instruction_floor_ms": pairs_floor_ms(pairs, xs.shape[1]),
                      "plan": band_plan(xs, bkw["k"])}
        log(f"kernel banded_topk_sorted ({what}): OK max|err| {err:.3e} ({nb} k-th boundary rows, "
            f"{nt} tie-order rows), repeat bitwise, bitwise banded_topk_fma_plain; N={xs.shape[0]} d={xs.shape[1]} k={bkw['k']} "
            f"radius={bkw['radius']} block_q={bkw['block_q']} block_c={bkw['block_c']} plan "
            f"{band[what]['plan']}; {ms:.3f} ms (plain {plain:.3f} ms, bound {bnd:.4f} ms by {by}, "
            f"instruction floor {band[what]['instruction_floor_ms']:.3f} ms, {pairs:.3e} pairs)")
    # the line's entry is the shape the windowed build runs (spatial, d = 3)
    results.append({"name": "banded_topk_sorted", **{k: band["spatial"][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
        "max_abs_err": max(b["max_abs_err"] for b in band.values())})

    # ---- (c) the builders, at their defaults ----------------------------------
    # (the resident top-k at k = 8 is row #13 up to knn.SPLIT_MAX_K, row #12 above)
    route = "pairwise_topk" if GC_K <= knn.SPLIT_MAX_K else "pairwise_topk_filter"
    counters = {route: getattr(pairwise_topk, route),
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
    with torch.no_grad():
        filtered = knn._edges_from_neighbor_topk(latent, *pairwise_topk.pairwise_topk_filter(latent, k=GC_K), None)
    with torch.no_grad():
        split = knn._edges_from_neighbor_topk(latent, *pairwise_topk.pairwise_topk(latent, k=GC_K), None)
    assert all(torch.equal(a, b) for a, b in zip(resident, filtered)), (
        f"the resident build ({route}) differs from row #12's graph on the same latent")
    assert all(torch.equal(a, b) for a, b in zip(resident, split)), (
        f"the resident build ({route}) differs from row #13's graph on the same latent")
    ties = {
        "ivf_vs_resident": compare_neighbours("IVF vs resident top-k (bench)", ivf, resident_bench, GC_K),
        "windowed_vs_resident": compare_neighbours(
            "banded vs resident top-k (spatial)", windowed, resident_xyz, GC_K),
    }
    # (c) row #11, the exact brute-force top-k, as the reference of every query of each build,
    # and a plain brute force on a seeded sample of each build's queries
    streaming = pairwise_topk.pairwise_topk_streaming
    streaming.launches = 0
    for i, (what, x, graph) in enumerate(
            (("trained", latent, resident), ("bench", bench, ivf), ("spatial", xyz, windowed))):
        with torch.no_grad():
            exact = knn._edges_from_exact(*streaming(x, k=GC_K), None)
        ties[f"row11_vs_{what}"] = compare_neighbours(f"{what} build vs row #11", graph, exact, GC_K)
        ties[f"brute_sample_{what}"] = brute_sample(x, *graph, GC_K, seed + i)
    launches["pairwise_topk_streaming"] = streaming.launches
    assert streaming.launches == 3, streaming.launches
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
            "split_topk_262k_ms": cuda_ms(lambda: pairwise_topk.pairwise_topk(latent, k=GC_K),
                                          reps=1, rounds=3),
        }
    windowed_split = windowed_build_split(xyz, GC_K)
    ivf_split = ivf_build_split(bench, GC_K)
    log(f"graph construction: the resident top-k at k = {GC_K} took {route} (knn.SPLIT_MAX_K = "
        f"{knn.SPLIT_MAX_K}): knn_graph {times['knn_resident_ms']:.2f} ms a build on the trained latent; "
        f"row #13 {times['split_topk_262k_ms']:.2f} ms, row #12 {times['topk_262k_ms']:.2f} ms on it")
    summary = {
        "hits": GC_HITS, "k": GC_K, "resident_route": route, **times, **eff, "launches": launches,
        "attempts": attempts,
        "uncertified_before_fallback": uncertified, "clusters": geometry,
        "banded_topk_sorted": band, "ivf_probe": probe, "ivf_k128_tie_rows": ivf128_ties,
        "windowed_split": windowed_split, "ivf_split": ivf_split, "edges_kept_by_radius": int(built.edge_mask.sum()),
        "tie_rows": ties, "ivf_stats": stats,
    }
    log("graph construction: " + json.dumps(summary))
    for r in results:
        r["launches"] = launches[r["name"]]
    return results, summary, launches


def make_ec_event(seed: int):
    """The JAX EC benchmark's event (``bench.py:66-79``): the training
    event's locality graph, with 30 % of the edges true at random."""
    ev = make_train_event(seed)
    ev["y"] = np.random.default_rng(seed + 2).random(N_EDGES) < 0.3
    return ev


def bf16_check(name, outs, again, plain, ref):
    """Phase 9's check of a bf16 kernel's outputs (dicts by output name):
    repeat bitwise; norm-wise within 2e-2 of the plain version (|k - p| <=
    2e-2 |p|, Frobenius); norm-wise error against float64 at most 2x the
    plain version's; exactly zero where the plain version is (no unmasked
    edge). Norms, not the largest element: a pre-activation within f32
    rounding of 0 falls on the ReLU's other side in another summation order,
    and then that edge's whole gradient row differs (a dozen of the 262,144
    edges). Returns per output (name, max |k - p|, |k - p| / |p|, rows with
    an element off by > 1e-2 of the largest, |k - ref| / |ref|, |p - ref| /
    |ref|)."""
    import torch

    errs = []
    for (key, kt), kt2, pt, rt in zip(outs.items(), again.values(), plain.values(), ref.values()):
        assert torch.equal(kt, kt2), f"{name} {key}: second launch differs"
        kd, pd = kt.double(), pt.double()
        if pd.norm().item() == 0:
            assert not kd.any(), f"{name} {key}: not zero where the plain version is"
            errs.append((key, 0.0, 0.0, 0, 0.0, 0.0))
            continue
        rel = ((kd - pd).norm() / pd.norm()).item()
        assert rel <= 2e-2, f"{name} {key}: |kernel - plain| is {rel:.3e} of |plain| (> 2e-2)"
        ek, ep = (kd - rt).norm().item(), (pd - rt).norm().item()
        assert math.isfinite(ek) and ek <= 2 * ep, (
            f"{name} {key}: |kernel - float64| {ek:.3e} > 2 x |plain - float64| {ep:.3e}")
        rows = int(((kd - pd).abs().reshape(kd.shape[0], -1) > 1e-2 * pd.abs().max()).any(dim=1).sum())
        errs.append((key, (kd - pd).abs().max().item(), rel, rows, ek / rd if (rd := rt.norm().item()) else 0.0,
                     ep / rd if rd else 0.0))
    return errs


def bf16_kernel_phases(model, g, seed: int) -> list[dict]:
    """Kernels A-D (table rows #3-#8) at the EC layer's shapes (see the
    module docstring, phase 9 (a)); ``model`` is the EC model, whose second
    layer gives the weights and whose encoders give the inputs."""
    import torch

    from gnn_tracking_tpu_torch.ops import fused_relational as fr

    dev = g.x.device
    csr, bf = g.csr(), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    with torch.no_grad():
        # a relu'd node encoding, a raw edge encoding (so that relu_edge cuts)
        x = torch.relu(model.ec_node_encoder(g.x)).to(bf).contiguous()
        ea = model.ec_edge_encoder(g.edge_attr).to(bf).contiguous()
        weights = {k: v.detach().to(bf).contiguous()
                   for k, v in model.ec_resin.layers[1].relational_weights().items()}
        mask = torch.from_numpy(np.random.default_rng(seed + 3).random(N_EDGES) < 0.8).to(dev)
        fo = weights["w3"].shape[0]
        g_e = torch.randn((N_EDGES, fo), generator=gen, device=dev).to(bf)
        g_a = torch.randn((N_NODES, fo), generator=gen, device=dev).to(bf)
        args = (x, ea, g.edge_index, mask, weights)
        args64 = (x.double(), ea.double(), g.edge_index, mask,
                  {k: v.double() for k, v in weights.items()})
        rowptr = csr["dst_rowptr"]

        fwd_names = ("e_tilde", "agg")
        bwd = lambda out: {"g_x": out[0], "g_edge_attr": out[1], **out[2]}
        worst = {k: 0.0 for k in ("A", "B", "C", "D")}
        for relu_edge in (False, True):
            kw = {"relu_edge": relu_edge}
            ref_f = dict(zip(fwd_names, fr.fused_relational_plain(*args64, **kw)))
            ref_b = bwd(fr.fused_relational_bwd_plain(*args64, g_e.double(), g_a.double(), **kw))
            a = dict(zip(fwd_names, fr.fused_relational_bf16_fwd(*args, rowptr=rowptr, **kw)))
            a2 = dict(zip(fwd_names, fr.fused_relational_bf16_fwd(*args, rowptr=rowptr, **kw)))
            c = fr.fused_relational_bf16_fwd_save(*args, rowptr=rowptr, **kw)
            c2 = fr.fused_relational_bf16_fwd_save(*args, rowptr=rowptr, **kw)
            b = bwd(fr.fused_relational_bf16_bwd(*args, g_e, g_a, csr, **kw))
            b2 = bwd(fr.fused_relational_bf16_bwd(*args, g_e, g_a, csr, **kw))
            d = bwd(fr.fused_relational_bf16_bwd_saved(c[2], c[3], *args[1:], g_e, g_a, csr, N_NODES, **kw))
            d2 = bwd(fr.fused_relational_bf16_bwd_saved(c[2], c[3], *args[1:], g_e, g_a, csr, N_NODES, **kw))
            pa = dict(zip(fwd_names, fr.fused_relational_bf16_plain(*args, **kw)))
            pb = bwd(fr.fused_relational_bf16_bwd_plain(*args, g_e, g_a, **kw))
            torch.cuda.synchronize()
            report = {
                "A": bf16_check("fused_relational_bf16_fwd", a, a2, pa, ref_f),
                "C": bf16_check("fused_relational_bf16_fwd_save", dict(zip(fwd_names, c)),
                           dict(zip(fwd_names, c2)), pa, ref_f),
                "B": bf16_check("fused_relational_bf16_bwd", b, b2, pb, ref_b),
                "D": bf16_check("fused_relational_bf16_bwd_saved", d, d2, pb, ref_b),
            }
            dst, src = g.edge_index[1].long(), g.edge_index[0].long()
            assert torch.equal(c[2], x[dst]) and torch.equal(c[3], x[src]), "C: saved rows differ from x[dst], x[src]"
            assert all(torch.equal(a[k], v) for k, v in zip(fwd_names, c)), "C differs from A"
            assert all(torch.equal(b[k], d[k]) for k in b), "D differs from B"
            assert not a["e_tilde"][~mask].any(), "A: masked edges' e_tilde rows not zero"
            assert not b["g_edge_attr"][~mask].any(), "B: masked edges' g_edge_attr rows not zero"
            for k, errs in report.items():
                worst[k] = max(worst[k], max(e[1] for e in errs))
            log(f"  bf16 kernels relu_edge={relu_edge}: C/D bitwise equal to A/B, every launch repeats "
                "bitwise; per output: max|kernel - plain|, |kernel - plain| / |plain|, rows with an "
                "element off by > 1e-2 of the largest, |err| / |float64| kernel/plain: " + "; ".join(
                    f"{k} " + ", ".join(f"{n} {e:.2e} {rel:.1e} {rows} ({ek:.2e}/{ep:.2e})"
                                        for n, e, rel, rows, ek, ep in errs)
                    for k, errs in report.items() if k in ("A", "B")))

        # timed with relu_edge (layers 2-6 of the stack run it)
        kw = {"relu_edge": True}
        c = fr.fused_relational_bf16_fwd_save(*args, rowptr=rowptr, **kw)
        calls = {
            "A": (lambda: fr.fused_relational_bf16_fwd(*args, rowptr=rowptr, **kw),
                  lambda: fr.fused_relational_bf16_plain(*args, **kw)),
            "C": (lambda: fr.fused_relational_bf16_fwd_save(*args, rowptr=rowptr, **kw),
                  lambda: fr.fused_relational_bf16_fwd_save_plain(*args, **kw)),
            "B": (lambda: fr.fused_relational_bf16_bwd(*args, g_e, g_a, csr, **kw),
                  lambda: fr.fused_relational_bf16_bwd_plain(*args, g_e, g_a, **kw)),
            "D": (lambda: fr.fused_relational_bf16_bwd_saved(c[2], c[3], *args[1:], g_e, g_a, csr, N_NODES, **kw),
                  lambda: fr.fused_relational_bf16_bwd_saved_plain(c[2], c[3], *args[1:], g_e, g_a, N_NODES, **kw)),
        }
        fx, fe, hid = x.shape[1], ea.shape[1], weights["w2"].shape[0]
        k = 2 * fx + fe
        n_valid = int(mask.sum())
        # MLP flops of the unmasked edges: the forward's three layers; the
        # backward's recompute of h1, h2, the input gradients and the weight
        # gradients of the three layers
        flops = {"A": 2.0 * n_valid * (k * hid + hid * hid + hid * fo)}
        flops["C"] = flops["A"]
        flops["B"] = flops["D"] = 2.0 * n_valid * (3 * k * hid + 3 * hid * hid + 2 * hid * fo)
        # each input read once, each output written once, only for the
        # unmasked edges (fwd_bound_bytes, bwd_bound_bytes)
        g_x, g_ea, grads = calls["B"][0]()
        bwd_args = (ea, g.edge_index, mask, weights, g_e, g_a, (g_x, g_ea, *grads.values()))
        sizes = {
            "A": fwd_bound_bytes(*args, rowptr, c[:2]),
            "C": fwd_bound_bytes(*args, rowptr, c, save=True),
            "B": bwd_bound_bytes(x, *bwd_args),
            "D": bwd_bound_bytes((c[2], c[3]), *bwd_args),
        }
        names = {"A": "fused_relational_bf16_fwd", "B": "fused_relational_bf16_bwd",
                 "C": "fused_relational_bf16_fwd_save", "D": "fused_relational_bf16_bwd_saved"}
        results = []
        for key in ("A", "B", "C", "D"):
            kernel, plain = calls[key]
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            bnd, by = bound(flops[key], sizes[key], peak=PEAK_BF16_FLOPS)
            results.append({"name": names[key], "max_abs_err": worst[key], "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bnd, "bound_by": by, "library_ms": None})
            log(f"kernel {names[key]} ({key}): OK; {ms:.4f} ms (plain bf16 {plain_ms:.4f} ms, bound "
                f"{bnd:.4f} ms by {by}: {flops[key] / 1e9:.1f} GFLOP bf16 at {n_valid} unmasked edges, "
                f"{sizes[key] / 1e6:.1f} MB)")
    return results


def ec_training_path(seed: int, steps: int, profile: bool, tmp: Path) -> tuple[list[dict], dict]:
    """Phase 9: bf16 EC training at ``ec.yml``'s width (see the module
    docstring). Returns kernels A-D's results, with their launches on the
    training path, and the summary."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.losses.ec import EdgeWeightFocalLoss
    from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
    from gnn_tracking_tpu_torch.ops import csr_segment
    from gnn_tracking_tpu_torch.ops import fused_relational as fr
    from gnn_tracking_tpu_torch.training.module import ECModule
    from gnn_tracking_tpu_torch.training.trainer import Trainer
    from gnn_tracking_tpu_torch.utils.loading import TrackingDataModule, save_graph

    g = EventGraph.from_arrays(**make_ec_event(seed + 120)).sort_edges_by_target().to("cuda")
    model = ECForGraphTCN(**EC_MODEL, device="cpu", generator=torch.Generator().manual_seed(seed + 121))
    module = ECModule(model=model, loss_fct=EdgeWeightFocalLoss(**EC_LOSS), lr=LR, precision="bf16",
                      device="cuda")
    module.setup_params(g)
    results = bf16_kernel_phases(model, g, seed)

    counters = {
        "fused_relational_bf16_fwd": fr.fused_relational_bf16_fwd,
        "fused_relational_bf16_bwd": fr.fused_relational_bf16_bwd,
        "fused_relational_bf16_fwd_save": fr.fused_relational_bf16_fwd_save,
        "fused_relational_bf16_bwd_saved": fr.fused_relational_bf16_bwd_saved,
        "sorted_segment_sum": csr_segment.sorted_segment_sum,
        "sorted_gather": csr_segment.sorted_gather,
    }

    def reset():
        for fn in counters.values():
            fn.launches = 0
        fr._compact.calls = 0

    def step0():
        model.train()
        model.zero_grad(set_to_none=True)
        out, pdata = module.apply_model(g)
        loss, _ = module.get_losses(out, pdata)
        loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return grads, loss.detach()

    reset()
    gk, lk = step0()
    launches0 = {k: fn.launches for k, fn in counters.items()}
    partitions0 = fr._compact.calls
    with plain_path():
        gp, lp = step0()
    worst_name, worst = None, 0.0
    for name, gpt in gp.items():
        assert torch.isfinite(gk[name]).all(), f"{name}: non-finite gradient"
        ratio = (gk[name] - gpt).abs().max().item() / gpt.abs().max().item()
        assert ratio <= 5e-2, f"{name}: max|g_kernel - g_plain| is {ratio:.3e} of its largest magnitude"
        if ratio >= worst:
            worst_name, worst = name, ratio
    L = EC_MODEL["L_ec"]
    assert launches0["fused_relational_bf16_fwd"] == L and launches0["fused_relational_bf16_bwd"] == L, launches0
    # one partition of the edge ids a layer call, shared by its forward and backward
    assert partitions0 == L, f"step 0: {partitions0} partitions of the edge ids for {L} layers"
    log(f"EC step 0: loss {lk.item():.6f} (plain {lp.item():.6f}); {len(gk)} parameter gradients agree "
        f"with the plain path, the worst max|g_kernel - g_plain| {worst:.3e} of its largest magnitude "
        f"({worst_name}; bound 5e-2); launches {launches0}")

    for layer in model.ec_resin.layers:
        layer.fused_save_acts = True
    reset()
    gs, ls = step0()
    saved_launches = {k: counters[k].launches for k in ("fused_relational_bf16_fwd_save",
                                                        "fused_relational_bf16_bwd_saved")}
    for layer in model.ec_resin.layers:
        layer.fused_save_acts = False
    assert all(n == L for n in saved_launches.values()), saved_launches
    assert fr._compact.calls == L, f"fused_save_acts step: {fr._compact.calls} partitions for {L} layers"
    assert counters["fused_relational_bf16_fwd"].launches == 0 == counters["fused_relational_bf16_bwd"].launches
    assert torch.equal(ls, lk), f"fused_save_acts: loss {ls.item()} != {lk.item()}"
    differ = [n for n in gk if not torch.equal(gk[n], gs[n])]
    assert not differ, f"fused_save_acts: gradients differ bitwise: {differ}"
    log(f"EC step with fused_save_acts: loss and {len(gk)} gradients bitwise equal; launches {saved_launches}")

    for _ in range(2):
        module.training_step(g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = module.training_step(g)
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    per_step = {k: v / steps for k, v in launches.items()}
    assert per_step["fused_relational_bf16_fwd"] == L and per_step["fused_relational_bf16_bwd"] == L, per_step
    assert fr._compact.calls == L * steps, f"{fr._compact.calls} partitions in {steps} steps of {L} layers"
    per_step["_compact"] = fr._compact.calls / steps
    assert per_step["sorted_segment_sum"] > 0, per_step
    assert math.isfinite(metrics["total"]), metrics
    peak = torch.cuda.max_memory_allocated() / 2**30
    summary = {
        "steps": steps, "steps_per_s": steps / dt, "edges_per_s": N_EDGES * steps / dt,
        "step_ms": dt / steps * 1e3, **step_split(module, g), "peak_mem_gib": peak,
        "launches_per_step": per_step, "total": metrics["total"],
    }
    log("ec training: " + json.dumps(summary))
    if profile:
        profile_run(lambda: [module.training_step(g) for _ in range(3)], "ec_training")

    # (c) Trainer.fit over 4 npz events, validation on the first
    ec_dir = tmp / "ec_train"
    ec_dir.mkdir()
    for i in range(4):
        save_graph(EventGraph.from_arrays(**make_ec_event(seed + 130 + i)), ec_dir / f"ev{i:02d}.npz")
    fit_model = ECForGraphTCN(**EC_MODEL, device="cpu", generator=torch.Generator().manual_seed(seed + 122))
    fit_module = ECModule(model=fit_model, loss_fct=EdgeWeightFocalLoss(**EC_LOSS), lr=LR,
                          precision="bf16", device="cuda")
    dm = TrackingDataModule(train={"dirs": [ec_dir]}, val={"dirs": [ec_dir], "stop": 1}, seed=seed)
    trainer = Trainer(max_epochs=1, log_dir=tmp / "runs", name="ec", print_validation_results=False)
    t0 = time.perf_counter()
    val = trainer.fit(fit_module, dm)
    fit_s = time.perf_counter() - t0
    assert fit_module.step == 4 and len(trainer.checkpoints) == 1, (fit_module.step, trainer.checkpoints)
    aucs = {k: v for k, v in val.items() if k.startswith("roc_auc") and not k.endswith("_std")}
    assert len(aucs) == 12 and all(math.isfinite(v) for v in aucs.values()), aucs
    assert math.isfinite(val["total"]), val
    log(f"EC Trainer.fit: 4 steps in {fit_s:.1f} s; validation total {val['total']:.6f}, "
        f"max_mcc_pt0.9 {val['max_mcc_pt0.9']:.4f}, ROC AUC " + json.dumps(aucs))
    summary["fit_s"], summary["val_roc_auc"] = fit_s, aucs

    for r in results:
        r["launches"] = (saved_launches[r["name"]] if r["name"] in saved_launches
                         else launches[r["name"]])
    return results, summary


def topk_bound(x, k: int, mask, batch) -> tuple[float, str]:
    """Row #11/#13's bound: 3 flops per dimension for each pair of a valid
    query and a valid candidate of its batch; bytes of the points, mask,
    batch ids and the [N, k] outputs."""
    import torch

    counts = torch.bincount(batch[mask].long()).double()
    pairs = float((counts * counts).sum())
    return bound(3.0 * x.shape[1] * pairs, nbytes(x, mask, batch) + 8 * x.shape[0] * k)


def width_checks(seed: int, table: dict, *, wide: bool = False) -> None:
    """A-D (bf16) and rows #1 / #2 with C32 / D32 (f32) at the widths of
    ``table`` (name -> (dtype, (Fx, Fe, H, Fo), edges)) through the wrappers
    and through the differentiable op ``fused_relational``: each output and
    gradient at the layer's own widths and against its plain version (bf16
    within 2e-2 of the plain one's norm, as phase 9 (a); f32 within 1e-4 of
    its largest magnitude, as phase 3's row #1), repeat bitwise, C / D (C32 /
    D32) bitwise A / B (rows #1 / #2). ``ODD_WIDTHS`` take the resident
    kernels only zero-padded (``_Padding``); with ``wide`` every launch must
    be the wide layout's (``csrc/fused_relational_wide.cu``), none the
    resident kernels'."""
    import torch

    from gnn_tracking_tpu_torch.ops import fused_relational as fr

    wide_fns = (fr.fused_relational_wide_fwd, fr.fused_relational_wide_bwd)
    for name, (route, (fx, fe, h, fo), n_edges) in table.items():
        bf16 = route == "bf16"
        dtype = torch.bfloat16 if bf16 else torch.float32
        g, (x, ea, ei, mask, w, g_e, g_a) = ec_width_case(seed + 150, fx, fe, h, fo, n_edges, 0.8,
                                                          n=min(2000, n_edges))
        x, ea, g_e, g_a = (t.to(dtype) for t in (x, ea, g_e, g_a))
        w = {k: v.to(dtype) for k, v in w.items()}
        csr = g.csr()
        fwd, fwd_save, bwd, bwd_saved, plain_f, plain_b = (
            (fr.fused_relational_bf16_fwd, fr.fused_relational_bf16_fwd_save, fr.fused_relational_bf16_bwd,
             fr.fused_relational_bf16_bwd_saved, fr.fused_relational_bf16_plain, fr.fused_relational_bf16_bwd_plain)
            if bf16 else
            (fr.fused_relational_fwd, fr.fused_relational_fwd_save, fr.fused_relational_bwd,
             fr.fused_relational_bwd_saved, fr.fused_relational_plain, fr.fused_relational_bwd_plain))
        resident = (fwd, fwd_save, bwd, bwd_saved)
        before = [fn.launches for fn in (*resident, *wide_fns)]
        flat = lambda out: [out[0], out[1], *out[2].values()]
        a = fwd(x, ea, ei, mask, w, rowptr=csr["dst_rowptr"], relu_edge=True)
        a2 = fwd(x, ea, ei, mask, w, rowptr=csr["dst_rowptr"], relu_edge=True)
        c = fwd_save(x, ea, ei, mask, w, rowptr=csr["dst_rowptr"], relu_edge=True)
        b = flat(bwd(x, ea, ei, mask, w, g_e, g_a, csr, relu_edge=True))
        b2 = flat(bwd(x, ea, ei, mask, w, g_e, g_a, csr, relu_edge=True))
        d = flat(bwd_saved(c[2], c[3], ea, ei, mask, w, g_e, g_a, csr, g.num_nodes, relu_edge=True))
        pa, pb = plain_f(x, ea, ei, mask, w, relu_edge=True), flat(plain_b(x, ea, ei, mask, w, g_e, g_a, relu_edge=True))

        def op(inputs, graph):
            leaves = [t.detach().clone().requires_grad_() for t in inputs]
            ws = dict(zip(fr.WEIGHT_KEYS, leaves[2:]))
            if graph is None:  # the plain path
                out = plain_f(leaves[0], leaves[1], ei, mask, ws, relu_edge=True)
            else:
                out = fr.fused_relational(leaves[0], leaves[1], ei, mask, ws, csr=graph, relu_edge=True)
            loss = (out[0].float() * g_e.float()).sum() + (out[1].float() * g_a.float()).sum()
            loss.backward()
            return [out[0].detach(), out[1].detach(), *(t.grad for t in leaves)]

        inputs = [x, ea, *(w[k] for k in fr.WEIGHT_KEYS)]
        ko, po = op(inputs, csr), op(inputs, None)
        torch.cuda.synchronize()
        launched = [fn.launches - n0 for fn, n0 in zip((*resident, *wide_fns), before)]
        widths = (fx, fe, h, fo)
        if wide:
            assert not any(launched[:4]) and all(launched[4:]), f"{name}: launches {launched} (resident, wide)"
        else:
            assert all(launched[:4]) and not any(launched[4:]), f"{name}: launches {launched} (resident, wide)"
        worst = 0.0
        for k_t, p_t in zip([*a, *b, *ko], [*pa, *pb, *po]):
            assert k_t.shape == p_t.shape, f"{name} at {widths}: shape {k_t.shape} != {p_t.shape}"
            if bf16:
                rel = ((k_t.double() - p_t.double()).norm() / p_t.double().norm().clamp(min=1e-30)).item()
                assert rel <= 2e-2, f"bf16 kernels at {widths}: {rel:.3e} of the plain norm"
            else:
                rel = ((k_t - p_t).abs().max() / p_t.abs().max().clamp(min=1e-30)).item()
                assert rel <= 1e-4, f"f32 kernels at {widths}: {rel:.3e} of the largest"
            worst = max(worst, rel)
        for u, v in zip([*a, *b], [*a2, *b2]):
            assert torch.equal(u, v), f"{name} at {widths}: second launch differs"
        assert torch.equal(c[0], a[0]) and torch.equal(c[1], a[1]), f"{name}: the saving forward differs"
        assert all(torch.equal(u, v) for u, v in zip(b, d)), f"{name}: the saved-rows backward differs"
        pad = fr._Padding.of(x, ea, w)
        log(f"kernels at {name} widths ((Fx, Fe, H, Fo) = {widths}, E = {n_edges}"
            f"{', padded to ' + str(pad.padded) if pad else ''}): OK through "
            f"{'the wide layout' if wide else 'the resident kernels'} (launches {launched}), forward, "
            f"backward and the op's gradients within {worst:.3e} of the plain version "
            f"({'norm' if bf16 else 'largest magnitude'}), repeat bitwise, "
            f"{'C / D bitwise A / B' if bf16 else 'C32 / D32 bitwise rows #1 / #2'}")


def odd_width_checks(seed: int) -> None:
    """``width_checks`` at ``ODD_WIDTHS`` (the resident kernels, zero-padded)."""
    width_checks(seed, {route: (route, widths, 16000) for route, widths in ODD_WIDTHS.items()})


def wide_timings(seed: int) -> list[dict]:
    """The wide layout (``fused_relational_wide_fwd`` / ``_bwd``) at
    ``WIDE_WIDTHS`` on 262,144 edges, 80 % unmasked, in f32 and bf16: the
    call beside the plain version and the bound (the unmasked edges' MLP
    flops at the card's peak for the operands' type: the f32 CUDA-core peak
    in f32, the bf16 tensor-core peak in bf16, though the wide kernel does
    its bf16 products on the CUDA cores too), each checked against the plain
    version as ``width_checks`` does. Returns the kernel line's two entries
    (f32)."""
    import torch

    from gnn_tracking_tpu_torch.ops import fused_relational as fr

    fx, fe, h, fo = WIDE_WIDTHS
    out, entries = {}, []
    with torch.no_grad():
        for route in ("f32", "bf16"):
            dtype = torch.bfloat16 if route == "bf16" else torch.float32
            g, (x, ea, ei, mask, w, g_e, g_a) = ec_width_case(seed + 180, fx, fe, h, fo, N_EDGES, 0.8,
                                                              n=N_NODES)
            x, ea, g_e, g_a = (t.to(dtype).contiguous() for t in (x, ea, g_e, g_a))
            w = {k: v.to(dtype) for k, v in w.items()}
            csr = g.csr()
            fargs = (x, ea, ei, mask, w)
            kf = fr.fused_relational_wide_fwd(*fargs, rowptr=csr["dst_rowptr"])
            kb = fr.fused_relational_wide_bwd(x, None, None, ea, ei, mask, w, g_e, g_a, csr, g.num_nodes)
            plain_f = fr.fused_relational_bf16_plain if route == "bf16" else fr.fused_relational_plain
            plain_b = fr.fused_relational_bf16_bwd_plain if route == "bf16" else fr.fused_relational_bwd_plain
            pf, pb = plain_f(*fargs), plain_b(*fargs, g_e, g_a)
            torch.cuda.synchronize()
            errs, abs_errs = [], []
            for k_t, p_t in zip([*kf, kb[0], kb[1], *kb[2].values()], [*pf, pb[0], pb[1], *pb[2].values()]):
                if route == "bf16":
                    rel = ((k_t.double() - p_t.double()).norm() / p_t.double().norm().clamp(min=1e-30)).item()
                    assert rel <= 2e-2, f"wide bf16 at {WIDE_WIDTHS}: {rel:.3e} of the plain norm"
                else:
                    rel = ((k_t - p_t).abs().max() / p_t.abs().max().clamp(min=1e-30)).item()
                    assert rel <= 1e-4, f"wide f32 at {WIDE_WIDTHS}: {rel:.3e} of the largest"
                errs.append(rel)
                abs_errs.append((k_t.double() - p_t.double()).abs().max().item())
            n_valid = int(mask.sum())
            k = 2 * fx + fe
            peak = PEAK_BF16_FLOPS if route == "bf16" else PEAK_F32_FLOPS
            row = {
                "fwd_ms": cuda_ms(lambda: fr.fused_relational_wide_fwd(*fargs, rowptr=csr["dst_rowptr"]), reps=2, rounds=3),
                "fwd_plain_ms": cuda_ms(lambda: plain_f(*fargs), reps=1, rounds=3),
                "bwd_ms": cuda_ms(lambda: fr.fused_relational_wide_bwd(
                    x, None, None, ea, ei, mask, w, g_e, g_a, csr, g.num_nodes), reps=1, rounds=3),
                "bwd_plain_ms": cuda_ms(lambda: plain_b(*fargs, g_e, g_a), reps=1, rounds=3),
                "max_rel_err": max(errs), "max_abs_err": max(abs_errs),
            }
            row["fwd_bound_ms"], row["fwd_bound_by"] = bound(
                2.0 * n_valid * (k * h + h * h + h * fo), nbytes(x, ea, ei, mask, *w.values(), kf[0], kf[1]), peak=peak)
            row["bwd_bound_ms"], row["bwd_bound_by"] = bound(
                2.0 * n_valid * (3 * k * h + 3 * h * h + 2 * h * fo),
                nbytes(x, ea, ei, mask, *w.values(), g_e, g_a, kb[0], kb[1]) + 4 * sum(t.numel() for t in kb[2].values()),
                peak=peak)
            out[route] = row
            if route == "f32":
                entries = [
                    {"name": "fused_relational_wide_fwd", "max_abs_err": max(abs_errs[:2]), "ms": row["fwd_ms"],
                     "plain_ms": row["fwd_plain_ms"], "bound_ms": row["fwd_bound_ms"],
                     "bound_by": row["fwd_bound_by"], "library_ms": None},
                    {"name": "fused_relational_wide_bwd", "max_abs_err": max(abs_errs[2:]), "ms": row["bwd_ms"],
                     "plain_ms": row["bwd_plain_ms"], "bound_ms": row["bwd_bound_ms"],
                     "bound_by": row["bwd_bound_by"], "library_ms": None},
                ]
    log(f"wide layout at (Fx, Fe, H, Fo) = {WIDE_WIDTHS}, {N_EDGES} edges, 80 % unmasked: OK against the plain "
        "version; wide timings: " + json.dumps(out))
    return entries


def wide_ec_steps(seed: int) -> dict:
    """The wide layout's own path: one ``ECModule`` step of ``ECForGraphTCN``
    at ``WIDE_EC_MODEL`` (every layer at ``WIDE_WIDTHS``), f32 and bf16, on
    phase 9's event: step 0's gradients through the kernels against the
    plain path's (f32 by ``compare_grads``; bf16 each tensor within 5e-2 of
    its largest magnitude, as phase 9), the wide kernels launched once a
    layer each way and the resident ones never (counts set to 0 just
    before). Returns the wide kernels' launches, by precision."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.losses.ec import EdgeWeightFocalLoss
    from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
    from gnn_tracking_tpu_torch.ops import fused_relational as fr
    from gnn_tracking_tpu_torch.training.module import ECModule

    g = EventGraph.from_arrays(**make_ec_event(seed + 190)).sort_edges_by_target().to("cuda")
    wide = {"fused_relational_wide_fwd": fr.fused_relational_wide_fwd,
            "fused_relational_wide_bwd": fr.fused_relational_wide_bwd}
    resident = (fr.fused_relational_fwd, fr.fused_relational_bwd, fr.fused_relational_bf16_fwd,
                fr.fused_relational_bf16_bwd)
    by_precision = {}
    for precision in ("f32", "bf16"):
        model = ECForGraphTCN(**WIDE_EC_MODEL, device="cpu", generator=torch.Generator().manual_seed(seed + 191))
        ec = ECModule(model=model, loss_fct=EdgeWeightFocalLoss(**EC_LOSS), lr=LR, precision=precision,
                      device="cuda")
        ec.setup_params(g)

        def step0():
            model.train()
            model.zero_grad(set_to_none=True)
            out, pdata = ec.apply_model(g)
            loss, _ = ec.get_losses(out, pdata)
            loss.backward()
            grads = {n: None if p.grad is None else p.grad.detach().clone() for n, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
            return grads, loss.item()

        for fn in (*wide.values(), *resident):
            fn.launches = 0
        gk, lk = step0()
        launches = {name: fn.launches for name, fn in wide.items()}
        assert not any(fn.launches for fn in resident), [fn.launches for fn in resident]
        assert all(n == WIDE_EC_MODEL["L_ec"] for n in launches.values()), launches
        with plain_path():
            gp, lp = step0()
        if precision == "f32":
            worst_name, worst, _, no_grad, _ = compare_grads(gk, gp)
            assert not no_grad, no_grad
        else:
            worst_name, worst = None, 0.0
            for name, gpt in gp.items():
                if gpt is None:
                    continue
                assert torch.isfinite(gk[name]).all(), f"{name}: non-finite gradient"
                ratio = (gk[name] - gpt).abs().max().item() / gpt.abs().max().item()
                assert ratio <= 5e-2, f"wide bf16 step: {name} {ratio:.3e} of its largest magnitude"
                if ratio >= worst:
                    worst_name, worst = name, ratio
        by_precision[precision] = launches
        log(f"wide EC step ({precision}, {WIDE_EC_MODEL}): loss {lk:.6f} (plain {lp:.6f}); gradients agree "
            f"with the plain path (worst {worst_name}: {worst:.3e}); launches {launches}")
    return by_precision


WIDE_DIMS = (33, 40, 64)


def wide_dim_checks(seed: int) -> None:
    """Rows #11-#13 above 32 dimensions (the kernels' run-time-d paths) at d
    in ``WIDE_DIMS``, on 4,096 points of the benchmark cloud's recipe (15 %
    masked, two batch ids): rows #13 / #11 at k = 1, 8, 32, 64 and 300 (row
    #12's kernel above 32) and with ``loop`` at k = 8, through
    ``check_split`` (bitwise row #12 on unmasked rows, masked (+inf, 0),
    repeat bitwise, key order, the plain version); row #12 in kNN and radius
    mode at k = 8 and 64 and at k = 1,024 (passes), against its plain
    version, repeat bitwise, key order."""
    import torch

    from gnn_tracking_tpu_torch.ops import pairwise_topk as pt

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 175)
    n = 4096
    on = lambda a: torch.from_numpy(a).to(dev)
    mask, batch = on(rng.random(n) > 0.15), on((np.arange(n) >= n // 2).astype(np.int32))
    out = {}
    for d in WIDE_DIMS:
        x = on(make_wide_cloud(seed + 176 + d, n, d))
        for k in (1, 8, 32, 64, 300):
            out[f"d{d}_k{k}_batched"] = check_split(
                f"pairwise_topk d={d} k={k}", pt.pairwise_topk, x, {"k": k, "node_mask": mask, "batch": batch})
            out[f"d{d}_k{k}_streaming"] = check_split(
                f"pairwise_topk_streaming d={d} k={k}", pt.pairwise_topk_streaming, x, {"k": k, "node_mask": mask})
        out[f"d{d}_k8_loop"] = check_split(
            f"pairwise_topk d={d} k=8 loop", pt.pairwise_topk, x, {"k": 8, "node_mask": mask, "batch": batch, "loop": True})
        r2 = 0.01 * d  # inside a cluster (0.005 d a pair on average), far below the centres' spacing
        for kw in ({"k": 8}, {"k": 64, "radius2": r2}, {"k": 64, "node_mask": mask, "batch": batch},
                   {"k": 1024, "node_mask": mask, "batch": batch}):
            what = f"pairwise_topk_filter d={d} " + ",".join(f"{a}={v}" for a, v in kw.items() if a in ("k", "radius2"))
            kd, ki = pt.pairwise_topk_filter(x, **kw)
            kd2, ki2 = pt.pairwise_topk_filter(x, **kw)
            pd, pi = pt.pairwise_topk_filter_plain(x, **kw)
            torch.cuda.synchronize()
            assert torch.equal(kd, kd2) and torch.equal(ki, ki2), f"{what}: second call differs"
            err, nb, nt = compare_topk(kd, ki, pd, pi, kw.get("radius2"))
            assert_key_order(kd, ki, what)
            out[what] = {"max_abs_err": err, "boundary_rows": nb, "tie_rows": nt,
                         "filled": float(torch.isfinite(kd).sum(dim=1).float().mean())}
    log(f"rows #11-#13 above 32 dimensions (d = {WIDE_DIMS}, 4,096 points): {len(out)} cases OK: " + json.dumps(out))


def resident_wide_checks(seed: int) -> dict:
    """Phase 8 (a)'s resident top-k above 32 dimensions: rows #13 (batched,
    two batch ids) and #11 at k = 8 on ``WIDE_HITS`` points of the benchmark
    cloud's recipe in 40 and 64 dimensions, each bitwise row #12 on unmasked
    rows and against its plain version (``check_split``), timed beside row
    #12 and the bound."""
    import torch

    from gnn_tracking_tpu_torch.ops import pairwise_topk as pt

    dev = torch.device("cuda")
    out = {}
    for d in (40, 64):
        x = torch.from_numpy(make_wide_cloud(seed + 94 + d, WIDE_HITS, d)).to(dev)
        mask = torch.ones(WIDE_HITS, dtype=torch.bool, device=dev)
        batch = (torch.arange(WIDE_HITS, device=dev) >= WIDE_HITS // 2).to(torch.int32)
        for what, fn, kw in (("row13", pt.pairwise_topk, {"k": GC_K, "node_mask": mask, "batch": batch}),
                             ("row11", pt.pairwise_topk_streaming, {"k": GC_K})):
            row = check_split(f"{fn.__name__} d={d} k={GC_K} on {WIDE_HITS} points", fn, x, kw)
            row["plan"] = fn.last_plan
            row["ms"] = cuda_ms(lambda: fn(x, **kw), reps=1, rounds=3)
            row["row12_ms"] = cuda_ms(lambda: pt.pairwise_topk_filter(x, **kw), reps=1, rounds=3)
            row["bound_ms"], row["bound_by"] = topk_bound(x, GC_K, mask, batch if fn is pt.pairwise_topk else
                                                          torch.zeros_like(batch))
            out[f"{what}_d{d}"] = row
    log(f"rows #13 / #11 above 32 dimensions on {WIDE_HITS} points at k = {GC_K}: OK (bitwise row #12 on "
        "unmasked rows, the plain version, repeat bitwise): " + json.dumps(out))
    return out


def validation_kernel_phases(seed: int) -> list[dict]:
    """Phase 10 (a): the split kernel pair as rows #13 and #11 against their
    plain versions, and rows #1/#2 at ``ec.yml``'s widths (see the module
    docstring) and at odd widths (``odd_width_checks``). Returns rows #13 and
    #11's results."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
    from gnn_tracking_tpu_torch.ops import fused_relational as fr
    from gnn_tracking_tpu_torch.ops import knn
    from gnn_tracking_tpu_torch.ops import pairwise_topk as pt

    dev = torch.device("cuda")
    results = []
    # ---- row #13 at 32,768 points: two batch ids, 10 % masked
    x, mask, batch = phase10_input(seed)
    row13 = {}
    for k in SPLIT_SWEEP_KS:
        kw = {"k": k, "node_mask": mask, "batch": batch}
        checked = check_split(f"pairwise_topk k={k}", pt.pairwise_topk, x, kw)
        err, nb, nt = checked["max_abs_err"], checked["boundary_rows"], checked["tie_rows"]
        reps = 5 if k <= 64 else 1
        ms = cuda_ms(lambda: pt.pairwise_topk(x, **kw), reps=reps, rounds=5 if k <= 64 else 3)
        plain = cuda_ms(lambda: pt.pairwise_topk_plain(x, **kw), reps=1, rounds=3)
        filt = cuda_ms(lambda: pt.pairwise_topk_filter(x, **kw), reps=reps, rounds=5 if k <= 64 else 3)
        bnd, by = topk_bound(x, k, mask, batch)
        row13[k] = {"max_abs_err": err, "ms": ms, "plain_ms": plain, "filter_ms": filt, "bound_ms": bnd,
                    "bound_by": by}
        log(f"kernel pairwise_topk (row #13) k={k}, plan {pt.pairwise_topk.last_plan} (R, S): OK "
            f"max|err| {err:.3e} ({nb} k-th boundary rows, {nt} tie-order rows), masked queries (+inf, 0), "
            f"unmasked rows bitwise equal to row #12's kernel, repeat bitwise, key order; "
            f"{ms:.3f} ms (row #12 on the same input {filt:.3f} ms, plain {plain:.3f} ms, bound {bnd:.4f} "
            f"ms by {by})")
    faster = [k for k in SPLIT_SWEEP_KS if row13[k]["ms"] < row13[k]["filter_ms"]]
    log(f"row #13 against row #12 on this input: faster at k in {faster} of {list(SPLIT_SWEEP_KS)}; "
        f"knn_graph takes row #13 at k <= knn.SPLIT_MAX_K = {knn.SPLIT_MAX_K} (set from --split-only)")
    # ---- above one pass of row #12 (k > 512) and above the split pair's k (rows #13 / #11 at k =
    # 300): row #12's passes, on 4,096 of those points (k = 2,048 leaves rows unfilled)
    xs, ms_ = x[:4096], mask[:4096]
    bs_ = (torch.arange(4096, device=dev) >= 2048).to(torch.int32)
    calls = [(f"pairwise_topk_filter k={k}", pt.pairwise_topk_filter, pt.pairwise_topk_filter_plain,
              {"k": k, "node_mask": ms_, "batch": bs_}) for k in (1024, 2048)]
    calls += [("pairwise_topk k=300", pt.pairwise_topk, pt.pairwise_topk_plain,
               {"k": 300, "node_mask": ms_, "batch": bs_}),
              ("pairwise_topk_streaming k=300", pt.pairwise_topk_streaming, pt.pairwise_topk_streaming_plain,
               {"k": 300, "node_mask": ms_})]
    for what, fn, plain_fn, kw in calls:
        before = pt.pairwise_topk_filter.launches
        kd, ki = fn(xs, **kw)
        passes = pt.pairwise_topk_filter.launches - before
        kd2, ki2 = fn(xs, **kw)
        pd, pi = plain_fn(xs, **kw)
        torch.cuda.synchronize()
        assert torch.equal(kd, kd2) and torch.equal(ki, ki2), f"{what}: second call differs"
        err, nb, nt = compare_topk(kd, ki, pd, pi, None)
        assert_key_order(kd, ki, what)
        if fn is not pt.pairwise_topk_filter:
            assert torch.isinf(kd[~ms_]).all() and (ki[~ms_] == 0).all(), f"{what}: masked queries not (+inf, 0)"
        ms = cuda_ms(lambda: fn(xs, **kw), reps=1, rounds=3)
        filled = torch.isfinite(kd).sum(dim=1).float().mean().item()
        log(f"kernel {what} on 4,096 points: OK in {passes} launches of row #12, max|err| {err:.3e} ({nb} "
            f"k-th boundary rows, {nt} tie-order rows), key order, repeat bitwise; {filled:.1f} filled slots "
            f"a row; {ms:.3f} ms")
    # the line's entry is the scanner's largest k
    results.append({"name": "pairwise_topk", **{k: row13[max(VAL_KS)][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
        "max_abs_err": max(r["max_abs_err"] for r in row13.values())})

    # ---- row #11 at 262,144 points on the JAX kNN benchmark's cloud, every query
    xb = torch.from_numpy(make_bench_latent(seed + 92, GC_HITS)[0]).to(dev)
    kd, ki = pt.pairwise_topk_streaming(xb, k=GC_K)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    pd, pi = pt.pairwise_topk_streaming_plain(xb, k=GC_K)
    end.record()
    end.synchronize()
    plain11 = start.elapsed_time(end)
    err11, nb11, nt11 = compare_topk(kd, ki, pd, pi, None)
    del pd, pi
    ms11 = cuda_ms(lambda: pt.pairwise_topk_streaming(xb, k=GC_K), reps=1, rounds=3)
    ones = torch.ones(GC_HITS, dtype=torch.bool, device=dev)
    bnd11, by11 = topk_bound(xb, GC_K, ones, torch.zeros(GC_HITS, dtype=torch.int32, device=dev))
    results.append({"name": "pairwise_topk_streaming", "max_abs_err": err11, "ms": ms11,
                    "plain_ms": plain11, "bound_ms": bnd11, "bound_by": by11, "library_ms": None})
    log(f"kernel pairwise_topk_streaming (row #11) at {GC_HITS} points, k={GC_K}, "
        f"plan {pt.pairwise_topk_streaming.last_plan} (R, S): OK on every query, max|err| "
        f"{err11:.3e} ({nb11} k-th boundary rows, {nt11} tie-order rows); {ms11:.3f} ms (plain {plain11:.1f} "
        f"ms, one call; bound {bnd11:.4f} ms by {by11})")

    # ---- rows #1/#2 at ec.yml's widths (W1 in device memory)
    g = EventGraph.from_arrays(**make_ec_event(seed + 142)).sort_edges_by_target().to(dev)
    model = ECForGraphTCN(**EC_MODEL, device="cpu", generator=torch.Generator().manual_seed(seed + 143)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 144)
    csr = g.csr()
    with torch.no_grad():
        h = torch.relu(model.ec_node_encoder(g.x)).contiguous()
        ea = model.ec_edge_encoder(g.edge_attr).contiguous()
        weights = {k: v.detach() for k, v in model.ec_resin.layers[1].relational_weights().items()}
        emask = torch.from_numpy(np.random.default_rng(seed + 145).random(N_EDGES) < 0.8).to(dev)
        fo, hid = weights["w3"].shape[0], weights["w2"].shape[0]
        g_e = torch.randn((N_EDGES, fo), generator=gen, device=dev)
        g_a = torch.randn((N_NODES, fo), generator=gen, device=dev)
        args = (h, ea, g.edge_index, emask, weights)
        args64 = (h.double(), ea.double(), g.edge_index, emask, {k: v.double() for k, v in weights.items()})
        err1 = err2 = 0.0
        for relu_edge in (False, True):
            for kt, pt_ in zip(fr.fused_relational_fwd(*args, rowptr=csr["dst_rowptr"], relu_edge=relu_edge),
                               fr.fused_relational_plain(*args, relu_edge=relu_edge)):
                err = (kt - pt_).abs().max().item()
                assert err <= 1e-4 * pt_.abs().max().item(), f"fused_relational_fwd at ec.yml widths: {err}"
                err1 = max(err1, err)
            named = lambda out: [out[0], out[1], *out[2].values()]
            kb = named(fr.fused_relational_bwd(*args, g_e, g_a, csr, relu_edge=relu_edge))
            kb2 = named(fr.fused_relational_bwd(*args, g_e, g_a, csr, relu_edge=relu_edge))
            pb = named(fr.fused_relational_bwd_plain(*args, g_e, g_a, relu_edge=relu_edge))
            rb = named(fr.fused_relational_bwd_plain(*args64, g_e.double(), g_a.double(), relu_edge=relu_edge))
            torch.cuda.synchronize()
            for kt, kt2, pt_, rt in zip(kb, kb2, pb, rb):
                assert torch.equal(kt, kt2), "fused_relational_bwd at ec.yml widths: second launch differs"
                ek, ep = (kt.double() - rt).abs().max().item(), (pt_.double() - rt).abs().max().item()
                assert math.isfinite(ek) and ek <= 4 * ep, (
                    f"fused_relational_bwd at ec.yml widths: kernel err {ek:.3e} > 4 x plain f32 err {ep:.3e}")
                err2 = max(err2, ek)
        ms1 = cuda_ms(lambda: fr.fused_relational_fwd(*args, rowptr=csr["dst_rowptr"]))
        plain1 = cuda_ms(lambda: fr.fused_relational_plain(*args))
        ms2 = cuda_ms(lambda: fr.fused_relational_bwd(*args, g_e, g_a, csr))
        plain2 = cuda_ms(lambda: fr.fused_relational_bwd_plain(*args, g_e, g_a))
        f32_saved_pair(h, ea, g.edge_index, emask, weights, csr, g_e, g_a, "ec.yml widths")
    k2, n_valid = 2 * h.shape[1] + ea.shape[1], int(emask.sum())
    bnd1, by1 = bound(2.0 * n_valid * (k2 * hid + hid * hid + hid * fo),
                      nbytes(h, ea, g.edge_index, emask, csr["dst_rowptr"], *weights.values())
                      + 4 * (N_EDGES + N_NODES) * fo)
    bnd2, by2 = bound(2.0 * n_valid * (3 * k2 * hid + 3 * hid * hid + 2 * hid * fo),
                      nbytes(h, ea, g.edge_index, emask, *weights.values(), g_e, g_a, *csr.values(), *kb))
    log(f"kernels fused_relational_fwd/bwd at ec.yml widths (K={k2}, H={hid}, Fo={fo}; W1 in device memory): "
        f"OK forward max|err| {err1:.3e} (<= 1e-4 of the largest), backward max|err| vs float64 {err2:.3e} "
        f"(<= 4x the plain f32 version's), repeat bitwise; forward {ms1:.3f} ms (plain {plain1:.3f} ms, bound "
        f"{bnd1:.4f} ms by {by1}), backward {ms2:.3f} ms (plain {plain2:.3f} ms, bound {bnd2:.4f} ms by {by2})")
    odd_width_checks(seed)
    wide_dim_checks(seed)
    width_checks(seed, WIDE_CHECKS, wide=True)
    return results + wide_timings(seed)


def save_clouds(directory: Path, seeds, *, all_pair_truth: bool) -> None:
    """32,768-hit point clouds as npz; ``all_pair_truth`` stores every
    intra-particle pair as the true edges (so the scanner's edge
    efficiency is defined), else the point-cloud layout."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.utils.loading import save_graph

    directory.mkdir()
    for s in seeds:
        cloud = make_point_cloud(s, ML_HITS, ML_PARTICLES)
        if not all_pair_truth:
            save_graph(EventGraph.from_arrays(**cloud), directory / f"pc{s}.npz")
            continue
        del cloud["edge_index"]
        te = torch.from_numpy(all_pairs(cloud["particle_id"]))
        save_graph(EventGraph.from_arrays(**cloud).replace(
            true_edge_index=te, true_edge_mask=torch.ones(te.shape[1], dtype=torch.bool)),
            directory / f"pc{s}.npz")


def foms_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        (math.isnan(a[k]) and math.isnan(b[k])) or math.isclose(a[k], b[k], rel_tol=1e-9, abs_tol=1e-12)
        for k in a)


def ml_validation_path(seed: int, epochs: int, fcnn, tmp: Path) -> tuple[dict, int]:
    """Phase 10 (b): ``MLModule`` with the k-scanner through
    ``Trainer.fit`` under the default choice (row #13 at k <= ``knn.SPLIT_MAX_K``),
    validations under ``"pallas"`` and ``"filter"``, and one f32 EC step at ``ec.yml``'s widths, recomputing
    and with ``fused_save_acts`` (bitwise equal). Returns the summary and row #13's launches in
    ``Trainer.fit`` (in the ``"pallas"`` validation where the route takes none)."""
    import torch

    from gnn_tracking_tpu_torch.graph_construction.k_scanner import GraphConstructionKNNScanner
    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.losses.ec import EdgeWeightFocalLoss
    from gnn_tracking_tpu_torch.losses.metric_learning import GraphConstructionHingeEmbeddingLoss
    from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
    from gnn_tracking_tpu_torch.ops import fused_relational as fr
    from gnn_tracking_tpu_torch.ops import knn, pairwise_topk
    from gnn_tracking_tpu_torch.training.module import ECModule, MLModule
    from gnn_tracking_tpu_torch.training.trainer import Trainer
    from gnn_tracking_tpu_torch.utils.loading import TrackingDataModule

    save_clouds(tmp / "ml_train", [seed + 150, seed + 151], all_pair_truth=False)
    save_clouds(tmp / "ml_val", [seed + 160, seed + 161], all_pair_truth=True)
    scanner = GraphConstructionKNNScanner(ks=VAL_KS)
    module = MLModule(model=copy.deepcopy(fcnn), loss_fct=GraphConstructionHingeEmbeddingLoss(**ML_LOSS),
                      lr=LR, gc_scanner=scanner, device="cuda")
    dm = TrackingDataModule(train={"dirs": [tmp / "ml_train"]}, val={"dirs": [tmp / "ml_val"]}, seed=seed)
    trainer = Trainer(max_epochs=epochs, val_every_n_epochs=epochs, log_dir=tmp / "runs", name="ml_val",
                      checkpoint_every_epoch=False, print_validation_results=False)
    split, resident = pairwise_topk.pairwise_topk, pairwise_topk.pairwise_topk_filter
    # the default route: row #13 at the scanner's k <= knn.SPLIT_MAX_K, row #12 above
    split_ks = sum(k <= knn.SPLIT_MAX_K for k in VAL_KS)
    saved_impl = knn._SMALL_TOPK_IMPL
    try:
        knn._SMALL_TOPK_IMPL = None
        split.launches = resident.launches = 0
        t0 = time.perf_counter()
        fit_val = trainer.fit(module, dm)
        fit_s = time.perf_counter() - t0
        launches = split.launches
        fit_resident = resident.launches  # the hinge loss's radius graphs, and the scanner's k above the route
        assert module.step == 2 * epochs, module.step
        assert launches == split_ks * 2, f"row #13 launched {launches} times in 2 validation events"
        records, results = scanner.results_raw, scanner.get_results()
        foms = module.on_validation_epoch_end()
        assert foms_equal(foms, {k: fit_val[k] for k in foms}), "figures of merit differ from Trainer.fit's"
        timed = {}
        for impl in ("pallas", "filter"):
            knn._SMALL_TOPK_IMPL = impl
            split.launches = resident.launches = 0
            t0 = time.perf_counter()
            trainer.validate(module, dm)
            timed[impl] = {"val_s": time.perf_counter() - t0, "row13": split.launches,
                           "row12": resident.launches, "foms": module.on_validation_epoch_end()}
            same = len(scanner.results_raw) == len(records) and all(
                foms_equal(a, b) for a, b in zip(scanner.results_raw, records))
            assert same, f"per-k records under '{impl}' differ from Trainer.fit's"
    finally:
        knn._SMALL_TOPK_IMPL = saved_impl
    assert foms_equal(timed["pallas"]["foms"], foms), "a second validation under 'pallas' differs"
    assert foms_equal(timed["filter"]["foms"], foms), (
        "validation under 'filter' (row #12) differs from 'pallas' (row #13)")
    # row #12 serves the hinge loss's radius graph of each event, and under
    # 'filter' the scanner's kNN graphs too
    n_val = len(VAL_KS) * 2
    assert timed["pallas"]["row13"] == n_val and timed["pallas"]["row12"] == 2, timed
    assert timed["filter"]["row13"] == 0 and timed["filter"]["row12"] == n_val + 2, timed
    # finite where the JAX rules give a number: an at-target figure is NaN
    # when the target lies above the largest mean frac50, or when its column
    # has a NaN at some k
    max50 = float(np.nanmax(results.df["frac50"]))
    nan_cols = {c for c, v in results.df.items() if np.isnan(v).any()}
    for t in scanner.targets:
        for key, col in ([(f"n_edges_frac_segment50_{t * 100:.0f}", "n_edges")]
                         + [(f"{v}_at_segment50_{t * 100:.0f}", v) for v in results._extra_metrics]):
            assert math.isnan(foms[key]) == (t > max50 or col in nan_cols), (key, foms[key], max50)
    for key in ("max_frac_segment50", "n_edges_max_frac_segment50", "efficiency_at_max_frac_segment50"):
        assert math.isfinite(foms[key]), (key, foms[key])
    for r in records:
        for key in ("max_double_majority_pt0.9", "max_perfect_pt0.9", "max_lhc_pt0.9", "efficiency", "purity"):
            assert math.isfinite(r[key]), (r["k"], key, r[key])
    by_k = {r["k"]: r for r in records[: len(VAL_KS)]}
    log(f"ML validation: Trainer.fit ({2 * epochs} steps, 2 validation events of {ML_HITS} hits, ks {VAL_KS}) in "
        f"{fit_s:.2f} s; row #13 launches {launches} at k <= knn.SPLIT_MAX_K = {knn.SPLIT_MAX_K} (row #12 "
        f"{fit_resident}: the hinge loss's radius graphs and the scanner's k above); "
        f"validation epoch {timed['pallas']['val_s']:.2f} s under 'pallas', {timed['filter']['val_s']:.2f} s "
        f"under 'filter' (row #12 in place of row #13), figures of merit equal; "
        f"max_frac_segment50 {foms['max_frac_segment50']:.4f} at k {foms['k_at_max_frac_segment50']:.0f}; "
        f"first event's k: frac50 / max_double_majority_pt0.9 / n_edges "
        + ", ".join(f"{k}: {r['frac50']:.4f}/{r['max_double_majority_pt0.9']:.4f}/{r['n_edges']}"
                    for k, r in by_k.items()))
    log("ML validation FOMs: " + json.dumps(foms))

    # ---- one f32 EC step at ec.yml's widths: step-0 gradients against the plain path
    g = EventGraph.from_arrays(**make_ec_event(seed + 170)).sort_edges_by_target().to("cuda")
    model = ECForGraphTCN(**EC_MODEL, device="cpu", generator=torch.Generator().manual_seed(seed + 171))
    ec = ECModule(model=model, loss_fct=EdgeWeightFocalLoss(**EC_LOSS), lr=LR, precision="f32", device="cuda")
    ec.setup_params(g)

    def step0():
        model.train()
        model.zero_grad(set_to_none=True)
        out, pdata = ec.apply_model(g)
        loss, _ = ec.get_losses(out, pdata)
        loss.backward()
        grads = {n: None if p.grad is None else p.grad.detach().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return grads, loss.item()

    fr.fused_relational_fwd.launches = fr.fused_relational_bwd.launches = fr._compact.calls = 0
    gk, lk = step0()
    f32_launches = {"fused_relational_fwd": fr.fused_relational_fwd.launches,
                    "fused_relational_bwd": fr.fused_relational_bwd.launches}
    # one partition of the edge ids a layer call, shared by its forward and backward
    assert fr._compact.calls == EC_MODEL["L_ec"], f"f32 EC step: {fr._compact.calls} partitions"
    with plain_path():
        gp, lp = step0()
    worst_name, worst, at_floor, no_grad, total = compare_grads(gk, gp)
    assert not no_grad, no_grad
    assert all(n == EC_MODEL["L_ec"] for n in f32_launches.values()), f32_launches
    # the same step with fused_save_acts (kernels C32 / D32): bitwise the recomputing step
    saving = (fr.fused_relational_fwd_save, fr.fused_relational_bwd_saved)
    for layer in model.ec_resin.layers:
        layer.fused_save_acts = True
    for fn in (fr.fused_relational_fwd, fr.fused_relational_bwd, *saving):
        fn.launches = 0
    gs, ls = step0()
    saved_launches = {fn.__name__: fn.launches for fn in saving}
    for layer in model.ec_resin.layers:
        layer.fused_save_acts = False
    assert all(n == EC_MODEL["L_ec"] for n in saved_launches.values()), saved_launches
    assert fr.fused_relational_fwd.launches == 0 == fr.fused_relational_bwd.launches
    assert ls == lk, f"f32 fused_save_acts: loss {ls} != {lk}"
    differ = [n for n in gk if not torch.equal(gk[n], gs[n])]
    assert not differ, f"f32 fused_save_acts: gradients differ bitwise: {differ}"
    log(f"f32 EC step with fused_save_acts: loss and {len(gk)} gradients bitwise equal to the recomputing "
        f"step's; launches {saved_launches}")
    t0 = time.perf_counter()
    metrics = ec.training_step(g)
    ec_step_ms = (time.perf_counter() - t0) * 1e3
    assert math.isfinite(metrics["total"]), metrics
    log(f"f32 EC step at ec.yml widths: loss {lk:.6f} (plain {lp:.6f}); {len(gk)} parameter gradients agree "
        f"with the plain path (worst {worst_name}: {worst:.3e} relative; within the floor of 1e-7 x "
        f"{total:.3e} only: {at_floor or 'none'}); launches {f32_launches}; one training_step "
        f"{ec_step_ms:.1f} ms (host clock, the first)")
    summary = {"fit_s": fit_s, "steps": 2 * epochs, "validations": timed, "row13_launches_fit": launches,
               "foms": foms, "ec_f32_step_ms": ec_step_ms, "ec_f32_launches": f32_launches,
               "ec_f32_saved_launches": saved_launches}
    # row #13's launches on the main path: the default route's, or the 'pallas' validation's where
    # knn.SPLIT_MAX_K sends every k of the scanner to row #12
    return summary, launches or timed["pallas"]["row13"]


def ptxas_by_kernel(text: str) -> list[str]:
    """``nvcc -Xptxas -v``'s register, stack and spill lines, each after the
    kernel it belongs to (names demangled with the toolkit's ``cu++filt``
    where it is found)."""
    from gnn_tracking_tpu_torch import _build

    lines, names, kernel = [], {}, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            lines.append((kernel, line.split(":", 1)[-1].strip() if "ptxas info" in line else line.strip()))
    filt = Path(_build.nvcc()).parent / "cu++filt"
    if filt.exists() and lines:
        mangled = sorted({k for k, _ in lines})
        out = subprocess.run([str(filt)], input="\n".join(mangled), capture_output=True, text=True).stdout
        names = dict(zip(mangled, out.splitlines()))
    return [f"{names.get(k, k)}: {line}" for k, line in lines]


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
    p.add_argument("--ec-steps", type=int, default=10,
                   help="timed bf16 EC training steps (after 2 warm-up steps)")
    p.add_argument("--val-epochs", type=int, default=75,
                   help="metric-learning epochs over 2 point clouds before phase 10's validation")
    p.add_argument("--profile", action="store_true",
                   help="also trace one predict_dir, 3 training steps, 3 metric-learning "
                   "steps and 3 EC steps with torch.profiler")
    p.add_argument("--segment-sum-only", action="store_true",
                   help="build, time row #9 on phase 3's and the masked-tail input "
                   "(segment_sum_timings), print them and stop")
    p.add_argument("--relational-bwd-only", action="store_true",
                   help="build, check and time row #2 and D32 at the GraphTCN HC layer's and "
                   "ec.yml's widths at several unmasked shares (relational_bwd_timings), "
                   "print them and stop")
    p.add_argument("--ec-bwd-only", action="store_true",
                   help="build, check and time kernels B and D (the bf16 backward) at phase 9's "
                   "input at several unmasked shares (ec_bwd_timings), print them and stop")
    p.add_argument("--ec-fwd-only", action="store_true",
                   help="build, check and time kernels A and C (the bf16 forward) at phase 9's "
                   "input at several unmasked shares (ec_fwd_timings), check them at other widths "
                   "(ec_fwd_widths, for the package beside this script), print them and stop")
    p.add_argument("--topk-only", action="store_true",
                   help="build, check and time row #12 (pairwise_topk_filter) on the ML, "
                   "serving, phase 10 and adversarial inputs (topk_timings), print them and stop")
    p.add_argument("--split-only", action="store_true",
                   help="build, check rows #13 / #11 (split_checks) and time them beside row #12 on "
                   "phase 10 (a)'s input and phase 8's 262,144-point inputs (split_timings), "
                   "print them and stop")
    p.add_argument("--band-only", action="store_true",
                   help="build, check and time row #14 (banded_topk_sorted) on phase 8's band inputs "
                   "at several k (band_timings), print them and stop")
    p.add_argument("--probe-only", action="store_true",
                   help="build, check and time row #15 (ivf_probe) on phase 8 (a)'s tables and the "
                   "hole, loop, shuffled and other-slot cases (probe_timings), time the IVF build "
                   "(split into its parts where the package records them), print them and stop")
    p.add_argument("--gather-only", action="store_true",
                   help="build, check and time row #10 (sorted_gather) at phase 3's shape, at F = 3 "
                   "and 33, in bf16 and through the source ids (gather_timings), print them and stop")
    p.add_argument("--digests", type=Path, default=None,
                   help="build, run the kernels this tree left in place on fixed inputs "
                   "(bitwise_digests) and write their output digests to the file, or compare "
                   "them with it where it exists (another tree's run), then stop")
    p.add_argument("--cc-only", action="store_true",
                   help="build, check and time row #16 (cc_neighbors) on phase 3's table and the "
                   "chain and edge-case tables (cc_checks), print them and stop")
    p.add_argument("--wide-only", action="store_true",
                   help="build, check rows #11-#13 above 32 dimensions and the fused relational "
                   "wide layout, time the latter and run its EC steps, print them and stop "
                   "(this tree only)")
    p.add_argument("--band-digests", type=Path, default=None,
                   help="with --band-only: a file of row #14's output digests to compare with "
                   "(another tree's run), or to write where there is none")
    p.add_argument("--package-root", type=Path, default=REPO,
                   help="directory holding the gnn_tracking_tpu_torch package to run "
                   "(default: beside this script), e.g. an older tree to compare on one card")
    args = p.parse_args(argv)
    if args.events < 3:
        p.error("--events must be at least 3")
    if min(args.train_steps, args.ml_steps, args.ec_steps, args.val_epochs) < 1:
        p.error("--train-steps, --ml-steps, --ec-steps and --val-epochs must be at least 1")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no GPU, no result", file=sys.stderr)
        return 2
    root = args.package_root.resolve()
    if not (root / "gnn_tracking_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the gnn_tracking_tpu_torch package is not in {root}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
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
        for line in ptxas_by_kernel(text):
            log(f"  ptxas[{name}]: {line}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {torch.cuda.get_device_name(0)} ({torch.cuda.device_count()} visible), torch {torch.__version__}, CUDA {torch.version.cuda}")
    if args.segment_sum_only:
        log(f"package: {root}")
        segment_sum_timings(args.seed)
        print(smi)
        return 0
    if args.relational_bwd_only:
        log(f"package: {root}")
        relational_bwd_timings(args.seed)
        print(smi)
        return 0
    if args.ec_bwd_only:
        log(f"package: {root}")
        ec_bwd_timings(args.seed)
        ec_bwd_widths(args.seed, this_tree=root == REPO)
        print(smi)
        return 0
    if args.ec_fwd_only:
        log(f"package: {root}")
        ec_fwd_timings(args.seed)
        if root == REPO:  # another tree's refusals are not this script's contract
            ec_fwd_widths(args.seed)
        print(smi)
        return 0

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

    if args.topk_only:
        log(f"package: {root}")
        topk_timings(args.seed, CondensedGraphTCN)
        print(smi)
        return 0
    if args.split_only:
        log(f"package: {root}")
        split_checks(args.seed)
        split_timings(args.seed)
        print(smi)
        return 0
    if args.band_only:
        log(f"package: {root}")
        band_timings(args.seed, args.band_digests, this_tree=root == REPO)
        print(smi)
        return 0
    if args.probe_only:
        from gnn_tracking_tpu_torch.ops import ivf_knn, knn

        log(f"package: {root}")
        probe_timings(args.seed)
        bench = torch.from_numpy(make_bench_latent(args.seed + 92, GC_HITS)[0]).to(dev)
        if hasattr(ivf_knn, "record_parts"):
            ivf_build_split(bench, GC_K)
        else:  # a tree from before the split: the whole build
            with torch.no_grad():
                ms = host_ms(lambda: knn.knn_graph_ivf(bench, GC_K), rounds=3)
            log(f"knn_graph_ivf at k = {GC_K} on the benchmark cloud: {ms:.2f} ms a build (median of 3)")
        print(smi)
        return 0
    if args.gather_only:
        log(f"package: {root}")
        gather_timings(args.seed)
        print(smi)
        return 0
    if args.digests is not None:
        log(f"package: {root}")
        bitwise_digests(args.seed, args.digests)
        print(smi)
        return 0
    if args.cc_only:
        log(f"package: {root}")
        model = CondensedGraphTCN(GraphTCN(**MODEL, device="cpu", generator=torch.Generator().manual_seed(
            args.seed))).to(dev).eval()
        ev = EventGraph.from_arrays(**make_event(args.seed + 10)).to(dev).sort_edges_by_target(with_unsort=True)
        with torch.no_grad():
            cc_checks(*core_table(model(ev)["H"].float().contiguous()), args.seed, this_tree=root == REPO)
        print(smi)
        return 0
    if args.wide_only:
        if root != REPO:
            p.error("--wide-only runs the tree beside this script only")
        wide_dim_checks(args.seed)
        resident_wide_checks(args.seed)
        width_checks(args.seed, WIDE_CHECKS, wide=True)
        wide_timings(args.seed)
        wide_ec_steps(args.seed)
        print(smi)
        return 0

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
            k_again = fused_relational.fused_relational_fwd(
                h_ec, e_ec, g0.edge_index, mask, weights, rowptr=rowptr, relu_edge=relu_edge)
            r_out = fused_relational.fused_relational_plain(
                h_ec.double(), e_ec.double(), g0.edge_index, mask,
                {k: v.double() for k, v in weights.items()}, relu_edge=relu_edge)
            torch.cuda.synchronize()
            for name, k_t, k2_t, p_t, r_t in zip(("e_tilde", "agg"), k_out, k_again, p_out, r_out):
                assert torch.equal(k_t, k2_t), f"fused_relational {name}: second launch differs"
                err = (k_t - p_t).abs().max().item()
                lim = 1e-4 * p_t.abs().max().item()
                assert err <= lim, f"fused_relational {name} relu_edge={relu_edge}: {err} > {lim}"
                err1 = max(err1, err)
                ek, ep = (k_t.double() - r_t).abs().max().item(), (p_t.double() - r_t).abs().max().item()
                assert ek <= 4 * ep, f"fused_relational {name}: err {ek:.3e} > 4 x plain f32 err {ep:.3e}"
                log(f"  fused_relational_fwd {name} relu_edge={relu_edge}: max|err| vs float64 kernel "
                    f"{ek:.3e}, plain f32 {ep:.3e}")
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
        assert_key_order(kd, ki, "pairwise_topk_filter (radius)")
        assert_key_order(kdn, kin, "pairwise_topk_filter (kNN)")
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
        results.append(cc_checks(*core_table(H), args.seed, this_tree=True))
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
        if r["name"] in train_launches and r["name"] not in launches:
            r["launches"] = train_launches[r["name"]]
            log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}), "
                f"{r['launches']} launches in {training['steps']} training steps")

    # ---- 6. Trainer.fit, then serve its checkpoint ---------------------------
    fit_and_serve(args.seed, tmp, CondensedGraphTCN)

    # ---- 7. metric-learning training ----------------------------------------
    _, ml_model = ml_training_path(args.seed, args.ml_steps, args.profile)

    # ---- 8. graph construction ---------------------------------------------
    gc_results, _, gc_launches = graph_construction_phase(args.seed, ml_model)
    row11_launches = gc_launches["pairwise_topk_streaming"]
    results += gc_results

    # ---- 9. bf16 EC training: kernels A-D, then the training path -------------
    ec_results, _ = ec_training_path(args.seed, args.ec_steps, args.profile, tmp)
    results += ec_results

    # ---- 10. metric-learning validation: rows #13 / #11, wide f32 rows #1 / #2 --
    val_results = validation_kernel_phases(args.seed)
    val_summary, row13_launches = ml_validation_path(args.seed, args.val_epochs, ml_model, tmp)
    # the wide layout's own path: EC steps at hidden width 256 (its counts set to 0 just before);
    # the kernel line's entries are wide_timings' f32 run, so they take the f32 step's launches
    wide_launches = wide_ec_steps(args.seed)["f32"]
    for r in val_results:
        r["launches"] = wide_launches.get(r["name"], row13_launches if r["name"] == "pairwise_topk"
                                          else row11_launches)
    results += val_results
    # C32 / D32: launches of the f32 EC step with fused_save_acts
    for r in results:
        if r["name"] in val_summary["ec_f32_saved_launches"]:
            r["launches"] = val_summary["ec_f32_saved_launches"][r["name"]]
    assert all("launches" in r for r in results), [r["name"] for r in results if "launches" not in r]

    # ---- 11. results ------------------------------------------------------
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
