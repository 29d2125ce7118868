#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py [--seed 0] [--events 32] [--train-steps 10] [--ml-steps 10]
                          [--ec-steps 10] [--val-epochs 75] [--profile]
    python3 chip_smoke.py --split-only [--package-root DIR]   # (or another *-only mode)
    python3 chip_smoke.py --band-only [--package-root DIR] [--band-digests FILE]
    python3 chip_smoke.py --variants-only   # phase 13 alone
    python3 chip_smoke.py --etl-only        # phase 14 alone
    python3 chip_smoke.py --drivers-only    # phase 15 alone
    python3 chip_smoke.py --analysis-only   # phase 16 alone
    python3 chip_smoke.py --parallel-only   # phase 18 alone
    python3 chip_smoke.py --fulldetector-only   # phase 19 alone

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
   and at widths whose backward tiles live in device memory, bf16 also where
   its tensor-core tiles do not fit (the CUDA-core kernels; ``width_checks``),
   and its edge cases (``wide_edge_checks``: a tail tile, one unmasked edge,
   none, H not a multiple of the weight chunk, each bf16 route),
   timed on 262,144 edges (``wide_timings``), and its own path: an
   ``ECModule`` step at hidden width 256 in f32 and bf16, gradients against
   the plain path, steps/s beside it (``wide_ec_steps``, whose launches,
   counted by route, the result line reports). (b) ``MLModule`` with phase 7's model and
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
11. ``examples/configs/tc.yml``'s recipe at its full widths through the
   port's CLI (``tc_cli_phase``): ``PerfectECGraphTCN(64, 64, 8, 128,
   L_hc 3)``, ``CondensationLossTiger(2048, 256)``,
   ``DBSCANHyperParamScanner(n_trials 12, keep_best 4)``, EMA 0.998 and
   the ``Compose`` of ``ZReflection`` / ``PhiRotation`` / ``HitDropout``;
   the config is a dict (``tc_cli_config``: the YAML file's tree with the
   data directories, ``max_epochs`` 2, ``log_dir`` and ``monitor`` =
   the scanner's guide figure of merit set; the card's machine has no
   PyYAML) handed to ``training.run.build_from_config`` and
   ``run_command``. 4 training and 2 validation events of 32,768 hits and
   262,144 edges (``make_tc_event``: tracks of ~16 hits, each hit linked to
   the next two of its track, ~23 % true edges). Step 0's gradients of the
   CLI's module through the kernels against the plain path
   (``compare_grads``); ``fit`` for 2 epochs (finite losses, steps/s and
   wall time); on every scanned validation event row #12 launches once and
   row #16 once per trial (counted at their launches), the scan's time split
   into radius graph, trials and metrics, and its labels bitwise equal to
   the same scan under ``plain_path()`` for every trial;
   ``checkpoint_best.pt`` restored by ``run_command("validate", ...,
   ckpt_path=...)`` (with the selected epoch's trials,
   ``DBSCANHyperParamScannerFixed``) gives the monitor value that ``fit``
   recorded; ``TrackingPredictor(checkpoint_best.pt).predict_dir(...,
   evaluate=True)`` over the validation events gives finite ``trk.*``
   values and labels equal to the plain path's;
12. stages chained through checkpoints (``pipeline_phase``) on 4 training
   and 32 serving point clouds of 32,768 hits / 2,048 particles
   (``make_point_cloud``, edge-less npz): (a) ``MLModule`` at ``ml.yml``'s
   widths, ``Trainer.fit`` for 1 epoch over 2 clouds, its epoch checkpoint
   restored bitwise by ``training.restore.get_model``; (b) the bake,
   ``DataTransformer(ml_graph_construction_from_chkpt(k 16, radius 1.0))``
   over the 4 clouds: row #13 once a cloud, each graph equal to the plain
   path's up to ties (``compare_neighbours``) and to the saved npz;
   (c) ``ec.yml``'s ``ECForGraphTCN`` on the baked graphs' 28 edge features,
   focal loss, bf16 (kernels A / B): step 0's gradients against the plain
   path's (5e-2 of each tensor's largest), a 1-epoch fit, a fresh module
   and trainer resuming it for 1 more (``fit(resume=True)``), held to an
   uninterrupted 2-epoch fit (equal step counts, parameters bitwise or
   within 1e-6 relative; both with the default shuffled training loader,
   whose second epoch the resumed fit must read); (d) ``TCModule`` around
   ``PreTrainedECGraphTCN(ec_from_chkpt(...), tc.yml's widths)`` with
   ``frozen_prefixes=("model/ec",)``: step 0's gradients against the plain
   path's (``compare_grads``, the EC's none), a 1-epoch fit, the EC bitwise
   unchanged and the TC's ``W`` within 1e-6 of the restored EC's; (e)
   ``inference.main --ml-chkpt --ml-neighbors 64 --ml-radius 1.0
   --evaluate`` over the serving clouds at ``--batch-size`` 1 and 2 (labels
   equal across batch sizes, and on the first 2 clouds to the plain path's;
   rows #12, #1, #9, #16 launched; events/s of each, over the 31 / 30
   clouds after the first batch); the briefly trained latent is one
   cluster an event, so the same model with a particle-structured latent
   (each hit at its particle's unit-normal 8-d centre plus 0.02 of ``H``)
   serves the first 2 clouds one by one and as one batch (``predict_batch``:
   DBSCAN's radius graph with ``batch`` ids, per-event renumbering) on the
   kernels and on the plain path: more than 1,024 clusters an event, the
   batch's labels equal to each event's and to the plain path's; then
   ``TrackingPredictor(precision="bf16")`` over the 32 clouds (kernel A
   launched, beta within 0.05 of f32's) and its forward on one transformed
   cloud against the plain path's (W, H and B each within 5e-2 of its
   largest magnitude, at the checkpoint's EC cut and at a cut that passes
   every edge to the condensation layers); warm events/s of f32 at batch 1 and 2 and of bf16, 3 passes
   over the 32 clouds in host memory, and the phase's wall time. Every
   kernel of ``PIPE_KERNELS`` must launch on the path;
13. the remaining losses and models on the kernels they run
   (``variants_phase``), all f32: (a) ``CondensationLossRG(max_num_neighbors
   256, max_n_objects 2048)`` under ``TCModule`` on phase 5's GraphTCN and
   event (the EC cut calibrated as there): step 0's loss and gradients
   against the plain path's (``compare_grads``), then ``VAR_STEPS`` timed
   steps with their split and the loss's radius graph (row #12, once a
   step) timed alone; (b) the residual variants, each from the same weights
   on both paths with step 0's outputs within 1e-4 of their largest
   magnitude, the loss within 1e-5 and the gradients by ``compare_grads``:
   ``PerfectECGraphTCN(tc.yml's widths, L_hc 4, skip2)`` with and without
   ``compat_overlap``, ``ECForGraphTCN(ec.yml's widths, skip_top)`` and
   ``ModularGraphTCN(hc_in=ResIN(64, 64, 128, 4 layers, skip2, add_bn))``,
   which then takes 2 optimizer steps on each path (the plain path from
   the kernels' weights before each): its running averages within 1e-4 of
   the plain path's (each tensor's largest magnitude), and
   its eval-mode outputs on the kernels' weights within 1e-4 of the plain
   path's; its step-0 gradients are held to a float64 evaluation
   (``compare_grads_f64``); (c)
   ``PointCloudTCN`` at the JAX defaults (h 10, e 10, out 5, hidden 100, 3 +
   1 blocks of 3 layers) on a 32,768-hit point cloud of 2,048 particles
   (``make_point_cloud``) under ``TCModule`` with the Tiger loss: step 0
   against the plain path on the kernels' neighbour choice (``TopkReplay``,
   which holds each row #13 call against its plain version), the gradients
   of both held to a float64 evaluation (``compare_grads_f64``: the random
   model's latent is collapsed, and most of the loss's gradients are
   rounding in f32 on either path), and so are the gradients of a fixed
   random projection of ``H`` and ``B``; ``VAR_STEPS`` timed steps (row #13 four times a
   step), then ``TrackingPredictor`` and DBSCAN (rows #12 / #16) on its
   trained ``H`` (``EPS``, ``CAP``), labels equal to those of the plain
   path's DBSCAN on the same ``H``, and again on a particle-structured
   latent (each hit at its particle's unit-normal centre plus 0.02 of
   ``H``: more than 1,024 clusters); (d) ``MLGraphConstruction`` with
   ``GraphConstructionHeteroEncResFCNN`` at ``ml.yml``'s widths (pixel and
   strip towers, ``hetero_layers``) and ``EFMLP(14, 28, hidden 128, depth
   3)`` cutting at a gap near the median score, at k = 64 on a 32,768-hit
   cloud: the kNN graph equal to the plain path's up to ties
   (``compare_neighbours``) and the filter's cut equal on every other row;
   ``GraphConstructionResIN(hidden 40, 2 layers)`` over that graph within
   1e-4 of the plain path's; ``VAR_ML_STEPS`` ``MLModule`` steps of the
   hetero embedding with the hinge loss (row #12 at k = 256) after step 0's
   gradients against the plain path. Rows #1, #2, #9, #10, #12, #13 and #16
   must launch on the phase's path;
14. the offline ETL at a full TrackML event's size (``etl_phase``):
   **etl-trackml-110k**, ``ETL_COPIES`` copies of the vendored event made
   into one (``make_pileup``: each copy rotated in phi by a seeded angle,
   hit ids offset, particle ids offset past 2^53), ~110k hits; (a)
   ``preprocessing.build_point_clouds.main`` over it and over the vendored
   event at 1 and 32 sectors (``--pixel-only --add-true-edges``), wall time
   a file and hits a sector; (b) ``graph_construction.build_graphs.main
   --device cuda`` over the four point-cloud directories (``edge_join``,
   ``csrc/edge_join.cu``, counted at its launches), then the kernel against
   its plain version on the card on every point cloud, with the defaults
   and with ``remove_intersecting=False, edge_augmentation="add_two_hop"``:
   edges, order, ``y`` and float64 attributes bitwise; the kernel timed on
   the full event at 1 sector (CUDA events, median of 5 rounds of 5, and
   its kernels on the device) beside the plain version and the bound (its
   FP64 operations on this input's work, ``EDGE_JOIN_OPS``, or its bytes);
   (c) ``tc.yml``'s recipe through ``run_command("fit", ...)`` for 2 steps
   on the 32-sector graphs of the full event, then ``predict_dir`` of its
   ``checkpoint_best.pt`` over the 32 (labels equal to the plain path's);
   rows #1, #2, #9, #10, #12 and #16 must launch on that path;
15. the real-data training drivers on a copy of the vendored TrackML event
   (``drivers_phase``): ``scripts.train_multievent.main`` with the accuracy
   drill's split (22 variants: 16 train, 2 selection, 4 report) at 2 EC and
   3 TC epochs with the cosine chain (clip by global norm, then Adam), and
   ``scripts.train_trackml.main`` with 4 sectors (1 test, 1 selection),
   stages A, B and C at 2 epochs each, both on the card (``build_data``'s
   join included), each stage's wall time logged; their figures finite and
   in range; then rows #1 / #2 at the drivers' widths (``DRIVER_WIDTHS``:
   K = 48, H = 48, Fo = 16 and K = 96, H = 64, Fo = 32) on a variant's edge
   count against their plain versions (``width_checks``), step 0 of both
   recipes' models on a variant with their gradients through the kernels
   against the plain path's (``compare_grads``; the TC's held to a float64
   evaluation beside the plain path's, ``compare_grads_f64``: its loss is
   translation invariant in the latent, so a bias gradient is exactly zero
   and rounding on both paths), and the TC model with trained weights
   (``DRIVER_TRAINED``, a selected model of the drill) scanned on the
   selection variants (double majority above 0.5) and served on a report
   variant (more than one cluster): its latent within 1e-4 of the plain
   path's, DBSCAN on the kernels' latent equal to the plain path's and to
   the served labels (at the latent's norm, ~1e4, the two paths' rounding
   exceeds eps, so DBSCAN is held on one latent).
   Rows #1, #2, #9, #10,
   #12, #13, #16 and ``edge_join`` must launch in the two ``main`` runs;
16. the analysis and metrics layer (``analysis_phase``): (a) on
   etl-trackml-110k at 1 sector (phase 14's point cloud, or made again),
   ``get_all_graph_construction_stats`` and ``collect_all_ec_stats`` at
   ``ANALYSIS_THRESHOLDS`` with the drivers' ``ECForGraphTCN`` (32 / 32,
   hidden 64, L_ec 4) after ``ANALYSIS_EC_EPOCHS`` epochs of
   ``train_multievent``'s stage-A recipe on the drill's training variants
   (W within 1e-4 of its largest magnitude of the plain path's; ROC AUC on
   the event above 0.8, the study's best MCC above 0.5), the track records
   at the cut 0.5, and the track
   records with ``ANALYSIS_TRUE_EDGE_DROP`` of the true edges cut (at
   least 200 breadth-first searches), each timed on the card (with the
   connected components' sweep counts) and equal to the CPU port's on the
   same graph and the card's W (integers equal, floats within 1e-12); (b)
   the drill's selected TC weights (``DRIVER_TRAINED``) on the 4 report
   variants at the (eps, min_samples) their scan of the selection variants
   picks: ``DBSCANPerformanceDetails``, ``tracking_metrics_vs_pt`` /
   ``_vs_eta`` and every ``common_metrics`` entry, equal to the CPU port's
   on the kernels' latent; (c) ``MLModule`` with
   ``OldGraphConstructionHingeEmbeddingLoss`` (row #12 at k = 256) on
   phase 7's 32,768-hit cloud and model: step 0's gradients against the
   plain path (``compare_grads``), then ``ANALYSIS_ML_STEPS`` timed steps
   after ``ML_WARMUP``. Rows #1, #9, #10, #12 and #16 must launch on the
   phase's path;
17. the single-device remainder (``remainder_phase``): (a) ``knn_graph_ivf``
   at k = 8 on phase 8's benchmark cloud and on its spatial cloud (the
   hits' coordinates of the 262,144-hit point cloud: near-uniform in 3-d;
   the IVF cannot certify a uniform 8-d cloud; its builds probe
   ``REMAINDER_SPATIAL``'s 32 cells, after one build at the default widths,
   which ``spill_passes=False`` at those widths is also held against)
   under the default and each of ``REMAINDER_IVF_OPTIONS``
   (``probe_impl="xla"``, ``bucket_impl="scatter"``, ``spill_passes``
   False / ``"probe"`` / ``"extra"``, ``fast_assign=False``; the port runs
   the default's build for the TPU hints ``bucket_impl`` and
   ``fast_assign``): every graph certified and equal to the
   default's (up to tie rows, ``compare_neighbours``), row #15 launched by
   every option but ``"xla"``, each build's ms (median of 3) with its
   ``ivf_knn.record_parts`` split; (b) on the drill's variants of the
   vendored event, the drill's TC module (``train_trackml.tc_module``): a
   real CUDA out-of-memory error forced inside a step guarded by
   ``utils.oom.tolerate_some_oom_errors`` (an allocation of twice the
   card's memory, after the loss and after Adam's update): the step returns None
   and leaves the weights, Adam's state, the update count, the step and the
   generator bitwise as they were; the next step runs; the third forced
   OOM in a row raises; then the cost of ``TrackingModule``'s undo copy
   (``_all_or_nothing``): ``REMAINDER_GUARD_PAIRS`` pairs of the same step
   with and without it, in the order with, without, without, with, and the
   copy's host time alone; (c) a 2-epoch ``Trainer.fit`` of that TC (16
   variants an epoch, the drill's transform and EMA, the DBSCAN scanner on
   the 2 selection variants) with a ``log_dir``: ``metrics.jsonl`` holds
   two lines, ``run_meta.json`` names the card; ``utils.profiling.device_trace``
   around ``REMAINDER_TRACE_STEPS`` of its steps writes a trace that names
   rows #1, #9 and #10 (``REMAINDER_TRACE_NAMES``), and the device's busy
   share of those steps comes from it (``trace_busy_share``); (d) the plot
   modules import (the card's machine has no matplotlib). The kernels of
   ``REMAINDER_KERNELS`` must launch on the phase's path;
18. the parallel package as ranks on this card (``parallel_phase``; ranks
   are processes sharing the one card over gloo, started by
   ``parallel.multihost.spawn`` with a ``FileStore`` in a temporary
   directory, the kernels built once before): first a probe, two gloo ranks
   calling each collective by hand on CUDA tensors (which gloo accepts, and
   which abort a rank: point-to-point does, so the ring fetch stages its
   buffers through pinned host memory, ``parallel.mesh.GLOO_CUDA_OPS``);
   then etl-trackml-110k's 1-sector graph (phase 14's point cloud where it
   ran; 55,660 hits, 6.09M edges) partitioned into 2 phi-sorted shards
   (``sort_edges``) and the references, the fast path on this card (one
   rank, no exchange, no collectives, the same kernels) from each step's
   starting weights and Adam state. (a) ``ShardedTCTrainer`` with
   ``tc.yml``'s ``PerfectECGraphTCN(64, 64, 8, 128, L_hc 3)``,
   ``max_n_objects`` 2048 and a subsample seed, in 2 ranks, with the
   ``a2a``, ``all_gather`` and ``ring`` fetches (ring distance 1 asserted)
   and the halo-split layout (``halo_edges_last``, a2a): the forward's H / B
   unpartitioned, 3 steps' losses, gradients and weights
   (``_check_steps``; rtol 1e-5 / 2e-5), each step and the exchange alone
   timed per rank with its halo rows, bytes and transport, one more step
   traced by ``torch.profiler`` in rank 0 (rows #1, #2, #9, #10 by kernel
   name); (b) ``ShardedGraphTCNTrainer`` with ``GraphTCN(64, 64, 8, 128,
   L_ec 6, L_hc 3)`` (an EC cut that no rounding moves an edge across,
   ``parallel_threshold``): W / H / B, the cut, one step; (c) ``DPTrainer``'s
   step over 2 ranks, each one training-graphtcn-32k event, against the
   single-process step on both; (d) ``DataGraphTCNTrainer`` over 2 x 2 = 4
   ranks (the event and its phi rotation, 2 shards each; the EC cut to 2
   layers so that four ranks fit the card) against the per-event average;
   (e) (a)'s sharded step through an NCCL group of world size 1. Rows #1,
   #2, #9 and #10 must launch in every rank; the phase's wall time and its
   parts are logged;
19. the full-detector training driver (``fulldetector_phase``;
   ``scripts/train_fulldetector.py``, JAX's BASELINE config 5): the
   driver's synthetic event (seed 0: 16,384 tracks x 16 hits + 2 % noise =
   267,386 hits, 2,139,088 edges) partitioned as the driver partitions it.
   (a) One rank, the fast path: rows #1-#4, #9 and #10 at the event's
   shapes against their plain versions (``fd_kernel_checks``), timed; step
   0 of the driver's ``GraphTCN(32, 32, 8, 128, L_ec 6, L_hc 3)`` (an EC
   cut that no rounding moves an edge across, ``parallel_threshold``)
   through the kernels against the plain path in f32 (1e-4) and bf16 (5e-2
   of each tensor's largest magnitude), a tensor that misses the gate held
   against a float64 evaluation (``fd_compare``, ``segment_plain``), and
   with ``remat`` against the f32 gradients (rtol 1e-5 / atol 1e-7; row #1
   launched twice a layer); then the driver's ``main`` at its defaults on
   one event, ``FD_STEPS`` steps each in f32, bf16 and with ``--remat``
   (finite losses; each step timed, the median of steps 1 on; peak memory
   from the driver's summary) and the step's forward / loss / backward /
   Adam split (``fd_split``); (b) the 2 x 2 mesh in four gloo ranks sharing
   the card (``fulldetector_rank``, the driver's ``build_trainer``), events
   0 and 1 in 2 shards each, ``FD_GRID_STEPS`` steps held step by step to
   the fast path on both events (phase 18's ``_reference`` /
   ``_check_steps``), then the driver's ``main`` on that mesh (its own four
   ranks; finite losses, its step time); (c) ``demo_pipeline --epochs 1`` on the vendored
   event, ``demo_sharded`` in 2 ranks sharing the card (its own bar: a
   double majority above 0.7) and ``mlb_scan --quick``. Every kernel of
   ``FD_KERNELS`` (and the demos' rows #12, #13, #16) must launch;
20. a JSON line of per-kernel results (rows #1, #2, #9, #10, #12 and #16
   also with ``cli_launches``, their launches in phase 11's ``fit``; the
   kernels of phase 12's path with ``pipeline_launches``, of phase
   13's with ``variants_launches``, of phase 14's served path with
   ``etl_launches``, of phase 15's with ``drivers_launches``, of phase
   16's with ``analysis_launches``, of phase 17's with
   ``remainder_launches``, of phase 18's ranks with
   ``parallel_launches`` and of phase 19 with ``fulldetector_launches``;
   ``edge_join``'s ``launches`` are phase 14's ``build_graphs`` calls), the
   ``nvidia-smi`` name/power line, and last the device JSON line.

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
FILE where another tree's run wrote it, and stops. ``--tc-cli-only`` builds, runs ``tc_cli_phase`` (phase 11) and stops;
``--pipeline-only`` builds, runs ``pipeline_phase`` (phase 12) and stops;
``--variants-only`` builds, runs ``variants_phase`` (phase 13) and stops;
``--etl-only`` builds, runs ``etl_phase`` (phase 14) and stops; ``--drivers-only``
builds, runs ``drivers_phase`` (phase 15) and stops; ``--analysis-only`` builds,
runs ``analysis_phase`` (phase 16) and stops; ``--remainder-only`` builds,
runs ``remainder_phase`` (phase 17) and stops; ``--parallel-only`` builds, runs
``parallel_phase`` (phase 18) and stops; ``--fulldetector-only`` builds, runs
``fulldetector_phase`` (phase 19) and stops. ``--wide-only``
builds, runs (for the tree beside this script) ``wide_dim_checks``,
``resident_wide_checks``, ``width_checks`` at ``WIDE_CHECKS`` and
``wide_edge_checks``, then (for either tree) ``wide_timings`` (the call,
and its kernels apart on the device), with ``--wide-phases``
``wide_phases`` (the edge kernels' cycles by phase, from a
``-DWIDE_PHASES`` build of that tree) and ``wide_ec_steps`` (with steps/s
beside the plain path), and stops. With ``--package-root DIR`` each runs the package in DIR (an
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
import shutil
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
    "fused_relational_wide_tc_fwd": "gnn_tracking_tpu/ops/pallas/fused_relational.py:721, "
    "gnn_tracking_tpu/ops/pallas/fused_relational_t.py:308 and :610 (bf16), beyond shared memory",
    "fused_relational_wide_tc_bwd": "gnn_tracking_tpu/ops/pallas/fused_relational.py:781, "
    "gnn_tracking_tpu/ops/pallas/fused_relational_t.py:377 and :680 (bf16), beyond shared memory",
    "edge_join": "csrc/edge_join.cpp:49 (the JAX package's host-native layer-pair join; no pallas_call)",
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
    **{f"fused_relational_wide_{k}": "gnn_tracking_tpu_torch/csrc/fused_relational_wide.cu"
       for k in ("fwd", "bwd", "tc_fwd", "tc_bwd")},
    "edge_join": "gnn_tracking_tpu_torch/csrc/edge_join.cu",
}
# metric-learning validation (examples/configs/ml.yml's gc_scanner)
VAL_KS = list(range(1, 9))
# k at which phase 10 (a) holds row #13 against its plain version and times it beside row #12
# (1-8: the scanner's; 256: the hinge loss's cap, which GNN_TRACKING_RADIUS_IMPL=topk sends
# through knn_graph; above 32, row #12's kernel serves row #13)
SPLIT_SWEEP_KS = (1, 2, 4, 8, 16, 32, 64, 256)


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


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


class TopkReplay:
    """The resident top-k calls of ``ops/knn.py`` (rows #13 and #12) made on
    the kernels' path, recorded, then replayed on the plain path, so that a
    step-0 comparison holds both paths to one neighbour choice: where the
    latent has equal distances (dead ReLUs give many hits one point), the
    kernel and its plain version may keep different tied neighbours, which
    is not an error of either but changes the gradients. :meth:`check`
    holds every recorded call against its plain version on the same input
    (``compare_topk``)."""

    NAMES = ("pairwise_topk", "pairwise_topk_filter")

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def _patched(self, make):
        from gnn_tracking_tpu_torch.ops import knn

        saved = {n: getattr(knn, n) for n in self.NAMES}
        for n, fn in saved.items():
            setattr(knn, n, make(n, fn))
        try:
            yield
        finally:
            for n, fn in saved.items():
                setattr(knn, n, fn)

    def record(self):
        def make(name, fn):
            def recorded(x, **kw):
                out = fn(x, **kw)
                self.calls.append((name, x.detach().clone(), dict(kw), out))
                return out
            return recorded

        return self._patched(make)

    def replay(self):
        calls = iter(list(self.calls))

        def make(name, _):
            def replayed(x, **kw):
                n, x0, kw0, out = next(calls)
                assert n == name and x.shape == x0.shape and kw.keys() == kw0.keys(), (name, n)
                return out
            return replayed

        return self._patched(make)

    def check(self) -> dict:
        """Each recorded call against its plain version: the largest squared
        distance error, and the boundary and tie rows (``compare_topk``)."""
        from gnn_tracking_tpu_torch.ops.pairwise_topk import pairwise_topk_filter_plain, pairwise_topk_plain

        err, n_boundary, n_tie = 0.0, 0, 0
        for name, x, kw, (kd, ki) in self.calls:
            plain = pairwise_topk_plain if name == "pairwise_topk" else pairwise_topk_filter_plain
            pd, pi = plain(x, **kw)
            e, b, t = compare_topk(kd, ki, pd, pi, kw.get("radius2"))
            err, n_boundary, n_tie = max(err, e), n_boundary + b, n_tie + t
        return {"calls": len(self.calls), "max_abs_err": err, "boundary_rows": n_boundary, "tie_rows": n_tie}


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


def compare_grads_f64(gk: dict, gp: dict, g64: dict):
    """Step-0 parameter gradients through the kernels (``gk``) and the plain
    path (``gp``), both f32, against a float64 evaluation (``g64``): per
    tensor, |g_kernel - g64| <= max(4 |g_plain - g64|, 1e-3 |g64|) plus a
    floor of 1e-7 of the whole gradient's norm: the kernels are no further
    from the exact gradient than a few times the plain f32 path. For models
    whose f32 rounding the gradients amplify: a batch norm's backward makes
    its cotangents zero-mean over the rows, so a weight gradient's sum over
    the edges cancels, and the kernels' fixed-order sum (tiles in edge
    order) then carries several times the error of cuBLAS's reduction tree
    (5x on ``VAR_BN_RESIN``'s layer 1 on an H100); a collapsed random
    latent makes the condensation loss's distances (the expansion
    ``|x|^2 + |y|^2 - 2 x.y``) cancel. Returns the worst tensor by
    |g_kernel - g64| / |g64| among those the plain path computes within
    1e-3 of ``g64`` (the others are ill-conditioned in f32: both paths'
    gradients are rounding there), that ratio, the ill-conditioned
    tensors, and the parameters without a gradient."""
    no_grad = [n for n in g64 if g64[n] is None]
    total = math.sqrt(sum(g64[n].square().sum().item() for n in g64 if g64[n] is not None))
    worst_name, worst, ill = None, 0.0, []
    for name in gk:
        if g64[name] is None:
            assert gk[name] is None and gp[name] is None, f"{name}: a gradient on one path only"
            continue
        ek = (gk[name] - g64[name]).norm().item()
        ep = (gp[name] - g64[name]).norm().item()
        ref = g64[name].norm().item()
        lim = max(4 * ep, 1e-3 * ref)
        assert ek <= lim + 1e-7 * total, (
            f"{name}: |g_kernel - g64| {ek:.3e} > max(4 x |g_plain - g64| {ep:.3e}, 1e-3 x {ref:.3e}) "
            f"+ 1e-7 x {total:.3e}")
        if ep > 1e-3 * ref:
            ill.append(f"{name} ({ek / max(ref, 1e-30):.1e} / {ep / max(ref, 1e-30):.1e} of {ref:.1e})")
        elif ek / ref >= worst:
            worst_name, worst = name, ek / ref
    return worst_name, worst, ill, no_grad


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


def cc_calls(fn, *, reps: int = 5, traces: int = 4) -> dict:
    """``torch.profiler`` over ``reps`` calls of ``fn``: the kernels it launches
    on the device and the copies between device and host, per call. A trace
    can lose device records (one came back with 4 kernel records for 5 calls
    that each launch one), never add them, so each count is the largest of
    ``traces`` traces."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    kernels = copies = 0
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        gpu = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        n_copies = sum("Memcpy" in e.name or "memcpy" in e.name for e in gpu)
        kernels, copies = max(kernels, len(gpu) - n_copies), max(copies, n_copies)
    assert kernels, f"profiler: no device records in {traces} traces of {reps} calls"
    return {"kernels_per_call": kernels / reps, "copies_per_call": copies / reps}


def cc_checks(idx, mask, seed: int, this_tree: bool) -> dict:
    """Row #16 (``cc_neighbors``) on phase 3's table (event 0's core-core
    radius graph, ``idx``, ``mask``) and on ``cc_tables``: labels bitwise the
    plain version's, sweeps; an unmasked index outside [0, N) raises
    ``ValueError``; the call (``cuda_ms``), its kernels on the device
    (``device_split``), the kernels launched and the copies a call
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
            row["device_ms"] = device_split(lambda: cc_kernel.cc_neighbors(ti, tm), names, reps=5)["any"]
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


def device_split(fn, names, *, reps: int = 3, tries: int = 4) -> dict:
    """``torch.profiler`` over ``reps`` calls of ``fn`` (after one warm-up):
    the device time a call of the kernels whose names hold each of
    ``names`` (a name no kernel holds has no entry), of those that hold any
    of them (``"any"``, asserted to exist) and of every kernel of the call
    (``"all"``). A trace can come back without device records, or without
    those of ``names`` (records are lost, never added): up to ``tries``
    traces, until one holds a kernel of ``names``."""
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
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        mine = [e for e in events if any(n in e.name for n in names)]
        if mine:
            break
    assert events, f"profiler: no device records in {reps} calls"
    assert mine, f"profiler: no launch of {names} in {reps} calls, {tries} traces"
    ms = lambda evs: sum(e.time_range.end - e.time_range.start for e in evs) / reps / 1e3
    out = {n: ms([e for e in events if n in e.name]) for n in names if any(n in e.name for e in events)}
    out["any"], out["all"] = ms(mine), ms(events)
    return out


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
    GraphTCN's, ``ec.yml``'s, odd ones), the wide layout's f32 per-edge
    outputs at ``WIDE_WIDTHS`` (with and without the save flag and the saved
    rows; not its weight gradients), each output of a second launch equal
    to the first's."""
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
    # the wide layout at WIDE_WIDTHS in f32 (rows #1 / #2 and C32 / D32 take it there): the per-edge
    # outputs e_tilde, agg, the saved rows, g_x, g_edge_attr and the per-edge g_xd / g_xs that the
    # backward hands to row #9's sums (recorded at fr.segment_sum_csr). The weight gradients are
    # left out: their summation order is the kernel's plan (products over slices of edges, then
    # the slices in order), not part of the contract.
    fx, fe, h, fo = WIDE_WIDTHS
    g, (xe, ea, ei, em, w, g_e, g_a) = ec_width_case(seed + 187, fx, fe, h, fo, 16000, 0.8)
    xe, ea, g_e, g_a = (t.float() for t in (xe, ea, g_e, g_a))
    w = {k: v.float() for k, v in w.items()}
    csr, args = g.csr(), (xe, ea, ei, em, w)
    inputs = (xe, ea, ei, em, *w.values(), g_e, g_a)
    src, dst = ei.long()
    gd, gs = xe[dst].contiguous(), xe[src].contiguous()
    name = "wide_f32_" + "_".join(map(str, WIDE_WIDTHS))
    record(f"{name}_fwd", inputs, lambda: fr.fused_relational_fwd(*args, rowptr=csr["dst_rowptr"], relu_edge=True))
    record(f"{name}_fwd_save", inputs,
           lambda: fr.fused_relational_fwd_save(*args, rowptr=csr["dst_rowptr"], relu_edge=True))

    def with_edge_rows(bwd):
        calls, undo = capture(fr, "segment_sum_csr")
        try:
            g_x, g_ea, _ = bwd()
        finally:
            undo()
        return (g_x, g_ea, *(a[0] for a, _ in calls))  # g_xd, g_xs

    record(f"{name}_bwd", inputs, lambda: with_edge_rows(
        lambda: fr.fused_relational_bwd(*args, g_e, g_a, csr, relu_edge=True)))
    record(f"{name}_bwd_saved", inputs, lambda: with_edge_rows(lambda: fr.fused_relational_bwd_saved(
        gd, gs, *args[1:], g_e, g_a, csr, g.num_nodes, relu_edge=True)))
    from gnn_tracking_tpu_torch.ops import csr_segment, ivf_probe

    for name, args, kw in probe_inputs(seed):
        record(f"row15_{name}", args, lambda: ivf_probe.ivf_probe(*args, **kw))
    for name, v, idx in gather_inputs(seed):
        record(f"row10_{name}", (v, idx), lambda: csr_segment.gather_rows(v, idx))
    compare_digests("rows #11-#13 (d <= 32), rows #1 / #2, C32 / D32, A-D (resident widths), the wide "
                    "layout's per-edge outputs (f32), row #15 and row #10", sums, path)



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
# (route, widths, edges): the wide layout in both dtypes; bf16 where its tensor-core tiles exceed
# shared memory (the CUDA-core kernels, tiles in shared memory); and widths whose tiles exceed
# shared memory even at 32 edges a tile (in device memory; bf16 padded to (32, 32, 2432, 32))
WIDE_CHECKS = {"wide bf16": ("bf16", WIDE_WIDTHS, 16000), "wide f32": ("f32", WIDE_WIDTHS, 16000),
               "wide bf16 (CUDA cores)": ("bf16", (64, 64, 512, 64), 16000),
               "wide f32 (backward tiles in device memory)": ("f32", (8, 8, 2432, 8), 600),
               "wide bf16 (CUDA cores, tiles in device memory)": ("bf16", (8, 8, 2432, 8), 600)}
# the wide layout's edge cases, through fused_relational_wide_fwd / _bwd (which take any width):
# (route, widths, edges, unmasked: a share, or an exact count where an int)
WIDE_EDGE_CASES = {
    "tail tile": ("f32", WIDE_WIDTHS, 1000, 0.8),  # an unmasked count not a multiple of the tile
    "one unmasked edge": ("f32", WIDE_WIDTHS, 500, 1),
    "all masked": ("f32", WIDE_WIDTHS, 500, 0),
    "H 52, K 31": ("f32", (14, 3, 52, 20), 3000, 0.8),  # H not a multiple of the weight chunk (32)
    "bf16 tail tile": ("bf16", WIDE_WIDTHS, 1000, 0.8),
    "bf16 H 96": ("bf16", (32, 32, 96, 32), 3000, 0.8),
    "bf16 H 52, K 31": ("bf16", (14, 3, 52, 20), 3000, 0.8),  # padded to (32, 32, 64, 32) by the wrapper
    "bf16 CUDA cores, tail tile": ("bf16", (64, 64, 512, 64), 1000, 0.8),
    "bf16 CUDA cores, tiles in device memory": ("bf16", (32, 32, 2432, 32), 600, 0.8),
}
# the checks above that take the bf16 tensor-core route; every other one takes the CUDA cores (bf16
# there only where its tensor-core tiles do not fit: the wrappers pad bf16 widths to multiples of 32)
WIDE_TC_CASES = {"wide bf16", "bf16 tail tile", "bf16 H 96", "bf16 H 52, K 31"}
# the wide layout's kernels, timed apart on the device (a tree without one has no entry)
WIDE_KERNELS = ("wide_fwd_kernel", "wide_bwd_kernel", "wgrad_kernel", "tc_fwd_kernel", "tc_bwd_kernel",
                "wgrad_tc_kernel", "masked_rows_kernel", "sum_partials_kernel")


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


def ivf_build_split(x, k: int, rounds: int = 3, *, warmup: bool = True, what: str = "",
                    **ivf_kwargs) -> tuple[dict, tuple]:
    """``knn_graph_ivf(x, k, **ivf_kwargs)`` in the parts ``ivf_knn.record_parts`` records
    for each attempt (``ivf_knn.PARTS``: the coarse quantization, the
    bucketing, the probe launch (row #15), the extra pass, the spill probe,
    the rerank, the certification, the fallback), each between two
    synchronisations, and the rest (the graph's edges, the retry loop);
    medians of ``rounds`` builds (after one warm-up with ``warmup``), and the
    attempts. Also returns the last build's graph."""
    import torch

    from gnn_tracking_tpu_torch.ops import ivf_knn, knn

    runs = []
    with ivf_knn.record_parts() as parts, torch.no_grad():
        for _ in range(rounds + int(warmup)):
            first = len(parts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph = knn.knn_graph_ivf(x, k, **ivf_kwargs)
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
            attempts = parts[first:]
            runs.append({"total_ms": total, "attempts": len(attempts),
                         **{q: sum(a[q] for a in attempts) for q in ivf_knn.PARTS}})
    runs = runs[int(warmup):]
    for r in runs:
        r["rest_ms"] = r["total_ms"] - sum(r[q] for q in ivf_knn.PARTS)
    out = {key: statistics.median(r[key] for r in runs) for key in ("total_ms", *ivf_knn.PARTS, "rest_ms")}
    out["attempts"] = runs[0]["attempts"]
    log(f"IVF build split{what} (medians of {rounds}, synchronised parts): {json.dumps(out)}")
    return out, graph


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
    ivf_split, _ = ivf_build_split(bench, GC_K)
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
    resident kernels', on the bf16 tensor cores for the checks in
    ``WIDE_TC_CASES`` and on the CUDA cores for every other."""
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
        tc_before = [fn.tc_launches for fn in wide_fns]
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
            tc = [fn.tc_launches - n0 for fn, n0 in zip(wide_fns, tc_before)]
            want = launched[4:] if name in WIDE_TC_CASES else [0, 0]
            assert tc == want, f"{name}: tensor-core launches {tc}, want {want}"
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
            f"{'the wide layout' if wide else 'the resident kernels'} (launches {launched}"
            f"{', tensor cores' if wide and name in WIDE_TC_CASES else ', CUDA cores' if wide else ''}), forward, "
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
    in f32, the bf16 tensor-core peak in bf16), each checked against the
    plain version as ``width_checks`` does, and on the device by kernel
    (``device_split``: the edge kernels, the weight-gradient products
    ``wgrad_kernel`` / ``wgrad_tc_kernel``, the masked rows and the slices'
    sum apart). Returns the kernel line's entries: the f32 pair and, where
    the bf16 calls took the tensor cores (their wrappers' ``tc_launches``),
    the bf16 pair (``*_tc_*``)."""
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
            wide_fns = (fr.fused_relational_wide_fwd, fr.fused_relational_wide_bwd)
            tc0 = [getattr(fn, "tc_launches", 0) for fn in wide_fns]  # a tree without the route: 0
            kf = fr.fused_relational_wide_fwd(*fargs, rowptr=csr["dst_rowptr"])
            kb = fr.fused_relational_wide_bwd(x, None, None, ea, ei, mask, w, g_e, g_a, csr, g.num_nodes)
            tc = [getattr(fn, "tc_launches", 0) - n0 for fn, n0 in zip(wide_fns, tc0)]
            assert tc[0] == tc[1] and (route == "bf16" or not tc[0]), f"wide {route}: tensor-core launches {tc}"
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
                # on the device, by kernel: the edge kernels and the weight gradients apart
                "fwd_device_ms": device_split(lambda: fr.fused_relational_wide_fwd(
                    *fargs, rowptr=csr["dst_rowptr"]), WIDE_KERNELS),
                "bwd_device_ms": device_split(lambda: fr.fused_relational_wide_bwd(
                    x, None, None, ea, ei, mask, w, g_e, g_a, csr, g.num_nodes), WIDE_KERNELS),
            }
            row["fwd_bound_ms"], row["fwd_bound_by"] = bound(
                2.0 * n_valid * (k * h + h * h + h * fo), nbytes(x, ea, ei, mask, *w.values(), kf[0], kf[1]), peak=peak)
            row["bwd_bound_ms"], row["bwd_bound_by"] = bound(
                2.0 * n_valid * (3 * k * h + 3 * h * h + 2 * h * fo),
                nbytes(x, ea, ei, mask, *w.values(), g_e, g_a, kb[0], kb[1]) + 4 * sum(t.numel() for t in kb[2].values()),
                peak=peak)
            row["tensor_cores"] = bool(tc[0])
            out[route] = row
            if route == "f32" or tc[0]:
                name = "fused_relational_wide_tc" if tc[0] else "fused_relational_wide"
                entries += [
                    {"name": f"{name}_fwd", "max_abs_err": max(abs_errs[:2]), "ms": row["fwd_ms"],
                     "plain_ms": row["fwd_plain_ms"], "bound_ms": row["fwd_bound_ms"],
                     "bound_by": row["fwd_bound_by"], "library_ms": None},
                    {"name": f"{name}_bwd", "max_abs_err": max(abs_errs[2:]), "ms": row["bwd_ms"],
                     "plain_ms": row["bwd_plain_ms"], "bound_ms": row["bwd_bound_ms"],
                     "bound_by": row["bwd_bound_by"], "library_ms": None},
                ]
    log(f"wide layout at (Fx, Fe, H, Fo) = {WIDE_WIDTHS}, {N_EDGES} edges, 80 % unmasked: OK against the plain "
        "version; wide timings: " + json.dumps(out))
    return entries


# the phases the wide kernels count in a -DWIDE_PHASES build (their counters' first index)
WIDE_PHASES = {
    "wide_fwd_kernel": (0, ("gather", "m W1^T", "h1 W2^T", "h2 W3^T")),
    "wide_bwd_kernel": (4, ("gather", "recompute h1", "recompute h2", "g_h2", "g_h1", "g_m")),
    "tc_fwd_kernel": (10, ("gather", "m W1^T", "h1 W2^T", "h2 W3^T")),
    "tc_bwd_kernel": (14, ("gather", "recompute h1", "recompute h2", "g_h2", "g_h1", "g_m")),
}


def wide_phases(seed: int) -> dict:
    """Where the wide edge kernels' time goes: ``csrc/fused_relational_wide.cu``
    built again with ``-DWIDE_PHASES`` (each block's thread 0 sums the
    cycles between its barriers: the gather and each product of a tile), put
    in the place of the library for 3 forward and 3 backward calls at
    ``wide_timings``' f32 and bf16 inputs, then put back. Returns each edge
    kernel's share of its cycles by phase."""
    import ctypes

    import torch

    from gnn_tracking_tpu_torch import _build
    from gnn_tracking_tpu_torch.ops import fused_relational as fr

    out = _build.build_dir() / "libfused_relational_wide-phases.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-DWIDE_PHASES", "-o", str(out),
                           str(_build.CSRC / "fused_relational_wide.cu")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(out))
    for name, argtypes in {**fr._SIGNATURES_WIDE, "fused_relational_wide_phases": [_build.P]}.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    counts = (ctypes.c_ulonglong * 24)()

    def read():
        torch.cuda.synchronize()
        _build.check(lib, lib.fused_relational_wide_phases(ctypes.addressof(counts)), "fused_relational_wide_phases")
        return list(counts)

    fx, fe, h, fo = WIDE_WIDTHS
    shares = {}
    kept = _build.library("fused_relational_wide", fr._SIGNATURES_WIDE)
    _build._LIBS["fused_relational_wide"] = lib
    try:
        with torch.no_grad():
            for route in ("f32", "bf16"):
                dtype = torch.bfloat16 if route == "bf16" else torch.float32
                g, (x, ea, ei, mask, w, g_e, g_a) = ec_width_case(seed + 180, fx, fe, h, fo, N_EDGES, 0.8,
                                                                  n=N_NODES)
                x, ea, g_e, g_a = (t.to(dtype).contiguous() for t in (x, ea, g_e, g_a))
                w = {k: v.to(dtype) for k, v in w.items()}
                csr = g.csr()
                calls = (lambda: fr.fused_relational_wide_fwd(x, ea, ei, mask, w, rowptr=csr["dst_rowptr"]),
                         lambda: fr.fused_relational_wide_bwd(x, None, None, ea, ei, mask, w, g_e, g_a, csr,
                                                              g.num_nodes))
                for fn in calls:
                    read()  # zeroes the counters
                    for _ in range(3):
                        fn()
                    cycles = read()
                    for kernel, (first, names) in WIDE_PHASES.items():
                        part = cycles[first:first + len(names)]
                        if sum(part):
                            shares[f"{route} {kernel}"] = {n: c / sum(part) for n, c in zip(names, part)}
    finally:
        _build._LIBS["fused_relational_wide"] = kept
    log(f"wide layout phases at {WIDE_WIDTHS}, {N_EDGES} edges (shares of each edge kernel's cycles, "
        "-DWIDE_PHASES build): " + json.dumps(shares))
    return shares


def wide_ec_steps(seed: int) -> dict:
    """The wide layout's own path: one ``ECModule`` step of ``ECForGraphTCN``
    at ``WIDE_EC_MODEL`` (every layer at ``WIDE_WIDTHS``), f32 and bf16, on
    phase 9's event: step 0's gradients through the kernels against the
    plain path's (f32 by ``compare_grads``; bf16 each tensor within 5e-2 of
    its largest magnitude, as phase 9), the wide kernels launched once a
    layer each way and the resident ones never (counts set to 0 just
    before); then steps/s through the kernels and through the plain path
    (the median of 7 synchronised ``training_step`` calls after 2 warm-up
    steps each). Returns the wide kernels' launches in step 0, by precision
    and by route, as the kernels line names them: ``fused_relational_wide_*``
    on the CUDA cores, ``fused_relational_wide_tc_*`` on the tensor cores
    (the wrappers' ``tc_launches``). In this tree the f32 step takes the
    CUDA cores and the bf16 step the tensor cores; a tree without that
    route (``--package-root``) counts every launch as the CUDA cores'."""
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
    has_tc = all(hasattr(fn, "tc_launches") for fn in wide.values())
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
        for fn in wide.values():
            fn.tc_launches = 0
        gk, lk = step0()
        assert not any(fn.launches for fn in resident), [fn.launches for fn in resident]
        assert all(fn.launches == WIDE_EC_MODEL["L_ec"] for fn in wide.values()), [fn.launches for fn in wide.values()]
        launches = {}
        for name, fn in wide.items():
            launches[name] = fn.launches - fn.tc_launches
            launches[name.replace("wide_", "wide_tc_")] = fn.tc_launches
            want = WIDE_EC_MODEL["L_ec"] if precision == "bf16" and has_tc else 0
            assert fn.tc_launches == want, f"{precision} step: {name} {fn.tc_launches} tensor-core launches"
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

        def steps_per_s(n: int = 7) -> float:
            """1 / the median of n synchronised training steps, after 2 warm-up steps."""
            for _ in range(2):
                ec.training_step(g)
            torch.cuda.synchronize()
            times = []
            for _ in range(n):
                t0 = time.perf_counter()
                ec.training_step(g)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            return 1.0 / statistics.median(times)

        rate = steps_per_s()
        with plain_path():
            rate_plain = steps_per_s()
        log(f"wide EC step ({precision}, {WIDE_EC_MODEL}): loss {lk:.6f} (plain {lp:.6f}); gradients agree "
            f"with the plain path (worst {worst_name}: {worst:.3e}); launches {launches}; "
            f"{rate:.2f} steps/s (plain path {rate_plain:.2f}; median of 7 after 2 warm-up)")
    return by_precision


def wide_edge_checks(seed: int) -> None:
    """The wide layout through ``fused_relational_wide_fwd`` / ``_bwd`` at
    ``WIDE_EDGE_CASES``: the forward (with and without the save flag) and
    the backward (from x and from the saved rows) against the plain
    versions (f32 within 1e-4 of the largest magnitude, bf16 within 2e-2
    of the norm), every output repeat bitwise (the weight gradients too),
    the saving forward and the saved-rows backward bitwise the others, the
    saved rows equal to ``x[dst]`` / ``x[src]``, the masked edges' rows
    zero, and with no unmasked edge zero weight gradients; every launch on
    the bf16 tensor cores for the cases in ``WIDE_TC_CASES``, on the CUDA
    cores for every other."""
    import torch

    from gnn_tracking_tpu_torch.ops import fused_relational as fr

    flat = lambda out: [out[0], out[1], *out[2].values()]
    for name, (route, (fx, fe, h, fo), e, unmasked) in WIDE_EDGE_CASES.items():
        bf16 = route == "bf16"
        dtype = torch.bfloat16 if bf16 else torch.float32
        g, (x, ea, ei, mask, w, g_e, g_a) = ec_width_case(seed + 195, fx, fe, h, fo, e, 0.8, n=min(2000, e))
        x, ea, g_e, g_a = (t.to(dtype) for t in (x, ea, g_e, g_a))
        w = {k: v.to(dtype) for k, v in w.items()}
        if isinstance(unmasked, int):  # an exact count of unmasked edges
            mask = torch.zeros_like(mask)
            mask[torch.from_numpy(np.random.default_rng(seed + 196).permutation(e)[:unmasked]).to(mask.device)] = True
        n_valid = int(mask.sum())
        if name.endswith("tail tile"):
            assert n_valid % 64 and n_valid % 32, f"{name}: {n_valid} unmasked edges fill whole tiles"
        csr = g.csr()
        wide_fns = (fr.fused_relational_wide_fwd, fr.fused_relational_wide_bwd)
        before = [(fn.launches, fn.tc_launches) for fn in wide_fns]
        fwd = lambda save: fr.fused_relational_wide_fwd(x, ea, ei, mask, w, rowptr=csr["dst_rowptr"],
                                                       relu_edge=True, save=save)
        bwd = lambda rows: flat(fr.fused_relational_wide_bwd(*rows, ea, ei, mask, w, g_e, g_a, csr, g.num_nodes,
                                                             relu_edge=True))
        a, a2, c = fwd(False), fwd(False), fwd(True)
        b, b2, d = bwd((x, None, None)), bwd((x, None, None)), bwd((None, c[2], c[3]))
        plain_f = fr.fused_relational_bf16_plain if bf16 else fr.fused_relational_plain
        plain_b = fr.fused_relational_bf16_bwd_plain if bf16 else fr.fused_relational_bwd_plain
        pa, pb = plain_f(x, ea, ei, mask, w, relu_edge=True), flat(plain_b(x, ea, ei, mask, w, g_e, g_a,
                                                                           relu_edge=True))
        torch.cuda.synchronize()
        launched = [(fn.launches - n0, fn.tc_launches - t0) for fn, (n0, t0) in zip(wide_fns, before)]
        tc = name in WIDE_TC_CASES
        assert launched == [(3, 3 if tc else 0)] * 2, f"{name}: launches {launched}"
        worst = 0.0
        for k_t, p_t in zip([*a, *b], [*pa, *pb]):
            assert k_t.shape == p_t.shape and k_t.dtype == dtype, f"{name}: {k_t.shape} {k_t.dtype}"
            if bf16:
                err = (k_t.double() - p_t.double()).norm().item()
                lim = 2e-2 * p_t.double().norm().item()
            else:
                err, lim = (k_t - p_t).abs().max().item(), 1e-4 * p_t.abs().max().item()
            assert err <= lim, f"wide layout, {name}: {err:.3e} > {lim:.3e}"
            worst = max(worst, err / lim if lim else 0.0)
        assert all(torch.equal(u, v) for u, v in zip([*a, *b], [*a2, *b2])), f"{name}: second launch differs"
        assert torch.equal(c[0], a[0]) and torch.equal(c[1], a[1]), f"{name}: the saving forward differs"
        src, dst = ei.long()
        assert torch.equal(c[2], x[dst]) and torch.equal(c[3], x[src]), f"{name}: saved rows"
        assert all(torch.equal(u, v) for u, v in zip(b, d)), f"{name}: the saved-rows backward differs"
        assert not a[0][~mask].any() and not b[1][~mask].any(), f"{name}: masked rows not zero"
        if n_valid == 0:
            assert not any(t.any() for t in b[2:]), f"{name}: weight gradients without an unmasked edge"
        log(f"wide layout, {name} ({route} on the {'tensor' if tc else 'CUDA'} cores, (Fx, Fe, H, Fo) = "
            f"{(fx, fe, h, fo)}, {n_valid} of {e} edges unmasked): OK, within {worst:.3f} of each bound, repeat bitwise, save flag and saved rows bitwise")


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
    wide_edge_checks(seed)
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


# tc.yml through the port's CLI (phase 11)
TC_TRAIN_EVENTS, TC_VAL_EVENTS, TC_EPOCHS = 4, 2, 2
TC_MONITOR = "trk.double_majority_pt0.9"  # the scanner's guide figure of merit
#: the kernels of phase 11's path, by the module attribute that launches each
TC_CLI_KERNELS = {
    "fused_relational_fwd": ("fused_relational", "fused_relational_fwd"),
    "fused_relational_bwd": ("fused_relational", "fused_relational_bwd"),
    "sorted_segment_sum": ("csr_segment", "sorted_segment_sum"),
    "sorted_gather": ("csr_segment", "sorted_gather"),
    "pairwise_topk_filter": ("pairwise_topk", "pairwise_topk_filter"),
    "cc_neighbors": ("cc_kernel", "cc_neighbors"),
}


def tc_cli_config(train_dir: Path, val_dir: Path, log_dir: Path) -> dict:
    """``examples/configs/tc.yml`` as a dict (the card's machine has no
    PyYAML), with phase 11's overrides: the data directories, ``max_epochs``,
    ``log_dir`` and ``monitor``. A CPU test holds it against the file."""
    aug = "gnn_tracking_tpu.utils.augmentation."
    return {
        "model": {
            "class_path": "gnn_tracking_tpu.training.module.TCModule",
            "init_args": {
                "model": {
                    "class_path": "gnn_tracking_tpu.models.track_condensation_networks.PerfectECGraphTCN",
                    "init_args": {"h_dim": 64, "e_dim": 64, "h_outdim": 8, "hidden_dim": 128, "L_hc": 3},
                },
                "loss_fct": {
                    "class_path": "gnn_tracking_tpu.losses.oc.CondensationLossTiger",
                    "init_args": {"lw_repulsive": 1.0, "lw_noise": 1.0, "lw_coward": 0.1,
                                  "max_n_objects": 2048, "object_block_size": 256},
                },
                "cluster_scanner": {
                    "class_path": "gnn_tracking_tpu.postprocessing.dbscanscanner.DBSCANHyperParamScanner",
                    "init_args": {"n_trials": 12, "keep_best": 4},
                },
                "lr": 0.001,
            },
        },
        "data": {
            "class_path": "gnn_tracking_tpu.utils.loading.TrackingDataModule",
            "init_args": {"train": {"dirs": [str(train_dir)]}, "val": {"dirs": [str(val_dir)]}},
        },
        "trainer": {
            "max_epochs": TC_EPOCHS,
            "log_dir": str(log_dir),
            "ema_decay": 0.998,
            "train_transform": {
                "class_path": aug + "Compose",
                "init_args": {"transforms": [
                    {"class_path": aug + "ZReflection", "init_args": {"p": 0.5, "seed": 0}},
                    {"class_path": aug + "PhiRotation", "init_args": {"seed": 0}},
                    {"class_path": aug + "HitDropout", "init_args": {"p": 0.08, "seed": 0}},
                ]},
            },
            "monitor": TC_MONITOR,
        },
    }


def make_tc_event(seed: int):
    """A training event for ``tc.yml``'s recipe at ``make_train_event``'s
    size (32,768 hits, 262,144 edges): particle ids in [0, 2048) (0 = noise),
    each particle's hits in a random order, every hit linked to the next two
    hits of its particle (true edges, ~23 % of all), the rest local fakes as
    in ``make_event``; per-particle pt and eta; 14 node features with phi / pi
    in column 1 and gphi in column 13, and each hit's mirror-module (geta,
    gphi) in ``extras["cell_refl"]`` (``ZReflection``'s exact path)."""
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, N_TRACKS, size=N_NODES)
    order = np.lexsort((rng.random(N_NODES), pid))
    ps = pid[order]
    true = []
    for hop in (1, 2):
        same = (ps[hop:] == ps[:-hop]) & (ps[hop:] > 0)
        true.append(np.stack([order[:-hop][same], order[hop:][same]]))
    true = np.concatenate(true, axis=1)
    n_fake = N_EDGES - true.shape[1]
    dst = rng.integers(0, N_NODES, size=n_fake)
    src = np.clip(dst + rng.integers(-LOCALITY, LOCALITY, size=n_fake), 0, N_NODES - 1)
    edge_index = np.concatenate([true, np.stack([src, dst])], axis=1)[:, rng.permutation(N_EDGES)]
    edge_index = edge_index.astype(np.int32)
    x = rng.normal(size=(N_NODES, NODE_DIM)).astype(np.float32)
    x[:, 1] = rng.uniform(-1, 1, N_NODES)
    x[:, 13] = rng.uniform(-np.pi, np.pi, N_NODES)
    refl = np.stack([rng.normal(size=N_NODES), rng.uniform(-np.pi, np.pi, N_NODES)], axis=1)
    s, d = edge_index
    return {
        "x": x, "edge_index": edge_index,
        "edge_attr": rng.normal(size=(N_EDGES, EDGE_DIM)).astype(np.float32),
        "y": (pid[s] == pid[d]) & (pid[s] > 0), "particle_id": pid,
        "pt": (2 * rng.random(N_TRACKS))[pid], "eta": (8 * (rng.random(N_TRACKS) - 0.5))[pid],
        "reconstructable": np.ones(N_NODES), "extras": {"cell_refl": refl.astype(np.float32)},
    }


def tc_cli_phase(seed: int, tmp: Path) -> dict:
    """Phase 11 (see the module docstring). Returns the launches of
    ``TC_CLI_KERNELS`` in the CLI's ``fit`` (counts set to 0 just before it,
    read just after) and the phase's summary."""
    import importlib

    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.inference import TrackingPredictor
    from gnn_tracking_tpu_torch.postprocessing import dbscanscanner
    from gnn_tracking_tpu_torch.training import run as tc_run
    from gnn_tracking_tpu_torch.utils.loading import load_graph, save_graph

    ops = {name: importlib.import_module(f"gnn_tracking_tpu_torch.ops.{name}")
           for name in {m for m, _ in TC_CLI_KERNELS.values()}}

    def counts() -> dict:
        return {k: getattr(ops[m], f).launches for k, (m, f) in TC_CLI_KERNELS.items()}

    def zero_counts() -> None:
        for m, f in TC_CLI_KERNELS.values():
            getattr(ops[m], f).launches = 0

    def sync() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    dirs = {"train": tmp / "tc_train", "val": tmp / "tc_val"}
    for split, n, base in (("train", TC_TRAIN_EVENTS, 300), ("val", TC_VAL_EVENTS, 400)):
        dirs[split].mkdir()
        for i in range(n):
            save_graph(EventGraph.from_arrays(**make_tc_event(seed + base + i)), dirs[split] / f"ev{i:02d}.npz")
    config = tc_cli_config(dirs["train"], dirs["val"], tmp / "tc_runs")

    # ---- step 0 of the CLI's module: gradients through the kernels against the plain path
    module, dm, trainer = tc_run.build_from_config(copy.deepcopy(config), device="cuda")
    dm.setup("fit")
    batch = trainer.train_transform(next(iter(dm.train_dataloader())).to("cuda"), 0)
    model = module.model

    def step0():
        model.train()
        model.zero_grad(set_to_none=True)
        out, data = module.apply_model(batch)
        loss, _ = module.get_losses(out, data)
        loss.backward()
        grads = {n: None if p.grad is None else p.grad.detach().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return grads, loss.item()

    zero_counts()
    gk, lk = step0()
    step0_launches = counts()
    with plain_path():
        gp, lp = step0()
    worst_name, worst, at_floor, no_grad, total = compare_grads(gk, gp)
    assert not no_grad, no_grad
    train_kernels = [k for k in TC_CLI_KERNELS if k not in ("pairwise_topk_filter", "cc_neighbors")]
    for name in train_kernels:
        assert step0_launches[name] > 0, f"step 0 never launched {name}"
    log(f"tc.yml CLI step 0: loss {lk:.6f} (plain {lp:.6f}); {len(gk)} parameter gradients agree with "
        f"the plain path (worst {worst_name}: {worst:.3e} relative; within the floor of 1e-7 x "
        f"{total:.3e} only: {at_floor or 'none'}); {int(batch.edge_mask.sum())} unmasked edges after "
        f"the augmentations, {int((batch.y & batch.edge_mask).sum())} true")
    del module, dm, trainer, model, batch, gk, gp

    # ---- fit through the command dispatch, instrumented
    rec = {"steps": [], "step_ms": [], "step_launches": [], "scans": [], "epochs": []}
    build = tc_run.build_from_config
    rescan_cls, metrics_fn = dbscanscanner.DBSCANFastRescan, dbscanscanner.tracking_metrics

    def instrumented_build(cfg, **kw):
        module, dm, trainer = build(cfg, **kw)
        step, epoch_end = module.training_step, module.on_validation_epoch_end

        def training_step(b):
            before, t0 = counts(), sync()
            out = step(b)
            rec["step_ms"].append((sync() - t0) * 1e3)
            after = counts()
            rec["step_launches"].append({k: after[k] - before[k] for k in after})
            rec["steps"].append(out)
            return out

        def on_validation_epoch_end():
            foms = epoch_end()
            rec["epochs"].append({"trials": module.cluster_scanner.trials, "foms": foms})
            return foms

        module.training_step, module.on_validation_epoch_end = training_step, on_validation_epoch_end
        rec["module"], rec["trainer"] = module, trainer
        return module, dm, trainer

    class TimedRescan(rescan_cls):
        """The scanner's rescanner, timed by part, with its inputs and labels
        kept for the plain path's scan after the fit."""

        def __init__(self, x, max_eps=1.0, **kw):
            before, t0 = counts(), sync()
            super().__init__(x, max_eps, **kw)
            self.scan = {"radius_ms": (sync() - t0) * 1e3, "metrics_ms": 0.0, "x": x.detach().clone(),
                         "max_eps": max_eps, "kw": kw,
                         "row12": counts()["pairwise_topk_filter"] - before["pairwise_topk_filter"]}
            rec["scans"].append(self.scan)

        def cluster_many(self, trials):
            before, t0 = counts(), sync()
            labels = super().cluster_many(trials)
            self.scan.update(trials_ms=(sync() - t0) * 1e3, trials=list(trials), labels=labels.clone(),
                             row16=counts()["cc_neighbors"] - before["cc_neighbors"])
            return labels

    def timed_metrics(**kw):
        t0 = sync()
        out = metrics_fn(**kw)
        rec["scans"][-1]["metrics_ms"] += (sync() - t0) * 1e3
        return out

    tc_run.build_from_config = instrumented_build
    dbscanscanner.DBSCANFastRescan, dbscanscanner.tracking_metrics = TimedRescan, timed_metrics
    try:
        zero_counts()
        t0 = sync()
        result = tc_run.run_command("fit", config, device="cuda")
        fit_s = sync() - t0
        fit_launches = counts()
    finally:
        tc_run.build_from_config = build
        dbscanscanner.DBSCANFastRescan, dbscanscanner.tracking_metrics = rescan_cls, metrics_fn
    trainer, n_steps = rec["trainer"], len(rec["steps"])
    assert n_steps == TC_EPOCHS * TC_TRAIN_EVENTS, n_steps
    assert all(math.isfinite(v) for m in rec["steps"] for v in m.values()), "non-finite training loss"
    for name, n in fit_launches.items():
        assert n > 0, f"the CLI fit never launched {name}"
    per_step = {k: statistics.mean(s[k] for s in rec["step_launches"]) for k in fit_launches}
    for name in train_kernels:
        assert per_step[name] > 0, f"a CLI training step never launched {name}"

    # ---- the scans: launches counted at their launches, labels against the plain path
    def check_scans(scans, what: str) -> dict:
        for i, scan in enumerate(scans):
            n_trials = len(scan["trials"])
            assert scan["row12"] == 1, f"{what} scan {i}: row #12 launched {scan['row12']} times, not once"
            assert scan["row16"] == n_trials == 12, (
                f"{what} scan {i}: row #16 launched {scan['row16']} times for {n_trials} trials")
            with plain_path():
                plain = rescan_cls(scan["x"], scan["max_eps"], **scan["kw"]).cluster_many(scan["trials"])
            for t, (a, b) in enumerate(zip(scan["labels"], plain)):
                assert torch.equal(a, b), f"{what} scan {i}, trial {scan['trials'][t]}: labels differ from plain"
            scan["clusters"] = [int(row.max()) + 1 for row in scan["labels"]]
        return {k: statistics.mean(s[k] for s in scans) for k in ("radius_ms", "trials_ms", "metrics_ms")}

    assert len(rec["scans"]) == TC_EPOCHS * TC_VAL_EVENTS, len(rec["scans"])
    fit_scans = rec["scans"]
    split = check_scans(fit_scans, "fit")
    best_value = result[f"best_{TC_MONITOR}"]
    assert math.isfinite(best_value), result
    best = trainer.best_checkpoint
    assert best is not None and best.exists(), "no checkpoint_best"
    chosen = next(e for e in rec["epochs"] if e["foms"][TC_MONITOR] == best_value)

    # The briefly trained latent spreads ~0.005 (the initial weights'), so every
    # trial eps joins each event into one cluster. The selected trials again,
    # through the scanner, on a particle-structured latent (make_event's:
    # unit-normal 8-d centres, 0.02 noise; noise hits unit-normal) plus the
    # trained latent, give the kernels real clusters at the same shapes.
    rec["scans"] = []
    structured = dbscanscanner.DBSCANHyperParamScannerFixed(chosen["trials"])
    ckpt_model = TrackingPredictor(best, device="cuda").model
    dbscanscanner.DBSCANFastRescan, dbscanscanner.tracking_metrics = TimedRescan, timed_metrics
    try:
        for i in range(TC_VAL_EVENTS):
            g = load_graph(dirs["val"] / f"ev{i:02d}.npz", device="cuda").sort_edges_by_target()
            with torch.no_grad():
                h = ckpt_model(g)["H"].float()
            rng = np.random.default_rng(seed + 500 + i)
            pid = g.particle_id.cpu().numpy()
            latent = rng.normal(size=(N_TRACKS, 8))[pid] + 0.02 * rng.normal(size=(N_NODES, 8))
            latent[pid == 0] = rng.normal(size=(int((pid == 0).sum()), 8))
            structured(g, {"H": torch.from_numpy(latent.astype(np.float32)).to(g.device) + h}, i)
    finally:
        dbscanscanner.DBSCANFastRescan, dbscanscanner.tracking_metrics = rescan_cls, metrics_fn
    structured_scans = rec["scans"]
    structured_split = check_scans(structured_scans, "particle-structured")
    structured_foms = structured.get_foms()
    assert all(max(s["clusters"]) > N_TRACKS // 2 for s in structured_scans), [s["clusters"] for s in structured_scans]

    # ---- checkpoint_best: validate with the selected epoch's trials, then serve it
    config_v = copy.deepcopy(config)
    config_v["model"]["init_args"]["cluster_scanner"] = {
        "class_path": "gnn_tracking_tpu.postprocessing.dbscanscanner.DBSCANHyperParamScannerFixed",
        "init_args": {"trials": chosen["trials"]},
    }
    val = tc_run.run_command("validate", config_v, ckpt_path=best, device="cuda")
    assert val[TC_MONITOR] == best_value, f"validate --ckpt_path: {val[TC_MONITOR]} != fit's {best_value}"
    chosen_total = trainer.metrics_history[rec["epochs"].index(chosen)]["total"]
    assert val["total"] == chosen_total, f"validate --ckpt_path: total {val['total']} != fit's {chosen_total}"
    predictor = TrackingPredictor(best, eps=chosen["foms"]["best_dbscan_eps"],
                                  min_samples=int(chosen["foms"]["best_dbscan_min_samples"]), device="cuda")
    stats = predictor.predict_dir(dirs["val"], tmp / "tc_labels", evaluate=True)
    trk = {k: v for k, v in stats.items() if k.startswith("trk.")}
    assert trk and TC_MONITOR in trk and all(math.isfinite(v) for v in trk.values()), trk
    with plain_path():
        for i in range(TC_VAL_EVENTS):
            want = predictor.predict(load_graph(dirs["val"] / f"ev{i:02d}.npz", device="cuda"))
            got = np.load(tmp / "tc_labels" / f"ev{i:02d}_labels.npz")
            assert np.array_equal(got["labels"], want["labels"]), f"served event {i}: labels differ from plain"

    steps_per_s = n_steps / (sum(rec["step_ms"]) / 1e3)
    warm_steps_per_s = (n_steps - 1) / (sum(rec["step_ms"][1:]) / 1e3)
    summary = {
        "steps": n_steps, "steps_per_s": steps_per_s, "warm_steps_per_s": warm_steps_per_s,
        "step_ms": rec["step_ms"], "step_ms_median": statistics.median(rec["step_ms"]),
        "fit_s": fit_s, "launches_per_step": per_step, "fit_launches": fit_launches,
        "scan_ms_per_event": split, "structured_scan_ms_per_event": structured_split,
        "scans": [{k: s[k] for k in ("row12", "row16", "radius_ms", "trials_ms", "metrics_ms", "clusters")}
                  for s in fit_scans + structured_scans],
        f"structured_{TC_MONITOR}": structured_foms[TC_MONITOR],
        f"best_{TC_MONITOR}": best_value, "validate_ckpt": val[TC_MONITOR],
        "best_dbscan": [chosen["foms"]["best_dbscan_eps"], chosen["foms"]["best_dbscan_min_samples"]],
        "served_trk": trk, "last_total_train": rec["steps"][-1]["total"],
    }
    log(f"tc.yml CLI fit: {n_steps} steps, {steps_per_s:.2f} steps/s ({warm_steps_per_s:.2f} after the first "
        f"step's {rec['step_ms'][0]:.1f} ms; median step {summary['step_ms_median']:.2f} ms), fit wall time {fit_s:.2f} s incl. {len(fit_scans)} scanned "
        f"validation events; scan per event: radius graph {split['radius_ms']:.2f} ms, 12 trials "
        f"{split['trials_ms']:.2f} ms, metrics {split['metrics_ms']:.2f} ms (on the particle-structured "
        f"latent {structured_split['radius_ms']:.2f} / {structured_split['trials_ms']:.2f} / "
        f"{structured_split['metrics_ms']:.2f} ms, {TC_MONITOR} {structured_foms[TC_MONITOR]:.4f}); rows "
        f"#12 / #16 once / 12 times a scanned event, labels bitwise the plain path's for every trial; checkpoint_best: "
        f"{TC_MONITOR} {best_value} and validation total {chosen_total:.6f} from fit and from validate "
        f"--ckpt_path; served with evaluate=True: "
        f"{TC_MONITOR} {trk[TC_MONITOR]}, labels equal to the plain path's")
    log("tc_cli: " + json.dumps(summary))
    return summary


# stages chained through checkpoints (phase 12)
PIPE_TRAIN_CLOUDS, PIPE_SERVE_CLOUDS, PIPE_ML_CLOUDS = 4, 32, 2
PIPE_CHECKED_CLOUDS = 2  # served again on the plain path and with a particle-structured latent
PIPE_WARM_PASSES = 3  # timed passes over the serving clouds in host memory, a mode
PIPE_BAKE = {"max_num_neighbors": 16, "max_radius": 1.0}  # row #13 (k <= knn.SPLIT_MAX_K)
PIPE_SERVE = {"max_num_neighbors": 64, "max_radius": 1.0}  # inference.main's --ml-neighbors / --ml-radius
# ec.yml's widths on the learned graph's 28 edge features ([x_i - x_j, x_i + x_j])
PIPE_EC_MODEL = {**EC_MODEL, "edge_indim": 2 * NODE_DIM}
PIPE_TC_MODEL = {"h_dim": 64, "e_dim": 64, "h_outdim": 8, "hidden_dim": 128, "L_hc": 3}  # tc.yml's widths
#: the kernels of phase 12's path, by the module attribute that launches each
PIPE_KERNELS = {
    "pairwise_topk_filter": ("pairwise_topk", "pairwise_topk_filter"),
    "pairwise_topk": ("pairwise_topk", "pairwise_topk"),
    "fused_relational_fwd": ("fused_relational", "fused_relational_fwd"),
    "fused_relational_bwd": ("fused_relational", "fused_relational_bwd"),
    "fused_relational_bf16_fwd": ("fused_relational", "fused_relational_bf16_fwd"),
    "fused_relational_bf16_bwd": ("fused_relational", "fused_relational_bf16_bwd"),
    "sorted_segment_sum": ("csr_segment", "sorted_segment_sum"),
    "sorted_gather": ("csr_segment", "sorted_gather"),
    "cc_neighbors": ("cc_kernel", "cc_neighbors"),
}


def save_point_clouds(directory: Path, seeds) -> None:
    """``make_point_cloud`` clouds of ``ML_HITS`` hits and ``ML_PARTICLES``
    particles as edge-less npz (the true edges between consecutive hits of a
    particle as ``true_edge_index``), the serving input of ``--ml-chkpt``."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.utils.loading import save_graph

    directory.mkdir(parents=True)
    for i, s in enumerate(seeds):
        pc = make_point_cloud(s, ML_HITS, ML_PARTICLES)
        g = EventGraph.from_arrays(x=pc["x"], particle_id=pc["particle_id"], pt=pc["pt"], eta=pc["eta"],
                                   reconstructable=pc["reconstructable"])
        te = torch.from_numpy(pc["edge_index"])
        save_graph(g.replace(true_edge_index=te, true_edge_mask=torch.ones(te.shape[1], dtype=torch.bool)),
                   directory / f"cloud{i:02d}.npz")


def pipeline_phase(seed: int, tmp: Path) -> dict:
    """Phase 12 (see the module docstring). Returns the launches of
    ``PIPE_KERNELS`` on the phase's path (each stage's counts set to 0 just
    before it and read just after; the comparisons with the plain path, the
    step-0 gradients and the uninterrupted fit that the resume is held to
    are not counted) and the phase's summary."""
    import importlib

    import torch
    from torch.func import functional_call

    from gnn_tracking_tpu_torch import inference
    from gnn_tracking_tpu_torch.graph_construction.data_transformer import DataTransformer
    from gnn_tracking_tpu_torch.losses.ec import EdgeWeightFocalLoss
    from gnn_tracking_tpu_torch.losses.metric_learning import GraphConstructionHingeEmbeddingLoss
    from gnn_tracking_tpu_torch.losses.oc import CondensationLossTiger
    from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
    from gnn_tracking_tpu_torch.models.graph_construction import GraphConstructionFCNN
    from gnn_tracking_tpu_torch.models.track_condensation_networks import PreTrainedECGraphTCN
    from gnn_tracking_tpu_torch.training import restore
    from gnn_tracking_tpu_torch.training.module import ECModule, MLModule, TCModule
    from gnn_tracking_tpu_torch.training.trainer import Trainer
    from gnn_tracking_tpu_torch.utils.loading import TrackingDataModule, load_graph

    ops = {name: importlib.import_module(f"gnn_tracking_tpu_torch.ops.{name}")
           for name in {m for m, _ in PIPE_KERNELS.values()}}
    path_launches = dict.fromkeys(PIPE_KERNELS, 0)

    def counts() -> dict:
        return {k: getattr(ops[m], f).launches for k, (m, f) in PIPE_KERNELS.items()}

    def counted(fn):
        """``fn()`` and its launches, counted from 0."""
        for m, f in PIPE_KERNELS.values():
            getattr(ops[m], f).launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, counts()

    def on_path(fn):
        """``fn()`` as a stage of the path: its launches, counted from 0
        and added to the path's."""
        out, launched = counted(fn)
        for k, n in launched.items():
            path_launches[k] += n
        return out, launched

    def sync() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    t_phase = sync()
    clouds, serve, baked, runs = tmp / "pipe_clouds", tmp / "pipe_serve", tmp / "pipe_baked", tmp / "pipe_runs"
    save_point_clouds(clouds, range(seed + 600, seed + 600 + PIPE_TRAIN_CLOUDS))
    save_point_clouds(serve, range(seed + 700, seed + 700 + PIPE_SERVE_CLOUDS))
    summary: dict = {}
    stage_s: dict = {}

    # ---- (a) the metric-learning stage, its checkpoint restored
    ml_model = GraphConstructionFCNN(**ML_MODEL, device="cpu", generator=torch.Generator().manual_seed(seed + 601))
    ml_module = MLModule(model=ml_model, loss_fct=GraphConstructionHingeEmbeddingLoss(**ML_LOSS), lr=LR,
                         device="cuda")
    ml_trainer = Trainer(max_epochs=1, log_dir=runs, name="ml", print_validation_results=False)
    t0 = sync()
    on_path(lambda: ml_trainer.fit(ml_module, TrackingDataModule(train={"dirs": [clouds], "stop": PIPE_ML_CLOUDS},
                                                                 seed=seed)))
    stage_s["ml_fit"] = sync() - t0
    ml_ckpt = ml_trainer.checkpoints[-1]
    restored = restore.get_model(ml_ckpt, device="cuda")
    assert isinstance(restored, GraphConstructionFCNN) and ml_module.step == PIPE_ML_CLOUDS
    for k, v in ml_model.state_dict().items():
        assert torch.equal(restored.state_dict()[k], v), f"restored ML checkpoint: {k} differs"

    # ---- (b) the bake: kNN graphs of every training cloud from the ML checkpoint
    gc = restore.ml_graph_construction_from_chkpt(ml_ckpt, **PIPE_BAKE, device="cuda")
    t0 = sync()
    _, bake_launches = on_path(lambda: DataTransformer(gc, device="cuda").process_directories([clouds], [baked]))
    stage_s["bake"] = sync() - t0
    assert bake_launches["pairwise_topk"] == PIPE_TRAIN_CLOUDS, f"bake: row #13 launched {bake_launches}"
    k = PIPE_BAKE["max_num_neighbors"]
    bake_ties, baked_edges = [], []
    for f in sorted(clouds.glob("*.npz")):
        g = load_graph(f, device="cuda")
        with torch.no_grad():
            h = gc.ml(g)["H"]
            built = gc(g)
            with plain_path():
                plain = gc(g)

        def with_dists(graph):
            src, dst = graph.edge_index.long()
            return graph.edge_index, graph.edge_mask, (h[src] - h[dst]).norm(dim=1)

        bake_ties.append(compare_neighbours(f"bake {f.name}: kernels vs plain", with_dists(built), with_dists(plain), k))
        saved = load_graph(baked / f.name, device="cuda")
        assert torch.equal(saved.edge_index, built.compact().edge_index), f"bake {f.name}: the saved graph differs"
        baked_edges.append(saved.num_edges)
    assert json.loads((baked / "transform_config.yml").read_text())["init_args"]["max_num_neighbors"] == k
    log(f"pipeline (a, b): ML fit {stage_s['ml_fit']:.2f} s ({PIPE_ML_CLOUDS} steps), checkpoint restored "
        f"bitwise; bake of {PIPE_TRAIN_CLOUDS} clouds {stage_s['bake']:.2f} s, row #13 once a cloud, graphs equal "
        f"to the plain path's up to {bake_ties} tie rows; {baked_edges} edges kept")

    # ---- (c) the EC stage in bf16: step 0 against the plain path, then the resume drill
    def ec_module():
        model = ECForGraphTCN(**PIPE_EC_MODEL, device="cpu", generator=torch.Generator().manual_seed(seed + 610))
        return ECModule(model=model, loss_fct=EdgeWeightFocalLoss(**EC_LOSS), lr=LR, precision="bf16",
                        device="cuda")

    g0 = load_graph(sorted(baked.glob("*.npz"))[0], device="cuda").sort_edges_by_target()
    probe = ec_module()

    def ec_step0():
        probe.model.train()
        probe.model.zero_grad(set_to_none=True)
        out, data = probe.apply_model(g0)
        loss, _ = probe.get_losses(out, data)
        loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in probe.model.named_parameters()}
        probe.model.zero_grad(set_to_none=True)
        return grads

    gk = ec_step0()
    with plain_path():
        gp = ec_step0()
    ec_worst = max((gk[n] - gp[n]).abs().max().item() / gp[n].abs().max().item() for n in gp)
    assert ec_worst <= 5e-2, f"EC step 0: a gradient differs by {ec_worst:.3e} of its largest magnitude"
    del probe
    modules = {name: ec_module() for name in ("first", "resumed", "whole")}
    first = Trainer(max_epochs=1, log_dir=runs, name="ec", print_validation_results=False)
    t0 = sync()
    # the default shuffled loader: the resumed fit reads the second epoch's order
    on_path(lambda: first.fit(modules["first"], TrackingDataModule(train={"dirs": [baked]}, seed=seed)))
    stage_s["ec_fit"] = sync() - t0
    resumed = Trainer(max_epochs=1, log_dir=runs, name="ec", print_validation_results=False)
    t0 = sync()
    on_path(lambda: resumed.fit(modules["resumed"], TrackingDataModule(train={"dirs": [baked]}, seed=seed),
                                resume=True))
    stage_s["ec_resumed_fit"] = sync() - t0
    Trainer(max_epochs=2, log_dir=runs, name="ec_whole", print_validation_results=False).fit(
        modules["whole"], TrackingDataModule(train={"dirs": [baked]}, seed=seed))
    steps = {name: m.step for name, m in modules.items()}
    assert steps == {"first": PIPE_TRAIN_CLOUDS, "resumed": 2 * PIPE_TRAIN_CLOUDS,
                     "whole": 2 * PIPE_TRAIN_CLOUDS}, steps
    whole = dict(modules["whole"].model.named_parameters())
    bitwise = all(torch.equal(p, whole[n]) for n, p in modules["resumed"].model.named_parameters())
    resume_rel = max((p - whole[n]).abs().max().item() / whole[n].abs().max().item()
                     for n, p in modules["resumed"].model.named_parameters())
    assert bitwise or resume_rel <= 1e-6, f"resumed EC fit: parameters {resume_rel:.3e} relative from uninterrupted"
    ec_ckpt = resumed.checkpoints[-1]
    log(f"pipeline (c): EC step 0 gradients within {ec_worst:.3e} of their largest magnitude of the plain "
        f"path's (bound 5e-2); fit {stage_s['ec_fit']:.2f} s, resumed fit {stage_s['ec_resumed_fit']:.2f} s; "
        f"steps {steps}; resumed parameters {'bitwise' if bitwise else f'{resume_rel:.3e} relative from'} "
        f"the uninterrupted fit's")

    # ---- (d) the TC stage around the frozen EC
    ec = restore.ec_from_chkpt(ec_ckpt, device="cuda")
    ec_ref = restore.ec_from_chkpt(ec_ckpt, device="cuda")
    ec_before = {n: v.clone() for n, v in ec.state_dict().items()}
    tc_model = PreTrainedECGraphTCN(ec, **PIPE_TC_MODEL, device="cuda",
                                    generator=torch.Generator().manual_seed(seed + 620))
    # the briefly trained EC puts most weights below 0.5: cut at the median (in a gap), as phase 4 does
    threshold = calibrate_ec_threshold(tc_model, g0)
    tc = TCModule(model=tc_model, loss_fct=CondensationLossTiger(**LOSS), lr=LR, frozen_prefixes=("model/ec",),
                  device="cuda")
    assert len(tc.frozen) == len(ec_before), (len(tc.frozen), len(ec_before))

    def tc_step0():
        tc_model.train()
        tc_model.zero_grad(set_to_none=True)
        out, data = tc.apply_model(g0)
        loss, _ = tc.get_losses(out, data)
        loss.backward()
        grads = {n: None if p.grad is None else p.grad.detach().clone() for n, p in tc_model.named_parameters()}
        tc_model.zero_grad(set_to_none=True)
        return grads

    gk = tc_step0()
    with plain_path():
        gp = tc_step0()
    worst_name, worst, at_floor, no_grad, _ = compare_grads(gk, gp)
    assert len(no_grad) == len(ec_before), "the frozen EC's parameters must get no gradient"
    tc_trainer = Trainer(max_epochs=1, log_dir=runs, name="tc", print_validation_results=False)
    t0 = sync()
    on_path(lambda: tc_trainer.fit(tc, TrackingDataModule(train={"dirs": [baked]}, seed=seed)))
    stage_s["tc_fit"] = sync() - t0
    assert tc.step == PIPE_TRAIN_CLOUDS
    for n, v in ec.state_dict().items():
        assert torch.equal(v, ec_before[n]), f"the frozen EC's {n} changed"
    with torch.no_grad():
        tc_model.eval()
        w_tc, w_ref = tc_model(g0)["W"], ec_ref(g0)["W"]
    w_rel = (w_tc - w_ref).abs().max().item() / w_ref.abs().max().item()
    assert w_rel <= 1e-6, f"the TC's W is {w_rel:.3e} relative from the restored EC's"
    tc_ckpt = tc_trainer.checkpoints[-1]
    log(f"pipeline (d): TC step 0: {len(gk) - len(no_grad)} gradients agree with the plain path's (worst "
        f"{worst_name}: {worst:.3e} relative; at the floor only: {at_floor or 'none'}), the EC's "
        f"{len(no_grad)} frozen; fit {stage_s['tc_fit']:.2f} s; the EC bitwise unchanged, W {w_rel:.3e} "
        f"relative from the restored EC's, {float((w_ref > threshold).float().mean()):.4f} of the edges above the "
        f"cut at {threshold:.6f}")

    # ---- (e) serving point clouds through inference.main with --ml-chkpt
    argv = ["--chkpt", str(tc_ckpt), "--ml-chkpt", str(ml_ckpt),
            "--ml-neighbors", str(PIPE_SERVE["max_num_neighbors"]), "--ml-radius", str(PIPE_SERVE["max_radius"]),
            "--evaluate", "--indir", str(serve), "--device", "cuda"]
    served, serve_launches = {}, dict.fromkeys(PIPE_KERNELS, 0)
    for batch in (1, 2):
        t0 = sync()
        stats, launched = on_path(lambda b=batch: inference.main(
            [*argv, "--batch-size", str(b), "--outdir", str(tmp / f"pipe_labels{b}")]))
        served[batch] = {"stats": stats, "wall_s": sync() - t0}
        serve_launches = {k: serve_launches[k] + n for k, n in launched.items()}
        assert all(math.isfinite(v) for key, v in stats.items() if key.startswith("trk.")), stats
    for name in ("pairwise_topk_filter", "fused_relational_fwd", "sorted_segment_sum", "cc_neighbors"):
        assert serve_launches[name] > 0, f"serving never launched {name}"
    for batch in (1, 2):
        eps_cli = served[batch]["stats"]["events_per_s"]
        assert math.isfinite(eps_cli) and eps_cli > 0, f"batch {batch}: events/s {eps_cli}"
    gc64 = restore.ml_graph_construction_from_chkpt(ml_ckpt, **PIPE_SERVE, device="cuda")
    plain_predictor = inference.TrackingPredictor(tc_ckpt, graph_transform=gc64, device="cuda")
    files = sorted(serve.glob("*.npz"))
    assert len(files) == PIPE_SERVE_CLOUDS
    for i, f in enumerate(files):
        one = np.load(tmp / "pipe_labels1" / f"{f.stem}_labels.npz")
        two = np.load(tmp / "pipe_labels2" / f"{f.stem}_labels.npz")
        assert np.array_equal(one["labels"], two["labels"]), f"{f.name}: batch sizes 1 and 2 label differently"
        if i < PIPE_CHECKED_CLOUDS:
            with plain_path():
                want = plain_predictor.predict(load_graph(f, device="cuda"))
            assert np.array_equal(one["labels"], want["labels"]), f"{f.name}: labels differ from the plain path's"
    graphs = [load_graph(f, device="cpu") for f in files]

    # The briefly trained latent is one cluster an event (trk.* 0), so the
    # labels above hold DBSCAN's batch ids and renumbering to nothing. The
    # same model with a particle-structured latent on the first clouds, one
    # by one and as one batch, on the kernels and on the plain path.
    class StructuredLatent(torch.nn.Module):
        """The TC model, each hit's latent moved to its particle's unit-normal
        8-d centre plus 0.02 of ``H``; noise hits (id 0) at their own
        features ``x[:, 6:14]``."""

        def __init__(self, model, centres):
            super().__init__()
            self.model, self.centres = model, centres

        def forward(self, data):
            out = dict(self.model(data))
            pid = data.particle_id.long()
            own = data.x[:, 6:14].float()
            out["H"] = torch.where((pid > 0)[:, None], self.centres[pid], own) + 0.02 * out["H"].float()
            return out

    centres = torch.from_numpy(np.random.default_rng(seed + 710).normal(size=(ML_PARTICLES, 8)).astype(np.float32))
    structured = inference.TrackingPredictor(StructuredLatent(plain_predictor.model, centres.to("cuda")),
                                             graph_transform=gc64, device="cuda")
    checked = graphs[:PIPE_CHECKED_CLOUDS]
    singles = [structured.predict(g) for g in checked]
    batched, batch_launches = counted(lambda: structured.predict_batch(checked))
    with plain_path():
        plain_batched = structured.predict_batch(checked)
    assert batch_launches["pairwise_topk_filter"] > 0 and batch_launches["cc_neighbors"] > 0, batch_launches
    structured_clusters = []
    for f, one, many, plain in zip(files, singles, batched, plain_batched):
        n_clusters = int(one["labels"].max()) + 1
        structured_clusters.append(n_clusters)
        assert n_clusters > ML_PARTICLES // 2, f"{f.name}: {n_clusters} clusters of the structured latent"
        assert np.array_equal(many["labels"], one["labels"]), f"{f.name}: predict_batch labels differ from predict's"
        assert np.array_equal(plain["labels"], many["labels"]), f"{f.name}: batched labels differ from the plain path's"

    # bf16 over every serving cloud, then kernel A at tc.yml's widths against
    # its plain bf16 version on one transformed cloud
    bf16 = inference.TrackingPredictor(tc_ckpt, precision="bf16", graph_transform=gc64, device="cuda")
    t0 = sync()
    (bf16_stats, bf16_launches) = on_path(lambda: bf16.predict_dir(serve, tmp / "pipe_labels_bf16"))
    bf16_s = sync() - t0
    assert bf16_launches["fused_relational_bf16_fwd"] > 0, bf16_launches
    assert math.isfinite(bf16_stats["events_per_s"]) and bf16_stats["events_per_s"] > 0, bf16_stats
    beta_err = 0.0
    for f in files:
        got = np.load(tmp / "pipe_labels_bf16" / f"{f.stem}_labels.npz")
        f32 = np.load(tmp / "pipe_labels1" / f"{f.stem}_labels.npz")
        assert got["labels"].shape == f32["labels"].shape == (ML_HITS,)
        beta_err = max(beta_err, float(np.abs(got["beta"] - f32["beta"]).max()))
        assert beta_err <= 0.05, f"{f.name}: bf16 beta {beta_err} from f32's"
    with torch.no_grad():
        g_bf16 = gc64(graphs[0].to("cuda")).to("cuda", dtype=torch.bfloat16).sort_edges_by_target()
    cast = {k: v.detach().to(torch.bfloat16) for k, v in bf16.model.named_parameters()}

    def bf16_forward():
        with torch.no_grad():
            out = functional_call(bf16.model, cast, (g_bf16,))
        kept = float(out["ec_edge_mask"][g_bf16.edge_mask].float().mean())
        return {k: out[k].float() for k in ("W", "H", "B")}, kept

    # At the checkpoint's cut the bf16 EC's weights (most near its floor) may
    # pass no edge, and H and B then hold only the node encoders; a cut at -1
    # passes every edge, so H and B also hold the condensation layers' kernel A.
    bf16_rel, bf16_kept, served_cut = {}, {}, bf16.model.ec_threshold
    try:
        for cut_name, cut in (("served_cut", served_cut), ("every_edge", -1.0)):
            bf16.model.ec_threshold = cut
            (kernel_out, bf16_kept[cut_name]), forward_launches = counted(bf16_forward)
            assert forward_launches["fused_relational_bf16_fwd"] > 0, forward_launches
            with plain_path():
                plain_out, _ = bf16_forward()
            bf16_rel[cut_name] = {k: (kernel_out[k] - plain_out[k]).abs().max().item()
                                  / plain_out[k].abs().max().item() for k in plain_out}
    finally:
        bf16.model.ec_threshold = served_cut
    assert bf16_kept["every_edge"] == 1.0, bf16_kept
    worst_bf16 = max(v for r in bf16_rel.values() for v in r.values())
    assert worst_bf16 <= 5e-2, f"bf16 forward against the plain path: {bf16_rel}"

    # warm rates on the device path, the clouds in host memory (no files)
    def warm_rate(run) -> float:
        run()
        t0 = sync()
        for _ in range(PIPE_WARM_PASSES):
            run()
        return PIPE_WARM_PASSES * len(graphs) / (sync() - t0)

    warm = {"f32_batch_1": warm_rate(lambda: [plain_predictor.predict(g) for g in graphs]),
            "f32_batch_2": warm_rate(lambda: [plain_predictor.predict_batch(graphs[i : i + 2])
                                              for i in range(0, len(graphs), 2)]),
            "bf16_batch_1": warm_rate(lambda: [bf16.predict(g) for g in graphs])}
    for name, n in path_launches.items():
        assert n > 0, f"phase 12's path never launched {name}"
    phase_s = sync() - t_phase
    summary = {
        "phase_s": phase_s, "stage_s": stage_s, "bake_tie_rows": bake_ties, "baked_edges": baked_edges,
        "ec_step0_worst": ec_worst, "resume_bitwise": bitwise, "resume_rel": resume_rel,
        "tc_step0_worst": worst, "ec_w_rel": w_rel,
        "events_per_s": {"batch_1": served[1]["stats"]["events_per_s"], "batch_2": served[2]["stats"]["events_per_s"],
                         "bf16": bf16_stats["events_per_s"]},
        "serve_wall_s": {"batch_1": served[1]["wall_s"], "batch_2": served[2]["wall_s"], "bf16": bf16_s},
        "warm_events_per_s": warm, "warm_events": PIPE_WARM_PASSES * len(graphs), "ec_threshold": threshold,
        "trk.double_majority_pt0.9": served[1]["stats"].get("trk.double_majority_pt0.9"),
        "structured_clusters": structured_clusters, "structured_launches": batch_launches,
        "bf16_beta_err": beta_err, "bf16_forward_rel": bf16_rel, "bf16_forward_kept": bf16_kept,
        "serve_launches": serve_launches, "launches": path_launches,
    }
    log(f"pipeline (e): served {len(files)} point clouds through inference.main at batch sizes 1 and 2 "
        f"({served[1]['wall_s']:.2f} / {served[2]['wall_s']:.2f} s a call, checkpoints and the first batch included; "
        f"{summary['events_per_s']['batch_1']:.2f} / {summary['events_per_s']['batch_2']:.2f} events/s after the first "
        f"batch), labels equal across batch sizes and on {PIPE_CHECKED_CLOUDS} clouds to the plain path's; the "
        f"particle-structured latent: {structured_clusters} clusters, predict_batch equal to predict and to the "
        f"plain path's; bf16 predict_dir {bf16_stats['events_per_s']:.2f} events/s, beta within {beta_err:.4f} of "
        f"f32's, its forward within {bf16_rel} of the plain path's (edges past the cut {bf16_kept}); warm over {summary['warm_events']} events: "
        f"{warm['f32_batch_1']:.2f} / {warm['f32_batch_2']:.2f} events/s at batch 1 / 2, bf16 "
        f"{warm['bf16_batch_1']:.2f}; serving launches {serve_launches}; phase wall time {phase_s:.1f} s")
    log("pipeline: " + json.dumps(summary))
    return summary


# ---- phase 13: the remaining losses and models on existing kernels
VAR_STEPS = 10  # timed training steps of (a) and (c)
VAR_RG_LOSS = {"max_num_neighbors": 256, "max_n_objects": 2048}
# tc.yml's widths with four condensation layers (skip2 takes an even count)
VAR_TCN = {"node_indim": NODE_DIM, "edge_indim": EDGE_DIM, "h_dim": 64, "e_dim": 64, "h_outdim": 8,
           "hidden_dim": 128, "L_hc": 4}
VAR_BN_RESIN = {"node_dim": 64, "edge_dim": 64, "object_hidden_dim": 128, "relational_hidden_dim": 128,
                "n_layers": 4, "residual_type": "skip2", "add_bn": True}
# the JAX PointCloudTCN's defaults (reference tcn.py:69-115)
VAR_PC_MODEL = {"node_indim": NODE_DIM, "h_dim": 10, "e_dim": 10, "h_outdim": 5, "hidden_dim": 100,
                "N_blocks": 3, "L": 3}
# ml.yml's widths in the heterogeneous encoder form, and an MLP edge filter on the built graph
VAR_GC_ML = {"in_dim": NODE_DIM, "hidden_dim_enc": 256, "hidden_dim": 256, "out_dim": 8, "depth_enc": 2,
             "depth": 5}
VAR_GC_EF = {"node_indim": NODE_DIM, "edge_indim": 2 * NODE_DIM, "hidden_dim": 128, "depth": 3}
VAR_GC = {"max_num_neighbors": 64, "max_radius": 1.0}
VAR_GC_RESIN = {"node_indim": NODE_DIM, "edge_indim": 2 * NODE_DIM, "h_outdim": 8, "hidden_dim": 40,
                "n_layers": 2}
VAR_ML_STEPS = 5
#: the kernels of phase 13's path, by the module attribute that launches each
VARIANT_KERNELS = {
    "fused_relational_fwd": ("fused_relational", "fused_relational_fwd"),
    "fused_relational_bwd": ("fused_relational", "fused_relational_bwd"),
    "sorted_segment_sum": ("csr_segment", "sorted_segment_sum"),
    "sorted_gather": ("csr_segment", "sorted_gather"),
    "pairwise_topk_filter": ("pairwise_topk", "pairwise_topk_filter"),
    "pairwise_topk": ("pairwise_topk", "pairwise_topk"),
    "cc_neighbors": ("cc_kernel", "cc_neighbors"),
}


def max_rel(a, b) -> float:
    """``max |a - b|`` over ``max |b|``."""
    return (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)


def hetero_layers(x):
    """Detector layers of ``make_point_cloud``'s hits from their radius:
    the barrel's 16 radii as layers 0, 2, ..., 30, so that layers from 18
    on are strips (``mlp.get_pixel_mask``)."""
    import torch

    r = np.hypot(x[:, 0], x[:, 1])
    return torch.from_numpy(2 * np.abs(r[:, None] - LAYER_RADII[None, :]).argmin(axis=1)).to(torch.int32)


def variants_phase(seed: int) -> dict:
    """Phase 13 (see the module docstring). Returns the launches of
    ``VARIANT_KERNELS`` on the phase's path (each stage's counts set to 0
    just before it and read just after; the step-0 comparisons with the
    plain path and the plain path's own steps are not counted) and the
    phase's summary."""
    import importlib

    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.inference import TrackingPredictor
    from gnn_tracking_tpu_torch.losses.ec import EdgeWeightFocalLoss
    from gnn_tracking_tpu_torch.losses.metric_learning import GraphConstructionHingeEmbeddingLoss
    from gnn_tracking_tpu_torch.losses.oc import CondensationLossRG, CondensationLossTiger
    from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
    from gnn_tracking_tpu_torch.models.edge_filter import EFMLP
    from gnn_tracking_tpu_torch.models.graph_construction import (
        GraphConstructionHeteroEncResFCNN,
        GraphConstructionResIN,
        MLGraphConstruction,
    )
    from gnn_tracking_tpu_torch.models.resin import ResIN
    from gnn_tracking_tpu_torch.models.track_condensation_networks import (
        GraphTCN,
        ModularGraphTCN,
        PerfectECGraphTCN,
        PointCloudTCN,
    )
    from gnn_tracking_tpu_torch.ops import knn
    from gnn_tracking_tpu_torch.ops.dbscan import dbscan
    from gnn_tracking_tpu_torch.training.module import ECModule, MLModule, TCModule

    ops = {name: importlib.import_module(f"gnn_tracking_tpu_torch.ops.{name}")
           for name in {m for m, _ in VARIANT_KERNELS.values()}}
    path_launches = dict.fromkeys(VARIANT_KERNELS, 0)

    def on_path(fn):
        """``fn()`` as a stage of the path: its launches, counted from 0 and
        added to the path's."""
        for m, f in VARIANT_KERNELS.values():
            getattr(ops[m], f).launches = 0
        out = fn()
        torch.cuda.synchronize()
        launched = {k: getattr(ops[m], f).launches for k, (m, f) in VARIANT_KERNELS.items()}
        for k, n in launched.items():
            path_launches[k] += n
        return out, launched

    def sync() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    def step0(module, g):
        """Outputs, loss and parameter gradients of one training step's
        forward and backward (no optimizer step)."""
        model = module.model
        model.train()
        model.zero_grad(set_to_none=True)
        out, data = module.apply_model(g)
        loss, _ = module.get_losses(out, data)
        loss.backward()
        grads = {n: None if p.grad is None else p.grad.detach().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        outs = {k: v.detach().clone() for k, v in out.items() if isinstance(v, torch.Tensor)}
        return outs, loss.item(), grads

    def step0_f64(module, state, g):
        """Step 0's parameter gradients of a float64 copy of ``module``'s
        model (at ``state``) on ``g`` in float64."""
        model = copy.deepcopy(module.model)
        model.load_state_dict(state)
        model.double().train()
        g64 = g.to(g.device, dtype=torch.float64)
        out = model(g64)
        loss, _ = module.get_losses(out, g64)
        loss.backward()
        return {n: None if p.grad is None else p.grad.detach().float() for n, p in model.named_parameters()}

    def held_to_plain(what, make_module, g, *, out_keys, bn=False):
        """Step 0 through the kernels against the plain path, from the same
        weights (and running averages): the forward outputs ``out_keys``
        within 1e-4 of their largest magnitude, the loss within 1e-5
        relative, the gradients by ``compare_grads``. With ``bn``, both
        start again from the same state and take 2 optimizer steps (the
        kernels' on the path), then the running averages and the eval-mode
        outputs are held to the plain path's. Returns the summary."""
        kernel, plain = make_module(), make_module()
        plain.model.load_state_dict(kernel.model.state_dict())
        init = {k: v.clone() for k, v in kernel.model.state_dict().items()}
        ok, lk, gk = step0(kernel, g)
        with plain_path():
            op, lp, gp = step0(plain, g)
        out_rel = {k: max_rel(ok[k], op[k]) for k in out_keys}
        assert all(v <= 1e-4 for v in out_rel.values()), f"{what}: outputs against the plain path {out_rel}"
        assert abs(lk - lp) <= 1e-5 * abs(lp), f"{what}: loss {lk} against the plain path's {lp}"
        if bn:
            # the batch norms' backward subtracts the batch means of its
            # cotangents: the f32 rounding of either path is amplified there,
            # so both are held to a float64 evaluation instead (as phase 3
            # holds row #1; compare_grads_f64)
            with plain_path():
                g64 = step0_f64(plain, init, g)
            worst_name, worst, at_floor, no_grad = compare_grads_f64(gk, gp, g64)
        else:
            worst_name, worst, at_floor, no_grad, _ = compare_grads(gk, gp)
        summary = {"loss": lk, "outputs_rel": out_rel, "grad_worst": worst, "grad_worst_name": worst_name,
                   "grads_at_floor": at_floor, "no_grad": len(no_grad)}
        if bn:
            for m in (kernel, plain):
                m.model.load_state_dict(init)
            # before each step the plain path takes the kernels' weights (its
            # running averages stay its own): Adam moves a weight whose
            # gradient is rounding noise by a whole step, so two paths'
            # own weights part after one step, and their statistics with them
            two_steps_s = 0.0
            for _ in range(2):
                with torch.no_grad():
                    weights = dict(kernel.model.named_parameters())
                    for n, p in plain.model.named_parameters():
                        p.copy_(weights[n])
                t0 = sync()
                on_path(lambda: kernel.training_step(g))
                two_steps_s += sync() - t0
                with plain_path():
                    plain.training_step(g)
            summary["two_steps_s"] = two_steps_s
            stats_k = {k: v for k, v in kernel.model.state_dict().items() if k.endswith((".mean", ".var"))}
            stats_p = plain.model.state_dict()
            assert stats_k, f"{what}: no running averages"
            stats_rel = {k: max_rel(v, stats_p[k]) for k, v in stats_k.items()}
            moved = sum(not torch.equal(v, init[k]) for k, v in stats_k.items())
            assert moved == len(stats_k), f"{what}: {len(stats_k) - moved} running averages never moved"
            assert max(stats_rel.values()) <= 1e-4, f"{what}: running averages against the plain path {stats_rel}"
            # eval mode (the running averages) through the kernels and the
            # plain path, on the kernels' trained weights: after Adam's first
            # steps the two paths' weights differ by whole steps where a
            # gradient is rounding noise (a bias that a batch norm removes in
            # training, but not in eval mode)
            with torch.no_grad():
                kernel.model.eval()
                ek = kernel.model(g)
                with plain_path():
                    ep = kernel.model(g)
            eval_rel = {k: max_rel(ek[k], ep[k]) for k in out_keys}
            assert all(v <= 1e-4 for v in eval_rel.values()), f"{what}: eval outputs {eval_rel}"
            summary |= {"running_averages": len(stats_k), "running_averages_rel": max(stats_rel.values()),
                        "eval_outputs_rel": eval_rel}
        log(f"variants (b) {what}: step 0 against the plain path: outputs {out_rel}, loss {lk:.6f} "
            f"(plain {lp:.6f}), gradients worst {worst_name} {worst:.3e} relative (at the floor only, or with "
            f"float64 ill-conditioned: "
            f"{at_floor or 'none'})" + (f"; after 2 steps {summary['running_averages']} running averages within "
                                         f"{summary['running_averages_rel']:.3e} of the plain path's, eval "
                                         f"outputs {summary['eval_outputs_rel']}" if bn else ""))
        return summary

    t_phase = sync()
    dev = torch.device("cuda")
    summary: dict = {}
    part_s: dict = {}

    # ---- (a) the radius-graph condensation loss on the serving GraphTCN
    t_part = sync()
    g = EventGraph.from_arrays(**make_train_event(seed + 800)).sort_edges_by_target().to(dev)
    rg_model = GraphTCN(**MODEL, device="cpu", generator=torch.Generator().manual_seed(seed + 801))
    rg = TCModule(model=rg_model, loss_fct=CondensationLossRG(**VAR_RG_LOSS), lr=LR, device="cuda")
    rg.setup_params(g)
    threshold = calibrate_ec_threshold(rg_model, g)
    probe = TCModule(model=copy.deepcopy(rg_model), loss_fct=CondensationLossRG(**VAR_RG_LOSS), lr=LR,
                     device="cuda")
    ok, lk, gk = step0(probe, g)
    with plain_path():
        op, lp, gp = step0(probe, g)
    del probe
    worst_name, worst, at_floor, no_grad, _ = compare_grads(gk, gp)
    assert abs(lk - lp) <= 1e-5 * abs(lp), f"RG loss step 0: {lk} against the plain path's {lp}"
    h_out = ok["H"].float().contiguous()
    edge_index, edge_mask, _ = knn.radius_graph(h_out, 1.0, max_num_neighbors=VAR_RG_LOSS["max_num_neighbors"],
                                                node_mask=g.node_mask)
    rg_edges = int(edge_mask.sum())
    rg_full_rows = int((edge_mask.view(-1, VAR_RG_LOSS["max_num_neighbors"]).all(dim=1)).sum())
    for _ in range(2):
        rg.training_step(g)
    t0 = sync()
    rg_metrics, rg_launches = on_path(lambda: [rg.training_step(g) for _ in range(VAR_STEPS)])
    rg_dt = sync() - t0
    metrics = rg_metrics[-1]
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    assert rg_launches["pairwise_topk_filter"] == VAR_STEPS, f"RG loss: row #12 launched {rg_launches}"
    rg_split = step_split(rg, g)
    with torch.no_grad():
        h_now = rg_model(g)["H"].float().contiguous()
    radius_ms = host_ms(lambda: knn.radius_graph(h_now, 1.0, max_num_neighbors=VAR_RG_LOSS["max_num_neighbors"],
                                                 node_mask=g.node_mask))
    part_s["a_rg_loss"] = sync() - t_part
    summary["rg_loss"] = {
        "step0_loss": lk, "step0_plain_loss": lp, "grad_worst": worst, "grad_worst_name": worst_name,
        "grads_at_floor": at_floor, "ec_no_grad": len(no_grad), "ec_threshold": threshold,
        "radius_edges_step0": rg_edges, "full_rows_step0": rg_full_rows, "steps": VAR_STEPS,
        "steps_per_s": VAR_STEPS / rg_dt, "step_ms": rg_dt / VAR_STEPS * 1e3, **rg_split,
        "radius_graph_ms": radius_ms, "launches_per_step": {k: v / VAR_STEPS for k, v in rg_launches.items()},
        "total": metrics["total"], "repulsive": metrics["repulsive"],
    }
    log(f"variants (a): CondensationLossRG({VAR_RG_LOSS}) on the GraphTCN: step 0 loss {lk:.6f} (plain "
        f"{lp:.6f}), gradients worst {worst_name} {worst:.3e} relative (at the floor only: {at_floor or 'none'}), "
        f"{len(no_grad)} EC parameters without gradient; the radius graph at step 0 {rg_edges} edges, "
        f"{rg_full_rows} full rows; {VAR_STEPS} steps {rg_dt / VAR_STEPS * 1e3:.2f} ms a step, split {rg_split}, "
        f"the loss's radius graph {radius_ms:.3f} ms alone")

    # ---- (b) the residual variants, each held to the plain path
    t_part = sync()
    g_b = EventGraph.from_arrays(**make_train_event(seed + 810)).sort_edges_by_target().to(dev)
    variants = {}

    def tc_module(model_fn):
        return lambda: TCModule(model=model_fn(), loss_fct=CondensationLossTiger(**LOSS), lr=LR, device="cuda")

    for compat in (False, True):
        name = f"PerfectECGraphTCN skip2{' compat_overlap' if compat else ''}"
        variants[name] = held_to_plain(name, tc_module(lambda c=compat: PerfectECGraphTCN(
            **VAR_TCN, residual_type="skip2", compat_overlap=c, device="cpu",
            generator=torch.Generator().manual_seed(seed + 811))), g_b, out_keys=("H", "B"))
    variants["ECForGraphTCN skip_top"] = held_to_plain(
        "ECForGraphTCN skip_top",
        lambda: ECModule(model=ECForGraphTCN(**EC_MODEL, residual_type="skip_top", device="cpu",
                                             generator=torch.Generator().manual_seed(seed + 812)),
                         loss_fct=EdgeWeightFocalLoss(**EC_LOSS), lr=LR, device="cuda"),
        g_b, out_keys=("W",))
    variants["ModularGraphTCN skip2 add_bn"] = held_to_plain(
        "ModularGraphTCN skip2 add_bn",
        tc_module(lambda: ModularGraphTCN(
            ResIN(**VAR_BN_RESIN, generator=torch.Generator().manual_seed(seed + 813)), None, NODE_DIM, EDGE_DIM,
            h_dim=VAR_BN_RESIN["node_dim"], e_dim=VAR_BN_RESIN["edge_dim"], h_outdim=8,
            hidden_dim=VAR_BN_RESIN["object_hidden_dim"], device="cpu",
            generator=torch.Generator().manual_seed(seed + 814))),
        g_b, out_keys=("H", "B"), bn=True)
    part_s["b_residual_variants"] = sync() - t_part
    summary["residual_variants"] = variants

    # ---- (c) PointCloudTCN on point clouds: rows #13, #1 / #2, #9 / #10; DBSCAN on its H
    t_part = sync()
    pc = make_point_cloud(seed + 820, ML_HITS, ML_PARTICLES)
    cloud = EventGraph.from_arrays(x=pc["x"], edge_index=pc["edge_index"], particle_id=pc["particle_id"],
                                   pt=pc["pt"], eta=pc["eta"], reconstructable=pc["reconstructable"])
    cloud = cloud.sort_edges_by_target().to(dev)
    pc_model = PointCloudTCN(**VAR_PC_MODEL, device="cpu", generator=torch.Generator().manual_seed(seed + 821))
    pc_module = TCModule(model=pc_model, loss_fct=CondensationLossTiger(**LOSS), lr=LR, device="cuda")
    pc_module.setup_params(cloud)
    probe = TCModule(model=copy.deepcopy(pc_model), loss_fct=CondensationLossTiger(**LOSS), lr=LR, device="cuda")
    pc_init = {k: v.clone() for k, v in probe.model.state_dict().items()}
    replay = TopkReplay()
    with replay.record():
        ok, lk, gk = step0(probe, cloud)
    with plain_path(), replay.replay():
        op, lp, gp = step0(probe, cloud)
    # twelve message-passing layers: some gradients are 1e-6 of the whole
    # and carry f32 rounding of its size, so both f32 paths are held to a
    # float64 evaluation (on the same neighbour choice)
    with plain_path(), replay.replay():
        g64 = step0_f64(probe, pc_init, cloud)
    # the random model's latent is collapsed (one cluster at eps 0.3), which
    # leaves most of the loss's gradients ill-conditioned in f32; those of a
    # fixed random projection of H and B are not, and hold the backward of
    # every layer (held to float64 as above: twelve layers of ReLUs with
    # pre-activations near 0 on the collapsed latent, where either f32 path
    # flips some of their masks)
    proj_rng = torch.Generator(device=dev).manual_seed(seed + 822)
    w_h = torch.randn(ok["H"].shape, generator=proj_rng, device=dev)
    w_b = torch.randn(ok["B"].shape, generator=proj_rng, device=dev)

    def projection_grads(dtype=torch.float32):
        model = copy.deepcopy(probe.model)
        model.load_state_dict(pc_init)
        model.to(dtype).train()
        out = model(cloud.to(dev, dtype=dtype))
        ((out["H"] * w_h.to(dtype)).sum() + (out["B"] * w_b.to(dtype)).sum()).backward()
        return {n: p.grad.detach().float() for n, p in model.named_parameters()}

    proj_replay = TopkReplay()
    with proj_replay.record():
        proj_k = projection_grads()
    with plain_path(), proj_replay.replay():
        proj_p = projection_grads()
    with plain_path(), proj_replay.replay():
        proj_64 = projection_grads(torch.float64)
    proj_worst_name, proj_worst, proj_floor, _ = compare_grads_f64(proj_k, proj_p, proj_64)
    del probe
    pc_knn = replay.check()
    assert pc_knn["calls"] == 4 and proj_replay.check()["calls"] == 4, pc_knn
    pc_out_rel = {k: max_rel(ok[k], op[k]) for k in ("H", "B")}
    assert all(v <= 1e-4 for v in pc_out_rel.values()), f"PointCloudTCN outputs against the plain path {pc_out_rel}"
    assert abs(lk - lp) <= 1e-5 * abs(lp), f"PointCloudTCN step 0: {lk} against the plain path's {lp}"
    pc_worst_name, pc_worst, pc_floor, pc_no_grad = compare_grads_f64(gk, gp, g64)
    assert not pc_no_grad, pc_no_grad
    for _ in range(2):
        pc_module.training_step(cloud)
    t0 = sync()
    pc_all, pc_launches = on_path(lambda: [pc_module.training_step(cloud) for _ in range(VAR_STEPS)])
    pc_dt = sync() - t0
    pc_metrics = pc_all[-1]
    assert all(math.isfinite(v) for v in pc_metrics.values()), pc_metrics
    # 4 blocks a forward, each one kNN (row #13 at k <= knn.SPLIT_MAX_K)
    assert pc_launches["pairwise_topk"] == 4 * VAR_STEPS, f"PointCloudTCN: row #13 launched {pc_launches}"
    pc_split = step_split(pc_module, cloud)
    # DBSCAN at the serving eps and cap on the trained H: through the
    # kernels (served) and, on the same H, through the plain path
    pc_model.eval()
    with torch.no_grad():
        h_pc = pc_model(cloud)["H"].float().contiguous()
    eps_pc = EPS
    predictor = TrackingPredictor(pc_model, eps=eps_pc, min_samples=MIN_SAMPLES, max_num_neighbors=CAP,
                                  device="cuda")
    served, serve_launches = on_path(lambda: predictor.predict(cloud))
    assert serve_launches["pairwise_topk_filter"] > 0 and serve_launches["cc_neighbors"] > 0, serve_launches
    with torch.no_grad():
        labels_k = dbscan(h_pc, eps=eps_pc, min_samples=MIN_SAMPLES, max_num_neighbors=CAP)
        with plain_path():
            labels_p = dbscan(h_pc, eps=eps_pc, min_samples=MIN_SAMPLES, max_num_neighbors=CAP)
    assert torch.equal(labels_k, labels_p), "PointCloudTCN: DBSCAN labels differ from the plain path's"
    assert np.array_equal(served["labels"], labels_k.cpu().numpy()), "PointCloudTCN: served labels differ"
    n_clusters = int(labels_k.max()) + 1
    # the trained H is one cluster: DBSCAN again with each hit moved to its
    # particle's unit-normal centre plus 0.02 of H (as phase 12 does)
    centres = torch.randn((ML_PARTICLES, h_pc.shape[1]), generator=proj_rng, device=dev)
    pid = cloud.particle_id.long()
    structured = torch.where((pid > 0)[:, None], centres[pid], cloud.x[:, 6 : 6 + h_pc.shape[1]]) + 0.02 * h_pc
    with torch.no_grad():
        (labels_s, s_launches) = on_path(lambda: dbscan(structured.contiguous(), eps=EPS, min_samples=MIN_SAMPLES,
                                                        max_num_neighbors=CAP))
        with plain_path():
            labels_sp = dbscan(structured.contiguous(), eps=EPS, min_samples=MIN_SAMPLES, max_num_neighbors=CAP)
    assert torch.equal(labels_s, labels_sp), "PointCloudTCN: structured DBSCAN labels differ from the plain path's"
    structured_clusters = int(labels_s.max()) + 1
    assert structured_clusters > ML_PARTICLES // 2, f"{structured_clusters} clusters of the structured latent"
    part_s["c_point_cloud_tcn"] = sync() - t_part
    summary["point_cloud_tcn"] = {
        "step0_loss": lk, "step0_plain_loss": lp, "outputs_rel": pc_out_rel, "grad_worst": pc_worst,
        "grad_worst_name": pc_worst_name, "grads_at_floor": pc_floor, "steps": VAR_STEPS,
        "steps_per_s": VAR_STEPS / pc_dt, "step_ms": pc_dt / VAR_STEPS * 1e3, **pc_split,
        "launches_per_step": {k: v / VAR_STEPS for k, v in pc_launches.items()}, "total": pc_metrics["total"],
        "dbscan_eps": eps_pc, "clusters": n_clusters, "step0_knn": pc_knn,
        "projection_grad_worst": proj_worst, "projection_grad_worst_name": proj_worst_name,
        "projection_grads_at_floor": proj_floor, "structured_clusters": structured_clusters,
    }
    log(f"variants (c): PointCloudTCN({VAR_PC_MODEL}) on {ML_HITS} hits: step 0 outputs {pc_out_rel}, loss "
        f"{lk:.6f} (plain {lp:.6f}), gradients worst {pc_worst_name} {pc_worst:.3e} against float64 (ill-conditioned in f32: "
        f"{pc_floor or 'none'}, kernel / plain error against float64 of its norm; one neighbour choice on both paths, row #13 against its plain version {pc_knn}); {VAR_STEPS} steps {pc_dt / VAR_STEPS * 1e3:.2f} ms a step, split {pc_split}; "
        f"DBSCAN at eps {eps_pc:.4g}: {n_clusters} clusters, labels equal to the plain path's; "
        f"gradients of a random projection of H and B worst {proj_worst_name} {proj_worst:.3e} against float64 "
        f"(ill-conditioned in f32: {proj_floor or 'none'}); the particle-structured latent {structured_clusters} clusters, "
        f"labels equal to the plain path's")

    # ---- (d) graph construction: hetero embedding, edge filter, ResIN refinement, ML steps
    t_part = sync()
    pcs = [make_point_cloud(seed + 830 + i, ML_HITS, ML_PARTICLES) for i in range(2)]
    clouds = []
    for p in pcs:
        c = EventGraph.from_arrays(x=p["x"], edge_index=p["edge_index"], particle_id=p["particle_id"], pt=p["pt"],
                                   eta=p["eta"], reconstructable=p["reconstructable"])
        clouds.append(c.replace(layer=hetero_layers(p["x"])).to(dev))
    ml = GraphConstructionHeteroEncResFCNN(**VAR_GC_ML, device="cuda",
                                           generator=torch.Generator().manual_seed(seed + 831))
    ef = EFMLP(**VAR_GC_EF, device="cuda", generator=torch.Generator().manual_seed(seed + 832))
    k = VAR_GC["max_num_neighbors"]
    with torch.no_grad():
        unfiltered = MLGraphConstruction(ml, **VAR_GC).eval()(clouds[0])
        with plain_path():
            plain_unfiltered = MLGraphConstruction(ml, **VAR_GC).eval()(clouds[0])
        w = torch.sort(ef(unfiltered)["W"][unfiltered.edge_mask]).values
        lo, hi = int(0.45 * len(w)), int(0.55 * len(w))
        i = lo + int(torch.argmax(w[lo + 1 : hi + 1] - w[lo:hi]))
        ef_threshold = float((w[i] + w[i + 1]) / 2)  # mid-gap near the median: an active cut
        gc = MLGraphConstruction(ml, ef, ec_threshold=ef_threshold, **VAR_GC).eval()
        built, build_launches = on_path(lambda: gc(clouds[0]))
        build_ms = host_ms(lambda: gc(clouds[0]))
        with plain_path():
            plain_built = gc(clouds[0])
        h = ml(clouds[0])["H"]

    def with_dists(graph, mask):
        src, dst = graph.edge_index.long()
        return graph.edge_index, mask, (h[src] - h[dst]).norm(dim=1)

    assert build_launches["pairwise_topk_filter"] == 1, f"graph construction: row #12 launched {build_launches}"
    gc_ties = compare_neighbours("graph construction (kNN)", with_dists(unfiltered, unfiltered.edge_mask),
                                 with_dists(plain_unfiltered, plain_unfiltered.edge_mask), k)
    assert torch.equal(built.edge_index, unfiltered.edge_index) and torch.equal(
        plain_built.edge_index, plain_unfiltered.edge_index), "the edge filter moved edges"
    # the filter's cut on every row whose neighbour set is the plain path's
    n = built.num_nodes
    same = (torch.sort(built.edge_index[0].view(n, k), dim=1).values
            == torch.sort(plain_built.edge_index[0].view(n, k), dim=1).values).all(dim=1)
    kept_k = torch.sort(torch.where(built.edge_mask, built.edge_index[0], -1).view(n, k), dim=1).values
    kept_p = torch.sort(torch.where(plain_built.edge_mask, plain_built.edge_index[0], -1).view(n, k), dim=1).values
    mask_rows_differ = int(((kept_k != kept_p).any(dim=1) & same).sum())
    assert mask_rows_differ == 0, f"graph construction: the edge filter keeps other edges on {mask_rows_differ} rows"
    kept, before = int(built.edge_mask.sum()), int(unfiltered.edge_mask.sum())
    assert 0 < kept < before, (kept, before)
    # GraphConstructionResIN over the built graph: rows #1 / #9 (forward)
    refine = GraphConstructionResIN(**VAR_GC_RESIN, device="cuda", generator=torch.Generator().manual_seed(seed + 833))
    sorted_graph = built.sort_edges_by_target()
    with torch.no_grad():
        refined, refine_launches = on_path(lambda: refine(sorted_graph)["H"])
        with plain_path():
            refined_plain = refine(sorted_graph)["H"]
    with torch.no_grad():
        refine_ms = host_ms(lambda: refine(sorted_graph))
    refine_rel = max_rel(refined, refined_plain)
    assert refine_rel <= 1e-4, f"GraphConstructionResIN against the plain path: {refine_rel}"
    assert refine_launches["fused_relational_fwd"] == VAR_GC_RESIN["n_layers"], refine_launches
    # MLModule steps of the hetero embedding with the hinge loss (row #12 at k = 256)
    ml_module = MLModule(model=copy.deepcopy(ml), loss_fct=GraphConstructionHingeEmbeddingLoss(**ML_LOSS), lr=LR,
                         device="cuda")
    replay = TopkReplay()
    with replay.record():
        ok, lk, gk = step0(ml_module, clouds[1])
    with plain_path(), replay.replay():
        op, lp, gp = step0(ml_module, clouds[1])
    ml_knn = replay.check()
    ml_worst_name, ml_worst, ml_floor, _, _ = compare_grads(gk, gp)
    assert abs(lk - lp) <= 1e-5 * abs(lp), f"hetero ML step 0: {lk} against the plain path's {lp}"
    t0 = sync()
    ml_all, ml_launches = on_path(lambda: [ml_module.training_step(clouds[1]) for _ in range(VAR_ML_STEPS)])
    ml_dt = sync() - t0
    ml_metrics = ml_all[-1]
    assert ml_launches["pairwise_topk_filter"] == VAR_ML_STEPS, f"hetero ML: row #12 launched {ml_launches}"
    assert all(math.isfinite(v) for v in ml_metrics.values()), ml_metrics
    pixel = float((clouds[1].layer < 18).float().mean())
    part_s["d_graph_construction"] = sync() - t_part
    summary["graph_construction"] = {
        "k": k, "build_ms": build_ms, "tie_rows": gc_ties, "edges_before_filter": before, "edges_kept": kept,
        "ef_threshold": ef_threshold, "refine_rel": refine_rel, "refine_ms": refine_ms, "ml_step0_loss": lk, "ml_grad_worst": ml_worst,
        "ml_grad_worst_name": ml_worst_name, "ml_grads_at_floor": ml_floor, "ml_steps": VAR_ML_STEPS,
        "ml_step_ms": ml_dt / VAR_ML_STEPS * 1e3, "pixel_share": pixel, "ml_step0_radius_graph": ml_knn,
    }
    log(f"variants (d): MLGraphConstruction(GraphConstructionHeteroEncResFCNN, EFMLP, k {k}) on {ML_HITS} hits "
        f"({pixel:.3f} pixel): {build_ms:.2f} ms a build (median of 5), the kNN graph equal to the plain path's up to {gc_ties} "
        f"tie rows, the filter at {ef_threshold:.6f} keeps {kept} of {before} edges as on the plain path; "
        f"GraphConstructionResIN {refine_ms:.2f} ms a forward, within {refine_rel:.3e} of the plain path's; hetero ML step 0 gradients worst "
        f"{ml_worst_name} {ml_worst:.3e} (at the floor only: {ml_floor or 'none'}), {VAR_ML_STEPS} steps "
        f"{ml_dt / VAR_ML_STEPS * 1e3:.2f} ms a step")

    for name, n_launch in path_launches.items():
        assert n_launch > 0, f"phase 13's path never launched {name}"
    summary |= {"phase_s": sync() - t_phase, "part_s": part_s, "launches": path_launches}
    log("variants: " + json.dumps(summary))
    return summary


# the offline ETL at a full TrackML event's size (phase 14)
ETL_COPIES = 20  # the vendored event is a 1/20 sample of a TrackML event (~110k hits)
# nonzero particle ids of copy c: + c * (2^58 + 1). The vendored ids reach 8.7e17 (2^59.6), and some
# differ by a multiple of 2^58, so c * 2^58 would make 168 of them collide; the odd stride does not,
# and a float64 parse of the offset ids merges 168 particles
ETL_PID_STRIDE = (1 << 58) + 1
ETL_SECTORS = (1, 32)
ETL_CSVS = ("detectors.csv.gz", "event000000001-cells.csv.gz", "event000000001-hits.csv.gz",
            "event000000001-particles.csv.gz", "event000000001-truth.csv.gz")
# H100 SXM data sheet: FP64 outside the tensor cores
PEAK_F64_FLOPS = 33.5e12
#: the cut's float64 operations in csrc/edge_join.cu, counted from its source: a candidate pair's
#: slope cut (2 subtractions, 2 wrap compares, a division, a compare), then on the pairs that pass
#: the z0 cut (a subtraction, a product, a division, a subtraction, a compare), the dR cut (a
#: subtraction, 2 products, a sum, a square root, a compare) and the intersecting-line cut (a
#: product, a division, a sum, 2 compares); a hit's eta (atan2, a division, tan, log, a negation)
EDGE_JOIN_OPS = {"pairs": 6, "slope": 5, "z0": 6, "intersect": 5, "hits": 5}
#: the served path's kernels (phase 11's) on the built graphs
ETL_SERVE_KERNELS = TC_CLI_KERNELS


def write_csv(path: Path, table: dict) -> None:
    """A table (dict of numpy columns) as a gzipped CSV; floats in their
    shortest round-trip text, so that a correctly rounded parse returns
    their bits."""
    import gzip

    cols = [v.astype(str) for v in table.values()]
    with gzip.open(path, "wt", compresslevel=1) as f:
        f.write(",".join(table) + "\n")
        f.write("\n".join(",".join(row) for row in zip(*cols)) + "\n")


def make_pileup(seed: int, src: Path, dst: Path, copies: int = ETL_COPIES) -> dict:
    """etl-trackml-110k: ``copies`` copies of the vendored event in one
    event (``event000000002``), each rotated in phi by a seeded angle (hits,
    truth positions and momenta, particle vertices and momenta alike), hit
    ids offset a copy (cells follow their hits), nonzero particle ids offset
    by ``c * ETL_PID_STRIDE`` (past 2^53: a float64 parse would merge
    particles), module ids unchanged. Returns the row counts."""
    from gnn_tracking_tpu_torch.utils.csv_io import read_csv

    rng = np.random.default_rng(seed + 2000)
    angles = rng.uniform(0, 2 * np.pi, copies)
    dst.mkdir(parents=True, exist_ok=True)
    tables = {k: read_csv(src / f"event000000001-{k}.csv.gz") for k in ("hits", "cells", "truth", "particles")}
    stride = int(tables["hits"]["hit_id"].max()) + 1

    def rotated(t, c, pairs):
        out = dict(t)
        cos, sin = math.cos(angles[c]), math.sin(angles[c])
        for a, b in pairs:
            out[a] = t[a] * cos - t[b] * sin
            out[b] = t[a] * sin + t[b] * cos
        return out

    merged = {k: [] for k in tables}
    for c in range(copies):
        hits = rotated(tables["hits"], c, [("x", "y")])
        truth = rotated(tables["truth"], c, [("tx", "ty"), ("tpx", "tpy")])
        particles = rotated(tables["particles"], c, [("vx", "vy"), ("px", "py")])
        cells = dict(tables["cells"])
        for t in (hits, truth, cells):
            t["hit_id"] = t["hit_id"] + c * stride
        truth["particle_id"] = np.where(truth["particle_id"] != 0, truth["particle_id"] + c * ETL_PID_STRIDE, 0)
        particles["particle_id"] = particles["particle_id"] + c * ETL_PID_STRIDE
        for k, t in (("hits", hits), ("truth", truth), ("particles", particles), ("cells", cells)):
            merged[k].append(t)
    rows = {}
    for k, parts in merged.items():
        table = {col: np.concatenate([p[col] for p in parts]) for col in parts[0]}
        write_csv(dst / f"event000000002-{k}.csv.gz", table)
        rows[k] = len(next(iter(table.values())))
    shutil.copy(src / "detectors.csv.gz", dst / "detectors.csv.gz")
    pids = np.concatenate([p["particle_id"] for p in merged["particles"]])
    assert len(np.unique(pids)) == len(pids), "the copies' particle ids collide"
    assert len(np.unique(pids.astype(np.float64))) < len(pids), "a float64 parse must merge particles"
    return rows


def edge_join_bound(stats: dict, n_hits: int) -> tuple[float, str, float, float]:
    """The least time of one join: its float64 operations (``EDGE_JOIN_OPS``
    on this input's work, ``edge_join_plain``'s ``stats``) at the FP64 peak,
    or its bytes (r, phi, z and the layer of every hit in, 48 bytes an edge
    out) at the memory rate, whichever is larger."""
    ops = sum(EDGE_JOIN_OPS[k] * (n_hits if k == "hits" else stats[k]) for k in EDGE_JOIN_OPS)
    nbytes = 16 * n_hits + 48 * stats["edges"]
    t_ops, t_bytes = ops / PEAK_F64_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", ops, nbytes


def etl_phase(seed: int, tmp: Path) -> dict:
    """Phase 14 (see the module docstring). Returns the kernels line's entry
    for ``edge_join`` (its launches those of ``build_graphs.main`` over the
    four point-cloud directories, counts set to 0 just before and read just
    after), the served path's launches and the phase's summary."""
    import importlib

    import torch

    from gnn_tracking_tpu_torch.graph_construction import build_graphs
    from gnn_tracking_tpu_torch.graph_construction.graph_builder import GraphBuilder
    from gnn_tracking_tpu_torch.inference import TrackingPredictor
    from gnn_tracking_tpu_torch.ops import edge_join as ej
    from gnn_tracking_tpu_torch.preprocessing import build_point_clouds
    from gnn_tracking_tpu_torch.training import run as tc_run
    from gnn_tracking_tpu_torch.utils.loading import load_graph, save_graph

    card = card_line()

    def say(msg: str) -> None:
        log(f"{msg} [{card}]")

    t_phase = time.perf_counter()
    raw = {"vendored": tmp / "etl_raw_vendored", "pileup": tmp / "etl_raw_110k"}
    raw["vendored"].mkdir()
    for name in ETL_CSVS:
        shutil.copy(REPO / "tests" / "test_data" / "trackml" / name, raw["vendored"] / name)
    t0 = time.perf_counter()
    rows = make_pileup(seed, raw["vendored"], raw["pileup"])
    say(f"etl: etl-trackml-110k made in {time.perf_counter() - t0:.2f} s: {rows}")

    # ---- (a) point clouds through the CLI
    summary = {"card": card, "pileup_rows": rows, "point_clouds": {}, "graphs": {}}
    for event, d in raw.items():
        for n_sectors in ETL_SECTORS:
            out = tmp / f"etl_pc_{event}_{n_sectors}"
            t0 = time.perf_counter()
            build_point_clouds.main(["--indir", str(d), "--outdir", str(out), "--detector-config",
                                     str(d / "detectors.csv.gz"), "--n-sectors", str(n_sectors),
                                     "--pixel-only", "--add-true-edges"])
            wall = time.perf_counter() - t0
            files = sorted(out.glob("*.npz"))
            assert len(files) == n_sectors, (event, n_sectors, len(files))
            sizes = []
            for f in files:
                with np.load(f) as pc:
                    assert pc["x"].shape[1] == 14 and np.isfinite(pc["x"]).all(), f
                    assert pc["particle_id"].dtype == np.int64, f
                    sizes.append(int(pc["x"].shape[0]))
            summary["point_clouds"][f"{event}/{n_sectors}"] = {
                "wall_s": wall, "hits_per_sector_mean": statistics.mean(sizes), "hits_per_sector_max": max(sizes)}
            say(f"etl (a): build_point_clouds {event}, {n_sectors} sectors: {wall:.2f} s a file of CSVs, "
                f"{statistics.mean(sizes):.0f} hits a sector (largest {max(sizes)})")
    pixel_hits = summary["point_clouds"]["pileup/1"]["hits_per_sector_max"]
    assert 40_000 < pixel_hits < 70_000, f"the pile-up's pixel hits: {pixel_hits}"

    # ---- (b) graphs through the CLI on the card; edge_join counted at its launches
    ej.edge_join.launches = 0
    for event in raw:
        for n_sectors in ETL_SECTORS:
            pcs, out = tmp / f"etl_pc_{event}_{n_sectors}", tmp / f"etl_graphs_{event}_{n_sectors}"
            t0 = time.perf_counter()
            build_graphs.main(["--indir", str(pcs), "--outdir", str(out), "--device", "cuda"])
            torch.cuda.synchronize()
            summary["graphs"][f"{event}/{n_sectors}"] = {"wall_s_per_event": time.perf_counter() - t0}
    join_launches = ej.edge_join.launches
    assert join_launches == 2 * sum(ETL_SECTORS), f"edge_join launched {join_launches} times"

    # the kernel against its plain version on the card, every point cloud, two configurations
    configs = {"defaults": {}, "two hop": {"remove_intersecting": False, "edge_augmentation": "add_two_hop"}}
    max_err = 0.0
    for event in raw:
        for n_sectors in ETL_SECTORS:
            pcs = tmp / f"etl_pc_{event}_{n_sectors}"
            for cname, kw in configs.items():
                gb = GraphBuilder(pcs, tmp / "etl_unused", device="cuda", **kw)
                n_edges, n_true = 0, 0
                for f in sorted(pcs.glob("*.npz")):
                    pc = load_graph(f, device="cpu")
                    got = gb.join(pc)
                    want = gb.join(pc, join_fn=ej.edge_join_plain)
                    for k in want:
                        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (f, k)
                        if k in ("dr", "dphi", "dz", "dR") and len(want[k]):
                            max_err = max(max_err, float(np.abs(got[k] - want[k]).max()))
                        assert got[k].tobytes() == want[k].tobytes(), f"{f.name} {cname}: {k} differs from plain"
                    y_got = gb.edges_from_join(got, pc)[2]
                    y_want = gb.edges_from_join(want, pc)[2]
                    assert np.array_equal(y_got, y_want), f"{f.name} {cname}: y differs"
                    n_edges += len(y_got)
                    n_true += int(y_got.sum())
                summary["graphs"][f"{event}/{n_sectors}"][f"edges_{cname}"] = n_edges
                say(f"etl (b): {event}, {n_sectors} sectors, {cname}: the kernel's edges, order, y and float64 "
                    f"attributes bitwise the plain version's ({n_edges} directed edges, {n_true} true)")
            with np.load(sorted((tmp / f"etl_graphs_{event}_{n_sectors}").glob("*.npz"))[0]) as g:
                assert g["edge_index"].dtype == np.int32 and g["edge_attr"].dtype == np.float32
                assert np.isfinite(g["edge_attr"]).all() and g["y"].dtype == bool
    for key, v in summary["graphs"].items():
        say(f"etl (b): build_graphs {key} sectors: {v['wall_s_per_event']:.3f} s an event "
            f"({v['edges_defaults']} directed edges)")

    # timing on the full event, one sector: the kernel, on the device, the plain version
    gb = GraphBuilder(tmp / "etl_pc_pileup_1", tmp / "etl_unused", device="cuda")
    pc = load_graph(sorted((tmp / "etl_pc_pileup_1").glob("*.npz"))[0], device="cpu")
    inputs, pairs = gb.join_inputs(pc), gb.layer_pairs()
    kw = {"phi_slope_max": gb.phi_slope_max, "z0_max": gb.z0_max, "dR_max": gb.dR_max}
    stats = {}
    ej.edge_join_plain(*inputs, pairs, stats=stats, **kw)
    ms = cuda_ms(lambda: ej.edge_join(*inputs, pairs, **kw))
    plain_ms = cuda_ms(lambda: ej.edge_join_plain(*inputs, pairs, **kw), reps=1, rounds=3)
    device = device_split(lambda: ej.edge_join(*inputs, pairs, **kw),
                          ["prepare_kernel", "join_kernel<false>", "scan_kernel", "join_kernel<true>"])
    bound_ms, bound_by, ops, nbytes = edge_join_bound(stats, pc.num_nodes)
    # build_graphs' event split into its stages (host clock, the join synchronised)
    stages = {}
    t0 = time.perf_counter()
    joined = gb.join(pc)
    stages["join_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    edges = gb.edges_from_join(joined, pc)
    stages["labels_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = gb.to_graph(pc, *edges[:3])
    stages["to_graph_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_graph(graph, tmp / "etl_split.npz")
    stages["save_s"] = time.perf_counter() - t0
    summary["edge_join"] = {"ms": ms, "device_ms": device, "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "ops": ops, "bytes": nbytes, "work": stats,
                            "hits": pc.num_nodes, "launches": join_launches, "build_split": stages}
    say(f"etl (b): edge_join on etl-trackml-110k (1 sector, {pc.num_nodes} pixel hits): {ms:.4f} ms a call "
        f"(CUDA events, median of 5 rounds of 5), on the device {device} ms; plain {plain_ms:.2f} ms; "
        f"{stats['pairs']} candidate pairs, {stats['slope']} pass the slope cut, {stats['z0']} the z0 cut, "
        f"{stats['edges']} edges; bound {bound_ms:.4f} ms by {bound_by} ({ops:.3e} FP64 operations, "
        f"{nbytes} bytes); {join_launches} launches in build_graphs; the event's build split "
        f"{ {k: round(v, 3) for k, v in stages.items()} } s")

    # ---- (c) the built graphs served: tc.yml's recipe for 2 steps, then predict_dir
    ops_mods = {name: importlib.import_module(f"gnn_tracking_tpu_torch.ops.{name}")
                for name in {m for m, _ in ETL_SERVE_KERNELS.values()}}
    graphs32 = tmp / "etl_graphs_pileup_32"
    config = tc_cli_config(graphs32, graphs32, tmp / "etl_runs")
    config["data"]["init_args"] = {"train": {"dirs": [str(graphs32)], "stop": 2},
                                   "val": {"dirs": [str(graphs32)], "start": 2, "stop": 3}}
    config["trainer"]["max_epochs"] = 1
    for m, f in ETL_SERVE_KERNELS.values():
        getattr(ops_mods[m], f).launches = 0
    t0 = time.perf_counter()
    fit = tc_run.run_command("fit", config, device="cuda")
    fit_s = time.perf_counter() - t0
    best = next((tmp / "etl_runs").rglob("checkpoint_best.pt"))
    predictor = TrackingPredictor(best, device="cuda")
    served = predictor.predict_dir(graphs32, tmp / "etl_labels", evaluate=True)
    serve_launches = {k: getattr(ops_mods[m], f).launches for k, (m, f) in ETL_SERVE_KERNELS.items()}
    assert math.isfinite(fit[f"best_{TC_MONITOR}"]), fit
    for name, n in serve_launches.items():
        assert n > 0, f"the served ETL path never launched {name}"
    with plain_path():
        for f in sorted(graphs32.glob("*.npz")):
            want = predictor.predict(load_graph(f, device="cuda"))
            got = np.load(tmp / "etl_labels" / f"{f.stem}_labels.npz")
            assert np.array_equal(got["labels"], want["labels"]), f"{f.name}: labels differ from the plain path"
    trk = {k: v for k, v in served.items() if k.startswith("trk.")}
    summary.update(fit_s=fit_s, served_events_per_s=served["events_per_s"], served_trk=trk,
                   serve_launches=serve_launches, phase_s=time.perf_counter() - t_phase)
    say(f"etl (c): tc.yml fit on 2 of the 32-sector graphs in {fit_s:.2f} s, predict_dir over the 32: "
        f"{served['events_per_s']:.2f} events/s, labels equal to the plain path's; launches {serve_launches}")
    log("etl: " + json.dumps(summary, default=float))
    entry = {"name": "edge_join", "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None, "launches": join_launches}
    return {"result": entry, "serve_launches": serve_launches, "summary": summary}


# the real-data training drivers (phase 15)
#: the kernels of phase 15's path, by the module attribute that launches each (edge_join: build_data's join)
DRIVER_KERNELS = {
    **TC_CLI_KERNELS,
    "pairwise_topk": ("pairwise_topk", "pairwise_topk"),
    "edge_join": ("edge_join", "edge_join"),
}
#: train_multievent at the accuracy drill's split (16 train, 2 selection, 4 report variants), cut to a few epochs
DRIVER_MULTIEVENT = ["--n-events", "22", "--n-select", "2", "--n-val", "4", "--epochs-ec", "2", "--epochs-tc", "3",
                     "--tc-cosine", "--device", "cuda"]
#: train_trackml's sector split with every stage, cut to a few epochs
DRIVER_TRACKML = ["--n-sectors", "4", "--holdout", "1", "--select-holdout", "1", "--epochs-ec", "2",
                  "--epochs-ml", "2", "--epochs-tc", "2", "--tc-cosine", "--device", "cuda"]
#: rows #1 / #2 at the drivers' widths, (Fx, Fe, H, Fo): the TC recipe's interaction networks
#: (PerfectECGraphTCN h 16, e 16, hidden 48: K = 48) and the EC's (ECForGraphTCN 32, 32, hidden 64: K = 96)
DRIVER_WIDTHS = {"TC (K 48, H 48, Fo 16)": (16, 16, 48, 16), "EC (K 96, H 64, Fo 32)": (32, 32, 64, 32)}
#: trained weights of the drill's TC model (its selected checkpoint, ``params/...`` in JAX's layout), so the
#: served latents form clusters; written by ``tests/drill_parity.py export``
DRIVER_TRAINED = REPO / "tests" / "test_data" / "tc_drill_selected.npz"


def trained_tc_params(path: Path) -> dict:
    """The ``params/...`` entries of ``path`` as a nested tree (``load_jax_params``' input)."""
    tree: dict = {}
    with np.load(path) as f:
        for key in f.files:
            if key.startswith("params/"):
                *parents, leaf = key.split("/")[1:]
                node = tree
                for part in parents:
                    node = node.setdefault(part, {})
                node[leaf] = f[key]
    return tree


@contextlib.contextmanager
def timed_functions(targets: list[tuple], record: dict):
    """Each ``(module, name)`` function replaced by a wrapper that adds its
    synchronised wall time to ``record[name]`` (restored after the block)."""
    import torch

    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def wrap(name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                record[name] = record.get(name, 0.0) + time.perf_counter() - t0
        return timed

    for mod, name, fn in saved:
        setattr(mod, name, wrap(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def drivers_phase(seed: int, tmp: Path) -> dict:
    """Phase 15 (see the module docstring). Returns the launches of
    ``DRIVER_KERNELS`` in the two drivers' ``main`` (counts set to 0 just
    before the first, read just after the second) and the phase's summary."""
    import importlib

    import torch

    from gnn_tracking_tpu_torch.inference import TrackingPredictor
    from gnn_tracking_tpu_torch.losses.ec import EdgeWeightFocalLoss
    from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
    from gnn_tracking_tpu_torch.ops.dbscan import dbscan
    from gnn_tracking_tpu_torch.scripts import train_multievent as me
    from gnn_tracking_tpu_torch.scripts import train_trackml as tt
    from gnn_tracking_tpu_torch.training.module import ECModule
    from gnn_tracking_tpu_torch.training.trainer import Trainer
    from gnn_tracking_tpu_torch.utils.loading import TrackingDataModule, load_graph
    from gnn_tracking_tpu_torch.utils.param_convert import load_jax_params

    card = card_line()

    def say(msg: str) -> None:
        log(f"{msg} [{card}]")

    ops = {name: importlib.import_module(f"gnn_tracking_tpu_torch.ops.{name}")
           for name in {m for m, _ in DRIVER_KERNELS.values()}}

    def counts() -> dict:
        return {k: getattr(ops[m], f).launches for k, (m, f) in DRIVER_KERNELS.items()}

    t_phase = time.perf_counter()
    raw = tmp / "drivers_raw"
    raw.mkdir()
    for name in ETL_CSVS:
        shutil.copy(REPO / "tests" / "test_data" / "trackml" / name, raw / name)

    # ---- both drivers through their main, on the card; the stages timed, the kernels counted
    built = {}
    real_tc_module = me.tc_module

    def tc_module(*args, **kwargs):  # the multievent TC module, kept for the checks below
        built["tc"] = real_tc_module(*args, **kwargs)
        epoch_end = built["tc"].on_validation_epoch_end

        def on_validation_epoch_end():
            foms = epoch_end()
            built.setdefault("foms", []).append(foms)
            return foms

        built["tc"].on_validation_epoch_end = on_validation_epoch_end
        return built["tc"]

    stage_s = {"multievent": {}, "trackml": {}}
    results = {}
    for m, f in DRIVER_KERNELS.values():
        getattr(ops[m], f).launches = 0
    me.tc_module = tc_module
    try:
        with timed_functions([(me, "build_data"), (me, "make_event_dirs"), (me, "stage_ec"), (me, "stage_tc")],
                             stage_s["multievent"]):
            t0 = time.perf_counter()
            results["multievent"] = me.main(["--workdir", str(tmp / "drivers_me"), "--trackml-dir", str(raw),
                                             "--json", str(tmp / "drivers_me.json"), *DRIVER_MULTIEVENT])
            stage_s["multievent"]["main"] = time.perf_counter() - t0
    finally:
        me.tc_module = real_tc_module
    with timed_functions([(tt, "build_data"), (tt, "split_sectors"), (tt, "stage_ec"), (tt, "stage_ml"),
                          (tt, "stage_tc")], stage_s["trackml"]):
        t0 = time.perf_counter()
        results["trackml"] = tt.main(["--workdir", str(tmp / "drivers_tt"), "--trackml-dir", str(raw),
                                      "--json", str(tmp / "drivers_tt.json"), *DRIVER_TRACKML])
        stage_s["trackml"]["main"] = time.perf_counter() - t0
    launches = counts()
    for name, n in launches.items():
        assert n > 0, f"the drivers' path never launched {name}"

    # ---- what came out: the drivers' keys, finite figures in range
    me_res, tt_res = results["multievent"], results["trackml"]
    assert json.loads((tmp / "drivers_me.json").read_text()).keys() == me_res.keys()
    for i in range(4):
        for tag in ("last", "selected"):
            v = me_res[f"tc.test.ev{i}.{tag}.dm_pt0.9"]
            assert 0.0 <= v <= 1.0, (i, tag, v)
    for res in (me_res, tt_res):
        assert 0.5 < res["ec.roc_auc"] <= 1.0, res["ec.roc_auc"]
        assert 0.0 <= res["tc.select.trk.double_majority_pt0.9"] <= 1.0
    for k in (8, 12, 16):
        for fig in ("edge_purity", "true_edge_efficiency"):
            assert 0.0 < tt_res[f"ml.{fig}_k{k}"] <= 1.0, (k, fig, tt_res[f"ml.{fig}_k{k}"])
    assert {"tc.test.last.trk.double_majority_pt0.9", "tc.test.selected.trk.double_majority_pt0.9"} <= tt_res.keys()
    assert tt_res["graph.n_edges"] > 0 and len(built["foms"]) == 3 + 2 * 4  # 3 selections, 4 events twice

    # ---- rows #1 / #2 at the drivers' widths, on the variants' edge count, against their plain versions
    event = load_graph(tmp / "drivers_me" / "events_train" / "event000.npz", device="cuda").sort_edges_by_target()
    n_edges = event.num_edges
    width_checks(seed + 15, {name: ("f32", widths, n_edges) for name, widths in DRIVER_WIDTHS.items()})

    # ---- step-0 gradients of both recipes' models through the kernels against the plain path's;
    # the TC's also against a float64 evaluation (compare_grads_f64): the condensation loss is
    # translation invariant in the latent, so the cluster head's bias gradient is exactly zero and
    # both f32 paths give rounding noise there
    def step0(module, batch, model=None):
        model = module.model if model is None else model
        model.train()
        model.zero_grad(set_to_none=True)
        if model is module.model:
            out, data = module.apply_model(batch)
        else:
            data = batch.to(batch.device, dtype=torch.float64)
            out = model(data)
        loss, _ = module.get_losses(out, data)
        loss.backward()
        grads = {n: None if p.grad is None else p.grad.detach().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return grads, loss.item()

    train_dir = tmp / "drivers_me" / "events_train"
    ec_in = tt.input_widths(train_dir)
    ec_model = ECForGraphTCN(*ec_in, interaction_node_dim=32, interaction_edge_dim=32, hidden_dim=64, L_ec=4,
                                device="cpu", generator=tt.seeded(seed + 15))
    recipes = {
        "TC": tt.tc_module(train_dir, 1, h_outdim=4, hidden_dim=48, cosine=True, rng_seed=seed + 15, device="cuda"),
        "EC": ECModule(model=ec_model, loss_fct=EdgeWeightFocalLoss(alpha=0.25, gamma=2.0), device="cuda"),
    }
    grads_summary = {}
    for name, module in recipes.items():
        before = counts()
        gk, lk = step0(module, event)
        step_launches = {k: v - before[k] for k, v in counts().items()}
        with plain_path():
            gp, lp = step0(module, event)
            if name == "TC":
                g64, _ = step0(module, event, model=copy.deepcopy(module.model).double())
        if name == "TC":
            worst_name, worst, at_floor, no_grad = compare_grads_f64(gk, gp, {k: v.float() for k, v in g64.items()})
        else:
            worst_name, worst, at_floor, no_grad, _ = compare_grads(gk, gp)
        assert not no_grad, no_grad
        assert step_launches["fused_relational_fwd"] > 0 and step_launches["fused_relational_bwd"] > 0, step_launches
        assert abs(lk - lp) <= 1e-4 * abs(lp), (name, lk, lp)
        grads_summary[name] = {"loss": lk, "plain_loss": lp, "worst": worst, "worst_name": worst_name,
                               "at_floor": at_floor, "launches": step_launches}
        say(f"drivers: {name} recipe step 0 on event000 ({event.num_nodes} hits, {n_edges} edges): loss {lk:.6f} "
            f"(plain {lp:.6f}); {len(gk)} parameter gradients agree "
            + ("within 4x the plain path's error against float64" if name == "TC" else "with the plain path")
            + f" (worst {worst_name}: {worst:.3e} relative; rounding only: {at_floor or 'none'})")

    # ---- the TC model with trained weights (3 epochs leave one cluster): scanned on the selection
    # variants, then served on a report variant with labels equal to the plain path's
    tc = built["tc"]
    load_jax_params(tc.model, trained_tc_params(DRIVER_TRAINED))
    select = TrackingDataModule(val={"dirs": [tmp / "drivers_me" / "events_select"]})
    select.setup("validate")
    best = Trainer(max_epochs=0, log_dir=tmp / "drivers_trained").validate(tc, loader=select.val_dataloader())
    assert best["trk.double_majority_pt0.9"] > 0.5, best["trk.double_majority_pt0.9"]
    predictor = TrackingPredictor(tc.model, eps=best["best_dbscan_eps"],
                                  min_samples=int(best["best_dbscan_min_samples"]), device="cuda")
    report = load_graph(tmp / "drivers_me" / "events_val" / "event018.npz", device="cuda")
    got = predictor.predict(report)
    assert got["labels"].max() > 0, "served report event: one cluster"
    # the latent through the kernels and the plain path; then DBSCAN on the kernels' latent through
    # both (the trained latent reaches norm ~1e4, where the two paths' rounding exceeds eps)
    graph = report.sort_edges_by_target()
    tc.model.eval()
    with torch.no_grad():
        h_k = tc.model(graph)["H"].float()
        with plain_path():
            h_p = tc.model(graph)["H"].float()
        h_rel = max_rel(h_k, h_p)
        assert h_rel <= 1e-4, f"trained TC latent against the plain path: {h_rel:.3e}"
        kw = {"eps": predictor.eps, "min_samples": predictor.min_samples,
              "max_num_neighbors": predictor.max_num_neighbors, "node_mask": graph.node_mask}
        labels_k = dbscan(h_k, **kw)
        with plain_path():
            labels_p = dbscan(h_k, **kw)
    assert torch.equal(labels_k, labels_p), (
        f"served report event: DBSCAN labels differ from the plain path's at {int((labels_k != labels_p).sum())} hits")
    assert np.array_equal(got["labels"], labels_k[: got["labels"].shape[0]].cpu().numpy()), "served labels differ"

    summary = {"card": card, "launches": launches, "stage_s": stage_s, "step0": grads_summary,
               "multievent": me_res, "trackml": tt_res, "served_clusters": int(got["labels"].max()) + 1,
               "trained_select_dm": best["trk.double_majority_pt0.9"], "trained_h_rel": h_rel,
               "phase_s": time.perf_counter() - t_phase}
    for driver, parts in stage_s.items():
        say(f"drivers: {driver} stages " + ", ".join(f"{k} {v:.2f} s" for k, v in parts.items()))
    say(f"drivers: launches on the path {launches}; multievent ec.roc_auc {me_res['ec.roc_auc']:.4f}, "
        f"tc.test.last DM {me_res['tc.test.last.dm_pt0.9_mean']:.4f}; trackml ec.roc_auc "
        f"{tt_res['ec.roc_auc']:.4f}, ml.true_edge_efficiency {tt_res['ml.true_edge_efficiency']:.4f}; "
        f"trained TC weights: selection DM {best['trk.double_majority_pt0.9']:.4f} (eps {best['best_dbscan_eps']:.4f}, "
        f"min_samples {int(best['best_dbscan_min_samples'])}), its latent on a report event within {h_rel:.2e} of "
        f"the plain path's, DBSCAN labels on it equal to the plain path's and the served ones "
        f"({summary['served_clusters']} clusters); phase {summary['phase_s']:.1f} s")
    log("drivers: " + json.dumps(summary, default=float))
    return summary


# the analysis and metrics layer (phase 16)
#: the kernels of phase 16's path, by the module attribute that launches each
ANALYSIS_KERNELS = {k: TC_CLI_KERNELS[k] for k in ("fused_relational_fwd", "sorted_segment_sum", "sorted_gather",
                                                   "pairwise_topk_filter", "cc_neighbors")}
#: edge-classifier thresholds of (a)'s study
ANALYSIS_THRESHOLDS = (0.1, 0.3, 0.5, 0.7, 0.9)
#: epochs of the drivers' EC recipe (stage A of train_multievent) over the drill's 16 training variants
ANALYSIS_EC_EPOCHS = 6
#: the share of the pile-up event's true edges that (a)'s breadth-first-search run cuts
ANALYSIS_TRUE_EDGE_DROP = 0.3
#: bins of (b)'s binned tracking metrics
ANALYSIS_PT_BINS = [0.0, 0.5, 0.9, 1.5, 3.0, 10.0]
ANALYSIS_ETA_BINS = [-4.0, -2.0, -1.0, 0.0, 1.0, 2.0, 4.0]
#: (c): timed ML steps with the legacy hinge loss, after ML_WARMUP steps
ANALYSIS_ML_STEPS = 10


def assert_same_figures(what: str, got: dict, want: dict) -> float:
    """Figures of the card's run (``got``) against the CPU port's
    (``want``): the same keys in the same order, integers equal, floats
    within 1e-12 relative, NaN where NaN. Returns the largest relative
    difference."""
    assert list(got) == list(want), (what, list(got), list(want))
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (int, np.integer)) and not isinstance(w, bool):
            assert g == w, f"{what}: {k} {g} != {w}"
        elif math.isnan(w):
            assert math.isnan(g), f"{what}: {k} {g} != NaN"
        elif g != w:
            rel = abs(g - w) / abs(w) if w else math.inf
            assert rel <= 1e-12, f"{what}: {k} {g} != {w}"
            worst = max(worst, rel)
    return worst


def assert_same_table(what: str, got: dict, want: dict) -> float:
    """A column table of the card's run against the CPU port's: the same
    columns, dtypes and lengths; integer columns equal, float columns within
    1e-12 relative (NaN where NaN). Returns the largest relative
    difference."""
    assert list(got) == list(want), (what, list(got), list(want))
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype, g.shape, w.shape)
        if w.dtype.kind != "f":
            assert np.array_equal(g, w), f"{what}: column {k} differs"
            continue
        assert np.array_equal(np.isnan(g), np.isnan(w)) and np.array_equal(np.isinf(g), np.isinf(w)), (what, k)
        fin = np.isfinite(w)
        diff = np.abs(g[fin] - w[fin])
        scale = np.abs(w[fin])
        assert (diff <= 1e-12 * scale).all(), f"{what}: column {k} beyond 1e-12 relative"
        if diff.size and scale.max() > 0:
            worst = max(worst, float((diff / np.where(scale > 0, scale, 1)).max()))
    return worst


def analysis_phase(seed: int, tmp: Path) -> dict:
    """Phase 16 (see the module docstring). Returns the launches of
    ``ANALYSIS_KERNELS`` on the phase's path (counts set to 0 after the
    set-up, just before (a), read just after (c); the CPU port's runs and
    step 0 on the plain path launch nothing) and the phase's summary."""
    import importlib

    import torch

    from gnn_tracking_tpu_torch.analysis import graphs as analysis_graphs
    from gnn_tracking_tpu_torch.analysis.edge_classification import collect_all_ec_stats
    from gnn_tracking_tpu_torch.graph_construction.graph_builder import GraphBuilder
    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.losses.ec import EdgeWeightFocalLoss
    from gnn_tracking_tpu_torch.losses.metric_learning import OldGraphConstructionHingeEmbeddingLoss
    from gnn_tracking_tpu_torch.metrics.binary_classification import roc_auc_score
    from gnn_tracking_tpu_torch.metrics.cluster_metrics import (
        common_metrics,
        tracking_metrics_vs_eta,
        tracking_metrics_vs_pt,
    )
    from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
    from gnn_tracking_tpu_torch.models.graph_construction import GraphConstructionFCNN
    from gnn_tracking_tpu_torch.ops import csr_segment
    from gnn_tracking_tpu_torch.postprocessing.dbscanscanner import DBSCANPerformanceDetails
    from gnn_tracking_tpu_torch.preprocessing import build_point_clouds
    from gnn_tracking_tpu_torch.scripts import train_multievent as me
    from gnn_tracking_tpu_torch.scripts import train_trackml as tt
    from gnn_tracking_tpu_torch.training.module import DEFAULT_RNG_SEED, ECModule, MLModule
    from gnn_tracking_tpu_torch.training.trainer import Trainer
    from gnn_tracking_tpu_torch.utils.loading import TrackingDataModule, load_graph
    from gnn_tracking_tpu_torch.utils.param_convert import load_jax_params

    card = card_line()

    def say(msg: str) -> None:
        log(f"{msg} [{card}]")

    def sync() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    ops = {name: importlib.import_module(f"gnn_tracking_tpu_torch.ops.{name}")
           for name in {m for m, _ in ANALYSIS_KERNELS.values()}}

    def counts() -> dict:
        return {k: getattr(ops[m], f).launches for k, (m, f) in ANALYSIS_KERNELS.items()}

    t_phase = time.perf_counter()
    summary = {"card": card, "s": {}}
    seconds = summary["s"]

    # ---- set-up: the drill's 22 variants of the vendored event (train_multievent's split), the
    # drivers' EC trained on them, etl-trackml-110k at 1 sector (phase 14's point cloud where it ran)
    raw = tmp / "analysis_raw"
    raw.mkdir()
    for name in ETL_CSVS:
        shutil.copy(REPO / "tests" / "test_data" / "trackml" / name, raw / name)
    t0 = time.perf_counter()
    _, graph_dir, _ = tt.build_data(raw, tmp / "analysis_drill", device="cuda")
    train_dir, val_dir, sel_dir = me.make_event_dirs(sorted(graph_dir.glob("*.npz"))[0], tmp / "analysis_drill",
                                                     22, 0.9, n_select=2, n_val=4)
    pcs = tmp / "etl_pc_pileup_1"
    if not pcs.is_dir():
        make_pileup(seed, raw, tmp / "analysis_raw_110k")
        build_point_clouds.main(["--indir", str(tmp / "analysis_raw_110k"), "--outdir", str(pcs),
                                 "--detector-config", str(raw / "detectors.csv.gz"), "--n-sectors", "1",
                                 "--pixel-only", "--add-true-edges"])
    gb = GraphBuilder(pcs, tmp / "analysis_unused", device="cuda")
    pc = load_graph(sorted(pcs.glob("*.npz"))[0], device="cpu")
    event = gb.to_graph(pc, *gb.edges_from_join(gb.join(pc), pc)[:3]).to("cuda").sort_edges_by_target()
    node_in, edge_in = tt.input_widths(train_dir)
    assert (event.x.shape[1], event.edge_attr.shape[1]) == (node_in, edge_in)
    ec_model = ECForGraphTCN(node_in, edge_in, interaction_node_dim=32, interaction_edge_dim=32, hidden_dim=64,
                             L_ec=4, device="cpu", generator=tt.seeded(DEFAULT_RNG_SEED))
    ec_module = ECModule(model=ec_model, loss_fct=EdgeWeightFocalLoss(alpha=0.25, gamma=2.0), lr=2e-3,
                         device="cuda")
    ec_fit = Trainer(max_epochs=ANALYSIS_EC_EPOCHS, log_dir=tmp / "analysis_ec", print_validation_results=False).fit(
        ec_module, TrackingDataModule(train={"dirs": [train_dir], "batch_size": 1}, val={"dirs": [val_dir]}))
    assert ec_fit["roc_auc"] > 0.9, ec_fit["roc_auc"]
    # the drill's selected TC weights, and the (eps, min_samples) their scan selects, as phase 15 serves them
    tc = tt.tc_module(train_dir, 1, h_outdim=4, hidden_dim=48, cosine=True, device="cuda")
    load_jax_params(tc.model, trained_tc_params(DRIVER_TRAINED))
    select = TrackingDataModule(val={"dirs": [sel_dir]})
    select.setup("validate")
    best = Trainer(max_epochs=0, log_dir=tmp / "analysis_tc").validate(tc, loader=select.val_dataloader())
    eps, min_samples = best["best_dbscan_eps"], int(best["best_dbscan_min_samples"])
    seconds["set_up"] = sync() - t0
    summary["event"] = {"hits": event.num_nodes, "edges": event.num_edges, "true_edges": int(event.y.sum())}
    say(f"analysis: set-up {seconds['set_up']:.2f} s: etl-trackml-110k at 1 sector ({event.num_nodes} hits, "
        f"{event.num_edges} edges); the drivers' EC after {ANALYSIS_EC_EPOCHS} epochs of stage A's recipe "
        f"(ROC AUC {ec_fit['roc_auc']:.4f} on the report variants); the drill's TC weights select eps {eps:.4f}, "
        f"min_samples {min_samples} (DM {best['trk.double_majority_pt0.9']:.4f})")

    for m, f in ANALYSIS_KERNELS.values():
        getattr(ops[m], f).launches = 0

    # ---- (a) graph-construction and EC statistics on the full event, card and CPU port
    event_cpu = event.to("cpu")
    sweeps: list[int] = []
    real_cc = analysis_graphs.connected_components

    def counted_cc(*args, **kwargs):
        out = real_cc(*args, **kwargs)
        sweeps.append(real_cc.sweeps)
        return out

    analysis_graphs.connected_components = counted_cc
    try:
        t0 = sync()
        stats = analysis_graphs.get_all_graph_construction_stats(event)
        seconds["graph_stats"] = sync() - t0
        summary["cc_sweeps"] = {"segments": sweeps[0], "components": sweeps[1]}
        t0 = time.perf_counter()
        stats_cpu = analysis_graphs.get_all_graph_construction_stats(event_cpu)
        seconds["graph_stats_cpu"] = time.perf_counter() - t0
    finally:
        analysis_graphs.connected_components = real_cc
    worst = {"graph_stats": assert_same_figures("graph-construction stats", stats, stats_cpu)}
    assert stats["n_edges"] == event.num_edges and 0 < stats["frac_segment50"] <= 1, stats

    ec_model.eval()
    w_seen = []

    def model_fn(d):
        with torch.no_grad():
            out = ec_model(d)
        w_seen.append(out["W"])
        return out

    before = counts()
    t0 = sync()
    ec_stats = collect_all_ec_stats(model_fn, [event], ANALYSIS_THRESHOLDS)
    seconds["ec_stats"] = sync() - t0
    ec_launches = {k: v - before[k] for k, v in counts().items()}
    for name in ("fused_relational_fwd", "sorted_segment_sum", "sorted_gather"):
        assert ec_launches[name] > 0, f"the EC study never launched {name}"
    w_cpu = w_seen[0].cpu()
    t0 = time.perf_counter()
    ec_stats_cpu = collect_all_ec_stats(lambda d: {"W": w_cpu}, [event_cpu], ANALYSIS_THRESHOLDS)
    seconds["ec_stats_cpu"] = time.perf_counter() - t0
    worst["ec_stats"] = assert_same_table("EC study", ec_stats, ec_stats_cpu)
    # the kernels' W at the event's size against the plain path's, as width_checks holds row #1; the
    # EC's own endpoint gathers (row #10, outside the fused op) take their plain version too
    before = counts()
    real_gather = csr_segment._gather
    csr_segment._gather = csr_segment.sorted_gather_plain
    try:
        with plain_path(), torch.no_grad():
            w_plain = ec_model(event)["W"]
    finally:
        csr_segment._gather = real_gather
    assert counts() == before, f"the plain path's W launched kernels: {before} -> {counts()}"
    w_err = float((w_seen[0] - w_plain).abs().max())
    w_scale = float(w_seen[0].abs().max())
    assert w_err <= 1e-4 * w_scale, f"the EC's W on the event: {w_err} from the plain path's (scale {w_scale})"
    del w_plain
    auc = roc_auc_score(y_true=event.y, y_score=w_seen[0], mask=event.edge_mask)
    assert auc > 0.8, f"the EC's W does not separate the event's edges: ROC AUC {auc}"
    # trained where 29 % of the edges are true, the EC's scores sit low on the event's 2 %: its
    # separation is held at the study's best threshold, not at 0.5
    mcc = float(np.max(ec_stats["MCC"]))
    assert mcc > 0.5, f"the EC's W does not separate the event's edges: MCC {list(ec_stats['MCC'])}"
    t0 = sync()
    tgi = analysis_graphs.get_track_graph_info_from_data(event, w=w_seen[0], threshold=0.5)
    seconds["track_info_cut"] = sync() - t0
    tgi_cpu = analysis_graphs.get_track_graph_info_from_data(event_cpu, w=w_cpu, threshold=0.5)
    worst["track_info_cut"] = assert_same_table("track-graph records at the cut 0.5", tgi, tgi_cpu)
    # the breadth-first search at scale: a share of the true edges cut (both directions of each, by a
    # symmetric draw a pair), the false edges kept, so a split track's segments share a component
    u, v = event.edge_index.long()
    r = torch.rand(event.num_nodes, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed + 90))
    w_drop = (~(event.y.bool() & ((r[u] + r[v]) % 1.0 < ANALYSIS_TRUE_EDGE_DROP))).double()
    del u, v
    t0 = sync()
    tgi_drop = analysis_graphs.get_track_graph_info_from_data(event, w=w_drop, threshold=0.5)
    seconds["track_info_drop"] = sync() - t0
    t0 = time.perf_counter()
    tgi_drop_cpu = analysis_graphs.get_track_graph_info_from_data(event_cpu, w=w_drop.cpu(), threshold=0.5)
    seconds["track_info_drop_cpu"] = time.perf_counter() - t0
    worst["track_info_drop"] = assert_same_table("track-graph records with true edges cut", tgi_drop, tgi_drop_cpu)
    dist = tgi_drop["distance_largest_segments"]
    searched = (tgi_drop["n_segments"] > 1) & np.isfinite(dist)
    assert searched.sum() >= 200, f"only {searched.sum()} breadth-first searches"
    study = ("threshold", "TPR", "FPR", "MCC", "frac_segment50", "frac_segment75", "frac_segment100", "n_segments")
    summary |= {"graph_stats": stats, "ec_roc_auc": auc, "ec_stats": {k: ec_stats[k].tolist() for k in study},
                "ec_launches": ec_launches,
                "track_info_cut": {"particles": len(tgi["pid"]),
                                   "multi_segment": int((tgi["n_segments"] > 1).sum()),
                                   "inf": int(np.isinf(tgi["distance_largest_segments"]).sum()),
                                   "max_finite_distance": float(np.max(
                                       tgi["distance_largest_segments"][np.isfinite(
                                           tgi["distance_largest_segments"])], initial=0))},
                "track_info_drop": {"particles": len(tgi_drop["pid"]),
                                    "multi_segment": int((tgi_drop["n_segments"] > 1).sum()),
                                    "bfs_queries": int(searched.sum()),
                                    "inf": int(np.isinf(dist).sum()),
                                    "distances": {int(d): int((dist[searched] == d).sum())
                                                  for d in np.unique(dist[searched])}},
                "ec_w_err": w_err}
    say(f"analysis (a): get_all_graph_construction_stats on {event.num_edges} edges: {seconds['graph_stats']:.3f} s "
        f"on the card (CC sweeps: segments {sweeps[0]}, components {sweeps[1]}), "
        f"{seconds['graph_stats_cpu']:.3f} s on the CPU port, equal figures (worst {worst['graph_stats']:.1e}); "
        f"frac_segment50 {stats['frac_segment50']:.4f}, n_segments {stats['n_segments']:.4f}, orphans "
        f"{stats['n_orphan_total']}")
    say(f"analysis (a): collect_all_ec_stats at {len(ANALYSIS_THRESHOLDS)} thresholds: {seconds['ec_stats']:.3f} s "
        f"on the card (launches {ec_launches}), {seconds['ec_stats_cpu']:.3f} s on the CPU port fed the card's W, "
        f"equal columns (worst {worst['ec_stats']:.1e}); W within {w_err:.2e} of the plain path's (largest "
        f"{w_scale:.4f}); the EC's ROC AUC on the event {auc:.4f}, MCC {[round(float(v), 4) for v in ec_stats['MCC']]}, "
        f"frac_segment50 {[round(float(v), 4) for v in ec_stats['frac_segment50']]}; the track records at 0.5 "
        f"({seconds['track_info_cut']:.3f} s) equal: {summary['track_info_cut']}")
    say(f"analysis (a): get_track_graph_info_from_data with {ANALYSIS_TRUE_EDGE_DROP} of the true edges cut: "
        f"{seconds['track_info_drop']:.3f} s on the card for {summary['track_info_drop']['bfs_queries']} "
        f"breadth-first searches, {seconds['track_info_drop_cpu']:.3f} s on the CPU port, equal records: "
        f"{summary['track_info_drop']}")

    # ---- (b) serving analysis on the drill's trained latent, the report variants
    details = DBSCANPerformanceDetails(eps=eps, min_samples=min_samples)
    details_cpu = DBSCANPerformanceDetails(eps=eps, min_samples=min_samples)
    tc.model.eval()
    seconds["details"] = seconds["details_cpu"] = 0.0
    before = counts()
    for i, f in enumerate(sorted(val_dir.glob("*.npz"))):
        g = load_graph(f, device="cuda").sort_edges_by_target()
        with torch.no_grad():
            h = tc.model(g)["H"].float()
        t0 = sync()
        details(g, {"H": h}, i)
        seconds["details"] += sync() - t0
        t0 = time.perf_counter()
        details_cpu(g.to("cpu"), {"H": h.cpu()}, i)
        seconds["details_cpu"] += time.perf_counter() - t0
    serve_launches = {k: v - before[k] for k, v in counts().items()}
    for name in ("pairwise_topk_filter", "cc_neighbors"):
        assert serve_launches[name] > 0, f"DBSCANPerformanceDetails never launched {name}"
    (hits, clusters), (hits_cpu, clusters_cpu) = details.get_results(), details_cpu.get_results()
    for i, (a, b, c, d) in enumerate(zip(hits, hits_cpu, clusters, clusters_cpu)):
        assert_same_table(f"report event {i}: hit records", a, b)
        worst[f"clusters_{i}"] = assert_same_table(f"report event {i}: cluster records", c, d)
        assert len(c["c"]) > 1, f"report event {i}: one cluster"
    keys = {"truth": "id", "predicted": "c", "pts": "pt", "reconstructable": "reconstructable", "eta": "eta"}
    events = [{k: torch.as_tensor(t[v], device="cuda") for k, v in keys.items()} for t in hits]
    events_cpu = [{k: t[v] for k, v in keys.items()} for t in hits_cpu]
    t0 = time.perf_counter()
    binned = {"pt": tracking_metrics_vs_pt(events, ANALYSIS_PT_BINS),
              "eta": tracking_metrics_vs_eta(events, ANALYSIS_ETA_BINS)}
    seconds["binned"] = time.perf_counter() - t0
    binned_cpu = {"pt": tracking_metrics_vs_pt(events_cpu, ANALYSIS_PT_BINS),
                  "eta": tracking_metrics_vs_eta(events_cpu, ANALYSIS_ETA_BINS)}
    for k in binned:
        worst[f"binned_{k}"] = assert_same_table(f"tracking metrics vs {k}", binned[k], binned_cpu[k])
    scores, t0 = [], time.perf_counter()
    for ev in events:
        scores.append({name: fn(**ev, pt_thlds=[0.0, 0.9]) for name, fn in common_metrics.items()})
    seconds["common_metrics"] = time.perf_counter() - t0
    for i, (ev, s) in enumerate(zip(events_cpu, scores)):
        want = {name: fn(**ev, pt_thlds=[0.0, 0.9]) for name, fn in common_metrics.items()}
        flat = {k: v for k, v in s.items() if k != "trk"} | s["trk"]
        worst[f"common_{i}"] = assert_same_figures(f"report event {i}: common_metrics", flat,
                                                   {k: v for k, v in want.items() if k != "trk"} | want["trk"])
    mean_v = statistics.mean(s["v_measure"] for s in scores)
    summary |= {"dbscan": {"eps": eps, "min_samples": min_samples}, "serve_launches": serve_launches,
                "clusters": [len(c["c"]) for c in clusters],
                "dm_vs_pt": binned["pt"]["double_majority"].tolist(),
                "common_metrics": [{k: v for k, v in s.items() if k != "trk"} for s in scores]}
    say(f"analysis (b): DBSCANPerformanceDetails on the 4 report variants: {seconds['details']:.3f} s on the card "
        f"(launches {serve_launches}), {seconds['details_cpu']:.3f} s on the CPU port, equal records "
        f"({summary['clusters']} clusters); tracking_metrics_vs_pt / _eta {seconds['binned']:.3f} s, DM by pt "
        f"{[round(v, 4) for v in summary['dm_vs_pt']]}; common_metrics {seconds['common_metrics']:.3f} s for 4 "
        f"events, v_measure mean {mean_v:.4f}; all equal to the CPU port's")

    # ---- (c) the legacy hinge loss in an ML step at ml-training-32k's size
    g = EventGraph.from_arrays(**make_point_cloud(seed + 80, ML_HITS, ML_PARTICLES)).to("cuda")
    model = GraphConstructionFCNN(**ML_MODEL, device="cpu", generator=torch.Generator().manual_seed(seed + 81))
    module = MLModule(model=model, loss_fct=OldGraphConstructionHingeEmbeddingLoss(**ML_LOSS), lr=LR,
                      device="cuda")
    module.setup_params(g)

    def step0():
        model.train()
        model.zero_grad(set_to_none=True)
        loss, _ = module.get_losses(model(g), g)
        loss.backward()
        grads = {n: None if p.grad is None else p.grad.detach().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return grads, loss.item()

    before = counts()
    gk, lk = step0()
    assert counts()["pairwise_topk_filter"] == before["pairwise_topk_filter"] + 1
    with plain_path():
        gp, lp = step0()
    worst_name, worst_grad, at_floor, no_grad, _ = compare_grads(gk, gp)
    assert not no_grad, no_grad
    assert abs(lk - lp) <= 1e-4 * abs(lp), (lk, lp)
    while module.step < ML_WARMUP:
        module.training_step(g)
    t0 = sync()
    for _ in range(ANALYSIS_ML_STEPS):
        metrics = module.training_step(g)
    dt = sync() - t0
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    launches = counts()
    for name, n in launches.items():
        assert n > 0, f"phase 16's path never launched {name}"
    summary |= {"old_hinge": {"loss": lk, "plain_loss": lp, "worst": worst_grad, "worst_name": worst_name,
                              "at_floor": at_floor, "steps_per_s": ANALYSIS_ML_STEPS / dt,
                              "step_ms": dt / ANALYSIS_ML_STEPS * 1e3, "total": metrics["total"]},
                "launches": launches, "worst": worst, "phase_s": time.perf_counter() - t_phase}
    say(f"analysis (c): OldGraphConstructionHingeEmbeddingLoss on {ML_HITS} hits (k = "
        f"{ML_LOSS['max_num_neighbors']}): step 0 loss {lk:.6f} (plain {lp:.6f}), {len(gk)} parameter gradients "
        f"agree with the plain path (worst {worst_name}: {worst_grad:.3e}; floor only: {at_floor or 'none'}); "
        f"{ANALYSIS_ML_STEPS / dt:.2f} steps/s over {ANALYSIS_ML_STEPS} steps after {ML_WARMUP}")
    say(f"analysis: launches on the path {launches}; phase {summary['phase_s']:.1f} s")
    log("analysis: " + json.dumps(summary, default=float))
    return summary


# the single-device remainder (phase 17)
#: the kernels of phase 17's path, by the module attribute that launches each
REMAINDER_KERNELS = {**TC_CLI_KERNELS, "ivf_probe": ("ivf_probe", "ivf_probe")}
#: the IVF's options of (a), each beside the default (``bucket_impl`` and ``fast_assign`` are
#: TPU hints that the port takes and runs as the default's build)
REMAINDER_IVF_OPTIONS = {
    "probe_impl=xla": {"probe_impl": "xla"},
    "bucket_impl=scatter": {"bucket_impl": "scatter"},
    "spill_passes=False": {"spill_passes": False},
    "spill_passes=probe": {"spill_passes": "probe"},
    "spill_passes=extra": {"spill_passes": "extra"},
    "fast_assign=False": {"fast_assign": False},
}
#: (a): the spatial cloud's probe width: at the default 8 its builds take 3 attempts (8, 16, then
#: 32 probed cells; ~2.6 s on an H100, 2.1 s of it the fallbacks), at 32 one
REMAINDER_SPATIAL = {"n_probe": 32}
#: (a): the option also held against the default at the spatial cloud's default widths (the one
#: that leans most on the retries: its unprobed spilled queries go to the fallback)
REMAINDER_DEFAULT_WIDTH_OPTION = {"spill_passes": False}
#: (b): pairs of steps (one with the undo copy, one without) that time the copy's cost
REMAINDER_GUARD_PAIRS = 100
#: the drill's split (16 train, 2 selection, 4 report variants) for (b) and (c)
REMAINDER_EVENTS = {"n_events": 22, "keep_frac": 0.9, "n_select": 2, "n_val": 4}
#: (c): the traced training steps (the module's step count before the first; all in the first
#: of 16 steps an epoch) and their span's name
REMAINDER_TRACE_FROM, REMAINDER_TRACE_STEPS, REMAINDER_SPAN = 3, 10, "remainder_tc_step"
#: (c): the device kernels by which the trace names rows #1, #9 and #10
REMAINDER_TRACE_NAMES = {"fused_relational_fwd": "edge_mlp_kernel", "sorted_segment_sum": "segment_tiles_kernel",
                         "sorted_gather": "gather_rows_kernel"}
#: (d): the plot modules, which import matplotlib only inside the methods that draw
REMAINDER_PLOT_MODULES = ("analysis.plotutils", "analysis.efficiencies", "analysis.latent",
                          "analysis.edge_classification", "utils.plotting", "utils.colors")


def trace_busy_share(path: Path, span: str) -> dict:
    """A Chrome trace of ``utils.profiling.device_trace``: the window from the
    first ``span`` annotation's start to the last one's end (host clock), the
    union of the device's kernel, copy and set intervals inside it, its share
    of the window, and the kernels' names."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == span and e.get("cat") == "user_annotation"]
    assert spans, f"trace {path}: no {span!r} span"
    t0, t1 = min(e["ts"] for e in spans), max(e["ts"] + e["dur"] for e in spans)
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, t0
    for a, b in device:
        a, b = max(a, end), min(b, t1)
        if b > a:
            busy += b - a
            end = b
    kernels = [e["name"] for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    return {"steps": len(spans), "window_ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / (t1 - t0), "kernel_launches": len(kernels), "kernel_names": sorted(set(kernels))}


def remainder_phase(seed: int, tmp: Path) -> dict:
    """Phase 17 (see the module docstring). Returns the launches of
    ``REMAINDER_KERNELS`` on the phase's path (counts set to 0 just before
    (a), read just after (c)) and the phase's summary."""
    import importlib

    import torch

    from gnn_tracking_tpu_torch.ops import ivf_probe, knn
    from gnn_tracking_tpu_torch.scripts import train_multievent as me
    from gnn_tracking_tpu_torch.scripts import train_trackml as tt
    from gnn_tracking_tpu_torch.training.trainer import Trainer
    from gnn_tracking_tpu_torch.utils import oom
    from gnn_tracking_tpu_torch.utils.augmentation import Compose, PhiRotation, ZReflection
    from gnn_tracking_tpu_torch.utils.loading import TrackingDataModule, load_graph
    from gnn_tracking_tpu_torch.utils.profiling import annotate, device_trace

    card = card_line()

    def say(msg: str) -> None:
        log(f"{msg} [{card}]")

    ops = {name: importlib.import_module(f"gnn_tracking_tpu_torch.ops.{name}")
           for name in {m for m, _ in REMAINDER_KERNELS.values()}}

    def counts() -> dict:
        return {k: getattr(ops[m], f).launches for k, (m, f) in REMAINDER_KERNELS.items()}

    t_phase = time.perf_counter()
    summary: dict = {"card": card}
    for m, f in REMAINDER_KERNELS.values():
        getattr(ops[m], f).launches = 0

    # ---- (a) every IVF option on phase 8's benchmark cloud and its spatial one, against the default
    bench = torch.from_numpy(make_bench_latent(seed + 92, GC_HITS)[0]).to("cuda")
    spatial = torch.from_numpy(make_point_cloud(seed + 90, GC_HITS, GC_PARTICLES)["extras"]["xyz"]).float()
    clouds = {"bench": (bench, {}), "spatial": (spatial.to("cuda").contiguous(), REMAINDER_SPATIAL)}
    ivf = {}
    for cloud, (x, widths) in clouds.items():
        t_cloud = time.perf_counter()
        rows = {}
        if widths:  # the default widths once: the retries that the wider probe saves
            split, want = ivf_build_split(x, GC_K, rounds=1, warmup=False, what=f" ({cloud}, default widths)")
            name = ", ".join(f"{k}={v}" for k, v in REMAINDER_DEFAULT_WIDTH_OPTION.items())
            got_split, got = ivf_build_split(x, GC_K, rounds=1, warmup=False,
                                             what=f" ({cloud}, default widths, {name})",
                                             **REMAINDER_DEFAULT_WIDTH_OPTION)
            ties = compare_neighbours(f"IVF {cloud} default widths {name}", got, want, GC_K)
            rows["default (default widths)"] = split
            rows[f"{name} (default widths)"] = {**got_split, "tie_rows": ties, "equal": bool(
                all(torch.equal(a, b) for a, b in zip(got, want)))}
        probe0 = ivf_probe.ivf_probe.launches
        split, want = ivf_build_split(x, GC_K, what=f" ({cloud}, default{', ' if widths else ''}"
                                      f"{', '.join(f'{k} {v}' for k, v in widths.items())})", **widths)
        rows["default"] = {**split, "row15_launches": ivf_probe.ivf_probe.launches - probe0}
        for name, option in REMAINDER_IVF_OPTIONS.items():
            probe0 = ivf_probe.ivf_probe.launches
            split, got = ivf_build_split(x, GC_K, warmup=False, what=f" ({cloud}, {name})", **widths, **option)
            launched = ivf_probe.ivf_probe.launches - probe0
            # the "xla" probe is its own path: it never reaches row #15, every other option does
            assert (launched == 0) == (name == "probe_impl=xla"), (cloud, name, launched)
            ties = compare_neighbours(f"IVF {cloud} {name}", got, want, GC_K)
            rows[name] = {**split, "row15_launches": launched, "tie_rows": ties,
                          "equal": bool(all(torch.equal(a, b) for a, b in zip(got, want)))}
        ivf[cloud] = rows
        say(f"remainder (a) {cloud} ({GC_HITS} points, k = {GC_K}), {time.perf_counter() - t_cloud:.1f} s: "
            + "; ".join(f"{n} {r['total_ms']:.2f} ms ({r['attempts']} attempts"
                        + (f", row #15 x{r['row15_launches']}" if "row15_launches" in r else "")
                        + ("" if "equal" not in r else f", {'equal' if r['equal'] else str(r['tie_rows']) + ' tie rows'}")
                        + ")" for n, r in rows.items()))
    summary["ivf"] = ivf

    # ---- the drill's variants of the vendored event (train_multievent's data)
    raw = tmp / "remainder_raw"
    raw.mkdir()
    for name in ETL_CSVS:
        shutil.copy(REPO / "tests" / "test_data" / "trackml" / name, raw / name)
    work = tmp / "remainder"
    _, graph_dir, _ = tt.build_data(raw, work, n_sectors=1, device="cuda")
    train_dir, val_dir, sel_dir = me.make_event_dirs(sorted(Path(graph_dir).glob("*.npz"))[0], work,
                                                     **REMAINDER_EVENTS)

    # ---- (b) the out-of-memory guard: real CUDA OOMs inside a wrapped TC step
    module = tt.tc_module(train_dir, 2, h_outdim=4, hidden_dim=48, cosine=True, rng_seed=seed + 17, device="cuda")
    batch = load_graph(sorted(train_dir.glob("*.npz"))[0], device="cuda").sort_edges_by_target()
    module.training_step(batch)  # Adam's state exists from here on

    def state():
        return ([p.detach().clone() for p in module.model.parameters()],
                [v.clone() for s in module.optimizer.state.values() for v in s.values() if torch.is_tensor(v)],
                [g["count"] for g in module.optimizer.param_groups], module.step,
                module.generator.get_state().clone())

    def same(a, b) -> bool:
        return (all(torch.equal(x, y) for x, y in zip(a[0] + a[1], b[0] + b[1])) and len(a[1]) == len(b[1])
                and a[2:4] == b[2:4] and torch.equal(a[4], b[4]))

    def exhaust():
        # twice the card's memory: never served, not even from the caching
        # allocator's reserve, which earlier phases may have grown past the free bytes
        _, total = torch.cuda.mem_get_info()
        return torch.empty(2 * total, dtype=torch.uint8, device="cuda")

    real_losses, real_adam = module.get_losses, module.optimizer.step

    def losses_then_oom(out, data):  # in the forward, after the loss has drawn from the generator
        result = real_losses(out, data)
        exhaust()
        return result

    def adam_then_oom():  # half-way: Adam's update has written the weights and moments
        real_adam()
        exhaust()

    oom.N_OOM_ERRORS.clear()
    safe = oom.tolerate_some_oom_errors(lambda b: module.training_step(b), max_consecutive=3)
    guard = {}
    for where, attr, fn in (("loss", "get_losses", losses_then_oom), ("adam", "step", adam_then_oom)):
        before = state()
        owner = module if attr == "get_losses" else module.optimizer
        setattr(owner, attr, fn)
        try:
            result = safe(batch)
        finally:
            delattr(owner, attr)
        assert result is None, f"(b) an OOM in the {where} was not skipped"
        assert same(state(), before), f"(b) the OOM in the {where} changed the module"
        guard[where] = "skipped, module bitwise unchanged"
    assert oom.N_OOM_ERRORS["<lambda>"] == 2
    metrics = safe(batch)  # the next ordinary step runs
    assert metrics is not None and math.isfinite(metrics["total"]) and module.step == 2
    assert oom.N_OOM_ERRORS["<lambda>"] == 0
    module.get_losses = losses_then_oom
    try:
        for i in range(3):
            try:
                safe(batch)
            except torch.cuda.OutOfMemoryError:
                assert i == 2, f"(b) raised at the {i + 1}-th OOM in a row, not the 3rd"
                guard["max_consecutive"] = "raised at the 3rd OOM in a row"
    finally:
        del module.get_losses
    assert "max_consecutive" in guard, "(b) 3 OOMs in a row did not raise"
    oom.N_OOM_ERRORS.clear()
    torch.cuda.empty_cache()

    def timed_step(undo: bool) -> float:
        if not undo:
            module._all_or_nothing = contextlib.nullcontext
        try:
            t0 = time.perf_counter()
            module.training_step(batch)  # it ends in the host read of its metrics
            return (time.perf_counter() - t0) * 1e3
        finally:
            if not undo:
                del module._all_or_nothing

    order = (True, False, False, True) * (REMAINDER_GUARD_PAIRS // 2)
    times = [timed_step(undo) for undo in order]
    steps = {u: [t for o, t in zip(order, times) if o is u] for u in (True, False)}
    # each neighbouring pair of steps holds one of each: their difference cancels the drift
    paired = [(a if oa else b) - (b if oa else a) for oa, a, b in zip(order[::2], times[::2], times[1::2])]
    t0 = time.perf_counter()
    for _ in range(200):
        with module._all_or_nothing():
            pass
    copy_host_us = (time.perf_counter() - t0) / 200 * 1e6
    cost = {"step_ms_with": statistics.median(steps[True]), "step_ms_without": statistics.median(steps[False]),
            "pairs": len(paired), "paired_diff_ms_mean": statistics.mean(paired),
            "paired_diff_ms_quartiles": statistics.quantiles(paired, n=4), "copy_host_us": copy_host_us,
            "tensors": len(module._mutable_tensors())}
    summary["oom_guard"] = guard
    summary["undo_cost"] = cost
    say(f"remainder (b) OOM guard: {guard}; the next step's loss {metrics['total']:.5f}; a step "
        f"{cost['step_ms_with']:.2f} ms with the undo copy, {cost['step_ms_without']:.2f} without (medians of "
        f"{len(steps[True])} steps each; {len(paired)} paired differences: mean {cost['paired_diff_ms_mean']:.3f} "
        f"ms, quartiles {', '.join(f'{q:.3f}' for q in cost['paired_diff_ms_quartiles'])} ms), the copy's host "
        f"time {copy_host_us:.1f} us for {cost['tensors']} tensors")

    # ---- (c) a 2-epoch fit of the drill's TC with RunLogger; device_trace around 10 of its steps
    module = tt.tc_module(train_dir, 2, h_outdim=4, hidden_dim=48, cosine=True, rng_seed=seed + 17, device="cuda")
    trace_dir = tmp / "remainder_trace"
    traced: dict = {}
    step_ms: list[float] = []
    real_step = module.training_step

    def training_step(b):
        if module.step == REMAINDER_TRACE_FROM:
            traced["cm"] = device_trace(trace_dir)
            traced["prof"] = traced["cm"].__enter__()
        t0 = time.perf_counter()
        with annotate(REMAINDER_SPAN) if "cm" in traced else contextlib.nullcontext():
            out = real_step(b)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if "cm" in traced and module.step == REMAINDER_TRACE_FROM + REMAINDER_TRACE_STEPS:
            traced.pop("cm").__exit__(None, None, None)
        return out

    module.training_step = training_step
    dm = TrackingDataModule(train={"dirs": [train_dir], "batch_size": 1}, val={"dirs": [sel_dir]})
    trainer = Trainer(max_epochs=2, log_dir=tmp / "remainder_runs", name="tc", monitor=tt.MONITOR,
                      train_transform=Compose([ZReflection(p=0.5, seed=4), PhiRotation(seed=4)]),
                      ema_decay=0.998, checkpoint_every_epoch=False, print_validation_results=False)
    t0 = time.perf_counter()
    val = trainer.fit(module, dm)
    fit_s = time.perf_counter() - t0
    assert "cm" not in traced, "(c) the trace did not close"
    launches = counts()
    for name, n in launches.items():
        assert n > 0, f"phase 17's path never launched {name}"
    history = [json.loads(x) for x in (trainer.log_dir / "metrics.jsonl").read_text().splitlines()]
    assert len(history) == 2 and [h["step"] for h in history] == [16, 32], [h.get("step") for h in history]
    assert all(math.isfinite(h["total_train"]) for h in history), history
    meta = json.loads((trainer.log_dir / "run_meta.json").read_text())
    assert meta["device"] == torch.cuda.get_device_name(0) and meta["n_devices"] == torch.cuda.device_count(), meta
    assert 0.0 <= val["trk.double_majority_pt0.9"] <= 1.0
    busy = trace_busy_share(traced["prof"].trace_path, REMAINDER_SPAN)
    assert busy["steps"] == REMAINDER_TRACE_STEPS, busy["steps"]
    for row, kernel in REMAINDER_TRACE_NAMES.items():
        assert any(kernel in k for k in busy["kernel_names"]), f"(c) the trace names no {kernel} ({row})"
    traced_ms = step_ms[REMAINDER_TRACE_FROM:REMAINDER_TRACE_FROM + REMAINDER_TRACE_STEPS]
    untraced = step_ms[1:REMAINDER_TRACE_FROM] + step_ms[REMAINDER_TRACE_FROM + REMAINDER_TRACE_STEPS:]
    rows_traced = {row: sorted({k for k in busy["kernel_names"] if kernel in k}) for row, kernel in
                   REMAINDER_TRACE_NAMES.items()}
    summary["fit"] = {"fit_s": fit_s, "steps": len(step_ms), "history_steps": [h["step"] for h in history],
                      "run_meta_device": meta["device"], "step_ms_median": statistics.median(untraced),
                      "traced_step_ms_median": statistics.median(traced_ms), "validation_dm": val[tt.MONITOR],
                      "trace": {k: v for k, v in busy.items() if k != "kernel_names"},
                      "trace_distinct_kernels": len(busy["kernel_names"]), "trace_rows": rows_traced}
    say(f"remainder (c) 2-epoch fit of the drill's TC: {fit_s:.2f} s, {len(step_ms)} steps (median "
        f"{summary['fit']['step_ms_median']:.2f} ms untraced, {summary['fit']['traced_step_ms_median']:.2f} ms "
        f"traced), metrics.jsonl steps {summary['fit']['history_steps']}, run_meta.json on {meta['device']}; "
        f"trace of {busy['steps']} steps: window {busy['window_ms']:.2f} ms, device busy {busy['busy_ms']:.2f} ms "
        f"({100 * busy['busy_share']:.1f} %), {busy['kernel_launches']} kernel launches, "
        f"{len(busy['kernel_names'])} kernels")

    # ---- (d) the plot modules import without matplotlib where it is missing
    try:
        importlib.import_module("matplotlib")
        have = True
    except ImportError:
        have = False
    for name in REMAINDER_PLOT_MODULES:
        importlib.import_module(f"gnn_tracking_tpu_torch.{name}")
    summary["plots"] = {"imported": list(REMAINDER_PLOT_MODULES), "matplotlib_installed": have}
    summary["launches"] = launches
    summary["phase_s"] = time.perf_counter() - t_phase
    say(f"remainder (d) plot modules imported ({'with' if have else 'without'} matplotlib installed); "
        f"launches on the path {launches}; phase {summary['phase_s']:.1f} s")
    log("remainder: " + json.dumps({k: v for k, v in summary.items() if k != "ivf"}, default=float))
    log("remainder ivf: " + json.dumps(ivf, default=float))
    return summary


# ---- 18. parallelism: ranks on the card ------------------------------------------------------

#: (a): tc.yml's PerfectECGraphTCN at its widths, its loss weights, max_n_objects and a subsample seed
PARALLEL_TC_MODEL = {"h_dim": 64, "e_dim": 64, "h_outdim": 8, "hidden_dim": 128, "L_hc": 3}
PARALLEL_TC_WEIGHTS = {"attractive": 1.0, "repulsive": 1.0, "coward": 0.1, "noise": 1.0}
PARALLEL_K, PARALLEL_SUBSAMPLE_SEED, PARALLEL_SHARDS, PARALLEL_STEPS = 2048, 7, 2, 3
#: (a): each exchange, and the halo-split layout (a2a, its edges ordered [local | halo] blocks)
PARALLEL_IMPLS = ("a2a", "all_gather", "ring", "split")
#: (b): the full GraphTCN at tc.yml's widths; (d) cuts its EC to 2 layers, so that four ranks'
#: activations on two full events fit one card
PARALLEL_GTCN_MODEL = {"h_dim": 64, "e_dim": 64, "h_outdim": 8, "hidden_dim": 128, "L_ec": 6, "L_hc": 3}
PARALLEL_GRID_MODEL = {**PARALLEL_GTCN_MODEL, "L_ec": 2}
PARALLEL_GTCN_WEIGHTS = {**PARALLEL_TC_WEIGHTS, "edge": 1.0}
#: (d): the second event is the first with every hit's phi turned by this angle (another partition)
PARALLEL_ROTATION = 2.0
#: the kernels each rank must launch, and their device kernels' names in a profiler trace
PARALLEL_KERNELS = {k: TC_CLI_KERNELS[k] for k in
                    ("fused_relational_fwd", "fused_relational_bwd", "sorted_segment_sum", "sorted_gather")}
PARALLEL_TRACE_NAMES = {"fused_relational_fwd": "edge_mlp_kernel", "fused_relational_bwd": "edge_mlp_bwd_kernel",
                        "sorted_segment_sum": "segment_tiles_kernel", "sorted_gather": "gather_rows_kernel"}
#: tolerances (JAX's own sharded tests: tests/test_sharded_model.py:130-136,
#: test_sharded_training.py:148): the forward; each step from the same weights and Adam state
#: (losses with an atol; gradients per tensor norm-wise, with a floor of 1e-6 of the whole
#: gradient's norm: a gradient that is exactly zero, as that of the latent's last bias under the
#: loss's translation invariance, is f32 rounding on both paths; the weights after it per tensor
#: norm-wise over the elements whose gradient exceeds PARALLEL_ADAM_FLOOR, every other element
#: within PARALLEL_ADAM_MOVE: Adam divides each gradient element by its own size plus 1e-8, so
#: below that a rounding-sized difference moves a weight by a share of the rate, 1e-3)
PARALLEL_FWD_RTOL, PARALLEL_STEP_RTOL, PARALLEL_LOSS_ATOL, PARALLEL_GRAD_FLOOR = 1e-5, 2e-5, 1e-7, 1e-6
PARALLEL_ADAM_FLOOR, PARALLEL_ADAM_MOVE = 1e-6, 4e-3
#: (b) / (d): the least gap around the EC cut (a hundred float32 steps at 0.5)
PARALLEL_CUT_GAP = 6e-6
#: the collectives the probe tries on CUDA tensors over gloo, point-to-point last
PARALLEL_PROBE_OPS = ("all_reduce", "broadcast", "all_gather", "all_to_all", "p2p")


def _launch_counts(table: dict | None = None) -> dict:
    """The launch counts of ``table``'s kernels (default ``PARALLEL_KERNELS``)."""
    import importlib

    return {k: getattr(importlib.import_module(f"gnn_tracking_tpu_torch.ops.{m}"), f).launches
            for k, (m, f) in (table or PARALLEL_KERNELS).items()}


def _reset_launches(table: dict | None = None) -> None:
    import importlib

    for m, f in (table or PARALLEL_KERNELS).values():
        getattr(importlib.import_module(f"gnn_tracking_tpu_torch.ops.{m}"), f).launches = 0


def _grads(model) -> dict:
    return {n: None if p.grad is None else p.grad.detach().cpu().clone() for n, p in model.named_parameters()}


def _params(model) -> dict:
    return {n: p.detach().cpu().clone() for n, p in model.named_parameters()}


def _state(model, optimizer) -> dict:
    """The weights and the optimizer's state before a step, on the host."""
    import torch

    opt = optimizer.state_dict()
    return {"params": _params(model), "opt": {
        "state": {i: {k: v.detach().cpu().clone() if torch.is_tensor(v) else v for k, v in st.items()}
                  for i, st in opt["state"].items()},
        "param_groups": copy.deepcopy(opt["param_groups"])}}


def _steps(model, optimizer, step, n: int, record: bool) -> dict:
    """``n`` calls of ``step()`` (each timed, ending in a synchronise); with
    ``record`` each one's starting state, step-0... gradients and the final
    weights, for ``_check_steps``."""
    import torch

    res = {"losses": [], "step_ms": [], "before": [], "grads": []}
    for _ in range(n):
        if record:
            res["before"].append(_state(model, optimizer))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res["losses"].append({k: float(v) for k, v in step().items()})
        torch.cuda.synchronize()
        res["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if record:
            res["grads"].append(_grads(model))
    if record:
        res["after"] = _params(model)
    return res


def parallel_probe_rank(rank: int, world: int, out: str) -> None:
    """Each collective of ``PARALLEL_PROBE_OPS`` called by hand on CUDA tensors
    over the gloo default group: accepted (and right) or refused, written to
    ``out`` after each, so that a crash leaves the earlier findings."""
    import torch
    import torch.distributed as dist

    found = {}
    dev = torch.device("cuda")
    for op in PARALLEL_PROBE_OPS:
        t = torch.full((4, 3), float(rank + 1), device=dev)
        try:
            if op == "all_reduce":
                dist.all_reduce(t)
                ok = bool((t == sum(range(1, world + 1))).all())
            elif op == "broadcast":
                dist.broadcast(t, src=0)
                ok = bool((t == 1).all())
            elif op == "all_gather":
                outs = [torch.empty_like(t) for _ in range(world)]
                dist.all_gather(outs, t)
                ok = all(bool((o == i + 1).all()) for i, o in enumerate(outs))
            elif op == "all_to_all":
                o = torch.empty_like(t)
                dist.all_to_all_single(o, t)
                ok = bool((o.view(world, -1) == torch.arange(1, world + 1, device=dev)[:, None]).all())
            else:
                got = torch.empty_like(t)
                works = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, (rank + 1) % world),
                                                dist.P2POp(dist.irecv, got, (rank - 1) % world)])
                for w in works:
                    w.wait()
                ok = bool((got == (rank - 1) % world + 1).all())
            torch.cuda.synchronize()
            found[op] = "accepted" if ok else "accepted, wrong result"
        except RuntimeError as e:  # the finding is the refusal itself
            found[op] = f"refused: {str(e).splitlines()[0][:160]}"
        Path(out % rank).write_text(json.dumps(found))


def _tc_trainer(spec: dict, case: dict, mesh):
    import torch

    from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN, PerfectECGraphTCN
    from gnn_tracking_tpu_torch.parallel.sharded_model import ShardedGraphTCNTrainer, ShardedTCTrainer

    split = case.get("split", 0)
    if case["model"] == "tc":
        model = PerfectECGraphTCN(**spec["widths"], **PARALLEL_TC_MODEL, halo_edge_split=split, device="cpu")
        cls, weights = ShardedTCTrainer, PARALLEL_TC_WEIGHTS
    else:
        widths = PARALLEL_GTCN_MODEL if case["model"] == "gtcn" else PARALLEL_GRID_MODEL
        model = GraphTCN(**spec["widths"], **widths, ec_threshold=case["threshold"], halo_edge_split=split,
                         device="cpu")
        cls, weights = ShardedGraphTCNTrainer, PARALLEL_GTCN_WEIGHTS
    model.load_state_dict(spec["state"][case["model"]])
    kw = {"max_n_objects": PARALLEL_K, "loss_weights": weights, "optimizer": None}
    if case.get("grid"):
        from gnn_tracking_tpu_torch.parallel.mesh2d import DataGraphTCNTrainer

        return DataGraphTCNTrainer(mesh, model=model, **kw)
    return cls(mesh, model=model, halo_impl=case.get("impl", "a2a"), ring_max_dist=1, **kw)


def _parallel_sharded_case(rank: int, spec: dict, case: dict) -> dict:
    """(a) / (b) / (d) / (e) in one rank: the forward, then ``case["steps"]``
    training steps (each timed, ending in a synchronise), the launches of
    ``PARALLEL_KERNELS`` over them, the exchange alone and its halo rows and
    bytes, and (``profile``) one more step under ``torch.profiler``."""
    import torch
    import torch.distributed as dist

    from gnn_tracking_tpu_torch.parallel.halo import HaloExchange
    from gnn_tracking_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(*case["mesh"], device="cuda")
    trainer = _tc_trainer(spec, case, mesh)
    sg_l, cd_l = trainer.place(spec["sg"][case["partition"]], spec["cd"][case["partition"]])
    trainer.init(sg_l)
    if case.get("force_sharded"):
        trainer._step = trainer._build_step_sharded()
    forward = [t.cpu() for t in trainer.forward(sg_l)]  # collectives: every rank takes part
    _reset_launches()
    res = _steps(trainer.model, trainer.optimizer, lambda: trainer.training_step(sg_l, cd_l), case["steps"],
                 rank == 0)
    res.update(forward=forward if rank == 0 else None, launches=_launch_counts(),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    # the exchange alone, at the HC layers' width, on every rank at once
    impl = trainer.halo_impl
    ex = HaloExchange(sg_l, trainer.group, impl, 1)
    x = torch.randn(sg_l.n_local, PARALLEL_TC_MODEL["h_dim"], device=mesh.device)
    ex(x)
    if trainer.group is not None:
        dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        ex(x)
    torch.cuda.synchronize()
    p, h, f = sg_l.n_shards, sg_l.n_halo, x.shape[1]
    hp = sg_l.send_local.shape[-1]
    rows = {"all_gather": p * sg_l.n_local, "a2a": p * hp, "ring": len(getattr(ex.fetch, "steps", [])) * hp}[impl]
    res.update(exchange_ms=(time.perf_counter() - t0) * 1e2, halo_rows=int(sg_l.halo_mask.sum()), halo_slots=h,
               exchange_rows=rows, exchange_bytes=rows * f * 4, transport={impl: ex.transport})
    if case.get("profile"):  # one more step, traced in rank 0
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) if rank == 0 else contextlib.nullcontext() as prof:
            trainer.training_step(sg_l, cd_l)
            torch.cuda.synchronize()
        if rank == 0:
            names = {e.key for e in prof.key_averages()}
            res["traced"] = {k: any(v in n for n in names) for k, v in PARALLEL_TRACE_NAMES.items()}
    return res


def _parallel_dp_case(rank: int, spec: dict, case: dict) -> dict:
    """(c) in one rank: ``DPTrainer``'s step on this rank's 32k event."""
    import torch

    from gnn_tracking_tpu_torch.parallel.dp import make_dp_train_step
    from gnn_tracking_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(case["mesh"][0], 1, device="cuda")
    module = _dp_module(spec["state"]["dp"], spec["dp_threshold"])
    step = make_dp_train_step(module, mesh)
    ev = spec["dp_events"][mesh.data_rank].to(mesh.device)
    _reset_launches()
    res = _steps(module.model, module.optimizer, lambda: step([ev]), 1, rank == 0)
    return res | {"launches": _launch_counts()}


def _dp_module(state: dict, threshold: float):
    import torch

    from gnn_tracking_tpu_torch.losses.oc import CondensationLossTiger
    from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN
    from gnn_tracking_tpu_torch.training.module import TCModule

    model = GraphTCN(**{**MODEL, "ec_threshold": threshold}, device="cpu")
    model.load_state_dict(state)
    return TCModule(model=model, loss_fct=CondensationLossTiger(**LOSS), lr=LR, device="cuda")


def parallel_rank(rank: int, world: int, spec_path: str) -> None:
    """One rank of phase 18: every case of the spec file whose world size is
    this group's, its results written to ``spec["out"] % rank``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = torch.load(spec_path, weights_only=False, mmap=True)
    results = {}
    for case in spec["cases"]:
        t0 = time.perf_counter()
        fn = _parallel_dp_case if case["kind"] == "dp" else _parallel_sharded_case
        results[case["name"]] = fn(rank, spec, case) | {"case_s": time.perf_counter() - t0}
    torch.save(results, spec["out"] % rank)


def _spawn_ranks(tmp: Path, name: str, world: int, spec: dict, backend: str = "gloo") -> list[dict]:
    """The cases of ``spec`` in ``world`` ranks on this card (a ``FileStore`` in
    ``tmp``); each rank's results."""
    import torch

    from gnn_tracking_tpu_torch.parallel.multihost import spawn

    spec = {**spec, "out": str(tmp / f"{name}_rank%d.pt")}
    torch.save(spec, tmp / f"{name}_spec.pt")
    spawn(parallel_rank, world, (str(tmp / f"{name}_spec.pt"),), store_file=str(tmp / f"{name}_store"),
          backend=backend, device="cuda", timeout_s=600)
    return [torch.load(spec["out"] % r, weights_only=False) for r in range(world)]


def _check_steps(what: str, got: dict, ref: dict) -> dict:
    """Each step of the ranks (``got``, rank 0) against the reference's
    step from the same weights and optimizer state, at the ``PARALLEL_*``
    tolerances: its losses, its gradients and the weights after it (see
    there). Returns the worst relative differences."""
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    after = [b["params"] for b in got["before"][1:]] + [got["after"]]
    for i in range(len(got["losses"])):
        for k, v in ref["losses"][i].items():
            a = got["losses"][i][k]
            assert abs(a - v) <= PARALLEL_STEP_RTOL * abs(v) + PARALLEL_LOSS_ATOL, (
                f"{what}: step {i} loss {k} {a} against {v}")
            worst["loss"] = max(worst["loss"], abs(a - v) / max(abs(v), 1e-30))
        grads = ref["grads"][i]
        total = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values() if g is not None))
        for n, g in grads.items():
            if g is None:
                assert got["grads"][i][n] is None, f"{what}: step {i}: {n} has a gradient only when sharded"
                continue
            diff = float((got["grads"][i][n].double() - g.double()).norm())
            assert diff <= PARALLEL_STEP_RTOL * float(g.double().norm()) + PARALLEL_GRAD_FLOOR * total, (
                f"{what}: step {i} gradient {n} differs by {diff:.3e} (norm {float(g.norm()):.3e})")
            if float(g.double().norm()) > PARALLEL_GRAD_FLOOR * total:
                worst["grad"] = max(worst["grad"], diff / float(g.double().norm()))
        for n, p in ref["after"][i].items():
            d = after[i][n].double() - p.double()
            steady = grads[n].abs() > PARALLEL_ADAM_FLOOR if grads[n] is not None else d != d
            diff, ref_norm = float(d[steady].norm()), float(p.double()[steady].norm())
            assert diff <= PARALLEL_STEP_RTOL * ref_norm, (
                f"{what}: step {i}: weights {n} after it differ by {diff:.3e} (norm {ref_norm:.3e})")
            assert float(d.abs().max()) <= PARALLEL_ADAM_MOVE, (
                f"{what}: step {i}: a weight of {n} moved {float(d.abs().max()):.3e} from the reference's")
            worst["param"] = max(worst["param"], diff / max(ref_norm, 1e-30))
    return worst


def parallel_threshold(model, graphs) -> tuple[float, dict]:
    """An EC cut for (b) / (d) that no rounding difference between the ranks
    and the fast path can move an edge across: the middle of the widest gap
    between adjacent edge weights of the middle 40 % (at least
    ``PARALLEL_CUT_GAP`` wide), else below every weight (every edge passes).
    A random EC's weights on 6M edges crowd within a few float32 steps of
    each other, where ``calibrate_ec_threshold``'s gap is a few ulps. Sets
    the model's threshold; returns it and the weights' quantiles (all of
    ``graphs``' edges)."""
    import torch

    with torch.no_grad():
        w = torch.sort(torch.cat([model.ec(g)["W"][g.edge_mask] for g in graphs])).values
    lo, hi = int(0.3 * len(w)), int(0.7 * len(w))
    i = lo + int(torch.argmax(w[lo + 1 : hi + 1] - w[lo:hi]))
    gap = float(w[i + 1] - w[i])
    threshold = float((w[i] + w[i + 1]) / 2) if gap >= PARALLEL_CUT_GAP else float(w[0]) - 1e-3
    model.ec_threshold = model.model_config["ec_threshold"] = threshold
    q = {f"q{p}": float(w[min(int(p / 100 * len(w)), len(w) - 1)]) for p in (0, 30, 50, 70, 100)}
    return threshold, {**q, "gap": gap, "passed": float((w > threshold).float().mean())}


def _load_state(model, optimizer, state: dict) -> None:
    import torch

    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(state["params"][n])
    optimizer.load_state_dict(state["opt"])


def _reference(trainer, events, run: dict, forward: bool = False) -> dict:
    """The fast path on this card (one rank, no exchange, no collectives),
    from each starting state of the ranks' steps (``run["before"]``): one
    step on the mean of ``events``' losses (their gradients summed over the
    events over their count); with ``forward``, the forward of the first
    event from the first state."""
    import torch

    trainer.init(events[0][0])
    ref = {"losses": [], "grads": [], "after": [], "step_ms": []}
    for i, state in enumerate(run["before"]):
        _load_state(trainer.model, trainer.optimizer, state)
        if i == 0 and forward:
            ref["forward"] = [t.cpu() for t in trainer.forward(events[0][0])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.model.train()
        trainer.optimizer.zero_grad(set_to_none=True)
        per_event = []
        for sg_l, cd_l in events:
            losses = trainer._shard_losses(trainer._apply(sg_l, exchange=False), sg_l, cd_l, None)
            total = sum(trainer.loss_weights.get(k, 0.0) * v for k, v in losses.items())
            (total / len(events)).backward()
            per_event.append({k: float(v.detach()) for k, v in (losses | {"total": total}).items()})
        trainer.optimizer.step()
        torch.cuda.synchronize()
        ref["step_ms"].append((time.perf_counter() - t0) * 1e3)
        ref["losses"].append({k: sum(e[k] for e in per_event) / len(events) for k in per_event[0]})
        ref["grads"].append(_grads(trainer.model))
        ref["after"].append(_params(trainer.model))
    return ref


def _parallel_event(seed: int, tmp: Path):
    """etl-trackml-110k's 1-sector graph as phase 14 builds it (its point
    cloud where phase 14 ran, else made again), on the host."""
    from gnn_tracking_tpu_torch.graph_construction.graph_builder import GraphBuilder
    from gnn_tracking_tpu_torch.preprocessing import build_point_clouds
    from gnn_tracking_tpu_torch.utils.loading import load_graph

    pcs = tmp / "etl_pc_pileup_1"
    if not pcs.is_dir():
        raw = tmp / "parallel_raw"
        raw.mkdir()
        for name in ETL_CSVS:
            shutil.copy(REPO / "tests" / "test_data" / "trackml" / name, raw / name)
        make_pileup(seed, raw, tmp / "parallel_raw_110k")
        build_point_clouds.main(["--indir", str(tmp / "parallel_raw_110k"), "--outdir", str(pcs),
                                 "--detector-config", str(raw / "detectors.csv.gz"), "--n-sectors", "1",
                                 "--pixel-only", "--add-true-edges"])
    gb = GraphBuilder(pcs, tmp / "parallel_unused", device="cuda")
    pc = load_graph(sorted(pcs.glob("*.npz"))[0], device="cpu")
    return gb.to_graph(pc, *gb.edges_from_join(gb.join(pc), pc)[:3]).to("cpu")


def parallel_phase(seed: int, tmp: Path) -> dict:
    """Phase 18 (see the module docstring). Returns the launches of
    ``PARALLEL_KERNELS`` summed over every rank of (a)-(e) (each rank a
    fresh process, its counts set to 0 just before its steps and read just
    after) and the phase's summary."""
    import torch

    from gnn_tracking_tpu_torch.graphs import EventGraph
    from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN, PerfectECGraphTCN
    from gnn_tracking_tpu_torch.parallel.dp import make_dp_train_step
    from gnn_tracking_tpu_torch.parallel.halo import (
        partition_event,
        ring_halo_distance,
        unpartition_edges,
        unpartition_nodes,
    )
    from gnn_tracking_tpu_torch.parallel.mesh import make_mesh
    from gnn_tracking_tpu_torch.parallel.mesh2d import sharded_buckets, stack_sharded
    from gnn_tracking_tpu_torch.parallel.multihost import spawn
    from gnn_tracking_tpu_torch.parallel.sharded_model import (
        ShardedGraphTCNTrainer,
        ShardedTCTrainer,
        shard_as_eventgraph,
    )
    from gnn_tracking_tpu_torch.parallel.sharded_tc import partition_condensation

    card = card_line()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    summary = {"card": card, "s": {}, "parent_reserved_gib": torch.cuda.memory_reserved() / 2**30}

    def say(msg: str) -> None:
        log(f"parallel: {msg} [{card}]")

    # ---- the probe: which collectives gloo takes on CUDA tensors (two ranks of their own)
    t0 = time.perf_counter()
    probe = str(tmp / "probe_rank%d.json")
    try:
        spawn(parallel_probe_rank, 2, (probe,), store_file=str(tmp / "probe_store"), backend="gloo",
              device="cuda", timeout_s=60)
        probe_exit = "both ranks ended"
    except Exception as e:  # noqa: BLE001 -- a rank that dies in a refused collective is a finding
        probe_exit = f"{type(e).__name__}: {str(e).strip().splitlines()[-1][:200]}"
    found = [json.loads(Path(probe % r).read_text()) if Path(probe % r).exists() else {} for r in range(2)]
    summary["probe"] = {"rank0": found[0], "rank1": found[1], "exit": probe_exit}
    summary["s"]["probe"] = time.perf_counter() - t0
    say(f"gloo on CUDA tensors: {json.dumps(found)}; {probe_exit} ({summary['s']['probe']:.1f} s)")

    # ---- the inputs: the full event and a rotation of it, their partitions and truth tables
    t0 = time.perf_counter()
    event = _parallel_event(seed, tmp)
    n, e = event.num_nodes, event.num_edges
    second = event.replace(x=event.x.clone())
    second.x[:, 1] = torch.remainder(second.x[:, 1] + PARALLEL_ROTATION + math.pi, 2 * math.pi) - math.pi
    summary["s"]["event"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sg = {"p2": partition_event(event, PARALLEL_SHARDS, sort_edges=True)}
    summary["s"]["partition_event"] = time.perf_counter() - t0
    sg["p1"] = partition_event(event, 1, sort_edges=True)
    sg["split"] = partition_event(event, PARALLEL_SHARDS, sort_edges=True, halo_edges_last=True)
    sg["p1_second"] = partition_event(second, 1, sort_edges=True)
    buckets = sharded_buckets([event, second], PARALLEL_SHARDS, sort_edges=True)
    grid = [partition_event(g, PARALLEL_SHARDS, sort_edges=True, pad_to=buckets) for g in (event, second)]
    sg["grid"] = stack_sharded(grid)

    def truth(g, part):
        return partition_condensation(g, part, max_n_objects=PARALLEL_K, subsample_seed=PARALLEL_SUBSAMPLE_SEED)

    cd = {k: truth(event, sg[k]) for k in ("p1", "p2", "split")}
    cd["p1_second"] = truth(second, sg["p1_second"])
    cd["grid"] = stack_sharded([truth(g, s) for g, s in zip((event, second), grid)])
    ring = ring_halo_distance(sg["p2"])
    assert ring <= 1, f"ring halo distance {ring}: the ring fetch would drop rows"
    p2 = sg["p2"]
    summary["event"] = {"hits": n, "edges": e, "shard_rows": p2.n_local, "halo_rows": p2.halo_mask.sum(1).tolist(),
                        "halo_slots": p2.n_halo, "pair_slots": p2.send_local.shape[-1],
                        "shard_edges": p2.edge_mask.sum(1).tolist(), "ring_distance": ring,
                        "e_split": sg["split"].e_split, "objects": int(cd["p1"].n_objects)}
    say(f"etl-trackml-110k at 1 sector ({summary['s']['event']:.1f} s), {PARALLEL_SHARDS} shards "
        f"(partition_event into them {summary['s']['partition_event']:.2f} s on the host): "
        + json.dumps(summary["event"]))

    # ---- seeded weights, the EC cuts near the median weight on the fast path
    widths = {"node_indim": event.x.shape[1], "edge_indim": event.edge_attr.shape[1]}
    gen = torch.Generator().manual_seed(seed + 18)
    models = {
        "tc": lambda: PerfectECGraphTCN(**widths, **PARALLEL_TC_MODEL, device="cpu"),
        "gtcn": lambda: GraphTCN(**widths, **PARALLEL_GTCN_MODEL, device="cpu"),
        "grid": lambda: GraphTCN(**widths, **PARALLEL_GRID_MODEL, device="cpu"),
    }
    state = {k: type(make())(**make().model_config, device="cpu", generator=gen).state_dict()
             for k, make in models.items()}
    state["dp"] = GraphTCN(**MODEL, device="cpu", generator=gen).state_dict()
    mesh1 = make_mesh(1, 1, device="cuda")
    thresholds = {}

    def fast_trainer(key):
        model = models[key]()
        model.load_state_dict(state[key])
        if key != "tc":
            model.ec_threshold = model.model_config["ec_threshold"] = thresholds.get(key, 0.5)
            return ShardedGraphTCNTrainer(mesh1, model=model, max_n_objects=PARALLEL_K,
                                          loss_weights=PARALLEL_GTCN_WEIGHTS)
        return ShardedTCTrainer(mesh1, model=model, max_n_objects=PARALLEL_K, loss_weights=PARALLEL_TC_WEIGHTS)

    cuts = {}
    for key in ("gtcn", "grid"):
        trainer = fast_trainer(key)
        events = [shard_as_eventgraph(trainer.place(sg[k]), local_csr=True)
                  for k in (("p1",) if key == "gtcn" else ("p1", "p1_second"))]
        thresholds[key], cuts[key] = parallel_threshold(trainer.model.model, events)
        del trainer, events
    dp_events = [EventGraph.from_arrays(**make_train_event(seed + 5 + i)).sort_edges_by_target() for i in range(2)]
    dp_model = GraphTCN(**MODEL, device="cpu")
    dp_model.load_state_dict(state["dp"])
    thresholds["dp"] = calibrate_ec_threshold(dp_model.to("cuda"), dp_events[0].to("cuda"))
    del dp_model
    torch.cuda.empty_cache()
    say(f"EC cuts {thresholds}; (b) / (d) edge weights {json.dumps(cuts)}")

    # ---- the ranks: (a), (b), (c) in two gloo ranks; (d) in four; (e) one NCCL rank
    cases = [{"name": f"a_{impl}", "kind": "sharded", "model": "tc", "mesh": (1, PARALLEL_SHARDS),
              "impl": "a2a" if impl == "split" else impl, "partition": "split" if impl == "split" else "p2",
              "split": sg["split"].e_split if impl == "split" else 0, "steps": PARALLEL_STEPS,
              "profile": impl == "a2a"} for impl in PARALLEL_IMPLS]
    cases.append({"name": "b", "kind": "sharded", "model": "gtcn", "mesh": (1, PARALLEL_SHARDS), "partition": "p2",
                  "threshold": thresholds["gtcn"], "steps": 1})
    cases.append({"name": "c", "kind": "dp", "mesh": (2, 1)})
    base = {"state": state, "widths": widths, "dp_events": dp_events, "dp_threshold": thresholds["dp"]}
    runs = {}
    for name, world, backend, group in (
        ("two", 2, "gloo", cases),
        ("four", 4, "gloo", [{"name": "d", "kind": "sharded", "model": "grid", "grid": True,
                              "mesh": (2, PARALLEL_SHARDS), "partition": "grid", "threshold": thresholds["grid"],
                              "steps": 1}]),
        ("nccl", 1, "nccl", [{"name": "e", "kind": "sharded", "model": "tc", "mesh": (1, 1), "partition": "p1",
                              "steps": PARALLEL_STEPS, "force_sharded": True}]),
    ):
        t0 = time.perf_counter()
        used = {c["partition"] for c in group if "partition" in c}  # only what the group's cases read
        spec = {**base, "cases": group, "sg": {k: sg[k] for k in used}, "cd": {k: cd[k] for k in used}}
        ranks = _spawn_ranks(tmp, name, world, spec, backend=backend)
        summary["s"][f"{name}_ranks"] = time.perf_counter() - t0
        runs |= {case["name"]: [r[case["name"]] for r in ranks] for case in group}
    launches = dict.fromkeys(PARALLEL_KERNELS, 0)
    for name, ranks in runs.items():
        for r, res in enumerate(ranks):
            for k, v in res["launches"].items():
                assert v > 0, f"({name}) rank {r} never launched {k}"
                launches[k] += v

    # ---- the references: the fast path on this card from each step's starting state, and the checks
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()

    def close(what, x, y):
        assert torch.allclose(x, y, rtol=PARALLEL_FWD_RTOL, atol=PARALLEL_FWD_RTOL * float(y.abs().max())), (
            f"{what} differs by {float((x - y).abs().max()):.3e}")
        return float((x - y).abs().max() / y.abs().max())

    def rank_stats(ranks):
        return {k: [res.get(k) for res in ranks] for k in ("step_ms", "case_s", "launches", "peak_gib")}

    trainer = fast_trainer("tc")
    events = [trainer.place(sg["p1"], cd["p1"])]
    for impl in (*PARALLEL_IMPLS, "e"):
        name = "e" if impl == "e" else f"a_{impl}"
        run = runs[name][0]
        ref = _reference(trainer, events, run, forward=True)
        part = {"split": sg["split"], "e": sg["p1"]}.get(impl, sg["p2"])
        fwd = [close(f"({name}) forward {k}", unpartition_nodes(x, part, n), unpartition_nodes(y, sg["p1"], n))
               for k, x, y in zip(("H", "B"), run["forward"], ref["forward"])]
        summary[name] = {"fwd_rel": fwd, "worst": _check_steps(f"({name})", run, ref),
                         "losses": [s["total"] for s in run["losses"]], **rank_stats(runs[name]),
                         "fast_path_step_ms": ref["step_ms"]}
        summary[name] |= {k: [res[k] for res in runs[name]] for k in
                          ("exchange_ms", "halo_rows", "exchange_rows", "exchange_bytes", "transport")}
        if "traced" in run:
            assert all(run["traced"].values()), run["traced"]
            summary[name]["traced"] = run["traced"]
        say(f"({name}): " + json.dumps(summary[name]))
    trainer = fast_trainer("gtcn")
    run = runs["b"][0]
    ref = _reference(trainer, [trainer.place(sg["p1"], cd["p1"])], run, forward=True)
    pairs = {}
    for i, k in enumerate(("H", "B", "W", "cut")):
        unpart = unpartition_edges if k in ("W", "cut") else unpartition_nodes
        size = e if k in ("W", "cut") else n
        pairs[k] = (unpart(run["forward"][i], sg["p2"], size), unpart(ref["forward"][i], sg["p1"], size))
    say(f"(b) forward: cut differs on {int((pairs['cut'][0] != pairs['cut'][1]).sum())} edges, max |diff| "
        + json.dumps({k: float((x.double() - y.double()).abs().max()) for k, (x, y) in pairs.items() if k != "cut"}))
    assert torch.equal(*pairs["cut"]), "(b): the EC cut differs"
    fwd = [close(f"(b) forward {k}", *pairs[k]) for k in ("H", "B", "W")]
    summary["b"] = {"fwd_rel": fwd, "worst": _check_steps("(b)", run, ref), "losses": run["losses"][0],
                    **rank_stats(runs["b"]), "fast_path_step_ms": ref["step_ms"]}
    say("(b) ShardedGraphTCNTrainer: " + json.dumps(summary["b"]))
    trainer = fast_trainer("grid")
    run = runs["d"][0]
    ref = _reference(trainer, [trainer.place(sg[k], cd[k]) for k in ("p1", "p1_second")], run)
    summary["d"] = {"worst": _check_steps("(d)", run, ref), "losses": run["losses"][0], **rank_stats(runs["d"]),
                    "fast_path_step_ms": ref["step_ms"]}
    say("(d) DataGraphTCNTrainer 2 x 2: " + json.dumps(summary["d"]))
    del trainer
    run = runs["c"][0]
    module = _dp_module(state["dp"], thresholds["dp"])
    step = make_dp_train_step(module, mesh1)
    _load_state(module.model, module.optimizer, run["before"][0])
    ref = _steps(module.model, module.optimizer, lambda: step([g.to("cuda") for g in dp_events]), 1, True)
    ref["after"] = [ref["after"]]
    summary["c"] = {"worst": _check_steps("(c)", run, ref), "losses": run["losses"][0], **rank_stats(runs["c"]),
                    "single_process_step_ms": ref["step_ms"]}
    say("(c) DPTrainer over 2 ranks: " + json.dumps(summary["c"]))
    summary["s"]["references"] = time.perf_counter() - t0
    summary["reference_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    summary["s"]["phase"] = time.perf_counter() - t_phase
    say(f"phase 18: {json.dumps(summary['s'])}; references' peak {summary['reference_peak_gib']:.1f} GiB; "
        f"launches over the ranks {launches}")
    return {"launches": launches, "summary": summary}


# ---------------------------------------------------------------------------
# phase 19: the full-detector training driver, its options and the demos

#: (a): the driver at the JAX script's defaults on one rank (1 x 1, the fast path, one event)
FD_ARGV = ["--n-data", "1", "--n-graph", "1", "--n-events", "1"]
FD_STEPS = 12
FD_MODES = {"f32": [], "bf16": ["--bf16"], "remat": ["--remat"]}
#: (b): the 2 x 2 mesh in four ranks sharing the card, one event a data rank
FD_GRID_ARGV = ["--n-data", "2", "--n-graph", "2", "--n-events", "2"]
FD_GRID_STEPS = 3
#: the kernels of (a) and (b), by the module attribute that launches each
FD_KERNELS = {**PARALLEL_KERNELS,
              "fused_relational_bf16_fwd": ("fused_relational", "fused_relational_bf16_fwd"),
              "fused_relational_bf16_bwd": ("fused_relational", "fused_relational_bf16_bwd")}
#: (c): the demos' kernels in this process (demo_sharded's ranks count their own)
FD_DEMO_KERNELS = {**TC_CLI_KERNELS, "pairwise_topk": ("pairwise_topk", "pairwise_topk")}


def fd_grads(trainer, sg_l, cd_l) -> tuple[dict, float]:
    """One step's parameter gradients on the fast path (no optimizer step)."""
    trainer.model.train()
    trainer.model.zero_grad(set_to_none=True)
    losses = trainer._shard_losses(trainer._apply(sg_l, exchange=False), sg_l, cd_l, None)
    total = sum(trainer.loss_weights.get(k, 0.0) * v for k, v in losses.items())
    total.backward()
    grads = _grads(trainer.model)
    trainer.model.zero_grad(set_to_none=True)
    return grads, float(total.detach())


def fd_compare(gk: dict, gp: dict, make_g64, *, bf16: bool) -> dict:
    """Step 0's gradients through the kernels (``gk``) against the plain
    path's (``gp``) at the existing gates: f32 ``compare_grads``' (per
    tensor |gk - gp| <= 1e-4 |gp| + 1e-7 of the whole norm), bf16 phase
    9's (max |gk - gp| <= 5e-2 of the tensor's largest magnitude). A tensor
    that misses it (cancelling sums) is held against a float64 evaluation
    (``make_g64()``, made once when first needed): the kernels no further
    from it than 4x the plain path, or than the gate. Returns the worst
    tensor and those held against float64."""
    import torch

    total = math.sqrt(sum(float(g.double().square().sum()) for g in gp.values() if g is not None))
    worst, ratio, at_floor, missed = None, 0.0, [], []
    for n, p in gp.items():
        if p is None:
            assert gk[n] is None, f"{n}: a gradient through the kernels only"
            continue
        k = gk[n]
        assert k is not None and bool(torch.isfinite(k).all()), f"{n}: no finite gradient through the kernels"
        if bf16:
            top = float(p.abs().max())
            r = float((k - p).abs().max()) / top if top else math.inf
            ok = r <= 5e-2
        else:
            ref = float(p.double().norm())
            diff = float((k.double() - p.double()).norm())
            r = diff / ref if ref else math.inf
            ok = diff <= 1e-4 * ref + 1e-7 * total
            if ok and r > 1e-4:  # within the floor of the whole norm only
                at_floor.append(n)
                continue
        if not ok:
            missed.append(n)
        elif r >= ratio:
            worst, ratio = n, r
    held = {}
    if missed:
        g64 = make_g64()
        total64 = math.sqrt(sum(float(g.square().sum()) for g in g64.values() if g is not None))
        for n in missed:
            ref = float(g64[n].norm())
            ek, ep = float((gk[n].double() - g64[n]).norm()), float((gp[n].double() - g64[n]).norm())
            lim = max(4 * ep, (5e-2 if bf16 else 1e-4) * ref) + 1e-7 * total64
            assert ek <= lim, f"{n}: |g_kernel - g64| {ek:.3e} > {lim:.3e} (|g_plain - g64| {ep:.3e}, |g64| {ref:.3e})"
            held[n] = {"kernel": ek, "plain": ep, "norm": ref, "floor": 1e-7 * total64}
    return {"worst": worst, "worst_rel": ratio, "at_floor": at_floor, "held_to_f64": held}


@contextlib.contextmanager
def segment_plain():
    """``ops/csr_segment``'s kernel routes (rows #9 / #10: the models'
    endpoint gathers and their backward sums outside the fused op) on their
    plain versions, which take any dtype: with ``plain_path`` a float64
    evaluation of a model on the card."""
    import torch

    from gnn_tracking_tpu_torch.ops import csr_segment as cs

    def segment_sum_csr(messages, rowptr, *, perm=None):
        n = rowptr.shape[0] - 1
        ids = torch.repeat_interleave(torch.arange(n, device=rowptr.device), rowptr.long().diff())
        rows = messages if perm is None else messages.index_select(0, perm.long())
        return cs.sorted_segment_sum_plain(rows, ids, n)

    sites = {"_gather": lambda values, dst: cs.sorted_gather_plain(values, dst.long()),
             "_segment_sum": lambda messages, dst, n, rowptr: cs.sorted_segment_sum_plain(messages, dst.long(), n),
             "segment_sum_csr": segment_sum_csr}
    saved = {k: getattr(cs, k) for k in sites}
    for k, fn in sites.items():
        setattr(cs, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(cs, k, fn)


def fd_split(trainer, sg_l, cd_l, rounds: int = 3) -> dict:
    """Median forward / loss / backward / Adam times (ms) of a fast-path
    step, each part ended by a synchronise."""
    import torch

    def once():
        marks = [time.perf_counter()]
        trainer.model.train()
        out = trainer._apply(sg_l, exchange=False)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        losses = trainer._shard_losses(out, sg_l, cd_l, None)
        total = sum(trainer.loss_weights.get(k, 0.0) * v for k, v in losses.items())
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        trainer.optimizer.zero_grad(set_to_none=True)
        total.backward()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        trainer.optimizer.step()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]

    torch.cuda.synchronize()
    splits = [once() for _ in range(rounds)]
    return {k: statistics.median(s[i] for s in splits)
            for i, k in enumerate(("forward_ms", "loss_ms", "backward_ms", "adam_ms"))}


def fd_kernel_checks(model, g, seed: int) -> dict:
    """Rows #1-#4, #9 and #10 at the full-detector event's shapes (EC layer
    1's inputs: 267,386 rows of 32 features, 2,139,088 edges, hidden 128),
    each against its plain version on the card as phases 3 and 9 hold them
    (rows #1 / #9 within 1e-4 / 1e-6 of the largest magnitude, row #2 within
    4x the plain f32 error against float64, A / B phase 9's ``bf16_check``,
    row #10 bitwise; each repeating bitwise), and timed (``cuda_ms``; rows #9
    / #10 on the device, ``graph_ms``) beside the plain version and the bound."""
    import torch

    from gnn_tracking_tpu_torch.ops import csr_segment
    from gnn_tracking_tpu_torch.ops import fused_relational as fr

    dev = g.x.device
    csr = g.csr()
    rowptr, dst = csr["dst_rowptr"], g.edge_index[1]
    n, e = g.x.shape[0], g.edge_index.shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    out = {}
    with torch.no_grad():
        x = torch.relu(model.ec.ec_node_encoder(g.x)).contiguous()
        ea = model.ec.ec_edge_encoder(g.edge_attr).contiguous()
        w = {k: v.detach() for k, v in model.ec.ec_resin.layers[1].relational_weights().items()}
        mask = g.edge_mask
        fx, fe, hid, fo = x.shape[1], ea.shape[1], w["w2"].shape[0], w["w3"].shape[0]
        n_valid = int(mask.sum())
        flops_f = 2.0 * n_valid * ((2 * fx + fe) * hid + hid * hid + hid * fo)
        flops_b = 2.0 * n_valid * (3 * (2 * fx + fe) * hid + 3 * hid * hid + 2 * hid * fo)
        g_e = torch.randn((e, fo), generator=gen, device=dev)
        g_a = torch.randn((n, fo), generator=gen, device=dev)
        w64 = {k: v.double() for k, v in w.items()}
        # row #1 (relu_edge: the layer's own call) and row #2
        k1 = fr.fused_relational_fwd(x, ea, g.edge_index, mask, w, rowptr=rowptr, relu_edge=True)
        k1b = fr.fused_relational_fwd(x, ea, g.edge_index, mask, w, rowptr=rowptr, relu_edge=True)
        p1 = fr.fused_relational_plain(x, ea, g.edge_index, mask, w, relu_edge=True)
        err1 = 0.0
        for name, kt, kt2, pt in zip(("e_tilde", "agg"), k1, k1b, p1):
            assert torch.equal(kt, kt2), f"fused_relational_fwd {name}: second launch differs"
            err = float((kt - pt).abs().max())
            assert err <= 1e-4 * float(pt.abs().max()), f"fused_relational_fwd {name}: {err}"
            err1 = max(err1, err)
        bargs = (x, ea, g.edge_index, mask, w, g_e, g_a)
        k2 = fr.fused_relational_bwd(*bargs, csr, relu_edge=True)
        k2b = fr.fused_relational_bwd(*bargs, csr, relu_edge=True)
        p2 = fr.fused_relational_bwd_plain(*bargs, relu_edge=True)
        r2 = fr.fused_relational_bwd_plain(x.double(), ea.double(), g.edge_index, mask, w64, g_e.double(),
                                           g_a.double(), relu_edge=True)

        def flat(o):
            return {"g_x": o[0], "g_edge_attr": o[1], **o[2]}

        err2 = 0.0
        for (name, kt), kt2, pt, rt in zip(flat(k2).items(), flat(k2b).values(), flat(p2).values(),
                                           flat(r2).values()):
            assert torch.equal(kt, kt2), f"fused_relational_bwd {name}: second launch differs"
            ek, ep = float((kt.double() - rt).abs().max()), float((pt.double() - rt).abs().max())
            assert math.isfinite(ek) and ek <= 4 * ep, f"fused_relational_bwd {name}: {ek:.3e} > 4 x {ep:.3e}"
            err2 = max(err2, float((kt - pt).abs().max()))
        del k2b, p2, r2
        args = (x, ea, g.edge_index, mask, w)
        for key, fn, plain, flops, err in (
            ("fused_relational_fwd", lambda: fr.fused_relational_fwd(*args, rowptr=rowptr, relu_edge=True),
             lambda: fr.fused_relational_plain(*args, relu_edge=True), flops_f, err1),
            ("fused_relational_bwd", lambda: fr.fused_relational_bwd(*bargs, csr, relu_edge=True),
             lambda: fr.fused_relational_bwd_plain(*bargs, relu_edge=True), flops_b, err2),
        ):
            outs = k1 if key.endswith("fwd") else (k2[0], k2[1], *k2[2].values())
            by = nbytes(x, ea, g.edge_index, mask, *w.values(), *outs) + (
                nbytes(g_e, g_a, *csr.values()) if key.endswith("bwd") else nbytes(rowptr))
            b_ms, b_by = bound(flops, by)
            out[key] = {"max_abs_err": err, "ms": cuda_ms(fn, rounds=3), "plain_ms": cuda_ms(plain, reps=1, rounds=3),
                        "bound_ms": b_ms, "bound_by": b_by}
        del k1, k1b, p1, k2
        # A / B: the same layer in bf16
        bf = torch.bfloat16
        xb, eab = x.to(bf), ea.to(bf)
        wb = {k: v.to(bf) for k, v in w.items()}
        g_eb, g_ab = g_e.to(bf), g_a.to(bf)
        ref_f = dict(zip(("e_tilde", "agg"), fr.fused_relational_plain(
            xb.double(), eab.double(), g.edge_index, mask, {k: v.double() for k, v in wb.items()}, relu_edge=True)))
        a = dict(zip(("e_tilde", "agg"), fr.fused_relational_bf16_fwd(xb, eab, g.edge_index, mask, wb, rowptr=rowptr,
                                                                       relu_edge=True)))
        a2 = dict(zip(("e_tilde", "agg"), fr.fused_relational_bf16_fwd(xb, eab, g.edge_index, mask, wb,
                                                                        rowptr=rowptr, relu_edge=True)))
        pa = dict(zip(("e_tilde", "agg"), fr.fused_relational_bf16_plain(xb, eab, g.edge_index, mask, wb,
                                                                         relu_edge=True)))
        errs_a = bf16_check("fused_relational_bf16_fwd (full detector)", a, a2, pa, ref_f)
        del a2, pa, ref_f
        bb = (xb, eab, g.edge_index, mask, wb, g_eb, g_ab)
        ref_b = flat(fr.fused_relational_bwd_plain(xb.double(), eab.double(), g.edge_index, mask,
                                                   {k: v.double() for k, v in wb.items()}, g_eb.double(),
                                                   g_ab.double(), relu_edge=True))
        b = flat(fr.fused_relational_bf16_bwd(*bb, csr, relu_edge=True))
        b2 = flat(fr.fused_relational_bf16_bwd(*bb, csr, relu_edge=True))
        pb = flat(fr.fused_relational_bf16_bwd_plain(*bb, relu_edge=True))
        errs_b = bf16_check("fused_relational_bf16_bwd (full detector)", b, b2, pb, ref_b)
        del b2, pb, ref_b
        for key, fn, plain, flops, errs, outs in (
            ("fused_relational_bf16_fwd",
             lambda: fr.fused_relational_bf16_fwd(xb, eab, g.edge_index, mask, wb, rowptr=rowptr, relu_edge=True),
             lambda: fr.fused_relational_bf16_plain(xb, eab, g.edge_index, mask, wb, relu_edge=True), flops_f,
             errs_a, a.values()),
            ("fused_relational_bf16_bwd", lambda: fr.fused_relational_bf16_bwd(*bb, csr, relu_edge=True),
             lambda: fr.fused_relational_bf16_bwd_plain(*bb, relu_edge=True), flops_b, errs_b, b.values()),
        ):
            by = nbytes(xb, eab, g.edge_index, mask, *wb.values(), *outs) + (
                nbytes(g_eb, g_ab, *csr.values()) if key.endswith("bwd") else nbytes(rowptr))
            b_ms, b_by = bound(flops, by, PEAK_BF16_FLOPS)
            out[key] = {"max_abs_err": max(er[1] for er in errs), "ms": cuda_ms(fn, rounds=3),
                        "plain_ms": cuda_ms(plain, reps=1, rounds=3), "bound_ms": b_ms, "bound_by": b_by}
        del a, b
        # rows #9 / #10 at the edge width
        msgs = torch.where(mask[:, None], torch.randn((e, fo), generator=gen, device=dev), 0.0)
        k9 = csr_segment.sorted_segment_sum(msgs, dst, n, rowptr=rowptr)
        assert torch.equal(k9, csr_segment.sorted_segment_sum(msgs, dst, n, rowptr=rowptr)), "row #9 repeat"
        p9 = csr_segment.sorted_segment_sum_plain(msgs, dst, n)
        err9 = float((k9 - p9).abs().max())
        assert err9 <= 1e-6 * float(p9.abs().max()), f"sorted_segment_sum: {err9}"
        b_ms, b_by = bound(float(e * fo), nbytes(msgs, rowptr, p9))
        out["sorted_segment_sum"] = {
            "max_abs_err": err9, "ms": graph_ms(lambda: csr_segment.sorted_segment_sum(msgs, dst, n, rowptr=rowptr)),
            "plain_ms": graph_ms(lambda: csr_segment.sorted_segment_sum_plain(msgs, dst, n)),
            "library_ms": graph_ms(lambda: torch.segment_reduce(msgs, "sum", offsets=rowptr.long(), unsafe=True)),
            "bound_ms": b_ms, "bound_by": b_by}
        vals = torch.randn((n, fx), generator=gen, device=dev)
        k10 = csr_segment.sorted_gather(vals, dst, rowptr=rowptr)
        assert torch.equal(k10, csr_segment.sorted_gather_plain(vals, dst)), "sorted_gather differs from index_select"
        b_ms, b_by = bound(0.0, nbytes(vals, dst, k10))
        out["sorted_gather"] = {
            "max_abs_err": 0.0, "ms": graph_ms(lambda: csr_segment.sorted_gather(vals, dst, rowptr=rowptr)),
            "plain_ms": graph_ms(lambda: csr_segment.sorted_gather_plain(vals, dst)),
            "library_ms": graph_ms(lambda: torch.index_select(vals, 0, dst)), "bound_ms": b_ms, "bound_by": b_by}
    return out


def fulldetector_rank(rank: int, world: int, spec_path: str) -> None:
    """One rank of phase 19 (b): the driver's trainer (``build_trainer``) on
    its shard of the stacked events, the spec's EC cut, ``FD_GRID_STEPS``
    steps recorded as ``_steps`` records them (rank 0: each step's starting
    state, gradients and the weights after), its launches and peak memory."""
    import torch

    from gnn_tracking_tpu_torch.scripts import train_fulldetector as fd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = torch.load(spec_path, weights_only=False, mmap=True)
    args = fd.parse_args([*FD_GRID_ARGV, "--steps", str(FD_GRID_STEPS)])
    mesh = fd.make_data_graph_mesh(args.n_data, args.n_graph, device="cuda")
    trainer = fd.build_trainer(args, mesh, spec["sgs"].x.shape[-1], spec["sgs"].edge_attr.shape[-1])
    trainer.model.model.ec_threshold = spec["threshold"]
    sg_l, cd_l = trainer.place(spec["sgs"], spec["cds"])
    trainer.init(sg_l)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(FD_KERNELS)
    res = _steps(trainer.model, trainer.optimizer, lambda: trainer.training_step(sg_l, cd_l), FD_GRID_STEPS,
                 rank == 0)
    res.update(launches=_launch_counts(FD_KERNELS), peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    torch.save(res, spec["out"] % rank)


def fulldetector_phase(seed: int, tmp: Path) -> dict:
    """Phase 19 (see the module docstring). Returns the launches of the
    phase's kernels summed over (a)'s three driver runs, (b)'s ranks and (c)'s
    demos in this process (each set to 0 just before and read just after)
    and the phase's summary."""
    import torch

    from gnn_tracking_tpu_torch.ops import fused_relational as fr
    from gnn_tracking_tpu_torch.parallel.halo import partition_event
    from gnn_tracking_tpu_torch.parallel.mesh2d import DataGraphTCNTrainer, stack_sharded
    from gnn_tracking_tpu_torch.parallel.multihost import spawn
    from gnn_tracking_tpu_torch.parallel.sharded_model import shard_as_eventgraph
    from gnn_tracking_tpu_torch.parallel.sharded_tc import partition_condensation
    from gnn_tracking_tpu_torch.scripts import demo_pipeline, demo_sharded, mlb_scan
    from gnn_tracking_tpu_torch.scripts import train_fulldetector as fd

    card = card_line()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    summary = {"card": card, "s": {}}

    def say(msg: str) -> None:
        log(f"fulldetector: {msg} [{card}]")

    # ---- the event and its 1-shard partition, as the driver makes them
    t0 = time.perf_counter()
    event = fd.full_detector_event(0)
    summary["s"]["event"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sgs, cds = fd.partition_events([event], 1, 512)
    summary["s"]["partition"] = time.perf_counter() - t0
    n_hits, n_edges = int(event.node_mask.sum()), event.num_edges
    assert (n_hits, n_edges) == (267386, 2139088), (n_hits, n_edges)
    say(f"event {n_hits} hits / {n_edges} edges ({summary['s']['event']:.1f} s), partitioned in "
        f"{summary['s']['partition']:.1f} s; {int(cds.n_objects[0])} objects of {int(cds.obj_valid.shape[-1])} slots")

    # ---- (a) step 0 through the kernels against the plain path: f32, bf16, and remat against f32
    args = {m: fd.parse_args([*FD_ARGV, *flags]) for m, flags in FD_MODES.items()}
    mesh1 = fd.make_data_graph_mesh(1, 1, device="cuda")
    widths = (sgs.x.shape[-1], sgs.edge_attr.shape[-1])

    def trainer_for(mode, threshold=None):
        trainer = fd.build_trainer(args[mode], mesh1, *widths)
        if threshold is not None:
            trainer.model.model.ec_threshold = threshold
        sg_l, cd_l = trainer.place(sgs, cds)
        trainer.init(sg_l)
        return trainer, sg_l, cd_l

    t0 = time.perf_counter()
    trainer, sg_l, cd_l = trainer_for("f32")
    ev_view = shard_as_eventgraph(sg_l, local_csr=True)
    threshold, cut = parallel_threshold(trainer.model.model, [ev_view])
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    summary["cut"] = {"threshold": threshold, **cut}
    kernels = fd_kernel_checks(trainer.model.model, ev_view, seed)
    say("kernels at the event's shapes (EC layer 1): " + json.dumps(kernels))

    def f64_grads(mode):
        def make():
            t64, s64, c64 = trainer_for("f32", threshold)
            t64.model.load_state_dict(state)
            t64.model.double()
            s64 = s64._map(lambda t: t.double() if t.is_floating_point() else t)
            with plain_path(), segment_plain():
                g64, _ = fd_grads(t64, s64, c64)
            del t64
            torch.cuda.empty_cache()
            return g64
        return make

    checks = {}
    for mode in ("f32", "bf16", "remat"):
        tr, s_l, c_l = (trainer, sg_l, cd_l) if mode == "f32" else trainer_for(mode, threshold)
        tr.model.model.ec_threshold = threshold
        tr.model.load_state_dict(state)
        _reset_launches(FD_KERNELS)
        fr._compact.calls = 0
        gk, lk = fd_grads(tr, s_l, c_l)
        launches0, partitions0 = _launch_counts(FD_KERNELS), fr._compact.calls
        with plain_path():
            gp, lp = fd_grads(tr, s_l, c_l)
        res = fd_compare(gk, gp, f64_grads(mode), bf16=mode == "bf16")
        checks[mode] = {"loss": lk, "plain_loss": lp, **res, "launches": launches0, "partitions": partitions0}
        if mode == "f32":
            g_f32 = gk
        if mode == "remat":  # the same kernels, the layers recomputed: the gradients of (a) f32
            worst = 0.0
            for n, g in g_f32.items():
                if g is None:
                    assert gk[n] is None, n
                    continue
                assert torch.allclose(gk[n], g, rtol=1e-5, atol=1e-7), f"remat gradient {n} differs"
                worst = max(worst, float((gk[n] - g).abs().max()))
            checks[mode]["vs_f32_max_abs"] = worst
            checks[mode]["bitwise_f32"] = all(g is None or torch.equal(gk[n], g) for n, g in g_f32.items())
        for v in (lk, lp):
            assert math.isfinite(v), f"({mode}) step 0 loss {v}"
        say(f"(a) step 0 {mode}: " + json.dumps(checks[mode]))
        if mode != "f32":
            del tr
        torch.cuda.empty_cache()
    L = 9  # the GraphTCN's interaction layers (L_ec 6 + L_hc 3)
    assert checks["f32"]["launches"]["fused_relational_fwd"] == L, checks["f32"]["launches"]
    assert checks["remat"]["launches"]["fused_relational_fwd"] == 2 * L, checks["remat"]["launches"]
    assert checks["bf16"]["launches"]["fused_relational_bf16_bwd"] == L, checks["bf16"]["launches"]
    summary["checks"] = checks
    del trainer, gk, gp, g_f32
    torch.cuda.empty_cache()
    summary["s"]["checks"] = time.perf_counter() - t0

    # ---- (a) the driver's main at its defaults: f32, bf16, remat (the phase's main path)
    _reset_launches(FD_KERNELS)
    runs = {}
    step_ms: list[float] = []
    orig_step = DataGraphTCNTrainer.training_step

    def timed_step(self, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_step(self, *a, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    DataGraphTCNTrainer.training_step = timed_step
    try:
        for mode, flags in FD_MODES.items():
            step_ms.clear()
            before = _launch_counts(FD_KERNELS)
            t0 = time.perf_counter()
            path = tmp / f"fd_{mode}.json"
            s = fd.main([*FD_ARGV, *flags, "--steps", str(FD_STEPS), "--json", str(path)])
            hist = json.loads(path.read_text())["history"]
            assert s["all_finite"] and all(math.isfinite(h["total"]) for h in hist), mode
            assert (s["n_hits_per_event"], s["n_edges_per_event"]) == (n_hits, n_edges)
            runs[mode] = {**s, "wall_s": time.perf_counter() - t0, "step0_ms": step_ms[0],
                          "median_step_ms": statistics.median(step_ms[1:]), "step_ms": list(step_ms),
                          "peak_gib": s["device_peak_bytes"] / 2**30,
                          "launches": {k: v - before[k] for k, v in _launch_counts(FD_KERNELS).items()}}
            torch.cuda.empty_cache()
            say(f"(a) train_fulldetector {mode}: " + json.dumps(runs[mode]))
    finally:
        DataGraphTCNTrainer.training_step = orig_step
    launches = _launch_counts(FD_KERNELS)
    for k in FD_KERNELS:
        assert launches[k] > 0, f"(a) never launched {k}"
    summary["runs"] = runs

    # ---- (a) each step's split, at the driver's configuration (its own EC cut)
    splits = {}
    for mode in FD_MODES:
        tr, s_l, c_l = trainer_for(mode)
        orig_step(tr, s_l, c_l)  # the first Adam step's lazy set-up
        splits[mode] = fd_split(tr, s_l, c_l)
        del tr
        torch.cuda.empty_cache()
    summary["split"] = splits
    say("(a) step split (median of 3): " + json.dumps(splits))
    del sg_l, cd_l, ev_view

    # ---- (b) 2 x 2 in four ranks sharing the card, against the fast path on both events
    t0 = time.perf_counter()
    events = [event, fd.full_detector_event(1)]
    grid_sgs, grid_cds = fd.partition_events(events, 2, 512)
    singles = []
    for i, ev in enumerate(events):
        sg1 = partition_event(ev, 1, sort_edges=True)
        singles.append((stack_sharded([sg1]), stack_sharded([partition_condensation(
            ev, sg1, max_n_objects=512, subsample_seed=1000 + i)])))
    ref_trainer = fd.build_trainer(args["f32"], mesh1, *widths)
    placed = [ref_trainer.place(s, c) for s, c in singles]
    grid_threshold, grid_cut = parallel_threshold(ref_trainer.model.model,
                                                  [shard_as_eventgraph(s, local_csr=True) for s, _ in placed])
    del ref_trainer, placed
    torch.cuda.empty_cache()
    spec = {"sgs": grid_sgs, "cds": grid_cds, "threshold": grid_threshold, "out": str(tmp / "fd_grid_rank%d.pt")}
    torch.save(spec, tmp / "fd_grid_spec.pt")
    t1 = time.perf_counter()
    spawn(fulldetector_rank, 4, (str(tmp / "fd_grid_spec.pt"),), store_file=str(tmp / "fd_grid_store"),
          backend="gloo", device="cuda", timeout_s=900)
    summary["s"]["grid_ranks"] = time.perf_counter() - t1
    grid = [torch.load(spec["out"] % r, weights_only=False) for r in range(4)]
    for r, res in enumerate(grid):
        for k in PARALLEL_KERNELS:
            assert res["launches"][k] > 0, f"(b) rank {r} never launched {k}"
        for k, v in res["launches"].items():
            launches[k] += v
    ref_trainer = fd.build_trainer(args["f32"], mesh1, *widths)
    ref_trainer.model.model.ec_threshold = grid_threshold
    ref = _reference(ref_trainer, [ref_trainer.place(s, c) for s, c in singles], grid[0])
    summary["grid"] = {"cut": {"threshold": grid_threshold, **grid_cut}, "worst": _check_steps("(b)", grid[0], ref),
                       "losses": [s["total"] for s in grid[0]["losses"]],
                       "step_ms": [res["step_ms"] for res in grid], "peak_gib": [res["peak_gib"] for res in grid],
                       "launches": [res["launches"] for res in grid], "fast_path_step_ms": ref["step_ms"]}
    del ref_trainer, ref, grid, singles
    torch.cuda.empty_cache()
    # the driver's own entry point on that mesh: its four ranks, spawned by its main
    t1 = time.perf_counter()
    path = tmp / "fd_grid.json"
    main_2x2 = fd.main([*FD_GRID_ARGV, "--steps", str(FD_GRID_STEPS), "--json", str(path)])
    assert main_2x2["all_finite"] and main_2x2["mesh"] == "2x2", main_2x2
    summary["grid"]["driver_main"] = {**main_2x2, "wall_s": time.perf_counter() - t1,
                                      "losses": [h["total"] for h in json.loads(path.read_text())["history"]]}
    summary["s"]["grid"] = time.perf_counter() - t0
    say("(b) 2 x 2, four ranks on the card: " + json.dumps(summary["grid"]))

    # ---- (c) the demos, once each, at their smallest size
    t0 = time.perf_counter()
    raw = tmp / "fd_raw"
    raw.mkdir(exist_ok=True)
    for name in ETL_CSVS:
        shutil.copy(REPO / "tests" / "test_data" / "trackml" / name, raw / name)
    _reset_launches(FD_DEMO_KERNELS)
    demos = {}
    t1 = time.perf_counter()
    figures = demo_pipeline.main(["--epochs", "1", "--workdir", str(tmp / "fd_demo"), "--trackml-dir", str(raw)])
    demos["demo_pipeline"] = {"s": time.perf_counter() - t1, "n_figures": len(figures),
                              "double_majority_pt0.9": figures["trk.double_majority_pt0.9"]}
    t1 = time.perf_counter()
    sharded = demo_sharded.main(["--ranks", "2"])
    demos["demo_sharded"] = {"s": time.perf_counter() - t1, "best_dm": sharded["best_dm"],
                             "best_eps": sharded["best_eps"], "last_total": sharded["losses"][-1]["total"]}
    t1 = time.perf_counter()
    scan = mlb_scan.main(["--quick", "--workdir", str(tmp / "fd_mlb"), "--trackml-dir", str(raw)])
    demos["mlb_scan"] = {"s": time.perf_counter() - t1,
                         "eff_k8": [r["evals"][8]["eff"] for r in scan], "purity_k8": [r["evals"][8]["purity"] for r in scan]}
    demo_launches = _launch_counts(FD_DEMO_KERNELS)
    for k, v in demo_launches.items():
        assert v > 0, f"(c) the demos never launched {k}"
        launches[k] = launches.get(k, 0) + v
    summary["demos"] = {**demos, "launches": demo_launches}
    summary["s"]["demos"] = time.perf_counter() - t0
    say("(c) demos: " + json.dumps(summary["demos"]))
    summary["kernels"] = kernels
    summary["s"]["phase"] = time.perf_counter() - t_phase
    say(f"phase 19: {json.dumps(summary['s'])}; launches {launches}")
    return {"launches": launches, "summary": summary}


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
                   "wide layout (this tree), time the latter and time its EC steps (this tree or "
                   "--package-root's), print them and stop")
    p.add_argument("--wide-phases", action="store_true",
                   help="with --wide-only: also count the wide edge kernels' cycles by phase "
                   "(wide_phases: a second build of the wide layout with -DWIDE_PHASES)")
    p.add_argument("--tc-cli-only", action="store_true",
                   help="build, run phase 11 (tc.yml's recipe through the port's CLI: tc_cli_phase), "
                   "print its summary and stop")
    p.add_argument("--pipeline-only", action="store_true",
                   help="build, run phase 12 (stages chained through checkpoints: pipeline_phase), "
                   "print its summary and stop")
    p.add_argument("--variants-only", action="store_true",
                   help="build, run variants_phase (phase 13: the remaining losses and models) and stop")
    p.add_argument("--etl-only", action="store_true",
                   help="build, run etl_phase (phase 14: the offline ETL at a full TrackML event's size, "
                   "its graphs served) and stop")
    p.add_argument("--drivers-only", action="store_true",
                   help="build, run drivers_phase (phase 15: train_multievent and train_trackml through their "
                   "main on the vendored event, rows #1 / #2 at their widths) and stop")
    p.add_argument("--analysis-only", action="store_true",
                   help="build, run analysis_phase (phase 16: the analysis and metrics layer on etl-trackml-110k, "
                   "the drill's trained latent and the legacy hinge loss) and stop")
    p.add_argument("--remainder-only", action="store_true",
                   help="build, run phase 17 (the IVF's options, the OOM guard, RunLogger and "
                   "device_trace, the plot modules) and stop")
    p.add_argument("--parallel-only", action="store_true",
                   help="build, run phase 18 (the parallel package: sharded, data-parallel and 2-D trainers "
                   "as ranks on this card) and stop")
    p.add_argument("--fulldetector-only", action="store_true",
                   help="build, run phase 19 (the full-detector driver at 267,386 hits, its 2 x 2 mesh "
                   "in four ranks and the demos) and stop")
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
    smi = card_line()
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
    if args.tc_cli_only:
        log(f"package: {root}")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tc_tmp:
            tc_cli_phase(args.seed, Path(tc_tmp))
        print(smi)
        return 0
    if args.pipeline_only:
        log(f"package: {root}")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as pipe_tmp:
            pipeline_phase(args.seed, Path(pipe_tmp))
        print(smi)
        return 0
    if args.variants_only:
        log(f"package: {root}")
        variants_phase(args.seed)
        print(smi)
        return 0
    if args.etl_only:
        log(f"package: {root}")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as etl_tmp:
            etl_phase(args.seed, Path(etl_tmp))
        print(smi)
        return 0
    if args.drivers_only:
        log(f"package: {root}")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as drivers_tmp:
            drivers_phase(args.seed, Path(drivers_tmp))
        print(smi)
        return 0
    if args.analysis_only:
        log(f"package: {root}")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as analysis_tmp:
            analysis_phase(args.seed, Path(analysis_tmp))
        print(smi)
        return 0
    if args.remainder_only:
        log(f"package: {root}")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as remainder_tmp:
            remainder_phase(args.seed, Path(remainder_tmp))
        print(smi)
        return 0
    if args.parallel_only:
        log(f"package: {root}")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as parallel_tmp:
            parallel_phase(args.seed, Path(parallel_tmp))
        print(smi)
        return 0
    if args.fulldetector_only:
        log(f"package: {root}")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as fd_tmp:
            fulldetector_phase(args.seed, Path(fd_tmp))
        print(smi)
        return 0
    if args.wide_only:
        log(f"package: {root}")
        if root == REPO:  # the checks of this tree; another tree is timed beside it
            wide_dim_checks(args.seed)
            resident_wide_checks(args.seed)
            width_checks(args.seed, WIDE_CHECKS, wide=True)
            wide_edge_checks(args.seed)
        wide_timings(args.seed)
        if args.wide_phases:
            wide_phases(args.seed)
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
    # each entry of the kernels line takes its route's launches in both steps
    steps = wide_ec_steps(args.seed)
    wide_launches = {name: steps["f32"][name] + steps["bf16"][name] for name in steps["f32"]}
    for r in val_results:
        r["launches"] = wide_launches.get(r["name"], row13_launches if r["name"] == "pairwise_topk"
                                          else row11_launches)
    results += val_results
    # C32 / D32: launches of the f32 EC step with fused_save_acts
    for r in results:
        if r["name"] in val_summary["ec_f32_saved_launches"]:
            r["launches"] = val_summary["ec_f32_saved_launches"][r["name"]]
    assert all("launches" in r for r in results), [r["name"] for r in results if "launches" not in r]

    # ---- 11. tc.yml's recipe through the port's CLI ---------------------------
    cli = tc_cli_phase(args.seed, tmp)
    assert {r["name"] for r in results} >= set(cli["fit_launches"]), sorted(cli["fit_launches"])

    # ---- 12. stages chained through checkpoints ---------------------------------
    pipe = pipeline_phase(args.seed, tmp)
    assert {r["name"] for r in results} >= set(pipe["launches"]), sorted(pipe["launches"])

    # ---- 13. the remaining losses and models ------------------------------------
    variants = variants_phase(args.seed)
    assert {r["name"] for r in results} >= set(variants["launches"]), sorted(variants["launches"])

    # ---- 14. the offline ETL at a full event's size, its graphs served ------------
    etl = etl_phase(args.seed, tmp)
    results.append(etl["result"])
    assert {r["name"] for r in results} >= set(etl["serve_launches"]), sorted(etl["serve_launches"])

    # ---- 15. the real-data training drivers on the vendored event -------------------
    drivers = drivers_phase(args.seed, tmp)
    assert {r["name"] for r in results} >= set(drivers["launches"]), sorted(drivers["launches"])

    # ---- 16. the analysis and metrics layer -------------------------------------------
    analysis = analysis_phase(args.seed, tmp)
    assert {r["name"] for r in results} >= set(analysis["launches"]), sorted(analysis["launches"])

    # ---- 17. the single-device remainder: the IVF's options, the OOM guard, the run loggers ---
    remainder = remainder_phase(args.seed, tmp)
    assert {r["name"] for r in results} >= set(remainder["launches"]), sorted(remainder["launches"])

    # ---- 18. parallelism: sharded, data-parallel and 2-D trainers as ranks on this card ---
    parallel = parallel_phase(args.seed, tmp)
    assert {r["name"] for r in results} >= set(parallel["launches"]), sorted(parallel["launches"])

    # ---- 19. the full-detector training driver, its 2 x 2 mesh, the demos -----------
    fulldetector = fulldetector_phase(args.seed, tmp)
    assert {r["name"] for r in results} >= set(fulldetector["launches"]), sorted(fulldetector["launches"])

    # ---- 20. results ------------------------------------------------------
    kernels = [
        {
            "name": r["name"], "route": "cuda", "source": SOURCES[r["name"]],
            "replaces": TPU_KERNELS[r["name"]], "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({"cli_launches": cli["fit_launches"][r["name"]]} if r["name"] in cli["fit_launches"] else {}),
            **({"pipeline_launches": pipe["launches"][r["name"]]} if r["name"] in pipe["launches"] else {}),
            **({"variants_launches": variants["launches"][r["name"]]} if r["name"] in variants["launches"] else {}),
            **({"etl_launches": etl["serve_launches"][r["name"]]} if r["name"] in etl["serve_launches"] else {}),
            **({"drivers_launches": drivers["launches"][r["name"]]} if r["name"] in drivers["launches"] else {}),
            **({"analysis_launches": analysis["launches"][r["name"]]} if r["name"] in analysis["launches"] else {}),
            **({"remainder_launches": remainder["launches"][r["name"]]} if r["name"] in remainder["launches"] else {}),
            **({"parallel_launches": parallel["launches"][r["name"]]} if r["name"] in parallel["launches"] else {}),
            **({"fulldetector_launches": fulldetector["launches"][r["name"]]}
               if r["name"] in fulldetector["launches"] else {}),
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
