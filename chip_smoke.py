#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port, lightgbm_tpu_torch, on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``lightgbm_tpu_torch/csrc`` and runs
twenty-eight phases; any failure exits non-zero:

  1. build    nvcc for sm_90a; prints ptxas's register/shared-memory lines
              and the card's name and power limit, and for the K1/K3,
              K5, K6/K7 and K2 kernels (their by-value and step entries)
              their registers, spills and atomic SASS opcodes (no
              ATOMS.CAS loop allowed); for P1's five and Q1's four
              instantiations their registers, spills and SASS counts (Q1's
              rotations funnel shifts: at least 160 SHF a quantizer body).
              Builds too the previous designs of P1 and Q1
              (tools/prev_kernels/, by tools/p1_time.py), which every P1
              and Q1 measurement times in turns with the shipped kernel
              (previous, shipped, shipped, previous: ``prev_ms``).  Then
              Q1's device operations a call (torch.profiler, the run's
              first session): two kernels, no copy, no memset.
  2. kernels  at the HIGGS shape (10.5M rows x 28 features, 64 bins), every
              kernel against its plain PyTorch version on the card: counts,
              leaf ids and scores exact, gradient/hessian sums within
              1e-5 x the bin's sum of |value|, a second launch bit-identical
              to the first; route descriptors cover numeric, NaN-missing,
              zero-missing and categorical-bitset splits and a partial
              window; K1 bit-identical to K6's single slot over the same
              blocks; K1, K2, K3 and K5 each one kernel a call
              (torch.profiler), replayed identically from a CUDA graph,
              timed there and on the host.  K5 (histogram_all) with C = 5
              channel sets at these rows too, each class slice
              bit-identical to a K1 root of that class.  The step entries
              of K1, K2 and K3 (window, target and route read from a step
              block in device memory, as the device loop calls them) bit
              for bit their by-value entries at the first split, a late
              window, an empty window and a categorical route, and timed
              as those.  Times each kernel, its plain version and the one
              PyTorch call that computes the same function (index_add_ for
              the histograms, with its flat keys made before the clock).
  3. train    the binary path: ``lightgbm_tpu_torch.train`` on synthetic
              HIGGS-shaped data (as bench.py makes it), 255 leaves,
              3 iterations, fused route (K3 at the roots, the K3 step entry
              in the device loop's CUDA graph, K4).  Train AUC must rise,
              held-out predictions must match the in-training valid
              scores, the model text is saved.  The device loop: every
              tree grown by graph replays, at most ceil((L - 1) / steps) +
              compactions + 2 host fetches a tree, the step kernel
              launched steps x replays times (+ the capture's warm-up
              step); the graph's capture time, steps, fetches a tree and
              the iteration walls are logged.  Then one more iteration:
              its tree's last split (a compacted window of a few row
              blocks), rebuilt from the grower's device state, through
              the by-value and step entries against the plain version,
              timed as in phase 2.
  4. unfused  1M rows, 2 iterations, ``fused_route=False`` (K1 at the
              roots, K2 + K1 step entries in the graph; the device loop
              checked as in phase 3); the same data through the fused
              path must give the same model.
  5. parity   200k rows, 31 leaves, 3 iterations on the card and on the
              CPU: the same split features and bin thresholds for splits
              with gain > 1e-2, raw predictions within 1e-3.
  6. mc kernels  at the multiclass_cat shape (1M rows x 28 features, 8 of
              them categorical, 256 bins, 5 classes): K5 against its plain
              version and the K1 roots of its classes; K1 and K3 at 256
              bins, K3 with the categorical route of a real best_split;
              K4 in place into one row of a [5, 1M] score with a 31-leaf
              table, as the multiclass loop calls it; K1/K3/K5 launch
              reports as in phase 2.
  7. mc train the multiclass path: 5-class softmax with categorical
              features as bench_suite.py makes it, 1M rows, 31 leaves,
              25 iterations, fused: K5 once per iteration, the K3 step
              entry in the device loop (checked as in phase 3), K4 once
              per class tree; held-out multi_logloss under
              bench_suite.py's gate of 0.9; held-out predictions match the
              in-training valid scores; the model text holds num_class=5
              and categorical nodes.  P1 over the training bins with the
              125 trees (classes interleaved) against its plain version,
              timed as in phase 23.
  8. mc parity  200k rows, 3 iterations on the card and on the CPU: the
              same split features, thresholds and category bitsets for
              splits with gain > 1e-2, raw predictions within 1e-3.
  9. frontier kernels  K6 (histogram_frontier) and K7 (histogram_frontier_
              routed, KT = K; histogram_frontier_fusedk, KT = 2K) against
              their plain versions in a frontier round: K = 16 leaves of a
              32-leaf layout of the HIGGS rows split over the union of their
              windows, and a K = 2 round (plus a K = 16 one: 32 slots at
              256 bins, one feature a block) at the multiclass_cat rows.
              Leaf ids bit for bit, counts exact, sums within tolerance,
              relaunches bit-identical, every slot bit-identical to K1 of
              its leaf over its parent's window; times, bounds and library
              calls as in phase 2, and the shared-memory tiling each launch
              chose.
              In the timed rounds each call is also captured in a CUDA
              graph and replayed (identical), its device operations
              counted with torch.profiler (one kernel, no memcpy or
              memset), and timed in a replayed graph of 20 (the device's
              time) and on the host (enqueue).
 10. frontier train  the HIGGS rows through ``tpu_tree_impl=frontier``,
              255 leaves, auto width K = 16, the default tier ("off": K2 a
              split, K6 a round), 3 iterations: train AUC rises, held-out
              AUC within 0.005 of phase 3's; K6 once a round and a tree
              root, K2 once a split, K1 and K3 never.  Then one more
              iteration records the grower's K2 calls: the bound summed
              over their windows, and the last call (a late split's
              window) replayed against the plain version and timed as in
              phase 2.
 11. frontier tiers  1M rows, 2 iterations each of the tiers "off", "k1"
              (K7 routed a round) and "fusedk" (K7 fused-K a round): each
              kernel launches on its tier; "k1" grows "off"'s model text.
 12. frontier parity  200k rows, 31 leaves, ``tpu_frontier_width=4`` on the
              card and on the CPU: the same splits at gain > 1e-2.
 13. frontier K=1  ``tpu_frontier_width=1`` on the card grows phase 5's
              segment model text.
 14. session  the session around ``train`` on the HIGGS rows (255 leaves,
              lr 1.0): ``train`` with the 100k holdout as valid set and
              ``early_stopping_rounds`` (the stop must fire); save_model ->
              ``Booster(model_file=)`` -> holdout predictions bit for bit;
              ``init_model`` continued training for 5 rounds (seeding
              timed: the host walk and the device adds); rollback_one_iter
              and the next update; ``cv`` with nfold=3 for 5 rounds (peak
              device memory).  One early-stopping iteration's wall against
              ``iter_seconds``, and eval_valid, eval_train and one tree's
              holdout walk timed alone.
 15. session parity  the same calls at 200k rows (31 leaves; 2 continued
              rounds, cv nfold=3 for 2 rounds) on the card and on the CPU:
              the same best iteration, the same splits at gain > 1e-2
              (early stop, continued + rolled back, cv folds), cv means
              within 1e-4; cv's fold boosters, updated in turns on the
              card, grow bit for bit the model text each fold grows alone.
 16. session mc  at multiclass_cat (after phase 8): ``cv`` with nfold=2
              for 3 rounds (K5 once an iteration a fold) and a save -> load
              round trip with categorical splits, bit for bit.
 17. objectives  first K1 (root) and K3 (a split) at the HIGGS shape on
              weighted L2 gradients (weights over 1e-3..1e3, rows of
              weight 0) against their plain versions at phase 2's
              tolerance; then on phase 3's bins with new labels, weights
              and init scores (the rows binned once), 2 iterations at 255
              leaves each: L2 (weights over 1e-3..1e3 with rows of weight
              0, init scores), L1 (weights, init scores), huber, fair,
              quantile, mape, poisson, gamma, tweedie, binary (weights,
              init scores), cross_entropy and cross_entropy_lambda
              (weights), then multiclassova (weights) on phase 7's rows (K5 at its
              class roots).  Each: the first metric improves on the
              holdout, Booster.predict of the holdout (+ its init scores)
              is the in-training valid score; L1/quantile/mape's last
              renewal is the host percentile of the fetched leaf ids and
              scores, bit for bit.  Logs iter_seconds and the renewal's
              share.
 18. lambdarank  BASELINE config 4 at bench_suite.py's shape: its
              generator (2.27M documents x 136 features, queries of 40-119,
              labels 0-4), max_bin 63, 255 leaves, lr 0.1,
              min_sum_hessian_in_leaf 100, label_gain 2^i - 1, 25
              iterations, ndcg@1..5 on a 50k-document holdout: NDCG@10 of
              the first 200k documents over bench_suite.py's gate of 0.80;
              logs the binning time, the gradient's time a call (CUDA
              events; two calls bit-identical), iter_seconds, K3 step
              launches.
 19. metadata parity  weighted L1 with init scores at 200k rows,
              lambdarank at 100k documents and weighted multiclassova at
              200k rows (31 leaves, 2 iterations) on the card and on the
              CPU: the same splits at gain > 1e-2 up to a near-tie (gains
              within 1e-4), raw predictions within 1e-3; a weighted and an
              unweighted booster updated in turns on the card grow their
              solo model texts.
 20. goss_regression  BASELINE config 2 at bench_suite.py's shape: its
              generator (2M rows x 28 features, a nonlinear regression
              target), ``boosting=goss``, 255 leaves, max_bin 63, lr 0.1,
              min_sum_hessian_in_leaf 100, 25 iterations: 10 of warm-up
              on every row, then each iteration's bag is the selection of
              its own gradients and key (recomputed on the card; the last
              also in numpy: top_k + other_k rows plus those tied at the
              other_k-th key); bench_suite.py's gate, l2 on the first 200k
              rows under 0.5 x var(y), and a 100k holdout's l2; K3 on the
              amplified gradients at phase 2's tolerance; logs the binning
              time, the warm-up and GOSS iteration walls apart, the
              selection's time a call (CUDA events) and K3 step launches.
 21. modes    on phase 3's binned HIGGS rows, 255 leaves, 3 iterations
              each (DART 6): bagging 0.5, balanced bagging 0.5 / 0.9,
              feature_fraction 0.5 with and without
              feature_fraction_bynode 0.5, DART (drop_rate 0.5,
              skip_drop 0), RF (bagging 0.632): the holdout AUC rises,
              save -> load -> predict = the valid score, the RF text
              carries ``average_output``; logs each run's iteration walls,
              DART's drop-walk share and the segment grower's graphs
              (device operations and time of a step replay and a tree
              start) with by-node masks and without.
 22. modes parity  200k rows, 31 leaves, on the card and on the CPU:
              bagging + feature_fraction + bynode (fused, unfused,
              frontier width 4 tiers "off" and "k1"), RF and multiclass
              with bagging (K5), 2 iterations each, GOSS (lr 0.5: two
              warm-up iterations, one selection) and DART, 3 each: the
              same splits up to a
              near-tie, raw predictions within 1e-3 and the same bag (GOSS:
              within 1e-4 of the rows) where no near-tie was met; the
              bagged model's refit on both devices; threefry bits and
              node masks card = CPU; a bagged and an unbagged booster in
              turns on the card grow their solo model texts.
 23. predict  prediction on the card (P1, route_trees): phase 3's
              in-training valid scores (P1 an iteration) = the host walk
              bit for bit; P1 on phase 3's device bins with its trees
              against its plain version and its previous design, bit for
              bit, one launch a call, timed (CUDA events, 20 launches, in
              turns with the previous design) beside its bound by both
              counts (the bins on each row's path, or each row's bin
              columns once) and the mode the shapes chose; then
              Booster.predict of phase 3's booster on 1M raw HIGGS rows
              and of phase 20's goss_regression booster (25 trees) on its
              2M rows: "auto" and "on" take P1 (the recorded route says
              so), "off" the host walk, raw scores and output bit for bit,
              timed; P1 alone on those i16 bins; and at 200k rows DART,
              rollback, init_model's seeding and a late add_valid with the
              walks on the card = the same booster's host walks, bit for
              bit.  Phase 14's seeding and rollback and phase 21's DART
              drops are card walks too.
 24. expo_onehot  exclusive feature bundling and sparse input at Expo's
              shape (``expo_like``: 11M training rows and a 100k holdout,
              4 numeric and 696 one-hot columns, from CSR): binned and
              bundled from the nonzeros (G columns of up to 256 bins),
              10 iterations with the reference's experiment settings
              (255 leaves, lr 0.1, min_sum_hessian_in_leaf 100, max_bin
              63): the holdout AUC rises, the card's valid scores (P1
              over the holdout's bundled bins) = the host walk and
              predict on = off, bit for bit; K1, K2 and K3 (the root
              split and a one-hot member's split at a bin offset >= 128),
              K5 (5 class sets), a K = 16 frontier round (K6, K7) and P1
              with the group tables on the bundled bins against their
              plain versions, timed; at 1M rows (every row in the binning
              sample, so no row conflicts) enable_bundle on = off split
              for split; at 200k rows card = CPU for the segment grower
              fused and unfused, the frontier grower (K = 16) and 5-class
              multiclass; the JAX package's sparse-at-scale gates
              (10,000 x 100,000 block one-hot, at most 6500 columns and
              80 MB of bins, log loss under 0.6915 after 4 rounds).
 25. packed4  HIGGS at max_bin 15 (16 bins) on the 4-bit packed layout
              (run after phase 28, on phase 3's rows):
              10.5M x 28 binned, packed on the host and
              uploaded as [14, Npad] bytes (walls and bytes against the
              unpacked 28 rows logged), byte for byte the host's packing;
              3 iterations each of the segment grower fused (then a
              rollback: P1 over the packed bins) and unfused, the
              frontier grower (K = 16) and 5-class multiclass (K5 roots),
              each launching the packed kernels only (median
              iter_seconds, peak device memory, the device loop); K1, K2,
              K3 (two nibbles), their step entries, K5, a K = 16 frontier
              round (K6, K7) and P1 on the packed bins against their plain
              versions and, bit for bit, against the same kernels on the
              unpacked bins, timed beside them (``unpacked_ms``); at 1M
              rows packed = unpacked (``packed4=False``) bit for bit for
              the fused segment grower and the frontier's three tiers,
              P1's walk over the packed bins = the host walk; at 200k rows
              card = CPU.
 26. packed_acc  the packed-accumulator stream (``packed_acc=True``:
              gradients and hessians quantized once a tree by Q1, integer
              histogram sums): on phase 3's HIGGS bins, 3 iterations each
              of the segment grower unfused and fused and the frontier
              grower (K = 16, "off"), in turns with the f32 mode (median
              iter_seconds, peak device memory, holdout AUC within 0.005
              of the f32 run's), each launching only the ``_packed_acc``
              histogram kernels; Q1 (its two kernels the call's only
              device operations; timed in turns with its previous design;
              its bound by 32 B a row and by its integer operations at
              the INT32 rate), K1, K3, their step entries, K5 (as
              leaf_histogram launches it) and a K = 16 frontier round
              (K6, K7 routed and fused-K) against their plain versions bit
              for bit, timed beside the same kernels in the f32 mode
              (``f32_ms``); at 1M rows the frontier's fused tiers, and at
              max_bin 15 the 4-bit bins with the stream (runs and
              kernels); at 200k rows card = CPU; on phase 7's
              multiclass_cat rows 5-class training (K5 roots on the f32
              channels, the splits on the stream, holdout multi_logloss
              within 1% of the f32 run's).
 27. split features  on phase 3's HIGGS bins, 3 iterations each of (a)
              the segment grower and (b) the frontier grower (K = 16)
              with monotone constraints of both signs on 9 features,
              feature_contri, cegb_penalty_split and
              cegb_penalty_feature_coupled, and (c) the fused grower,
              reached as the JAX package reaches it (auto with a forced
              plan of three levels, written to a temp directory), with
              CEGB-lazy and the constraints; each beside the same run
              without the features, in turns (median iter_seconds, peak
              device memory, holdout AUC with no gate): predictions
              monotone over 1000-value sweeps of every constrained
              feature, at least one split off the run without the
              features; (c) K5 once for each tree's root and once a split,
              the plan heading every tree, the share of its iteration
              CEGB-lazy's bookkeeping takes (a split's timed),
              and K5 as its leaf histogram against its plain version,
              timed; at 200k rows card = CPU for (a), (b) and (c).
 28. wide bins and file input  the second histogram path, B3
              (``histogram_chunked``, csrc/wide_hist.cu) on the fused
              grower: (a) HIGGS at max_bin 1023 (two-byte bins), 255
              leaves, 3 iterations in turns with the max_bin 63 run
              (63, 1023, 1023, 63): iteration walls, B3-u16 once a node
              and K2-u16 once a split, peak memory, holdout AUC (no gate),
              a tree's splits timed part by part (the scan's share); B3
              at the root and at half the rows, K2-u16 at the first split
              and P1-u16 over the training bins against their plain
              versions bit for bit, timed beside their bounds and one
              index_add_; B3 at 64-65,536 bins on one- and two-byte random
              bins (the global-atomic mode at 65,536); (b) multiclass_cat
              with its 8 categorical columns re-drawn from 1,000
              Zipf-like categories (more than 256 bins each), 3
              iterations; (c) gpu_use_dp on phase 3's max_bin 63 bins (B3
              on one-byte bins), 3 iterations; (d) the first 1M HIGGS
              rows as a CSV (header, named label, a .weight side file)
              and as LibSVM: lt.Dataset(path), two_round off and on, bins
              byte for byte the parsed matrix's, the native tokenizers and
              binner run, models from the files, from the matrix and from
              save_binary's .bin one model, predict(path) =
              predict(matrix), parse MB/s and binning seconds native
              against Python; at 200k rows card = CPU for max_bin 1023,
              max_bin_by_feature and (b)'s categoricals.

Launch counts: a kernel captured into a CUDA graph counts at each replay
(ops/kernels.py count_replay), when the card runs it.

Output: one JSON line per kernel, a ``{"device_loop": ...}`` line (phases
3, 4 and 7), a ``{"session": ...}`` line (phases 14-16: walls, seeding
times, peak memory, launches by kernel; the kernels' ``launches_by_path``
holds them as "session"), an ``{"objectives": ...}`` line (phases 17-19;
"objectives" and "lambdarank" in ``launches_by_path``), a
``{"goss_regression": ..., "modes": ...}`` line (phases 20-22;
"goss_regression" and "modes" in ``launches_by_path``), a
``{"predict": ...}`` line (phase 23; "predict" in ``launches_by_path``,
the path whose P1 launches the kernels line reports), an
``{"expo_onehot": ...}`` line (phase 24; "expo" and "sparse_at_scale" in
``launches_by_path``, each kernel's bundled measurements under
``"expo"``), a ``{"packed4": ...}`` line (phase 25; its runs are the
"packed4_*" paths, and each kernel's packed input mode is a row of its
own, named with "_packed4"), a ``{"packed_acc": ...}`` line (phase 26;
its runs are the "packed_acc_*" and "leaf_histogram*" paths, each
kernel's packed-accumulator mode a row named with "_packed_acc", and Q1
the row "quantize_pack"), a ``{"split_features": ...}`` line (phase 27;
its runs are the "split_features_*" paths, and K5's row holds its
fused-grower measurement under ``"fused_leaf"``), a
``{"wide_bins": ...}`` line (phase 28; its runs are the "wide_bins",
"wide_categoricals", "gpu_use_dp" and "file_input" paths, and B3 and the
u16 modes of K2 and P1 rows of their own), a ``{"phase_walls_s": ...}``
line (each phase's wall on the host clock, also logged as a ``wall:``
line as the phase ends), one ``{"kernels": [...]}`` line, the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Without a
card, or run from a directory that does not hold the package, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HIGGS_ROWS = 10_500_000
HOLDOUT_ROWS = 100_000
UNFUSED_ROWS = 1_000_000
PARITY_ROWS = 200_000
N_FEATURES = 28
MAX_BIN = 63
TRAIN_PARAMS = dict(objective="binary", num_leaves=255, max_bin=MAX_BIN,
                    learning_rate=0.1, min_sum_hessian_in_leaf=100.0,
                    metric=["auc"], verbosity=-1, device_type="cuda")
# bench_suite.py's multiclass_cat: 1M rows x 28 features, 20-27
# categorical of cardinality 16, 5 classes, 31 leaves, default max_bin
MC_ROWS = 1_000_000
MC_CLASSES = 5
MC_CAT = list(range(20, 28))
MC_ITERS = 25
MC_PARAMS = dict(objective="multiclass", num_class=MC_CLASSES,
                 num_leaves=31, metric=["multi_logloss"], verbosity=-1,
                 device_type="cuda")
MC_LOGLOSS_GATE = 0.9       # bench_suite.py:282-289
# H100 SXM data sheet: HBM3 rate, and the float32 rate outside the tensor
# cores (the fastest non-tensor rate the sheet lists; the kernels' integer
# adds run on the same units)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Q1's work is integer: the H100 SXM5 issues 64 INT32 operations a clock
# on each of its 132 SMs (NVIDIA H100 Tensor Core GPU Architecture
# whitepaper, the SM's four partitions of 16 INT32 units) at a 1.98 GHz
# boost clock (H100 SXM5 data sheet)
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
HIST_RTOL = 1e-5

SOURCES = {
    "histogram_segment": ("lightgbm_tpu_torch/csrc/histogram.cu",
                          "lightgbm_tpu/ops/pallas_histogram.py:668"),
    "route_window": ("lightgbm_tpu_torch/csrc/histogram.cu",
                     "lightgbm_tpu/ops/pallas_histogram.py:1590"),
    "histogram_segment_routed": ("lightgbm_tpu_torch/csrc/histogram.cu",
                                 "lightgbm_tpu/ops/pallas_histogram.py:1126"),
    "histogram_segment_step": ("lightgbm_tpu_torch/csrc/histogram.cu",
                               "lightgbm_tpu/ops/pallas_histogram.py:668"),
    "route_window_step": ("lightgbm_tpu_torch/csrc/histogram.cu",
                          "lightgbm_tpu/ops/pallas_histogram.py:1590"),
    "histogram_segment_routed_step": (
        "lightgbm_tpu_torch/csrc/histogram.cu",
        "lightgbm_tpu/ops/pallas_histogram.py:1126"),
    "score_gather_add": ("lightgbm_tpu_torch/csrc/score.cu",
                         "lightgbm_tpu/ops/pallas_score.py:106"),
    "histogram_all": ("lightgbm_tpu_torch/csrc/histogram.cu",
                      "lightgbm_tpu/ops/pallas_histogram.py:460"),
    "histogram_frontier": ("lightgbm_tpu_torch/csrc/histogram.cu",
                           "lightgbm_tpu/ops/pallas_histogram.py:842"),
    "histogram_frontier_routed": ("lightgbm_tpu_torch/csrc/histogram.cu",
                                  "lightgbm_tpu/ops/pallas_histogram.py:1279"),
    "histogram_frontier_fusedk": ("lightgbm_tpu_torch/csrc/histogram.cu",
                                  "lightgbm_tpu/ops/pallas_histogram.py:1279"),
    # no Pallas site: the JAX route is XLA gathers (_tree_leaves)
    "route_trees": ("lightgbm_tpu_torch/csrc/predict.cu",
                    "lightgbm_tpu/models/device_predict.py:99"),
    # no Pallas site: the JAX quantizer is XLA (quantize_pack_channels)
    "quantize_pack": ("lightgbm_tpu_torch/csrc/quantize.cu",
                      "lightgbm_tpu/ops/pallas_histogram.py:188"),
    # no Pallas site: the JAX onehot path's histogram is XLA; B3 is two
    # kernels, the leaf's row list (pass 1) and the histogram (pass 2)
    "histogram_chunked": ("lightgbm_tpu_torch/csrc/wide_hist.cu",
                          "lightgbm_tpu/ops/histogram.py:32"),
    "histogram_chunked_select": ("lightgbm_tpu_torch/csrc/wide_hist.cu",
                                 "lightgbm_tpu/ops/histogram.py:32"),
}
FRONTIER_PARAMS = dict(TRAIN_PARAMS, tpu_tree_impl="frontier")
# the session phase: a learning rate and stop at which the holdout's
# binary_logloss turns within SESSION_ROUNDS (the run is deterministic:
# the same data and kernels stop at the same iteration)
SESSION_PARAMS = dict(TRAIN_PARAMS, learning_rate=1.0,
                      metric=["binary_logloss"])
SESSION_PARITY_PARAMS = dict(SESSION_PARAMS, num_leaves=31)
SESSION_ROUNDS = 40
SESSION_STOP = 2
# cv rounds at 200k rows (the CPU's share of the session phase's wall)
SESSION_PARITY_CV_ROUNDS = 2
# phase 19's card = CPU runs (cut from 3 in PR 16 to make room for phase 27)
META_PARITY_ITERS = 2
FRONTIER_TIER_KERNEL = {"off": "histogram_frontier",
                        "k1": "histogram_frontier_routed",
                        "fusedk": "histogram_frontier_fusedk"}


class SmokeError(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# each phase's wall on the host clock, summed over its parts in main's
# order: mark(name) books the time since the previous mark to name
PHASE_WALLS: dict = {}
_MARK = [0.0, 0.0]


def mark(name: str) -> None:
    now = time.perf_counter()
    PHASE_WALLS[name] = PHASE_WALLS.get(name, 0.0) + now - _MARK[1]
    _MARK[1] = now
    log(f"wall: {name} {PHASE_WALLS[name]:.1f} s, {now - _MARK[0]:.1f} s "
        "since the start")


def higgs_like(n: int, seed: int):
    """bench.py's synthetic HIGGS-shaped binary data."""
    import numpy as np
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, N_FEATURES)).astype(np.float32)
    logit = (2.0 * X[:, 0] + X[:, 1] - X[:, 2] * X[:, 3]
             + 0.5 * np.sin(3 * X[:, 4]))
    y = (logit + rng.normal(size=n) * 0.5 > 0).astype(np.float64)
    return X, y


def multiclass_cat(n: int, seed: int):
    """bench_suite.py's _gen_multiclass (multiclass_cat)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, N_FEATURES)).astype(np.float32)
    cats = rng.randint(0, 16, size=(n, 8))
    X[:, 20:28] = cats
    logits = np.stack([
        X[:, 0] + (cats[:, 0] % 5 == k) * 1.5
        + 0.5 * X[:, k % 4] * (1 if k % 2 else -1)
        for k in range(MC_CLASSES)], axis=1)
    y = np.argmax(2.0 * logits + rng.gumbel(size=(n, MC_CLASSES)), axis=1)
    return X, y.astype(np.float64)


# Expo, the flight-delay set of the reference's experiments
# (docs/Experiments.rst:101-146, BASELINE.md:17,21; "Flight Delay" in Ke
# et al., NeurIPS 2017, Table 1): 11M training rows, a 100k holdout, 4
# numeric columns and 696 one-hot columns (700 in all), binary "delayed"
EXPO_ROWS = 11_000_000
EXPO_HOLDOUT = 100_000
# (name, categories, Zipf-like p ~ 1 / rank or uniform), in column order
EXPO_BLOCKS = (("Month", 12, False), ("DayofMonth", 31, False),
               ("DayOfWeek", 7, False), ("UniqueCarrier", 22, True),
               ("Origin", 300, True), ("Dest", 300, True),
               ("DepHour", 24, False))
EXPO_NUMERIC = 4
# BASELINE.md:9 and the GPU experiment's max_bin (BASELINE.md:40-41)
EXPO_PARAMS = dict(objective="binary", num_leaves=255, learning_rate=0.1,
                   min_sum_hessian_in_leaf=100.0, max_bin=63,
                   metric=["auc"], verbosity=-1, device_type="cuda")


def expo_like(n: int, seed: int):
    """Expo-shaped data as a scipy CSR float64 matrix [n, 700] and a
    binary label: CRSDepTime and CRSArrTime uniform in [0, 2400),
    Distance lognormal and CRSElapsedTime from it, then the one-hot
    blocks of EXPO_BLOCKS (DepHour is CRSDepTime's hour).  The label is
    a draw from a logistic of per-category effects plus a departure-time
    term (about 22% positive)."""
    import numpy as np
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    dep = rng.uniform(0.0, 2400.0, n)
    arr = rng.uniform(0.0, 2400.0, n)
    dist = rng.lognormal(6.2, 0.6, n)
    elapsed = 30.0 + dist / 8.0 + rng.uniform(0.0, 20.0, n)
    logit = -2.5 + 1.2 * dep / 2400.0 + 0.1 * np.log(dist)
    cols = [np.arange(EXPO_NUMERIC)[None, :].repeat(n, 0)]
    base = EXPO_NUMERIC
    for name, k, zipf in EXPO_BLOCKS:
        if name == "DepHour":
            c = (dep // 100).astype(np.int64) % k
        elif zipf:
            p = 1.0 / np.arange(1, k + 1)
            c = rng.choice(k, n, p=p / p.sum())
        else:
            c = rng.randint(0, k, n)
        logit += rng.normal(0.0, 0.4, k)[c]
        cols.append((base + c)[:, None])
        base += k
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logit))).astype(
        np.float64)
    indices = np.concatenate(cols, axis=1).astype(np.int32)
    width = indices.shape[1]
    data = np.ones((n, width), dtype=np.float64)
    data[:, :EXPO_NUMERIC] = np.stack([dep, arr, dist, elapsed], axis=1)
    X = sp.csr_matrix((data.reshape(-1), indices.reshape(-1),
                       np.arange(0, n * width + 1, width, dtype=np.int64)),
                      shape=(n, base))
    return X, y


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn(i)`` for i in [0, reps) (CUDA events),
    after one warm-up call ``fn(reps)``."""
    import torch
    fn(reps)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, nops: float, ops_per_s: float = PEAK_OPS_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def prev_designs():
    """tools/p1_time.py, which builds and calls the previous designs of P1
    and Q1 (tools/prev_kernels/) for timing in turns with the shipped
    ones."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import p1_time
    return p1_time


# ---------------------------------------------------------------- phase 1
def build_phase():
    """Builds the kernels; returns the build report of each hand-written
    histogram and route body: ptxas's stack, spill and register lines and
    the atomic SASS opcodes of each instantiation.  A 64-bit shared add,
    which sm_90a lacks, would show as an ATOMS.CAS loop: each histogram
    body must have none."""
    from lightgbm_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    prev = prev_designs()
    handle = prev.prev_build_start()
    kernels.library()
    prev.prev_library(handle)
    log(f"build: {time.perf_counter() - t0:.1f} s (the previous P1 and Q1 "
        f"designs' library too)")
    for line in kernels.build_log().splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("ptxas: " + line.strip())
    report = {}
    # body -> (name of the instantiation without, with a route) and its
    # bool template arguments in order: a route ("routed"; K2's "table"),
    # the 4-bit bins ("packed4", named " packed4"), the packed-accumulator
    # stream ("acc", named " packed_acc")
    for body, names, flags in (
            ("segment_window_kernel", ("K1", "K3"),
             ("routed", "packed4", "acc")),
            ("segment_step_kernel", ("K1 step", "K3 step"),
             ("routed", "packed4", "acc")),
            ("frontier_hist_kernel", ("K6", "K7"),
             ("routed", "packed4", "acc")),
            ("all_hist_kernel", ("K5",), ("packed4", "acc")),
            ("route_window_kernel", ("K2",), ("table", "packed4", "wide")),
            ("route_step_kernel", ("K2 step",), ("table", "packed4"))):
        ptxas = kernels.ptxas_lines(body)
        sass = kernels.sass_opcodes(body)
        part = {}
        for fn in sorted(set(ptxas) | set(sass)):
            ops = sass.get(fn, {})
            on = dict(zip(flags, (b == "1" for b in
                                  re.findall(r"Lb([01])E", fn))))
            name = (names[1 if on.get("routed") else 0]
                    + (" packed4" if on.get("packed4") else "")
                    + (" packed_acc" if on.get("acc") else "")
                    + (" u16" if on.get("wide") else ""))
            part[name] = {
                "ptxas": ptxas.get(fn, []),
                "atomics": {k: v for k, v in sorted(ops.items())
                            if k.startswith(("ATOMS", "ATOM", "RED"))},
                "atoms_cas": sum(v for k, v in ops.items()
                                 if k.startswith("ATOMS.CAS"))}
        log(f"{body} build: {json.dumps(part)}")
        want = {n + p + a for n in names
                for p in (("", " packed4") if "packed4" in flags else ("",))
                for a in (("", " packed_acc") if "acc" in flags else ("",))}
        if "wide" in flags:
            # K2's u16 mode: one instantiation, neither table nor packed
            want.add(names[0] + " u16")
        require(set(part) == want and len(ptxas) == len(want),
                f"{body}'s instantiations are missing from the build: "
                f"{sorted(part)}")
        for name, rec in part.items():
            require(rec["atoms_cas"] == 0, f"{name} ({body}) has "
                    f"{rec['atoms_cas']} ATOMS.CAS loops")
        report.update(part)
    report.update(p1_q1_build_report(kernels))
    report.update(b3_build_report(kernels))
    return report


def b3_build_report(kernels):
    """B3's instantiations (pass 1, chunked_select_kernel; pass 2 on u8 or
    u16 bins, shared planes or global-atomic): ptxas's lines and the
    atomic SASS opcodes; no body may hold an ATOMS.CAS loop, nor a
    returning shared atomic (an ATOMS whose result feeds a later add shows
    as no other opcode, so the report lists them all).  Then
    tools/b3_atomics_probe.cu (tools/p1_time.py b3_probe): whether a 64-bit
    shared add is native on this card (its variant compiles to an
    ATOMS.ADD.64, not an ATOMS.CAS loop) and each way of adding a pair's
    rate over random cells."""
    part = {}
    for body in ("chunked_hist_kernel", "chunked_select_kernel"):
        ptxas = kernels.ptxas_lines(body)
        sass = kernels.sass_opcodes(body)
        for fn in sorted(set(ptxas) | set(sass)):
            m = re.search(r"chunked_hist_kernelI([ht])Lb([01])E", fn)
            name = ("B3 select" if body == "chunked_select_kernel" else
                    "B3 " + ("u16" if m and m.group(1) == "t" else "u8")
                    + (" global" if m and m.group(2) == "1" else ""))
            ops = sass.get(fn, {})
            part[name] = {
                "ptxas": ptxas.get(fn, []),
                "atomics": {k: v for k, v in sorted(ops.items())
                            if k.startswith(("ATOMS", "ATOM", "RED"))},
                "atoms_cas": sum(v for k, v in ops.items()
                                 if k.startswith("ATOMS.CAS"))}
    log(f"B3 build: {json.dumps(part)}")
    require(set(part) == {f"B3 {b}{g}" for b in ("u8", "u16")
                          for g in ("", " global")} | {"B3 select"},
            f"B3's instantiations are missing from the build: "
            f"{sorted(part)}")
    for name, rec in part.items():
        require(rec["atoms_cas"] == 0, f"{name} has {rec['atoms_cas']} "
                "ATOMS.CAS loops")
    probe = prev_designs().b3_probe()
    u64 = [ops for fn, ops in probe["sass"].items()
           if "probe_kernelILi4E" in fn]
    require(len(u64) == 1, "the probe's 64-bit variant is missing")
    part["shared_add64"] = {
        "native": any(k.startswith("ATOMS.ADD.64") for k in u64[0])
        and not any(k.startswith("ATOMS.CAS") for k in u64[0]),
        "sass": u64[0]}
    part["atomics_probe"] = probe["rates"]
    log(f"B3 shared atomics: a 64-bit shared add is "
        f"{'native' if part['shared_add64']['native'] else 'a CAS loop'} "
        f"({u64[0]}); " + "; ".join(
            f"{r['variant']} {'skewed' if r['skewed'] else 'uniform'} "
            f"{r['cells']} cells: {r['pairs_per_clock_sm']} pairs a clock "
            f"an SM" for r in probe["rates"]))
    return part


def p1_q1_build_report(kernels):
    """P1's six instantiations (u8 bins tiled or read in place, 4-bit
    packed or not; i16 and u16 bins read in place) and Q1's two kernels
    (16-byte access or not, two instantiations each): ptxas's lines and SASS
    opcode counts.  Q1's rotations must be funnel shifts: each
    quantize_pack_kernel holds at least 40 SHF a row (two hashes of 20
    rounds) for its four rows."""
    part = {}
    for body, label in (("route_trees_kernel", "P1"),
                        ("quantize_reduce_kernel", "Q1 reduce"),
                        ("quantize_pack_kernel", "Q1 pack")):
        ptxas = kernels.ptxas_lines(body)
        sass = kernels.sass_opcodes(body)
        for fn in sorted(set(ptxas) | set(sass)):
            flags = [b == "1" for b in re.findall(r"Lb([01])E", fn)]
            if body == "route_trees_kernel":
                m = re.search(r"route_trees_kernelI([hst])", fn)
                kind = {"s": "i16", "t": "u16"}.get(m and m.group(1), "u8")
                name = (f"P1 {kind}"
                        + (" packed4" if flags[0] else "")
                        + (" tiled" if flags[1] else ""))
            else:
                name = label + (" vec" if flags and flags[0] else "")
            ops = sass.get(fn, {})
            part[name] = {
                "ptxas": ptxas.get(fn, []),
                "shf": sum(v for k, v in ops.items() if k.startswith("SHF")),
                "sass_instructions": sum(ops.values())}
    want = {"P1 i16", "P1 u16"} | {f"P1 u8{p}{t}" for p in ("", " packed4")
                         for t in ("", " tiled")} | {
        f"Q1 {k}{v}" for k in ("reduce", "pack") for v in ("", " vec")}
    log(f"P1 / Q1 build: {json.dumps(part)}")
    require(set(part) == want, f"P1 / Q1 instantiations missing from the "
            f"build: {sorted(part)}")
    for name in ("Q1 pack", "Q1 pack vec"):
        require(part[name]["shf"] >= 40 * 4, f"{name}: {part[name]['shf']} "
                "funnel shifts, fewer than its 160 rotations")
    return part


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 2
def hist_abs_sums(th, binsT, w8, lid, lo_blk, n_blk, target, B, rb,
                  packed4=False):
    """Per-bin sums of |gradient| and |hessian| (the tolerance's scale),
    by the plain histogram over absolute-valued channels."""
    return th.histogram_segment_plain(binsT, abs_channel_sets(w8), lid,
                                      lo_blk, n_blk, target, B, rb, packed4)


def check_hist(name, got, want, abs_sums) -> float:
    """Counts exact; sums within HIST_RTOL x the bin's sum of |value|.
    Returns the largest absolute difference."""
    import torch
    require(torch.equal(got[..., 2], want[..., 2]),
            f"{name}: counts differ from the plain version")
    diff = (got.double() - want.double()).abs()
    tol = HIST_RTOL * abs_sums.double() + 1e-30
    bad = (diff[..., :2] > tol[..., :2]).sum().item()
    require(bad == 0, f"{name}: {bad} sums outside {HIST_RTOL} x sum|value|")
    return float(diff.max().item())


def abs_channel_sets(w8C):
    """[8C, N] channel sets -> float32 sets of |g|, |h| and member: the
    tolerance's scale, through the plain histograms."""
    import torch
    out = []
    for c in range(w8C.shape[0] // 8):
        w = w8C[8 * c:8 * c + 8]
        g = (w[0].float() + w[1].float()).abs()
        h = (w[2].float() + w[3].float()).abs()
        z = torch.zeros_like(g)
        out.append(torch.stack([g, z, h, z, w[4].float(), z, z, z]))
    return torch.cat(out)


def check_histogram_all(th, binsT, w8C, B, rb, tag, packed4=False):
    """K5 against its plain version: counts exact, sums in tolerance, a
    relaunch bit-identical, and class c's slice bit-identical to K1 on a
    root of class c at the class's scale.  Returns (max |diff|, scales)."""
    import torch
    F, npad = binsT.shape
    C = w8C.shape[0] // 8
    scales = th.class_scales(w8C)
    want = th.histogram_all_plain(binsT, w8C, B, packed4)
    a = th.histogram_all(binsT, w8C, B, scales, packed4)
    b = th.histogram_all(binsT, w8C, B, scales, packed4)
    torch.cuda.synchronize()
    require(torch.equal(a, b), f"histogram_all {tag}: a second launch "
            "differs from the first")
    abs_sums = th.histogram_all_plain(binsT, abs_channel_sets(w8C), B,
                                      packed4)
    err = check_hist(f"histogram_all {tag}", a, want, abs_sums)
    lid0 = torch.zeros(npad, dtype=torch.int32, device=binsT.device)
    for c in range(C):
        root = th.histogram_segment(binsT, w8C[8 * c:8 * c + 8], lid0, 0,
                                    npad // rb, 0, B, rb, scales[c],
                                    packed4)
        require(torch.equal(a[c], root), f"histogram_all {tag}: class {c} "
                "differs from the K1 root of that class")
    log(f"histogram_all {tag}: {C} sets, counts exact, max |diff| "
        f"{err:.3g}, class slices equal the K1 roots")
    return err, scales


def check_step_entries(th, binsT, w8, scales, lid, B, rb, cases, tag,
                       packed4=False):
    """The step entries (K1, K2 and K3 reading their window, target and
    route from a step block in device memory) against their by-value
    entries, bit for bit (histograms and leaf ids), and each against its
    own plain version on the same block (ids exact, counts exact, sums in
    tolerance), for each case (name, start block, blocks, target, route).
    Returns each step entry's largest |diff| from its plain version (K2:
    the leaf ids that differ)."""
    import torch
    err = dict.fromkeys(("histogram_segment_step", "route_window_step",
                         "histogram_segment_routed_step"), 0.0)
    for name, lo, nb, target, route in cases:
        step = th.pack_step(lo, nb, target, route).to(binsT.device)
        want_ids = lid.clone()
        _, want = th.histogram_segment_routed(binsT, w8, want_ids, lo, nb,
                                              target, route, B, rb, scales,
                                              packed4)
        ids = lid.clone()
        _, got = th.histogram_segment_routed_step(binsT, w8, ids, step, B,
                                                  rb, scales,
                                                  packed4=packed4)
        k2 = th.route_window_step(binsT, lid.clone(), step, rb, packed4)
        k1 = th.histogram_segment_step(binsT, w8, want_ids, step, B, rb,
                                       scales, packed4=packed4)
        k1_by = th.histogram_segment(binsT, w8, want_ids, lo, nb, target, B,
                                     rb, scales, packed4)
        torch.cuda.synchronize()
        require(torch.equal(ids, want_ids) and torch.equal(got, want),
                f"histogram_segment_routed_step {tag} {name}: differs from "
                "the by-value entry")
        require(torch.equal(k2, want_ids), f"route_window_step {tag} {name}: "
                "differs from the by-value entry")
        require(torch.equal(k1, k1_by), f"histogram_segment_step {tag} "
                f"{name}: differs from the by-value entry")
        plain_ids, plain = th.histogram_segment_routed_step_plain(
            binsT, w8, lid.clone(), step, B, rb, packed4)
        require(torch.equal(plain_ids, ids), f"histogram_segment_routed_step "
                f"{tag} {name}: leaf ids differ from the plain version")
        abs_sums = hist_abs_sums(th, binsT, w8, ids, lo, nb, target, B, rb,
                                 packed4)
        key = "histogram_segment_routed_step"
        err[key] = max(err[key], check_hist(f"{key} {tag} {name}", got,
                                            plain, abs_sums))
        plain_k2 = th.route_window_step_plain(binsT, lid.clone(), step, rb,
                                              packed4)
        moved = int((k2 != plain_k2).sum().item())
        require(moved == 0, f"route_window_step {tag} {name}: {moved} leaf "
                "ids differ from the plain version")
        err["route_window_step"] = max(err["route_window_step"], moved)
        # K1 over the routed ids, as the unfused split runs it after K2
        plain_k1 = th.histogram_segment_step_plain(binsT, w8, want_ids, step,
                                                   B, rb, packed4)
        key = "histogram_segment_step"
        err[key] = max(err[key], check_hist(f"{key} {tag} {name}", k1,
                                            plain_k1, abs_sums))
        if nb == 0:
            require(not got.any() and not k1.any(), f"step entries {tag} "
                    f"{name}: an empty window wrote a non-zero histogram")
        log(f"step entries {tag} {name} ({nb} blocks): K1, K2 and K3 bit "
            f"for bit their by-value entries; max |diff| from their plain "
            f"versions: K1 {err['histogram_segment_step']:.3g}, K2 "
            f"{moved} ids, K3 {err['histogram_segment_routed_step']:.3g}")
    return err


def library_hist_ms(binsT, w8s, rows, B, reps, slots=None, n_slots=1):
    """One torch index_add_ of (g, h, member) into [C*F*B, 3] computing
    what a histogram kernel computes over ``rows`` for each of the
    channel sets ``w8s``; with ``slots`` (one w8, the target slot of each
    row) into [n_slots*F*B, 3], what a frontier kernel computes.  The flat
    keys and values are made before the clock starts, set by set into
    buffers of their final size."""
    import torch
    F = binsT.shape[0]
    b = binsT[:, rows].long()
    f_off = torch.arange(F, device=b.device)[:, None]
    per_set = F * b.shape[1]
    keys = torch.empty(len(w8s) * per_set, dtype=torch.int64,
                       device=b.device)
    vals = torch.empty((len(w8s) * per_set, 3), dtype=torch.float32,
                       device=b.device)
    for c, w8 in enumerate(w8s):
        w = w8[:, rows].float()
        v = torch.stack([w[0] + w[1], w[2] + w[3], w[4]], dim=1)
        first = c if slots is None else slots.long()[None, :]
        keys[c * per_set:(c + 1) * per_set] = ((first * F + f_off) * B
                                                + b).reshape(-1)
        vals[c * per_set:(c + 1) * per_set].view(F, -1, 3).copy_(
            v[None].expand(F, -1, -1))
        del w, v
    del b
    n_out = len(w8s) if slots is None else n_slots
    out = torch.zeros((n_out * F * B, 3), dtype=torch.float32,
                      device=binsT.device)
    ms = time_ms(lambda i: out.index_add_(0, keys, vals), reps)
    del keys, vals, out
    torch.cuda.empty_cache()
    return ms


def kernel_phase(handle, config, device):
    """K1-K4 against their plain versions at the main path's shapes.
    Returns {kernel name: measurement dict}."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.models.gbdt import block_rows
    from lightgbm_tpu_torch.objective import create_objective
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import score as ts
    from lightgbm_tpu_torch.ops.split import FeatureMeta

    n = handle.num_data
    rb = block_rows(config, n)
    binsT = handle.device_bins(rb, device)
    F, npad = binsT.shape
    nblk = npad // rb
    B = 1 << max(0, (handle.max_num_bin - 1).bit_length())
    infos = handle.feature_infos()
    fm = FeatureMeta(*(np.array([getattr(i, k) for i in infos], np.int32)
                       for k in ("num_bin", "missing_type", "default_bin")))
    # the first iteration's gradients, from the boost-from-average score
    obj = create_objective(config)
    obj.init(handle.metadata, n, device)
    score0 = torch.full((n,), obj.boost_from_score(), dtype=torch.float32,
                        device=device)
    grad, hess = obj.get_gradients(score0)
    grad = torch.nn.functional.pad(grad, (0, npad - n))
    hess = torch.nn.functional.pad(hess, (0, npad - n))
    member = torch.zeros(npad, dtype=torch.float32, device=device)
    member[:n] = 1.0
    w8 = th.pack_channels(grad, hess, member)
    scales = th.fixed_point_scales(w8)
    lid0 = torch.zeros(npad, dtype=torch.int32, device=device)
    log(f"kernels: F={F} B={B} Npad={npad} rb={rb}")

    def with_missing(f, mt):
        m = FeatureMeta(*(a.copy() for a in fm[:3]))
        m.missing_type[f] = mt
        return m

    rng = np.random.RandomState(3)
    bitset = rng.randint(0, 2**32, size=8, dtype=np.uint64).astype(np.uint32)
    none = np.zeros(8, np.uint32)
    mid = int(fm.num_bin[0]) // 2
    routes = {
        "numeric": th.pack_route(0, 1, 0, mid, False, False, none, fm),
        "nan_missing": th.pack_route(0, 1, 1, mid - 5, True, False, none,
                                     with_missing(1, 2)),
        "zero_missing": th.pack_route(0, 1, 2, mid + 5, True, False, none,
                                      with_missing(2, 1)),
        "categorical": th.pack_route(0, 1, 3, 0, False, True, bitset, fm),
    }
    windows = {"full": (0, nblk), "partial": (nblk // 4, nblk // 4)}
    results = {}

    # K2 route_window: bit-identical ids, repeat identical, window respected
    err = 0
    for rname, route in routes.items():
        for wname, (lo, nb) in windows.items():
            want = th.route_window_plain(binsT, lid0.clone(), lo, nb, route,
                                         rb)
            runs = [th.route_window(binsT, lid0.clone(), lo, nb, route, rb)
                    for _ in range(2)]
            torch.cuda.synchronize()
            for got in runs:
                err = max(err, int((got != want).sum().item()))
            require(err == 0, f"route_window {rname}/{wname}: leaf ids "
                    "differ from the plain version")
            moved = int((want == 1).sum().item())
            require(0 < moved < nb * rb, f"route_window {rname}/{wname}: "
                    f"the route moved {moved} rows")
            outside = torch.ones(npad, dtype=torch.bool, device=device)
            outside[lo * rb:(lo + nb) * rb] = False
            require(not bool(want[outside].any().item()),
                    "rows outside the window were routed")
            log(f"route_window {rname}/{wname}: identical, {moved} rows "
                "moved")
    results["route_window"] = {"max_abs_err": float(err)}

    # K1 histogram_segment: the root (every row of leaf 0, full window)
    # and a child after the numeric split (half the window)
    lid_split = th.route_window_plain(binsT, lid0.clone(), 0, nblk,
                                      routes["numeric"], rb)
    err = 0.0
    for cname, lid, target in (("root", lid0, 0), ("child", lid_split, 1)):
        want = th.histogram_segment_plain(binsT, w8, lid, 0, nblk, target,
                                          B, rb)
        a = th.histogram_segment(binsT, w8, lid, 0, nblk, target, B, rb,
                                 scales)
        b = th.histogram_segment(binsT, w8, lid, 0, nblk, target, B, rb,
                                 scales)
        torch.cuda.synchronize()
        require(torch.equal(a, b), f"histogram_segment {cname}: a second "
                "launch differs from the first")
        abs_sums = hist_abs_sums(th, binsT, w8, lid, 0, nblk, target, B, rb)
        err = max(err, check_hist(f"histogram_segment {cname}", a, want,
                                  abs_sums))
        log(f"histogram_segment {cname}: counts exact, max |diff| {err:.3g}")
    results["histogram_segment"] = {"max_abs_err": err}

    # K3 histogram_segment_routed: every route case, plus the null route
    err = 0.0
    lid_err = 0
    for rname, route in list(routes.items()) + [("null", th.null_route())]:
        target = 0 if rname == "null" else 1
        want_lid, want = th.histogram_segment_routed_plain(
            binsT, w8, lid0.clone(), 0, nblk, target, route, B, rb)
        runs = []
        for _ in range(2):
            lid = lid0.clone()
            got_lid, got = th.histogram_segment_routed(
                binsT, w8, lid, 0, nblk, target, route, B, rb, scales)
            require(got_lid.data_ptr() == lid.data_ptr(),
                    "histogram_segment_routed: leaf_id not updated in place")
            runs.append((got_lid, got))
        torch.cuda.synchronize()
        require(torch.equal(runs[0][1], runs[1][1]),
                f"histogram_segment_routed {rname}: a second launch differs")
        for got_lid, _ in runs:
            lid_err = max(lid_err, int((got_lid != want_lid).sum().item()))
        require(lid_err == 0, f"histogram_segment_routed {rname}: leaf ids "
                "differ from the plain version")
        abs_sums = hist_abs_sums(th, binsT, w8, want_lid, 0, nblk, target,
                                 B, rb)
        err = max(err, check_hist(f"histogram_segment_routed {rname}",
                                  runs[0][1], want, abs_sums))
        log(f"histogram_segment_routed {rname}: ids identical, counts "
            f"exact, max |diff| {err:.3g}")
    results["histogram_segment_routed"] = {"max_abs_err": err}

    # the step entries: the first split, a late window, an empty window
    # and a categorical route over a partial window
    step_errs = check_step_entries(th, binsT, w8, scales, lid0, B, rb, (
        ("first split", 0, nblk, 1, routes["numeric"]),
        ("late window", nblk - 3, 2, 1, routes["numeric"]),
        ("empty window", nblk // 2, 0, 1, routes["numeric"]),
        ("categorical", nblk // 4, nblk // 4, 1, routes["categorical"])),
        "HIGGS")
    for name, e in step_errs.items():
        results[name] = {"max_abs_err": e}

    # K1 of target t is K6's single slot [t] over the same blocks, bit for
    # bit: the root, the numeric split's child, and a partial window
    blocks = torch.arange(nblk, dtype=torch.int32, device=device)
    for cname, lid, target, lo, nb in (
            ("root", lid0, 0, 0, nblk), ("child", lid_split, 1, 0, nblk),
            ("partial child", lid_split, 1, nblk // 4, nblk // 4)):
        k1 = th.histogram_segment(binsT, w8, lid, lo, nb, target, B, rb,
                                  scales)
        k6 = th.histogram_frontier(binsT, w8, lid, blocks[lo:lo + nb].clone(),
                                   nb, torch.tensor([target],
                                                    dtype=torch.int32),
                                   B, rb, scales)
        require(torch.equal(k1, k6[0]), f"histogram_segment {cname}: "
                "differs from K6's single slot over the same blocks")
    log("histogram_segment: root, child and partial window each equal "
        "K6's single slot, bit for bit")

    # K4 score_gather_add: leaf ids of a 255-leaf tree; ids >= L add 0
    L = 255
    lid_score = torch.from_numpy(
        rng.randint(0, L, size=n).astype(np.int32)).to(device)
    score = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(device)
    table = torch.from_numpy(rng.normal(size=L).astype(np.float32)).to(device)
    want = ts.score_gather_add_plain(score, lid_score, table)
    a = ts.score_gather_add(score, lid_score, table)
    # in place, as the boosting loop calls it
    b = score.clone()
    ts.score_gather_add(b, lid_score, table, out=b)
    lid_oob = lid_score[:4096] + torch.tensor(8, dtype=torch.int32,
                                              device=device)
    oob = ts.score_gather_add(score[:4096], lid_oob, table)
    torch.cuda.synchronize()
    require(torch.equal(a.view(torch.int32), want.view(torch.int32))
            and torch.equal(a.view(torch.int32), b.view(torch.int32)),
            "score_gather_add: not bit-identical to the plain version")
    require(torch.equal(oob.view(torch.int32), ts.score_gather_add_plain(
        score[:4096], lid_oob, table).view(torch.int32)),
        "score_gather_add: out-of-range leaf ids")
    results["score_gather_add"] = {
        "max_abs_err": float((a - want).abs().max().item())}
    log("score_gather_add: bit-identical")

    # K5 histogram_all: C = 5 channel sets over the HIGGS rows, gradients
    # of a 5-class softmax at random scores (made from a seed)
    gen = torch.Generator(device=device).manual_seed(5)
    mc_score = torch.randn((MC_CLASSES, npad), generator=gen, device=device)
    p = torch.softmax(mc_score, dim=0)
    mc_label = torch.randint(0, MC_CLASSES, (npad,), generator=gen,
                             device=device)
    mc_grad = (p - torch.nn.functional.one_hot(mc_label, MC_CLASSES).T) \
        * member
    mc_hess = 2.0 * p * (1.0 - p) * member
    w8C = th.pack_channel_sets(mc_grad, mc_hess, member)
    del mc_score, p, mc_label, mc_grad, mc_hess
    err5, scales5 = check_histogram_all(th, binsT, w8C, B, rb, "HIGGS rows")

    # ---- times at the main path's shapes
    # K2 and K3 rewrite leaf ids in place: every timed call gets a fresh
    # copy of the unrouted ids, made before the clock starts
    reps, plain_reps = 20, 3

    def fresh_ids(k):
        return [lid0.clone() for _ in range(k + 1)]

    route = routes["numeric"]
    W = npad
    moved = int((lid_split == 1).sum().item())
    out_bytes = F * B * 3 * 4
    # K1 root: reads every row's leaf id, bins and five weight channels
    k1_bytes = W * 4 + W * (F + 10) + out_bytes
    k1_ops = W * F * 3
    # K3 first split: ids and the split feature's bins of every row, the
    # moved rows' ids written, bins and weights of the target's rows
    k3_bytes = W * 5 + moved * 4 + moved * (F - 1 + 10) + out_bytes
    k3_ops = W * 20 + moved * F * 3
    k2_bytes = W * 5 + moved * 4
    k2_ops = W * 20
    k4_bytes = n * 12 + L * 4
    k4_ops = n

    t = results["histogram_segment"]
    t["ms"] = time_ms(lambda i: th.histogram_segment(
        binsT, w8, lid0, 0, nblk, 0, B, rb, scales), reps)
    t["plain_ms"] = time_ms(lambda i: th.histogram_segment_plain(
        binsT, w8, lid0, 0, nblk, 0, B, rb), plain_reps)
    t["bound_ms"], t["bound_by"] = bound_ms(k1_bytes, k1_ops)
    t["library_ms"] = library_hist_ms(binsT, [w8], torch.arange(
        n, device=device), B, reps)
    t["shape"] = f"root: {W} rows x {F} features, all of leaf 0"
    t["tiling"] = th.segment_tiling(F, B)
    want = th.histogram_segment(binsT, w8, lid0, 0, nblk, 0, B, rb, scales)
    t.update(launch_report("histogram_segment root", lambda ids: (
        th.histogram_segment(binsT, w8, ids, 0, nblk, 0, B, rb, scales)),
        lid0, want, lid0, reps))

    t = results["histogram_segment_routed"]
    ids = fresh_ids(reps)
    t["ms"] = time_ms(lambda i: th.histogram_segment_routed(
        binsT, w8, ids[i], 0, nblk, 1, route, B, rb, scales), reps)
    ids = fresh_ids(plain_reps)
    t["plain_ms"] = time_ms(lambda i: th.histogram_segment_routed_plain(
        binsT, w8, ids[i], 0, nblk, 1, route, B, rb), plain_reps)
    t["bound_ms"], t["bound_by"] = bound_ms(k3_bytes, k3_ops)
    t["library_ms"] = library_hist_ms(
        binsT, [w8], torch.nonzero(lid_split == 1)[:, 0], B, reps)
    t["shape"] = (f"first split: {W} rows, {moved} routed to the target "
                  "child")
    # the root case of the fused path (null route)
    t["root_ms"] = time_ms(lambda i: th.histogram_segment_routed(
        binsT, w8, lid0, 0, nblk, 0, th.null_route(), B, rb, scales), reps)
    want_lid = lid0.clone()
    want = th.histogram_segment_routed(binsT, w8, want_lid, 0, nblk, 1, route,
                                       B, rb, scales)[1]
    t.update(launch_report("histogram_segment_routed first split",
                           lambda ids: th.histogram_segment_routed(
                               binsT, w8, ids, 0, nblk, 1, route, B, rb,
                               scales)[1], lid0, want, want_lid, reps))
    del want_lid

    t = results["route_window"]
    ids = fresh_ids(reps)
    t["ms"] = time_ms(lambda i: th.route_window(
        binsT, ids[i], 0, nblk, route, rb), reps)
    ids = fresh_ids(plain_reps)
    t["plain_ms"] = time_ms(lambda i: th.route_window_plain(
        binsT, ids[i], 0, nblk, route, rb), plain_reps)
    t["bound_ms"], t["bound_by"] = bound_ms(k2_bytes, k2_ops)
    t["library_ms"] = None
    t["shape"] = f"first split: {W} rows, {moved} routed"
    t.update(launch_report("route_window first split", lambda ids: (
        th.route_window(binsT, ids, 0, nblk, route, rb)), lid0, lid_split,
        lid_split, reps))

    t = results["score_gather_add"]
    t["ms"] = time_ms(lambda i: ts.score_gather_add(score, lid_score, table),
                      reps)
    t["plain_ms"] = time_ms(lambda i: ts.score_gather_add_plain(
        score, lid_score, table), reps)
    t["library_ms"] = time_ms(lambda i: score + table[lid_score], reps)
    t["bound_ms"], t["bound_by"] = bound_ms(k4_bytes, k4_ops)
    t["shape"] = f"{n} rows, {L} leaves"

    # K5 at the HIGGS rows: bins once per set and five channels a set
    C = MC_CLASSES
    k5_bytes = W * C * (F + 10) + C * out_bytes
    t = {"max_abs_err": err5}
    t["ms"] = time_ms(lambda i: th.histogram_all(binsT, w8C, B, scales5),
                      reps)
    t["plain_ms"] = time_ms(lambda i: th.histogram_all_plain(
        binsT, w8C, B), plain_reps)
    t["bound_ms"], t["bound_by"] = bound_ms(W * (F + 10 * C)
                                            + C * out_bytes, W * F * C * 3)
    t["per_set_bytes_ms"] = bound_ms(k5_bytes, 0)[0]
    t["library_ms"] = library_hist_ms(
        binsT, [w8C[8 * c:8 * c + 8] for c in range(C)],
        torch.arange(n, device=device), B, reps)
    t["shape"] = f"{W} rows x {F} features x {C} sets, {B} bins"
    t["tiling"] = th.all_tiling(F, B, C)
    want = th.histogram_all(binsT, w8C, B, scales5)
    t.update(launch_report("histogram_all HIGGS rows", lambda ids: (
        th.histogram_all(binsT, w8C, B, scales5)), lid0, want, lid0, reps))
    results["histogram_all_higgs"] = t

    # the step entries at the same calls as their by-value entries: K1 at
    # the root, K3 and K2 at the first split; same bounds and library calls
    root_step = th.pack_step(0, nblk, 0, th.null_route()).to(device)
    split_step = th.pack_step(0, nblk, 1, route).to(device)
    t = results["histogram_segment_step"]
    t["ms"] = time_ms(lambda i: th.histogram_segment_step(
        binsT, w8, lid0, root_step, B, rb, scales), reps)
    t["plain_ms"] = time_ms(lambda i: th.histogram_segment_step_plain(
        binsT, w8, lid0, root_step, B, rb), plain_reps)
    for k in ("bound_ms", "bound_by", "library_ms", "shape"):
        t[k] = results["histogram_segment"][k]
    want = th.histogram_segment(binsT, w8, lid0, 0, nblk, 0, B, rb, scales)
    t.update(launch_report("histogram_segment_step root", lambda ids: (
        th.histogram_segment_step(binsT, w8, ids, root_step, B, rb,
                                  scales)), lid0, want, lid0, reps))

    t = results["histogram_segment_routed_step"]
    ids = fresh_ids(reps)
    t["ms"] = time_ms(lambda i: th.histogram_segment_routed_step(
        binsT, w8, ids[i], split_step, B, rb, scales), reps)
    ids = fresh_ids(plain_reps)
    t["plain_ms"] = time_ms(
        lambda i: th.histogram_segment_routed_step_plain(
            binsT, w8, ids[i], split_step, B, rb), plain_reps)
    for k in ("bound_ms", "bound_by", "library_ms", "shape"):
        t[k] = results["histogram_segment_routed"][k]
    want_lid = lid0.clone()
    want = th.histogram_segment_routed(binsT, w8, want_lid, 0, nblk, 1, route,
                                       B, rb, scales)[1]
    t.update(launch_report(
        "histogram_segment_routed_step first split",
        lambda ids: th.histogram_segment_routed_step(
            binsT, w8, ids, split_step, B, rb, scales)[1], lid0, want,
        want_lid, reps))

    t = results["route_window_step"]
    ids = fresh_ids(reps)
    t["ms"] = time_ms(lambda i: th.route_window_step(
        binsT, ids[i], split_step, rb), reps)
    ids = fresh_ids(plain_reps)
    t["plain_ms"] = time_ms(lambda i: th.route_window_step_plain(
        binsT, ids[i], split_step, rb), plain_reps)
    for k in ("bound_ms", "bound_by", "library_ms", "shape"):
        t[k] = results["route_window"][k]
    t.update(launch_report("route_window_step first split", lambda ids: (
        th.route_window_step(binsT, ids, split_step, rb)), lid0, lid_split,
        lid_split, reps))
    del ids, want_lid
    return results


class record_trees:
    """Context: every SegmentGrower.grow inside it appends its tree's
    ``last_stats`` to ``self.stats``."""

    def __enter__(self):
        from lightgbm_tpu_torch.models import grower_seg
        self.cls = grower_seg.SegmentGrower
        self.grow, self.stats = self.cls.grow, []
        grow, stats = self.grow, self.stats

        def recorded(g, *a, **k):
            out = grow(g, *a, **k)
            stats.append(dict(g.last_stats))
            return out

        self.cls.grow = recorded
        return self

    def __exit__(self, *exc):
        self.cls.grow = self.grow


def device_loop_report(tag, bst, stats, launches, kname, wall_s):
    """The segment grower's device loop on one path: every tree grown by
    graph replays of its ``steps`` split steps, at most ceil((L - 1) /
    steps) + compactions + 2 host fetches a tree, and the step kernel
    launched steps x replays times plus the capture's one warm-up step.
    Logs and returns the graph's capture time, steps, fetches a tree and
    the iteration walls."""
    g = bst.gbdt.grower
    L, S = g.p.num_leaves, g.steps
    require(stats and all(st["graph"] for st in stats),
            f"device loop {tag}: a tree did not grow from the CUDA graph")
    for st in stats:
        bound = -(-(L - 1) // S) + st["compactions"] + 2
        require(st["fetches"] <= bound, f"device loop {tag}: "
                f"{st['fetches']} host fetches in a tree, bound {bound}")
    replays = sum(st["replays"] for st in stats)
    require(launches[kname] == S * replays + 1, f"device loop {tag}: "
            f"{kname} launched {launches[kname]} times, expected {S} x "
            f"{replays} replays + 1")
    rec = {"steps": S, "capture_s": g.last_stats["capture_s"],
           "trees": len(stats), "replays": replays,
           "fetches_a_tree": [st["fetches"] for st in stats],
           "compactions_a_tree": [st["compactions"] for st in stats],
           "splits_a_tree": [st["splits"] for st in stats],
           "iter_s": list(bst.gbdt.iter_seconds), "wall_s": wall_s}
    log(f"device loop {tag}: steps {S}, graph captured in "
        f"{rec['capture_s']:.3f} s, {replays} replays for {len(stats)} "
        f"trees, fetches a tree {sorted(set(rec['fetches_a_tree']))}, "
        f"compactions {sorted(set(rec['compactions_a_tree']))}, iteration "
        f"wall {[round(x, 4) for x in rec['iter_s']]} s")
    return rec


# ---------------------------------------------------------------- phase 3
def train_phase(ds, Xh, yh):
    """The main path: lightgbm_tpu_torch.train on the card, fused route."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.metric import AUCMetric
    from lightgbm_tpu_torch.ops import kernels

    valid = ds.create_valid(Xh, yh)
    evals = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    with record_trees() as rec:
        bst = lt.train(TRAIN_PARAMS, ds, 3, valid_sets=[ds, valid],
                       valid_names=["train", "holdout"], evals_result=evals)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    trees = bst.gbdt.models
    auc = evals["training"]["auc"]
    log(f"train: {len(trees)} iterations in {wall:.2f} s, per iteration "
        f"{[round(s, 3) for s in bst.gbdt.iter_seconds]} s")
    log(f"train: leaves per tree {[t.num_leaves for t in trees]}, "
        f"train AUC {auc}, holdout AUC {evals['holdout']['auc']}")
    log(f"train: launches {launches}")
    require(len(trees) == 3, "training stopped early")
    require(all(b > a for a, b in zip(auc, auc[1:])),
            "train AUC did not rise every iteration")
    require(launches["histogram_segment_routed"] == 3,
            f"histogram_segment_routed launched "
            f"{launches['histogram_segment_routed']} times, expected one "
            "a tree root (3)")
    loop = device_loop_report("HIGGS fused", bst, rec.stats, launches,
                              "histogram_segment_routed_step", wall)
    require(launches["score_gather_add"] == 3,
            "score_gather_add did not run once per iteration")
    require(launches["histogram_segment"] == launches["route_window"]
            == launches["histogram_segment_step"]
            == launches["route_window_step"] == 0,
            "the fused path launched the unfused kernels")

    pred = bst.predict(Xh)
    raw = bst.predict(Xh, raw_score=True)
    require(pred.shape == (len(Xh),) and np.all(np.isfinite(pred))
            and np.all((pred > 0) & (pred < 1)),
            "held-out predictions are not finite probabilities")
    vdiff = float(np.abs(raw - bst.gbdt.valid_scores[0]).max())
    require(vdiff <= 1e-9, f"Booster.predict differs from the in-training "
            f"valid scores by {vdiff}")
    m = AUCMetric()
    m.label = np.asarray(yh, np.float64)
    hauc = m.eval(raw)
    require(hauc > 0.6, f"held-out AUC {hauc}")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.txt")
        bst.save_model(path)
        with open(path) as fh:
            text = fh.read()
    require("Tree=2" in text and text.endswith("end of parameters\n"),
            "saved model text is incomplete")
    log(f"train: holdout predict ok (AUC {hauc:.5f}, |raw - valid score| "
        f"{vdiff:.3g}), model text {len(text)} bytes")
    return launches, {"wall_s": wall, "iter_s": bst.gbdt.iter_seconds,
                      "train_auc": auc, "holdout_auc": hauc,
                      "leaves": [t.num_leaves for t in trees],
                      "device_loop": loop}, bst


# ---------------------------------------------------------- phase 3b
def late_split_phase(bst):
    """K3 at a late split of the main path: one more iteration of phase
    3's booster, whose tree's last split (a compacted window of a few row
    blocks) is rebuilt from the grower's device state after the tree: the
    route from the tree's last node, the window its new leaf inherited,
    the leaf ids before the split (the rows of the last new leaf back in
    its parent) and the smaller child as target.  The step entry (which
    the device loop ran there) and the by-value entry replay it bit for
    bit, against the plain version, timed as phase 2 times K3.  Returns
    {"by_value": ..., "step": ...} measurement dicts."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops.split import FeatureMeta

    bst.update()
    g = bst.gbdt.grower
    s = g.s
    tree, _ = s.tree()
    n = tree.num_leaves
    require(n >= 2, "the fourth tree did not split")
    node, new_leaf = n - 2, n - 1
    leaf = int(~tree.left_child[node])
    fm = FeatureMeta(*(t.cpu().numpy() for t in s.fmeta[:3]))
    route = th.pack_route(leaf, new_leaf, int(tree.split_feature[node]),
                          int(tree.threshold_bin[node]),
                          bool(tree.default_left[node]),
                          bool(tree.is_cat[node]), tree.cat_bitset[node], fm)
    lo, hi = (int(x) for x in s.window[new_leaf].tolist())
    nb = hi - lo
    target = (leaf if tree.leaf_count[leaf] <= tree.leaf_count[new_leaf]
              else new_leaf)
    binsT, w8, scales, rb, B = s.binsT, s.w8, s.scales, g.rb, g.B
    lid = torch.where(s.leaf_id == new_leaf, leaf, s.leaf_id)
    F = binsT.shape[0]
    step = th.pack_step(lo, nb, target, route).to(binsT.device)
    want_lid, want = th.histogram_segment_routed_plain(
        binsT, w8, lid.clone(), lo, nb, target, route, B, rb)
    require(torch.equal(want_lid, s.leaf_id), "late split: the rebuilt "
            "split does not route the rows the tree routed")
    runs = [th.histogram_segment_routed(binsT, w8, lid.clone(), lo, nb,
                                        target, route, B, rb, scales)
            for _ in range(2)]
    steps = [th.histogram_segment_routed_step(binsT, w8, lid.clone(), step,
                                              B, rb, scales)
             for _ in range(2)]
    torch.cuda.synchronize()
    for got_lid, _ in runs + steps:
        require(torch.equal(got_lid, want_lid), "late split: leaf ids differ "
                "from the plain version")
    require(torch.equal(runs[0][1], runs[1][1])
            and torch.equal(runs[0][1], steps[0][1])
            and torch.equal(steps[0][1], steps[1][1]),
            "late split: a relaunch, or the step entry, differs from the "
            "by-value entry")
    rows = slice(lo * rb, (lo + nb) * rb)
    err = check_hist("histogram_segment_routed late split", runs[0][1], want,
                     hist_abs_sums(th, binsT, w8, want_lid, lo, nb, target, B,
                                   rb))
    W = nb * rb
    moved = int((want_lid[rows] != lid[rows]).sum().item())
    in_target = (want_lid[rows] == target) & (w8[4, rows] != 0)
    M = int(in_target.sum().item())
    bound = bound_ms(W * 5 + moved * 4 + M * (F - 1 + 10) + F * B * 12,
                     W * 20 + M * F * 3)
    library = library_hist_ms(binsT, [w8], lo * rb + torch.nonzero(
        in_target)[:, 0], B, 20)
    shape = (f"late split: window of {nb} blocks ({W} rows), {M} in the "
             f"target, {moved} routed")
    reps = 20
    out = {}
    for name, call, plain in (
            ("by_value", lambda ids: th.histogram_segment_routed(
                binsT, w8, ids, lo, nb, target, route, B, rb, scales),
             lambda ids: th.histogram_segment_routed_plain(
                 binsT, w8, ids, lo, nb, target, route, B, rb)),
            ("step", lambda ids: th.histogram_segment_routed_step(
                binsT, w8, ids, step, B, rb, scales),
             lambda ids: th.histogram_segment_routed_step_plain(
                 binsT, w8, ids, step, B, rb))):
        rec = {"max_abs_err": err, "window_blocks": nb, "window_rows": W,
               "target_rows": M, "moved_rows": moved, "shape": shape,
               "bound_ms": bound[0], "bound_by": bound[1],
               "library_ms": library, "grower": dict(g.last_stats)}
        ids = [lid.clone() for _ in range(reps + 1)]
        rec["ms"] = time_ms(lambda i: call(ids[i]), reps)
        ids = [lid.clone() for _ in range(4)]
        rec["plain_ms"] = time_ms(lambda i: plain(ids[i]), 3)
        del ids
        rec.update(launch_report(f"histogram_segment_routed {name} late "
                                 "split", lambda ids: call(ids)[1], lid,
                                 runs[0][1], want_lid, reps))
        log(f"histogram_segment_routed {name} late split: {shape}, ids "
            f"identical, counts exact, max |diff| {err:.3g}; "
            f"{rec['ms']:.4f} ms eager, {rec['graph_ms']:.4f} ms in a graph")
        out[name] = rec
    del runs, steps, lid
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 4
def unfused_phase():
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import kernels

    X, y = higgs_like(UNFUSED_ROWS, 7)
    ds = lt.Dataset(X, y)
    models = {}
    launches = None
    loop = None
    for fused in (False, True):
        bst = lt.Booster(TRAIN_PARAMS, ds, fused_route=fused)
        kernels.reset_launches()
        t0 = time.perf_counter()
        with record_trees() as rec:
            for _ in range(2):
                bst.update()
            torch.cuda.synchronize()
        if not fused:
            launches = dict(kernels.LAUNCHES)
            trees = bst.gbdt.models
            log(f"unfused: leaves per tree {[t.num_leaves for t in trees]}, "
                f"per iteration {[round(s, 3) for s in bst.gbdt.iter_seconds]}"
                f" s, launches {launches}")
            require(len(trees) == 2, "unfused training stopped early")
            require(launches["histogram_segment"] == len(trees),
                    "unfused path: histogram_segment must launch once a "
                    "tree root")
            loop = device_loop_report("HIGGS 1M unfused", bst, rec.stats,
                                      launches, "histogram_segment_step",
                                      time.perf_counter() - t0)
            require(launches["route_window_step"]
                    == launches["histogram_segment_step"],
                    "unfused path: route_window_step must launch once a "
                    "step")
            require(launches["histogram_segment_routed"]
                    == launches["histogram_segment_routed_step"]
                    == launches["route_window"] == 0,
                    "unfused path launched the fused kernel")
        models[fused] = bst.model_to_string()
    require(models[False] == models[True],
            "fused and unfused paths grew different models")
    log("unfused: same model text as the fused path")
    return launches, ds, loop


# ---------------------------------------------------------------- phase 5
def parity_phase():
    import numpy as np
    import lightgbm_tpu_torch as lt

    X, y = higgs_like(PARITY_ROWS, 11)
    params = dict(TRAIN_PARAMS, num_leaves=31, metric=[])
    out = {}
    for dev in ("cuda", "cpu"):
        bst = lt.Booster(dict(params, device_type=dev), lt.Dataset(X, y))
        for _ in range(3):
            bst.update()
        out[dev] = bst
    compared = 0
    for i, (a, b) in enumerate(zip(out["cuda"].gbdt.models,
                                   out["cpu"].gbdt.models)):
        nf = min(a.num_leaves, b.num_leaves) - 1
        k = 0
        while k < nf and a.split_gain[k] > 1e-2 and b.split_gain[k] > 1e-2:
            k += 1
        require(np.array_equal(a.split_feature[:k], b.split_feature[:k])
                and np.array_equal(a.threshold_in_bin[:k],
                                   b.threshold_in_bin[:k]),
                f"tree {i}: card and CPU split differently")
        compared += k
    require(compared >= 60, f"only {compared} splits compared")
    diff = float(np.abs(out["cuda"].predict(X, raw_score=True)
                        - out["cpu"].predict(X, raw_score=True)).max())
    require(diff < 1e-3, f"card and CPU raw predictions differ by {diff}")
    same = (out["cuda"].model_to_string() == out["cpu"].model_to_string())
    log(f"parity: {compared} splits identical, max |raw diff| {diff:.3g}, "
        f"model text identical: {same}")
    return out["cuda"].model_to_string().split("parameters:")[0]


# ---------------------------------------------------------------- phase 6
def mc_kernel_phase(handle, config, device):
    """K5 at the multiclass_cat shape against its plain version and the K1
    roots of its classes; K1 and K3 at 256 bins, K3 with the categorical
    route of a real best_split.  Returns {name: measurement dict}."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.models.gbdt import block_rows, build_feature_meta
    from lightgbm_tpu_torch.objective import create_objective
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import score as ts
    from lightgbm_tpu_torch.ops.split import (FeatureMeta, SplitParams,
                                              best_split)

    n = handle.num_data
    rb = block_rows(config, n)
    binsT = handle.device_bins(rb, device)
    F, npad = binsT.shape
    nblk = npad // rb
    B = 1 << max(0, (handle.max_num_bin - 1).bit_length())
    C = MC_CLASSES
    require(B == 256, f"multiclass_cat gives {B} bins, expected 256")
    log(f"mc kernels: F={F} B={B} C={C} Npad={npad} rb={rb}")
    # the first iteration's gradients, from the boost-from-average scores
    obj = create_objective(config)
    obj.init(handle.metadata, n, device)
    score0 = torch.tensor([obj.boost_from_score(k) for k in range(C)],
                          dtype=torch.float32, device=device)[:, None]
    grad, hess = obj.get_gradients(score0.expand(C, n).contiguous())
    grad = torch.nn.functional.pad(grad, (0, npad - n))
    hess = torch.nn.functional.pad(hess, (0, npad - n))
    member = torch.zeros(npad, dtype=torch.float32, device=device)
    member[:n] = 1.0
    w8C = th.pack_channel_sets(grad, hess, member)
    err5, scales = check_histogram_all(th, binsT, w8C, B, rb,
                                       "multiclass_cat")

    # a categorical split of class 0's root: best_split over the root
    # histogram with the numeric features' histograms emptied
    fmeta = build_feature_meta(handle, device)
    root = th.histogram_all(binsT, w8C, B, scales)[0]
    cat_only = root * fmeta.is_cat[:, None, None].to(root.dtype)
    info = best_split(cat_only[None], grad[0].sum()[None],
                      hess[0].sum()[None], member.sum()[None], fmeta,
                      SplitParams(has_cat=True))
    require(bool(info.is_cat[0].item()), "no categorical split at the root")
    f_cat = int(info.feature[0].item())
    bitset = info.cat_bitset[0].cpu().numpy().astype(np.uint32)
    fm = FeatureMeta(*(t.cpu().numpy() for t in fmeta[:3]))
    routes = {
        "categorical": th.pack_route(0, 1, f_cat, int(info.threshold[0]),
                                     False, True, bitset, fm),
        "numeric": th.pack_route(0, 1, 0, int(fm.num_bin[0]) // 2, False,
                                 False, np.zeros(8, np.uint32), fm),
    }
    log(f"mc kernels: categorical split of feature {f_cat}, bitset "
        f"{[hex(int(w)) for w in bitset]}")
    w8 = w8C[:8]
    lid0 = torch.zeros(npad, dtype=torch.int32, device=device)
    want = th.histogram_segment_plain(binsT, w8, lid0, 0, nblk, 0, B, rb)
    a = th.histogram_segment(binsT, w8, lid0, 0, nblk, 0, B, rb, scales[0])
    b = th.histogram_segment(binsT, w8, lid0, 0, nblk, 0, B, rb, scales[0])
    torch.cuda.synchronize()
    require(torch.equal(a, b), "histogram_segment 256 bins: a second launch "
            "differs")
    err1 = check_hist("histogram_segment 256 bins", a, want, hist_abs_sums(
        th, binsT, w8, lid0, 0, nblk, 0, B, rb))
    err3 = 0.0
    for rname, route in routes.items():
        want_lid, want = th.histogram_segment_routed_plain(
            binsT, w8, lid0.clone(), 0, nblk, 1, route, B, rb)
        runs = [th.histogram_segment_routed(binsT, w8, lid0.clone(), 0, nblk,
                                            1, route, B, rb, scales[0])
                for _ in range(2)]
        torch.cuda.synchronize()
        require(torch.equal(runs[0][1], runs[1][1]),
                f"histogram_segment_routed 256 bins {rname}: a second "
                "launch differs")
        for got_lid, _ in runs:
            require(torch.equal(got_lid, want_lid),
                    f"histogram_segment_routed 256 bins {rname}: leaf ids "
                    "differ from the plain version")
        moved = int((want_lid == 1).sum().item())
        require(0 < moved < n, f"the {rname} route moved {moved} rows")
        err3 = max(err3, check_hist(
            f"histogram_segment_routed 256 bins {rname}", runs[0][1], want,
            hist_abs_sums(th, binsT, w8, want_lid, 0, nblk, 1, B, rb)))
        log(f"histogram_segment_routed 256 bins {rname}: ids identical, "
            f"{moved} rows routed, counts exact, max |diff| {err3:.3g}")

    # K4 as the multiclass loop calls it: in place into one row (not the
    # first) of the [C, N] train score, with a 31-leaf table
    L = MC_PARAMS["num_leaves"]
    rng = np.random.RandomState(4)
    score_cn = torch.from_numpy(
        rng.normal(size=(C, n)).astype(np.float32)).to(device)
    lid_score = torch.from_numpy(
        rng.randint(0, L, size=n).astype(np.int32)).to(device)
    table = torch.from_numpy(rng.normal(size=L).astype(np.float32)).to(device)
    k = C - 1
    want = ts.score_gather_add_plain(score_cn[k], lid_score, table)
    runs = []
    for _ in range(2):
        s = score_cn.clone()
        row = s[k]
        ret = ts.score_gather_add(row, lid_score, table, out=row)
        require(ret.data_ptr() == row.data_ptr(),
                "score_gather_add: out= was not written in place")
        runs.append(s)
    torch.cuda.synchronize()
    for s in runs:
        require(torch.equal(s[k].view(torch.int32), want.view(torch.int32)),
                f"score_gather_add [{C}, {n}] row: not bit-identical to the "
                "plain version")
        require(torch.equal(s[:k], score_cn[:k]),
                f"score_gather_add [{C}, {n}] row: other rows changed")
    err4 = float((runs[0][k] - want).abs().max().item())
    log(f"score_gather_add [{C}, {n}] row {k}, {L} leaves: bit-identical, "
        "other rows unchanged")

    reps, plain_reps = 20, 3
    W = npad
    out_bytes = F * B * 3 * 4
    t = {"max_abs_err": err5}
    t["ms"] = time_ms(lambda i: th.histogram_all(binsT, w8C, B, scales),
                      reps)
    t["plain_ms"] = time_ms(lambda i: th.histogram_all_plain(
        binsT, w8C, B), plain_reps)
    # one pass over all sets: the bins once, five bf16 channels a set
    t["bound_ms"], t["bound_by"] = bound_ms(W * (F + 10 * C)
                                            + C * out_bytes, W * F * C * 3)
    t["library_ms"] = library_hist_ms(
        binsT, [w8C[8 * c:8 * c + 8] for c in range(C)],
        torch.arange(n, device=device), B, reps)
    t["shape"] = f"{W} rows x {F} features x {C} sets, {B} bins"
    t["tiling"] = th.all_tiling(F, B, C)
    want = th.histogram_all(binsT, w8C, B, scales)
    t.update(launch_report("histogram_all multiclass_cat", lambda ids: (
        th.histogram_all(binsT, w8C, B, scales)), lid0, want, lid0, reps))
    ids = [lid0.clone() for _ in range(reps + 1)]
    k3_ms = time_ms(lambda i: th.histogram_segment_routed(
        binsT, w8, ids[i], 0, nblk, 1, routes["categorical"], B, rb,
        scales[0]), reps)
    k1_ms = time_ms(lambda i: th.histogram_segment(
        binsT, w8, lid0, 0, nblk, 0, B, rb, scales[0]), reps)
    k1_lib = library_hist_ms(binsT, [w8], torch.arange(n, device=device), B,
                             reps)
    cat_lid, _ = th.histogram_segment_routed_plain(
        binsT, w8, lid0.clone(), 0, nblk, 1, routes["categorical"], B, rb)
    k3_lib = library_hist_ms(binsT, [w8], torch.nonzero(cat_lid == 1)[:, 0],
                             B, reps)
    # bytes as in phase 2: the root reads every row; the split reads ids
    # and split bins of every row, writes the moved ids, and reads bins
    # and weights of the target's rows
    moved = int((cat_lid == 1).sum().item())
    k1_bound = bound_ms(W * 4 + W * (F + 10) + out_bytes, W * F * 3)
    k3_bound = bound_ms(W * 5 + moved * 4 + moved * (F - 1 + 10) + out_bytes,
                        W * 20 + moved * F * 3)
    k1_report = launch_report(
        "histogram_segment 256 bins root", lambda ids: th.histogram_segment(
            binsT, w8, ids, 0, nblk, 0, B, rb, scales[0]), lid0, a, lid0,
        reps)
    k3_want = th.histogram_segment_routed(binsT, w8, lid0.clone(), 0, nblk, 1,
                                          routes["categorical"], B, rb,
                                          scales[0])[1]
    k3_report = launch_report(
        "histogram_segment_routed 256 bins categorical",
        lambda ids: th.histogram_segment_routed(
            binsT, w8, ids, 0, nblk, 1, routes["categorical"], B, rb,
            scales[0])[1], lid0, k3_want, cat_lid, reps)
    del cat_lid
    row = runs[0][k]
    k4 = {"mc_max_abs_err": err4}
    k4["mc_ms"] = time_ms(lambda i: ts.score_gather_add(
        row, lid_score, table, out=row), reps)
    k4["mc_plain_ms"] = time_ms(lambda i: ts.score_gather_add_plain(
        row, lid_score, table, out=row), reps)
    k4["mc_library_ms"] = time_ms(lambda i: torch.add(
        row, table[lid_score], out=row), reps)
    k4["mc_bound_ms"], k4["mc_bound_by"] = bound_ms(n * 12 + L * 4, n)
    k4["mc_shape"] = f"row {k} of a [{C}, {n}] score in place, {L} leaves"
    return {"histogram_all": t, "score_gather_add": k4,
            "histogram_segment": {"b256_ms": k1_ms, "b256_max_abs_err": err1,
                                  "b256_library_ms": k1_lib,
                                  "b256_tiling": th.segment_tiling(F, B),
                                  "b256_bound_ms": k1_bound[0],
                                  **{"b256_" + k: v
                                     for k, v in k1_report.items()}},
            "histogram_segment_routed": {"b256_cat_ms": k3_ms,
                                         "b256_max_abs_err": err3,
                                         "b256_cat_library_ms": k3_lib,
                                         "b256_cat_bound_ms": k3_bound[0],
                                         **{"b256_cat_" + k: v
                                            for k, v in k3_report.items()}}}


# ---------------------------------------------------------------- phase 7
def mc_train_phase(ds, Xh, yh):
    """The multiclass path: lightgbm_tpu_torch.train, 5-class softmax with
    categorical features, fused route."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import kernels

    C = MC_CLASSES
    valid = ds.create_valid(Xh, yh)
    evals = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    with record_trees() as rec:
        bst = lt.train(MC_PARAMS, ds, MC_ITERS, valid_sets=[valid],
                       valid_names=["holdout"], evals_result=evals)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    trees = bst.gbdt.models
    ll = evals["holdout"]["multi_logloss"]
    it_s = bst.gbdt.iter_seconds
    log(f"mc train: {len(trees)} trees in {wall:.2f} s, per iteration "
        f"{[round(x, 3) for x in it_s]} s")
    log(f"mc train: holdout multi_logloss {[round(x, 5) for x in ll]}")
    log(f"mc train: launches {launches}")
    require(len(trees) == MC_ITERS * C, f"{len(trees)} trees, expected "
            f"{MC_ITERS * C}")
    require(all(t.num_leaves > 1 for t in trees), "a class tree did not split")
    splits = sum(t.num_leaves - 1 for t in trees)
    require(launches["histogram_all"] == MC_ITERS,
            f"histogram_all launched {launches['histogram_all']} times, "
            f"expected once per iteration ({MC_ITERS})")
    require(launches["histogram_segment_routed"] == 0,
            "the class roots must come from K5, not histogram_segment_routed")
    loop = device_loop_report("multiclass_cat", bst, rec.stats, launches,
                              "histogram_segment_routed_step", wall)
    require(launches["score_gather_add"] == MC_ITERS * C,
            "score_gather_add did not run once per class tree")
    require(launches["histogram_segment"] == launches["route_window"]
            == launches["histogram_segment_step"]
            == launches["route_window_step"] == 0,
            "the fused path launched the unfused kernels")
    require(ll[-1] < MC_LOGLOSS_GATE, f"held-out multi_logloss {ll[-1]} is "
            f"not under {MC_LOGLOSS_GATE}")
    raw = bst.predict(Xh, raw_score=True)
    prob = bst.predict(Xh)
    require(raw.shape == (len(Xh), C) and prob.shape == (len(Xh), C)
            and np.all(np.isfinite(prob)), "held-out predictions are not "
            "finite [N, C] arrays")
    vdiff = float(np.abs(raw.T - bst.gbdt.valid_scores[0]).max())
    require(vdiff <= 1e-9, f"Booster.predict differs from the in-training "
            f"valid scores by {vdiff}")
    hll = float(-np.mean(np.log(np.clip(
        prob[np.arange(len(yh)), yh.astype(int)], 1e-15, 1.0))))
    require(abs(hll - ll[-1]) < 1e-9, f"held-out multi_logloss from "
            f"Booster.predict {hll} differs from the valid metric {ll[-1]}")
    n_cat = sum(t.num_cat for t in trees)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.txt")
        bst.save_model(path)
        with open(path) as fh:
            text = fh.read()
    require(f"num_class={C}" in text and "cat_threshold=" in text
            and f"Tree={MC_ITERS * C - 1}" in text, "saved model text lacks "
            "num_class, categorical nodes or trees")
    log(f"mc train: {splits} splits, {n_cat} categorical, holdout predict "
        f"ok (multi_logloss {hll:.5f}, |raw - valid score| {vdiff:.3g}), "
        f"model text {len(text)} bytes")
    # P1 over the training bins with the 125 trees, classes interleaved
    p1 = route_kernel_phase(bst, "multiclass_cat training bins")
    return launches, {"wall_s": wall, "iter_s": it_s,
                      "holdout_multi_logloss": ll, "splits": splits,
                      "categorical_splits": n_cat, "device_loop": loop,
                      "p1": p1}


# ---------------------------------------------------------------- phase 8
def mc_parity_phase():
    import numpy as np
    import lightgbm_tpu_torch as lt

    X, y = multiclass_cat(PARITY_ROWS, 11)
    ds = lt.Dataset(X, y, categorical_feature=MC_CAT)
    params = dict(MC_PARAMS, metric=[])
    out = {}
    for dev in ("cuda", "cpu"):
        bst = lt.Booster(dict(params, device_type=dev), ds)
        t0 = time.perf_counter()
        for _ in range(3):
            bst.update()
        log(f"mc parity: {dev} 3 iterations in "
            f"{time.perf_counter() - t0:.1f} s")
        out[dev] = bst
    compared = cats = 0
    for i, (a, b) in enumerate(zip(out["cuda"].gbdt.models,
                                   out["cpu"].gbdt.models)):
        nf = min(a.num_leaves, b.num_leaves) - 1
        k = 0
        while k < nf and a.split_gain[k] > 1e-2 and b.split_gain[k] > 1e-2:
            k += 1
        same = (np.array_equal(a.split_feature[:k], b.split_feature[:k])
                and np.array_equal(a.threshold_in_bin[:k],
                                   b.threshold_in_bin[:k])
                and np.array_equal(a.decision_type[:k] & 1,
                                   b.decision_type[:k] & 1))
        for j in range(k):
            if same and a.decision_type[j] & 1:
                c = int(a.threshold_in_bin[j])
                same = np.array_equal(a.cat_threshold_inner[c],
                                      b.cat_threshold_inner[c])
                cats += 1
        require(same, f"tree {i}: card and CPU split differently")
        compared += k
    require(compared >= 60 and cats > 0, f"only {compared} splits ({cats} "
            "categorical) compared")
    diff = float(np.abs(out["cuda"].predict(X, raw_score=True)
                        - out["cpu"].predict(X, raw_score=True)).max())
    require(diff < 1e-3, f"card and CPU raw predictions differ by {diff}")
    log(f"mc parity: {compared} splits identical ({cats} categorical), "
        f"max |raw diff| {diff:.3g}")


# ---------------------------------------------------------------- phase 9
def leaf_layout(th, binsT, fm, rb, levels, packed4=False):
    """2^levels leaves of the rows, each a split of every leaf on feature
    (level) at its middle bin, then the rows sorted by leaf as compaction
    leaves them.  Returns (perm, leaf_id, lo, hi) in the sorted order, lo
    and hi each leaf's window in blocks."""
    import numpy as np
    import torch
    npad = binsT.shape[1]
    F = min(th.logical_columns(binsT, packed4), len(fm.num_bin))
    lid = torch.zeros(npad, dtype=torch.int32, device=binsT.device)
    none = np.zeros(8, np.uint32)
    for lvl in range(levels):
        f = lvl % F
        for leaf in range(1 << lvl):
            route = th.pack_route(leaf, leaf + (1 << lvl), f,
                                  int(fm.num_bin[f]) // 2, False, False,
                                  none, fm, packed4)
            th.route_window(binsT, lid, 0, npad // rb, route, rb, packed4)
    lid, perm = torch.sort(lid, stable=True)
    leaves = torch.arange(1 << levels, dtype=lid.dtype, device=lid.device)
    starts = torch.searchsorted(lid, leaves).tolist()
    ends = torch.searchsorted(lid, leaves, side="right").tolist()
    lo = [a // rb for a in starts]
    hi = [-(-b // rb) for b in ends]
    return perm, lid, lo, hi


def frontier_round(th, binsT, w8, scales, fm, feats, rb, K, levels, B, tag,
                   reps, plain_reps, timed=True, thr=None, packed4=False):
    """One frontier round at this shape: leaves 0..K-1 of a 2^levels-leaf
    layout split into new leaves 2^levels + k, leaf k on feature
    feats[k % len(feats)] = (f, categorical): a numeric split at its middle
    bin (or at ``thr(f)``), or a categorical one by a bitset of every
    other bin.  K6 on the
    routed ids (targets: the smaller children), K7 routed (the same
    targets) and K7 fused-K (parents then new leaves) against their plain
    versions.  ``packed4``: the bins hold two columns a byte; each kernel
    is also held against, and timed beside, the same kernel on the
    unpacked bins (``unpacked_ms``), bit for bit over the G real columns.
    Returns {kernel: measurement dict}."""
    import numpy as np
    import torch
    rows_b, npad = binsT.shape
    F = th.logical_columns(binsT, packed4)
    perm, lid, lo, hi = leaf_layout(th, binsT, fm, rb, levels, packed4)
    binsT = binsT.index_select(1, perm)
    w8 = w8.index_select(1, perm)
    # the unpacked bins, for the comparison and the library call only
    G = len(fm.num_bin) if fm.feat_group is None else int(
        max(fm.feat_group)) + 1
    flat = (th.unpack_bins_4bit(binsT)[:G].contiguous() if packed4
            else binsT)
    n_leaves = 1 << levels
    every_other = np.full(8, 0x55555555, np.uint32)
    routes, flat_routes, new = [], [], []
    for k in range(K):
        f, cat = feats[k % len(feats)]
        t = int(fm.num_bin[f]) // 2 if thr is None else thr(f)
        for out, p4 in ((routes, packed4), (flat_routes, False)):
            out.append(th.pack_route(k, n_leaves + k, f, t, k % 2 == 1,
                                     cat, every_other * cat, fm, p4))
        new.append(n_leaves + k)
    routes = torch.stack(routes)
    flat_routes = torch.stack(flat_routes)
    bl, n = th.union_block_list(lo[:K], hi[:K], [True] * K)
    bl = bl.to(binsT.device)
    routed_lid, _ = th.histogram_frontier_routed_plain(
        binsT, w8, lid.clone(), bl, n, torch.tensor(new, dtype=torch.int32),
        routes, B, rb, packed4)
    counts = torch.bincount(routed_lid.long(), minlength=n_leaves + K)
    smaller = torch.tensor(
        [k if counts[k] <= counts[n_leaves + k] else n_leaves + k
         for k in range(K)], dtype=torch.int32)
    targets2 = torch.tensor(list(range(K)) + new, dtype=torch.int32)
    U = n * rb
    out = {}
    cases = (("histogram_frontier", smaller, None),
             ("histogram_frontier_routed", smaller, routes),
             ("histogram_frontier_fusedk", targets2, routes))
    def call(name, bins, ids, targets, rts, p4):
        """The kernel ``name`` on these bins: (leaf ids, histograms)."""
        if rts is None:
            return ids, th.histogram_frontier(bins, w8, ids, bl, n, targets,
                                              B, rb, scales, p4)
        return getattr(th, name)(bins, w8, ids, bl, n, targets, rts, B, rb,
                                 scales, p4)

    for name, targets, rts in cases:
        KT = int(targets.shape[0])
        frts = None if rts is None else flat_routes
        if rts is None:
            want_lid = routed_lid
            want = th.histogram_frontier_plain(binsT, w8, routed_lid, bl, n,
                                               targets, B, rb, packed4)
        else:
            want_lid, want = th.histogram_frontier_routed_plain(
                binsT, w8, lid.clone(), bl, n, targets, rts, B, rb, packed4)
        runs = []
        start = routed_lid if rts is None else lid
        for _ in range(2):
            ids = start.clone() if rts is not None else start
            got_lid, got = call(name, binsT, ids, targets, rts, packed4)
            require(got_lid.data_ptr() == ids.data_ptr(),
                    f"{name}: leaf_id not updated in place")
            runs.append((got_lid, got))
        torch.cuda.synchronize()
        for got_lid, _ in runs:
            require(torch.equal(got_lid, want_lid), f"{name} {tag}: leaf ids "
                    "differ from the plain version")
        require(torch.equal(runs[0][1], runs[1][1]),
                f"{name} {tag}: a second launch differs from the first")
        if packed4:
            flat_lid, flat_hist = call(name, flat, start.clone(), targets,
                                       frts, False)
            torch.cuda.synchronize()
            require(torch.equal(flat_lid, want_lid)
                    and torch.equal(runs[0][1][:, :G], flat_hist),
                    f"{name} {tag}: packed differs from unpacked")
        abs_sums = th.histogram_frontier_plain(
            binsT, abs_channel_sets(w8), want_lid, bl, n, targets, B, rb,
            packed4)
        err = check_hist(f"{name} {tag}", runs[0][1], want, abs_sums)
        # slot j is K1 of its target over the window of the parent it came
        # from (split k = j mod K), bit for bit
        for j, t in enumerate(targets.tolist()):
            k = j % K
            k1 = th.histogram_segment(binsT, w8, want_lid, lo[k],
                                      hi[k] - lo[k], t, B, rb, scales,
                                      packed4)
            require(torch.equal(runs[0][1][j], k1), f"{name} {tag}: slot {j} "
                    f"differs from K1 of leaf {t}")
        tiling = th.frontier_tiling(F, B, KT, 0 if rts is None else K,
                                    int(th.frontier_params(targets, rts)[2]),
                                    packed4)
        moved = int((want_lid != lid).sum().item())
        log(f"{name} {tag}: K={K} KT={KT}, {n} blocks ({U} rows) listed, "
            f"{moved} routed, ids identical, counts exact, max |diff| "
            f"{err:.3g}, every slot = K1 of its leaf, tiling {tiling}")
        rec = {"max_abs_err": err, "tiling": tiling, "K": K, "KT": KT}
        if timed:
            # bytes: every listed row's leaf id, the split bin of each row a
            # route matches and the id of each row it moves, bins and five
            # weight channels of each row a target matches, the output
            sel = torch.isin(want_lid[_rows(bl, n, rb)],
                             targets.to(lid.device))
            M = int(sel.sum().item())
            R = 0 if rts is None else int(torch.isin(
                lid[_rows(bl, n, rb)], torch.arange(K, device=lid.device,
                                                    dtype=lid.dtype)
            ).sum().item())
            # (a byte of bins a row: rows_b bytes, F columns)
            nbytes = (U * 4 + 4 * n + R + moved * 4 * (rts is not None)
                      + M * (rows_b + 10) + KT * F * B * 12)
            nops = U * (KT + (0 if rts is None else K)) + R * 20 + M * F * 3
            rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, nops)
            ids = [start.clone() for _ in range(reps + 1)]
            rec["ms"] = time_ms(lambda i: call(
                name, binsT, ids[i], targets, rts, packed4), reps)
            if packed4:
                rec["unpacked_ms"] = time_ms(lambda i: call(
                    name, flat, ids[i], targets, frts, False), reps)
            ids = [start.clone() for _ in range(plain_reps + 1)]
            if rts is None:
                rec["plain_ms"] = time_ms(
                    lambda i: th.histogram_frontier_plain(
                        binsT, w8, ids[i], bl, n, targets, B, rb, packed4),
                    plain_reps)
            else:
                rec["plain_ms"] = time_ms(
                    lambda i: th.histogram_frontier_routed_plain(
                        binsT, w8, ids[i], bl, n, targets, rts, B, rb,
                        packed4),
                    plain_reps)
            del ids
            rows = _rows(bl, n, rb)[sel]
            slot_of = torch.full((n_leaves + K,), -1, dtype=torch.int64,
                                 device=lid.device)
            slot_of[targets.long().to(lid.device)] = torch.arange(
                KT, device=lid.device)
            rec["library_ms"] = library_hist_ms(
                flat, [w8], rows, B, reps,
                slots=slot_of[want_lid[rows].long()], n_slots=KT)
            rec["shape"] = (f"{tag}: {U} listed rows of {npad}, {M} in the "
                            f"{KT} targets, {moved} routed, {F} x {B} bins"
                            + (f" in {rows_b} bytes a row" if packed4
                               else ""))
            # one call is one launch: what the profiler sees on the card,
            # and a CUDA graph's capture and replay (a stream sync or a
            # pageable copy in the call would fail the capture)
            rec.update(launch_report(
                f"{name} {tag}",
                lambda ids: call(name, binsT, ids, targets, rts, packed4)[1],
                start, runs[0][1], want_lid, reps))
            log(f"{name} {tag}: {rec['ms']:.4f} ms a call eager")
        out[name] = rec
    torch.cuda.empty_cache()
    return out


def launch_report(tag, call, start, want, want_ids, reps):
    """One call is one launch: the device operations torch.profiler sees
    for ``call(ids)`` on a copy of ``start``, a CUDA graph's capture and
    replay (a stream sync or a pageable copy in the call would fail the
    capture; the replay must give ``want`` and leave ``want_ids``), and
    its device time in a replayed graph and host time a call.  Returns
    {device_ops_per_call, graph_ms, host_us}."""
    import torch
    fresh = iter([start.clone() for _ in range(2)])
    rec = {"device_ops_per_call": device_ops_per_call(
        lambda: call(next(fresh)))}
    rec["graph_ms"], rec["host_us"] = graph_and_host_times(call, start, reps)
    ids = start.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = call(ids)
    ids.copy_(start)
    graph.replay()
    torch.cuda.synchronize()
    require(torch.equal(replayed, want) and torch.equal(ids, want_ids),
            f"{tag}: a CUDA graph's replay differs from the eager call")
    del graph, replayed, ids
    ops = rec["device_ops_per_call"]
    require(ops is None or (ops["kernel"] == 1 and ops["memcpy"] == 0
                            and ops["memset"] == 0),
            f"{tag}: a call put {ops} on the stream, not one kernel")
    log(f"{tag}: device ops a call {ops}, CUDA graph replay identical; "
        f"{rec['graph_ms']:.4f} ms in a graph, {rec['host_us']:.1f} us of "
        "host a call")
    return rec


def device_ops_per_call(fn):
    """The device operations one call of ``fn`` puts on the stream, by
    kind, from torch.profiler (after a warm-up call); None where the
    profiler records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = {"kernel": 0, "memcpy": 0, "memset": 0}
    names = []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        low = evt.name.lower()
        kind = ("memcpy" if low.startswith("memcpy") else
                "memset" if low.startswith("memset") else "kernel")
        kinds[kind] += 1
        names.append(evt.name[:60])
    if not names:
        return None
    kinds["names"] = names
    return kinds


def graph_and_host_times(call, start, reps):
    """(ms, us): the device time of one ``call(ids)`` when ``reps`` calls,
    each on its own copy of ``start``, run as one replayed CUDA graph (no
    host between them), and the host's time to enqueue one eager call."""
    import torch
    ids = [start.clone() for _ in range(reps)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for x in ids:
            call(x)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    for timed in (False, True):
        for x in ids:
            x.copy_(start)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
    device_ms = a.elapsed_time(b) / reps
    del graph
    for x in ids:
        x.copy_(start)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in ids:
        call(x)
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return device_ms, host_us


def _rows(bl, n, rb):
    import torch
    blk = bl[:n].long()
    return (blk[:, None] * rb + torch.arange(rb, device=bl.device)).reshape(-1)


def frontier_kernel_phase(handle, config, device, tag, rounds):
    """K6 and K7 against their plain versions in frontier rounds of
    ``rounds`` ((K, layout levels, timed), ...) on the dataset's rows.
    Returns {kernel name: measurement dict} of the timed rounds, and the
    checked-only rounds under "<name>_k<K>"."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.models.gbdt import block_rows
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops.split import FeatureMeta

    n = handle.num_data
    rb = block_rows(config, n)
    binsT = handle.device_bins(rb, device)
    F, npad = binsT.shape
    B = 1 << max(0, (handle.max_num_bin - 1).bit_length())
    infos = handle.feature_infos()
    fm = FeatureMeta(*(np.array([getattr(i, k) for i in infos], np.int32)
                       for k in ("num_bin", "missing_type", "default_bin")))
    # the round's split features: categorical ones first where there are
    # any, numeric ones after the layout's
    cats = [(f, True) for f, i in enumerate(infos) if i.is_cat]
    nums = [(f, False) for f, i in enumerate(infos) if not i.is_cat][5:]
    feats = [x for pair in zip(cats, nums) for x in pair] or nums
    gen = torch.Generator(device=device).manual_seed(9)
    grad = torch.randn(npad, generator=gen, device=device)
    hess = torch.rand(npad, generator=gen, device=device) * 0.25
    member = torch.zeros(npad, device=device)
    member[:n] = 1.0
    w8 = th.pack_channels(grad, hess, member)
    del grad, hess
    scales = th.fixed_point_scales(w8)
    log(f"frontier kernels {tag}: F={F} B={B} Npad={npad} rb={rb}")
    out = {}
    for K, levels, timed in rounds:
        res = frontier_round(th, binsT, w8, scales, fm, feats, rb, K, levels,
                             B, f"{tag} K={K}", 20, 3, timed=timed)
        for name, rec in res.items():
            out[name if timed else f"{name}_k{K}"] = rec
    del binsT, w8
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 10
def count_rounds(bst):
    """Wraps the booster's frontier grower to sum its rounds over trees."""
    g = bst.gbdt.grower
    grow, total = g.grow, {"rounds": 0, "trees": 0}

    def counted(*a, **k):
        res = grow(*a, **k)
        total["rounds"] += g.last_stats["rounds"]
        total["trees"] += 1
        return res

    g.grow = counted
    return total


def frontier_train_phase(ds, Xh, yh, seg_stats):
    """The HIGGS rows through the frontier grower, default tier."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.metric import AUCMetric
    from lightgbm_tpu_torch.ops import kernels

    bst = lt.Booster(FRONTIER_PARAMS, ds)
    bst.add_valid(ds.create_valid(Xh, yh), "holdout")
    g = bst.gbdt.grower
    require(g.K == 16 and g.tier == "off", f"frontier K={g.K} tier="
            f"{g.tier}, expected 16 and off")
    total = count_rounds(bst)
    auc = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(3):
        bst.update()
        auc.append(bst.eval_train()[0][2])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    trees = bst.gbdt.models
    splits = sum(t.num_leaves - 1 for t in trees)
    it_s = bst.gbdt.iter_seconds
    hauc = bst.eval_valid()[0][2]
    log(f"frontier train: {len(trees)} iterations in {wall:.2f} s, per "
        f"iteration {[round(x, 3) for x in it_s]} s (segment "
        f"{[round(x, 3) for x in seg_stats['iter_s']]}), "
        f"{total['rounds']} rounds for {splits} splits")
    log(f"frontier train: leaves per tree {[t.num_leaves for t in trees]}, "
        f"train AUC {auc}, holdout AUC {hauc} (segment "
        f"{seg_stats['holdout_auc']})")
    log(f"frontier train: launches {launches}")
    require(len(trees) == 3 and all(t.num_leaves == 255 for t in trees),
            "frontier training stopped early or grew short trees")
    require(all(b > a for a, b in zip(auc, auc[1:])),
            "train AUC did not rise every iteration")
    require(abs(hauc - seg_stats["holdout_auc"]) <= 0.005,
            f"held-out AUC {hauc} is not within 0.005 of the segment run's "
            f"{seg_stats['holdout_auc']}")
    require(launches["histogram_frontier"] == total["rounds"] + 3,
            f"histogram_frontier launched {launches['histogram_frontier']} "
            f"times, expected once a round and a root "
            f"({total['rounds']} + 3)")
    require(launches["route_window"] == splits,
            f"route_window launched {launches['route_window']} times, "
            f"expected once a split ({splits})")
    require(launches["histogram_segment"] == 0
            and launches["histogram_segment_routed"] == 0
            and launches["histogram_frontier_routed"] == 0
            and launches["histogram_frontier_fusedk"] == 0,
            "the default frontier tier launched another histogram kernel")
    require(launches["score_gather_add"] == 3,
            "score_gather_add did not run once per iteration")
    raw = bst.predict(Xh, raw_score=True)
    m = AUCMetric()
    m.label = np.asarray(yh, np.float64)
    require(abs(m.eval(raw) - hauc) < 1e-9 and np.all(np.isfinite(raw)),
            "held-out predictions disagree with the valid metric")
    return launches, {"wall_s": wall, "iter_s": it_s, "train_auc": auc,
                      "holdout_auc": hauc, "rounds": total["rounds"],
                      "splits": splits, "K": g.K, "tier": g.tier,
                      "grower_stats": dict(g.last_stats)}, bst


# -------------------------------------------------------------- phase 10b
def route_late_phase(bst):
    """K2 at the windows the main path gives it: one more iteration of
    phase 10's booster (the frontier grower's tier "off", a K2 call a
    split), recording each call's window and the rows it moved.  The
    bound summed over the iteration's real windows; the last call (a late
    split's window of a few row blocks) replayed from the grower's own
    inputs against the plain version, timed eager, in a CUDA graph and on
    the host.  Returns the measurement dict."""
    import torch
    from lightgbm_tpu_torch.models import grower_frontier
    from lightgbm_tpu_torch.ops import histogram as th

    fn = grower_frontier.route_window
    calls, last = [], {}

    def recorded(binsT, leaf_id, start_block, n_blocks, route, block_rows,
                 packed4=False):
        require(not packed4, "route_window late window: packed bins at "
                "max_bin 63")
        before = leaf_id.clone()
        out = fn(binsT, leaf_id, start_block, n_blocks, route, block_rows)
        calls.append((int(n_blocks) * block_rows,
                      int((leaf_id != before).sum().item())))
        last.update(binsT=binsT, ids=before, args=(
            int(start_block), int(n_blocks), route.clone(), block_rows))
        return out

    grower_frontier.route_window = recorded
    try:
        bst.update()
    finally:
        grower_frontier.route_window = fn
    binsT, lid = last["binsT"], last["ids"]
    lo, nb, route, rb = last["args"]
    want = th.route_window_plain(binsT, lid.clone(), lo, nb, route, rb)
    runs = [th.route_window(binsT, lid.clone(), lo, nb, route, rb)
            for _ in range(2)]
    torch.cuda.synchronize()
    for got in runs:
        require(torch.equal(got, want), "route_window late window: leaf ids "
                "differ from the plain version")
    W = nb * rb
    moved = int((want != lid).sum().item())
    reps = 20
    ids = [lid.clone() for _ in range(reps + 1)]
    rec = {"window_blocks": nb, "window_rows": W, "moved_rows": moved}
    rec["ms"] = time_ms(lambda i: th.route_window(binsT, ids[i], lo, nb,
                                                  route, rb), reps)
    ids = [lid.clone() for _ in range(4)]
    rec["plain_ms"] = time_ms(lambda i: th.route_window_plain(
        binsT, ids[i], lo, nb, route, rb), 3)
    del ids
    rec["bound_ms"], rec["bound_by"] = bound_ms(W * 5 + moved * 4, W * 20)
    rec.update(launch_report("route_window late window", lambda ids: (
        th.route_window(binsT, ids, lo, nb, route, rb)), lid, want, want,
        reps))
    # the bound of the iteration's calls, each at its own window
    rows = sorted(w for w, _ in calls)
    rec["iteration"] = {
        "calls": len(calls),
        "bound_ms": sum(bound_ms(w * 5 + m * 4, w * 20)[0]
                        for w, m in calls),
        "window_rows": {"min": rows[0], "median": rows[len(rows) // 2],
                        "max": rows[-1], "sum": sum(rows)},
        "moved_rows": sum(m for _, m in calls)}
    rec["shape"] = (f"late window: {nb} blocks ({W} rows), {moved} routed")
    log(f"route_window late window: {rec['shape']}, ids identical; "
        f"{rec['ms']:.4f} ms eager; the iteration's {len(calls)} calls "
        f"walked {rec['iteration']['window_rows']} rows, bound summed "
        f"{rec['iteration']['bound_ms']:.3f} ms")
    del last
    torch.cuda.empty_cache()
    return rec


# --------------------------------------------------------------- phase 11
def frontier_tiers_phase(ds):
    """1M rows, 2 iterations on each tier: each launches its kernel."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import kernels

    out, texts, raws = {}, {}, {}
    for tier, kname in FRONTIER_TIER_KERNEL.items():
        bst = lt.Booster(FRONTIER_PARAMS, ds, frontier_tier=tier)
        total = count_rounds(bst)
        kernels.reset_launches()
        for _ in range(2):
            bst.update()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        trees = bst.gbdt.models
        splits = sum(t.num_leaves - 1 for t in trees)
        log(f"frontier tier {tier}: leaves {[t.num_leaves for t in trees]}, "
            f"{total['rounds']} rounds, per iteration "
            f"{[round(x, 3) for x in bst.gbdt.iter_seconds]} s, launches "
            f"{launches}")
        require(len(trees) == 2, f"tier {tier}: training stopped early")
        require(launches[kname] == total["rounds"] + 2,
                f"tier {tier}: {kname} launched {launches[kname]} times, "
                f"expected {total['rounds'] + 2}")
        others = sum(v for k, v in launches.items()
                     if k not in (kname, "route_window", "score_gather_add"))
        require(others == 0, f"tier {tier} launched other histogram kernels")
        require(launches["route_window"] == (splits if tier == "off" else 0),
                f"tier {tier}: route_window launched "
                f"{launches['route_window']} times")
        out[tier] = launches
        texts[tier] = bst.model_to_string().split("parameters:")[0]
        raws[tier] = bst.predict(ds.data[:100_000], raw_score=True)
    require(texts["off"] == texts["k1"], "tiers off and k1 grew different "
            "models")
    diff = float(np.abs(raws["fusedk"] - raws["off"]).max())
    log(f"frontier tiers: k1 grew off's model text; fusedk max |raw diff| "
        f"{diff:.3g} on 100k rows")
    require(diff < 1e-2, f"fusedk and off raw predictions differ by {diff}")
    return out


# --------------------------------------------------------------- phase 12
def frontier_parity_phase(seg_text):
    """Card against CPU at width 4; width 1 on the card against the
    segment grower's model text (phase 5's card run)."""
    import numpy as np
    import lightgbm_tpu_torch as lt

    X, y = higgs_like(PARITY_ROWS, 11)
    params = dict(FRONTIER_PARAMS, num_leaves=31, metric=[],
                  tpu_frontier_width=4)
    out = {}
    for dev in ("cuda", "cpu"):
        bst = lt.Booster(dict(params, device_type=dev), lt.Dataset(X, y))
        for _ in range(3):
            bst.update()
        out[dev] = bst
    compared = 0
    for i, (a, b) in enumerate(zip(out["cuda"].gbdt.models,
                                   out["cpu"].gbdt.models)):
        nf = min(a.num_leaves, b.num_leaves) - 1
        k = 0
        while k < nf and a.split_gain[k] > 1e-2 and b.split_gain[k] > 1e-2:
            k += 1
        require(np.array_equal(a.split_feature[:k], b.split_feature[:k])
                and np.array_equal(a.threshold_in_bin[:k],
                                   b.threshold_in_bin[:k]),
                f"frontier tree {i}: card and CPU split differently")
        compared += k
    require(compared >= 60, f"only {compared} frontier splits compared")
    diff = float(np.abs(out["cuda"].predict(X, raw_score=True)
                        - out["cpu"].predict(X, raw_score=True)).max())
    require(diff < 1e-3, f"frontier card and CPU raw predictions differ by "
            f"{diff}")
    log(f"frontier parity: {compared} splits identical, max |raw diff| "
        f"{diff:.3g}")
    # phase 13
    bst = lt.Booster(dict(params, tpu_frontier_width=1), lt.Dataset(X, y))
    for _ in range(3):
        bst.update()
    require(bst.gbdt.grower.K == 1, "width 1 did not give K = 1")
    require(bst.model_to_string().split("parameters:")[0] == seg_text,
            "tpu_frontier_width=1 on the card grew another model than the "
            "segment grower")
    log("frontier K=1: the segment grower's model text")
    return {"splits_compared": compared, "max_raw_diff": diff}


# ------------------------------------------------------------------ main
# --------------------------------------------------------------- phase 14
def _same_splits(a_trees, b_trees, tag):
    """Card = CPU: the same split feature, bin and categorical bitset at
    gain > 1e-2; returns the splits compared."""
    import numpy as np
    require(len(a_trees) == len(b_trees), f"{tag}: {len(a_trees)} against "
            f"{len(b_trees)} trees")
    compared = 0
    for i, (a, b) in enumerate(zip(a_trees, b_trees)):
        nf = min(a.num_leaves, b.num_leaves) - 1
        k = 0
        while k < nf and a.split_gain[k] > 1e-2 and b.split_gain[k] > 1e-2:
            k += 1
        same = (np.array_equal(a.split_feature[:k], b.split_feature[:k])
                and np.array_equal(a.threshold_in_bin[:k],
                                   b.threshold_in_bin[:k]))
        for j in range(k):
            if same and a.decision_type[j] & 1:
                c = int(a.threshold_in_bin[j])
                same = np.array_equal(a.cat_threshold_inner[c],
                                      b.cat_threshold_inner[c])
        require(same, f"{tag}: tree {i} split differently")
        compared += k
    return compared


def _timed(fn):
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def session_phase(ds, Xh, yh):
    """The session around train at HIGGS scale: early stopping on the
    holdout, save -> load -> predict, init_model continued training,
    rollback, cv.  Returns (launches, stats)."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import kernels

    rec = {"params": {k: SESSION_PARAMS[k] for k in
                      ("learning_rate", "num_leaves", "metric")},
           "max_rounds": SESSION_ROUNDS,
           "early_stopping_rounds": SESSION_STOP}
    valid = ds.create_valid(Xh, yh)
    kernels.reset_launches()
    evals = {}
    bst, wall = _timed(lambda: lt.train(
        SESSION_PARAMS, ds, SESSION_ROUNDS, valid_sets=[valid],
        valid_names=["holdout"], early_stopping_rounds=SESSION_STOP,
        evals_result=evals, verbose_eval=False))
    iters = bst.current_iteration()
    it_s = list(bst.gbdt.iter_seconds)
    curve = evals["holdout"][SESSION_PARAMS["metric"][0]]
    log(f"session: early stopping at lr {SESSION_PARAMS['learning_rate']}: "
        f"best iteration {bst.best_iteration} of {iters} run "
        f"(max {SESSION_ROUNDS}, stop after {SESSION_STOP}) in {wall:.2f} "
        f"s; holdout {SESSION_PARAMS['metric'][0]} "
        f"{[round(x, 6) for x in curve]}")
    require(0 < bst.best_iteration < iters < SESSION_ROUNDS,
            "the early stop did not fire")
    require(iters - bst.best_iteration == SESSION_STOP,
            f"stopped {iters - bst.best_iteration} rounds after the best")
    require(all(np.isfinite(curve)) and min(curve) == curve[
        bst.best_iteration - 1], "the best iteration is not the curve's "
            "minimum")
    # one early-stopping iteration: the wall against the bare iteration
    # (grow + score + the valid walk), and its parts timed alone
    ev_valid, ev_valid_s = _timed(bst.eval_valid)
    _, ev_train_s = _timed(bst.gbdt.eval_train)
    vh = valid._handle
    last = bst.gbdt.models[-1]
    # the valid walk an iteration makes (P1 and its fetch), and the host
    # walk it replaced
    _, walk_s = _timed(lambda: bst.gbdt._card_delta(vh, [last], [0]).cpu())
    _, host_walk_s = _timed(lambda: last.predict_binned(vh.bins_t,
                                                        vh.feature_infos()))
    rec.update(best_iteration=bst.best_iteration, iterations=iters,
               wall_s=wall, iter_s=it_s, curve=curve,
               es_iteration_wall_s=wall / iters,
               iter_s_median=float(np.median(it_s)),
               eval_valid_s=ev_valid_s, eval_train_s=ev_train_s,
               valid_walk_tree_s=walk_s, valid_host_walk_tree_s=host_walk_s)
    log(f"session: an early-stopping iteration {wall / iters:.4f} s wall "
        f"against iter_seconds median {np.median(it_s):.4f} s; eval_valid "
        f"{ev_valid_s:.4f} s, eval_train {ev_train_s:.4f} s, one tree's "
        f"valid walk ({len(Xh)} rows) {walk_s:.4f} s on the card, "
        f"{host_walk_s:.4f} s on the host")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.txt")
        _, save_s = _timed(lambda: bst.save_model(path))
        loaded, load_s = _timed(lambda: lt.Booster(model_file=path))
    want, pred_s = _timed(lambda: bst.predict(Xh))
    got = loaded.predict(Xh, num_iteration=bst.best_iteration)
    require(np.array_equal(got, want), "the loaded model's holdout "
            "predictions differ from the trained Booster's")
    allraw = loaded.predict(Xh, raw_score=True)
    vdiff = float(np.abs(allraw - bst.gbdt.valid_scores[0]).max())
    require(vdiff <= 1e-9, f"the loaded model differs from the in-training "
            f"valid scores by {vdiff}")
    rec.update(save_s=save_s, load_s=load_s, predict_holdout_s=pred_s)
    log(f"session: save {save_s:.3f} s, load {load_s:.3f} s, holdout "
        f"predict {pred_s:.3f} s: bit for bit")

    cont_evals = {}
    cont, cont_s = _timed(lambda: lt.train(
        SESSION_PARAMS, ds, 5, valid_sets=[valid], valid_names=["holdout"],
        init_model=bst, evals_result=cont_evals, verbose_eval=False))
    require(cont.current_iteration() == iters + 5, "continued training "
            "did not add 5 iterations")
    require(np.array_equal(cont.predict(Xh, raw_score=True,
                                        num_iteration=iters), allraw),
            "the continued model's first trees predict differently")
    seed = cont.gbdt.init_model_seconds
    cc = cont_evals["holdout"][SESSION_PARAMS["metric"][0]]
    require("card_walk" in seed, "init_model's seeding did not walk the "
            "trees on the card")
    rec.update(continue_wall_s=cont_s, seed_card_walk_s=seed["card_walk"],
               seed_device_add_s=seed["device_add"],
               continue_iter_s=list(cont.gbdt.iter_seconds),
               continue_curve=cc)
    log(f"session: init_model + 5 rounds in {cont_s:.2f} s: seeding "
        f"{seed['card_walk']:.4f} s card walk (P1) of {iters} trees over "
        f"{ds.num_data()} rows, {seed['device_add']:.4f} s device adds; "
        f"holdout {[round(x, 6) for x in cc]}")

    _, rb_s = _timed(cont.rollback_one_iter)
    require(cont.current_iteration() == iters + 4, "rollback did not remove "
            "an iteration")
    rdiff = float(np.abs(cont.gbdt.valid_scores[0] - cont.predict(
        Xh, raw_score=True, num_iteration=0)).max())
    require(rdiff <= 1e-9, f"rolled-back valid scores differ from the model "
            f"by {rdiff}")
    _, up_s = _timed(cont.update)
    require(cont.current_iteration() == iters + 5
            and cont.gbdt.models[-1].num_leaves > 1,
            "no tree grew after the rollback")
    rec.update(rollback_s=rb_s, update_after_rollback_s=up_s)
    log(f"session: rollback_one_iter {rb_s:.3f} s (P1 over the training "
        f"and holdout bins), the next update {up_s:.3f} s")
    del bst, cont, loaded

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, cv_s = _timed(lambda: lt.cv(SESSION_PARAMS, ds, 5, nfold=3,
                                     return_cvbooster=True))
    peak = torch.cuda.max_memory_allocated()
    key = f"valid {SESSION_PARAMS['metric'][0]}-mean"
    require(len(res[key]) == 5 and all(np.isfinite(res[key]))
            and res[key][-1] < res[key][0], f"cv curve {res[key]}")
    rec.update(cv_wall_s=cv_s, cv_mean=res[key],
               cv_stdv=res[key.replace("mean", "stdv")],
               cv_peak_device_bytes=peak, cv_base_device_bytes=base)
    log(f"session: cv nfold=3 x 5 rounds in {cv_s:.2f} s, {key} "
        f"{[round(x, 6) for x in res[key]]}, peak device memory "
        f"{peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB before)")
    del res
    return dict(kernels.LAUNCHES), rec


def session_parity_phase():
    """The session's calls at 200k rows on the card and on the CPU: the
    same early stop and splits, the same continued and rolled-back trees,
    cv means within 1e-4; on the card, cv's fold boosters (updated in
    turns) grow the model text each fold grows alone."""
    import numpy as np
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.engine import _make_n_folds

    X, y = higgs_like(PARITY_ROWS + HOLDOUT_ROWS, 13)
    Xh, yh = X[PARITY_ROWS:], y[PARITY_ROWS:]
    X, y = X[:PARITY_ROWS], y[:PARITY_ROWS]
    out, times = {}, {}
    key = f"valid {SESSION_PARAMS['metric'][0]}-mean"
    with tempfile.TemporaryDirectory() as d:
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            params = dict(SESSION_PARITY_PARAMS, device_type=dev)
            ds = lt.Dataset(X, y)
            va = ds.create_valid(Xh, yh)
            es = lt.train(params, ds, SESSION_ROUNDS, valid_sets=[va],
                          early_stopping_rounds=SESSION_STOP,
                          verbose_eval=False)
            path = os.path.join(d, f"{dev}.txt")
            es.save_model(path)
            cont = lt.train(params, ds, 2, valid_sets=[va], init_model=path,
                            verbose_eval=False)
            cont.rollback_one_iter()
            cont.update()
            cvr = lt.cv(params, ds, SESSION_PARITY_CV_ROUNDS, nfold=3,
                        return_cvbooster=True)
            out[dev] = (ds, es, cont, cvr)
            times[dev] = time.perf_counter() - t0
    (ds, es_g, cont_g, cv_g), (_, es_c, cont_c, cv_c) = out["cuda"], out["cpu"]
    require(es_g.best_iteration == es_c.best_iteration
            and es_g.current_iteration() == es_c.current_iteration()
            and es_g.best_iteration < es_g.current_iteration(),
            f"early stop: card {es_g.best_iteration}/"
            f"{es_g.current_iteration()}, CPU {es_c.best_iteration}/"
            f"{es_c.current_iteration()}")
    n_es = _same_splits(es_g.gbdt.models, es_c.gbdt.models, "early stop")
    n_cont = _same_splits(cont_g.gbdt.models, cont_c.gbdt.models,
                          "continued + rolled back")
    mean_g, mean_c = np.asarray(cv_g[key]), np.asarray(cv_c[key])
    cv_diff = float(np.max(np.abs(mean_g - mean_c) / np.abs(mean_c)))
    require(cv_diff <= 1e-4, f"cv means differ by {cv_diff} (relative)")
    n_cv = sum(_same_splits(a.gbdt.models, b.gbdt.models, f"cv fold {i}")
               for i, (a, b) in enumerate(zip(cv_g["cvbooster"].boosters,
                                              cv_c["cvbooster"].boosters)))
    # the folds one by one, alone on the card
    params = dict(SESSION_PARITY_PARAMS, device_type="cuda")
    for i, (tr, te) in enumerate(_make_n_folds(ds, 3, 0, True, True)):
        solo = lt.Booster(params, ds.subset(tr))
        solo.add_valid(ds.subset(te), "valid")
        for _ in range(SESSION_PARITY_CV_ROUNDS):
            solo.update()
        require(solo.model_to_string()
                == cv_g["cvbooster"].boosters[i].model_to_string(),
                f"cv fold {i}: the booster updated in turns grew another "
                "model than the fold alone")
        del solo
    rec = {"best_iteration": es_g.best_iteration,
           "iterations": es_g.current_iteration(),
           "splits_compared": {"early_stop": n_es, "continued": n_cont,
                               "cv": n_cv},
           "cv_mean_rel_diff": cv_diff, "wall_s": times}
    log(f"session parity: best iteration {es_g.best_iteration} of "
        f"{es_g.current_iteration()} on both; splits identical: {n_es} "
        f"early stop, {n_cont} continued, {n_cv} cv; cv means within "
        f"{cv_diff:.3g}; 3 cv folds in turns = alone, bit for bit; "
        f"card {times['cuda']:.1f} s, CPU {times['cpu']:.1f} s")
    return rec


def session_mc_phase(ds, Xh, yh):
    """The session at multiclass_cat: cv nfold=2 x 3 rounds, and a save ->
    load round trip with categorical splits."""
    import numpy as np
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import kernels

    kernels.reset_launches()
    res, cv_s = _timed(lambda: lt.cv(MC_PARAMS, ds, 3, nfold=2,
                                     return_cvbooster=True))
    launches = dict(kernels.LAUNCHES)
    key = "valid multi_logloss-mean"
    require(len(res[key]) == 3 and res[key][-1] < res[key][0],
            f"mc cv curve {res[key]}")
    require(launches["histogram_all"] == 3 * 2, "histogram_all did not run "
            "once an iteration a fold")
    bst = res["cvbooster"].boosters[0]
    text = bst.model_to_string()
    require("cat_threshold=" in text, "no categorical split to round-trip")
    loaded, load_s = _timed(lambda: lt.Booster(model_str=text))
    for raw in (True, False):
        require(np.array_equal(loaded.predict(Xh, raw_score=raw),
                               bst.predict(Xh, raw_score=raw)),
                "the loaded multiclass model predicts differently")
    rec = {"cv_wall_s": cv_s, "cv_mean": res[key],
           "cv_stdv": res[key.replace("mean", "stdv")], "load_s": load_s,
           "categorical_splits": sum(t.num_cat for t in bst.gbdt.models)}
    log(f"session mc: cv nfold=2 x 3 rounds in {cv_s:.2f} s, {key} "
        f"{[round(x, 6) for x in res[key]]}; save/load with "
        f"{rec['categorical_splits']} categorical splits: bit for bit")
    return launches, rec


# --------------------------------------------------------------- phase 17
def heavy_weights(n: int, seed: int):
    """Sample weights log-uniform over 1e-3..1e3, every 13th row 0."""
    import numpy as np
    w = np.exp(np.random.RandomState(seed).uniform(
        np.log(1e-3), np.log(1e3), size=n)).astype(np.float32)
    w[::13] = 0.0
    return w


def mild_weights(n: int, seed: int):
    """Sample weights log-uniform over 0.25..4."""
    import numpy as np
    return np.exp(np.random.RandomState(seed).uniform(
        np.log(0.25), np.log(4.0), size=n)).astype(np.float32)


def objective_labels(objective: str, X, seed: int):
    """Labels the objective accepts, made from the features."""
    import numpy as np
    rng = np.random.RandomState(seed)
    n = len(X)
    f = (X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 2] * X[:, 3]).astype(
        np.float64)
    if objective in ("poisson", "tweedie"):
        return rng.poisson(np.exp(0.4 * f)).astype(np.float64)
    if objective == "gamma":
        return rng.gamma(2.0, np.exp(0.3 * f) / 2.0) + 1e-3
    if objective.startswith("cross_entropy"):
        return 1.0 / (1.0 + np.exp(-2.0 * f - 0.3 * rng.normal(size=n)))
    return 2.0 * f + rng.normal(size=n)


# objective -> (weights, init score, the first metric)
OBJECTIVE_CASES = {
    "regression": ("heavy", True, "l2"),
    "regression_l1": ("mild", True, "l1"),
    "huber": ("mild", False, "huber"),
    "fair": ("mild", False, "fair"),
    "quantile": (None, False, "quantile"),
    "mape": ("mild", False, "mape"),
    "poisson": ("mild", False, "poisson"),
    "gamma": ("mild", False, "gamma"),
    "tweedie": ("mild", False, "tweedie"),
    "binary": ("mild", True, "binary_logloss"),
    # the JAX package's cross_entropy metric scores against label > 0;
    # kullback_leibler holds the soft labels
    "cross_entropy": ("mild", False, "kullback_leibler"),
    "cross_entropy_lambda": ("mild", False, "cross_entropy_lambda"),
}
OBJ_ITERS = 2
OBJ_PARAMS = dict(num_leaves=255, max_bin=MAX_BIN, learning_rate=0.1,
                  min_sum_hessian_in_leaf=100.0, verbosity=-1,
                  device_type="cuda")
RENEWING = ("regression_l1", "quantile", "mape")


def with_metadata(handle, label=None, weights=None, init_score=None,
                  group=None):
    """A dataset over ``handle``'s bins (and its device copy) with other
    metadata: the rows are binned once for every objective."""
    import copy
    from lightgbm_tpu_torch import Dataset
    from lightgbm_tpu_torch.core.metadata import Metadata
    h = copy.copy(handle)
    h.metadata = Metadata(h.num_data)
    h._set_metadata(handle.metadata.label if label is None else label,
                    weights, group, init_score)
    return Dataset(h)


class record_renewals:
    """Context: every renew_tree_output of an objective inside it keeps its
    leaf ids, score and result (host copies) in ``self.calls``."""

    def __init__(self, objective):
        self.obj = objective
        self.calls = []

    def __enter__(self):
        renew, calls = self.obj.renew_tree_output, self.calls

        def recorded(leaf_values, leaf_ids, score):
            out = renew(leaf_values, leaf_ids, score)
            calls.append((leaf_ids.cpu().numpy().copy(),
                          score.cpu().numpy().copy(), leaf_values,
                          out.copy()))
            return out

        self.obj.renew_tree_output = recorded
        return self

    def __exit__(self, *exc):
        del self.obj.renew_tree_output


def host_renewal(obj, leaf_ids, score, leaf_values):
    """The host percentile of each leaf's residuals, in row order (the
    JAX package's per-leaf masks, grouped here by one stable argsort)."""
    import numpy as np
    from lightgbm_tpu_torch.objective.base import (percentile,
                                                   weighted_percentile)
    r = obj.label_np.astype(np.float64) - score.astype(np.float64)
    w = (None if obj.renew_weights is None
         else obj.renew_weights.cpu().numpy())
    order = np.argsort(leaf_ids, kind="stable")
    ends = np.cumsum(np.bincount(leaf_ids, minlength=len(leaf_values)))
    out = np.array(leaf_values, dtype=np.float64)
    for k in range(len(out)):
        rows = order[ends[k - 1] if k else 0:ends[k]]
        if len(rows):
            out[k] = (percentile(r[rows], obj.alpha) if w is None else
                      weighted_percentile(r[rows], w[rows], obj.alpha))
    return out


def train_objective(name, ds, valid, Xh, params, iters, metric):
    """Train ``iters`` iterations with ``valid`` (binned from ``Xh``):
    the first metric improves, Booster.predict of ``Xh`` (plus the valid
    set's init scores) is the in-training valid score, and a renewing
    objective's last renewal is the host percentile bit for bit.
    Returns (booster, record)."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt

    evals = {}
    t0 = time.perf_counter()
    bst = lt.Booster(dict(params, metric=[metric]), ds)
    bst.add_valid(valid, "holdout")
    with record_renewals(bst.gbdt.objective) if (
            name in RENEWING) else contextlib.nullcontext() as rec:
        for _ in range(iters):
            bst.update()
            for _, m, v, _ in bst.eval_valid():
                evals.setdefault(m, []).append(v)
        renewals = getattr(rec, "calls", None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    curve = evals[metric]
    require(len(bst.gbdt.models) == iters * bst.gbdt.num_tree_per_iteration
            and all(t.num_leaves > 1 for t in bst.gbdt.models),
            f"{name}: a tree did not split")
    require(all(np.isfinite(curve)) and curve[-1] < curve[0],
            f"{name}: holdout {metric} {curve} did not improve")
    C = bst.gbdt.num_tree_per_iteration
    pred = bst.predict(Xh, raw_score=True).T.reshape(C, -1)
    init = valid._handle.metadata.init_score
    if init is not None:
        pred = np.reshape(init, (C, -1)) + pred
    vdiff = float(np.abs(np.reshape(bst.gbdt.valid_scores[0], (C, -1))
                         - pred).max())
    require(vdiff <= 1e-9, f"{name}: the held-out scores differ from the "
            f"in-training valid scores by {vdiff}")
    it_s = list(bst.gbdt.iter_seconds)
    rec = {"metric": metric, "curve": curve, "iter_s": it_s,
           "wall_s": wall, "valid_diff": vdiff}
    if renewals is not None:
        require(len(renewals) == iters, f"{name}: {len(renewals)} renewals")
        lid, score, lv, got = renewals[-1]
        want = host_renewal(bst.gbdt.objective, lid, score, lv)
        require(np.array_equal(got, want), f"{name}: the renewed leaves "
                "differ from the host percentile")
        rs = list(bst.gbdt.renew_seconds)
        rec.update(renew_s=rs, renew_share=sum(rs) / sum(it_s))
    return bst, rec


def weighted_kernel_phase(handle, X):
    """K1 (root) and K3 (a numeric split) at the HIGGS shape on weighted
    L2 gradients (weights over 1e-3..1e3, rows of weight 0 kept as
    members) against their plain versions, at phase 2's tolerance: the
    fixed-point scale is set by the largest |g w| and is coarsest for the
    small weights.  Returns the largest errors and the scale."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch import Config
    from lightgbm_tpu_torch.core.metadata import Metadata
    from lightgbm_tpu_torch.models.gbdt import block_rows
    from lightgbm_tpu_torch.objective import create_objective
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops.split import FeatureMeta

    device = torch.device("cuda")
    n = handle.num_data
    config = Config.from_params(dict(OBJ_PARAMS, objective="regression"))
    rb = block_rows(config, n)
    binsT = handle.device_bins(rb, device)
    npad = binsT.shape[1]
    nblk = npad // rb
    B = 1 << max(0, (handle.max_num_bin - 1).bit_length())
    md = Metadata(n)
    md.init(n)
    md.set_label(objective_labels("regression", X, 99))
    md.set_weights(heavy_weights(n, 98))
    obj = create_objective(config)
    obj.init(md, n, device)
    grad, hess = obj.get_gradients(torch.full((n,), obj.boost_from_score(),
                                              device=device))
    pad = (0, npad - n)
    member = torch.nn.functional.pad(torch.ones(n, device=device), pad)
    w8 = th.pack_channels(torch.nn.functional.pad(grad, pad),
                          torch.nn.functional.pad(hess, pad), member)
    scales = th.fixed_point_scales(w8)
    infos = handle.feature_infos()
    fm = FeatureMeta(*(np.array([getattr(i, k) for i in infos], np.int32)
                       for k in ("num_bin", "missing_type", "default_bin")))
    route = th.pack_route(0, 1, 0, int(fm.num_bin[0]) // 2, False, False,
                          np.zeros(8, np.uint32), fm)
    lid0 = torch.zeros(npad, dtype=torch.int32, device=device)
    want = th.histogram_segment_plain(binsT, w8, lid0, 0, nblk, 0, B, rb)
    got = th.histogram_segment(binsT, w8, lid0, 0, nblk, 0, B, rb, scales)
    err_k1 = check_hist("histogram_segment weighted root", got, want,
                        hist_abs_sums(th, binsT, w8, lid0, 0, nblk, 0, B,
                                      rb))
    want_lid, want = th.histogram_segment_routed_plain(
        binsT, w8, lid0.clone(), 0, nblk, 1, route, B, rb)
    got_lid, got = th.histogram_segment_routed(
        binsT, w8, lid0.clone(), 0, nblk, 1, route, B, rb, scales)
    require(torch.equal(got_lid, want_lid), "histogram_segment_routed "
            "weighted: leaf ids differ from the plain version")
    err_k3 = check_hist("histogram_segment_routed weighted", got, want,
                        hist_abs_sums(th, binsT, w8, want_lid, 0, nblk, 1,
                                      B, rb))
    rec = {"k1_root_max_abs_err": err_k1, "k3_split_max_abs_err": err_k3,
           "grad_scale": float(scales[0]), "max_abs_grad":
           float((grad.abs()).max())}
    log(f"objectives: K1 root and K3 split on weighted gradients (weights "
        f"1e-3..1e3, max |g w| {rec['max_abs_grad']:.4g}, gradient scale "
        f"2^{np.log2(rec['grad_scale']):.0f}): counts exact, max |diff| "
        f"{err_k1:.3g} / {err_k3:.3g}, within {HIST_RTOL} x sum|value|")
    del w8, grad, hess
    return rec


def objectives_phase(ds, X, Xh, yh):
    """Phase 17 at HIGGS: every objective of OBJECTIVE_CASES on the
    phase 3 bins with its own labels, weights and init scores, 2
    iterations at 255 leaves.  Returns (launches, records)."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops import kernels

    base = ds.create_valid(Xh, yh).construct()._handle
    out = {}
    kernels.reset_launches()
    for i, (name, (wkind, init, metric)) in enumerate(
            OBJECTIVE_CASES.items()):
        t0 = time.perf_counter()
        y = (ds.get_label().astype(np.float64) if name == "binary"
             else objective_labels(name, X, 100 + i))
        yv = yh if name == "binary" else objective_labels(name, Xh, 200 + i)
        n, nv = len(y), len(yv)
        make = {"heavy": heavy_weights, "mild": mild_weights,
                None: lambda n, seed: None}[wkind]
        w, wv = make(n, 300 + i), make(nv, 400 + i)
        rng = np.random.RandomState(500 + i)
        s0 = 0.1 * rng.normal(size=n) if init else None
        sv = 0.1 * rng.normal(size=nv) if init else None
        train = with_metadata(ds._handle, y, w, s0)
        valid = with_metadata(base, yv, wv, sv)
        setup = time.perf_counter() - t0
        bst, rec = train_objective(name, train, valid, Xh,
                                   dict(OBJ_PARAMS, objective=name),
                                   OBJ_ITERS, metric)
        rec.update(weights=wkind, init_score=init, setup_s=setup)
        out[name] = rec
        share = (f", renewal {rec['renew_share']:.1%} of the iterations "
                 f"({[round(x, 3) for x in rec['renew_s']]} s)"
                 if "renew_s" in rec else "")
        log(f"objectives: {name} ({wkind or 'no'} weights"
            f"{', init scores' if init else ''}): holdout {metric} "
            f"{[round(x, 6) for x in rec['curve']]}, iter_seconds "
            f"{[round(x, 4) for x in rec['iter_s']]}{share}")
        del bst, train, valid
    torch.cuda.empty_cache()
    return dict(kernels.LAUNCHES), out


def ova_phase(ds, Xh, yh):
    """Phase 17's multiclassova on the multiclass_cat rows (weighted,
    255 leaves, 2 iterations): K5 at each iteration's class roots."""
    import numpy as np
    from lightgbm_tpu_torch.ops import kernels

    kernels.reset_launches()
    n, nv = ds.num_data(), len(yh)
    train = with_metadata(ds._handle, weights=mild_weights(n, 600))
    valid = ds.create_valid(Xh, yh, weight=mild_weights(nv, 601))
    params = dict(OBJ_PARAMS, objective="multiclassova",
                  num_class=MC_CLASSES)
    _, rec = train_objective("multiclassova", train, valid, Xh, params,
                             OBJ_ITERS, "multi_logloss")
    launches = dict(kernels.LAUNCHES)
    require(launches["histogram_all"] == OBJ_ITERS, "multiclassova: K5 "
            f"launched {launches['histogram_all']} times")
    log(f"objectives: multiclassova (weights): holdout multi_logloss "
        f"{[round(x, 6) for x in rec['curve']]}, iter_seconds "
        f"{[round(x, 4) for x in rec['iter_s']]}, K5 "
        f"{launches['histogram_all']}")
    return launches, rec


# --------------------------------------------------------------- phase 18
# BASELINE.json config 4 at bench_suite.py's shape and parameters
RANK_ROWS = 2_270_000
RANK_HOLDOUT_ROWS = 50_000
RANK_FEATURES = 136
RANK_ITERS = 25
RANK_GATE = 0.80            # bench_suite.py:290-304
RANK_PARAMS = dict(objective="lambdarank", num_leaves=255, max_bin=MAX_BIN,
                   learning_rate=0.1, min_sum_hessian_in_leaf=100.0,
                   label_gain=[(1 << i) - 1 for i in range(32)],
                   metric=["ndcg"], eval_at=[1, 2, 3, 4, 5], verbosity=-1,
                   device_type="cuda")


def msltr_like(rng, n: int):
    """bench_suite.py's _gen_rank: MSLR-WEB30K-shaped queries of 40-119
    documents, 136 features, graded relevance 0-4 by each query's score
    quintile.  Returns (X, y, group sizes)."""
    import numpy as np
    sizes = []
    left = n
    while left > 0:
        s = min(int(rng.randint(40, 120)), left)
        sizes.append(s)
        left -= s
    group = np.asarray(sizes)
    X = rng.normal(size=(n, RANK_FEATURES)).astype(np.float32)
    score = (X[:, 0] + 0.7 * X[:, 1] - 0.5 * X[:, 2]
             + 0.3 * X[:, 3] * X[:, 4] + rng.normal(size=n) * 0.7)
    y = np.zeros(n)
    pos = 0
    for s in sizes:
        sl = slice(pos, pos + s)
        order = np.argsort(np.argsort(score[sl]))
        y[sl] = np.minimum(4, (5 * order) // max(s, 1))
        pos += s
    return X, y, group


def ndcg_at_10(pred, y, group):
    """bench_suite.py's _ndcg_at_10: the mean NDCG@10 of the queries with
    a relevant document."""
    import numpy as np
    pos, total, nq = 0, 0.0, 0
    disc = 1.0 / np.log2(np.arange(2, 13))
    for s in group:
        sl = slice(pos, pos + s)
        ys, ps = y[sl], pred[sl]
        k = min(10, s)
        top = np.argsort(-ps, kind="stable")[:k]
        dcg = float((((2.0 ** ys[top]) - 1) * disc[:k]).sum())
        ideal = np.sort(ys)[::-1][:k]
        idcg = float((((2.0 ** ideal) - 1) * disc[:k]).sum())
        if idcg > 0:
            total += dcg / idcg
            nq += 1
        pos += s
    return total / max(nq, 1)


def lambdarank_phase():
    """Phase 18: lambdarank at 2.27M x 136 for 25 iterations; NDCG@10 of
    the first 200k documents over bench_suite.py's gate, ndcg@1..5 on a
    holdout each iteration.  Returns (launches, record)."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import Config
    from lightgbm_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    X, y, group = msltr_like(np.random.RandomState(7), RANK_ROWS)
    Xh, yh, gh = msltr_like(np.random.RandomState(8), RANK_HOLDOUT_ROWS)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = lt.Dataset(X, y, group=group)
    ds.construct(Config.from_params(RANK_PARAMS))
    bin_s = time.perf_counter() - t0
    log(f"lambdarank data: {RANK_ROWS} x {RANK_FEATURES} in {len(group)} "
        f"queries generated in {gen_s:.1f} s, binned in {bin_s:.1f} s")
    valid = ds.create_valid(Xh, yh, group=gh)
    evals = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    with record_trees() as rec:
        bst = lt.train(RANK_PARAMS, ds, RANK_ITERS, valid_sets=[valid],
                       valid_names=["holdout"], evals_result=evals,
                       verbose_eval=False)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    it_s = list(bst.gbdt.iter_seconds)
    curves = evals["holdout"]
    require(list(curves) == [f"ndcg@{k}" for k in range(1, 6)],
            f"holdout metrics {list(curves)}")
    require(len(bst.gbdt.models) == RANK_ITERS
            and all(t.num_leaves > 1 for t in bst.gbdt.models),
            "lambdarank: a tree did not split")
    require(all(c[-1] > c[0] for c in curves.values()),
            "lambdarank: holdout ndcg did not rise")
    loop = device_loop_report("lambdarank", bst, rec.stats, launches,
                              "histogram_segment_routed_step", wall)
    require(launches["score_gather_add"] == RANK_ITERS,
            "score_gather_add did not run once per iteration")
    # the gate, as bench_suite.py takes it: the queries wholly inside the
    # first 200k documents
    m, take = 0, 0
    while take < len(group) and m + group[take] <= 200_000:
        m += group[take]
        take += 1
    pred = bst.predict(X[:200_000])
    nd10 = ndcg_at_10(np.asarray(pred[:m]), y[:m], group[:take])
    require(nd10 > RANK_GATE, f"NDCG@10 {nd10} is not over {RANK_GATE}")
    raw = bst.predict(Xh, raw_score=True)
    vdiff = float(np.abs(raw - bst.gbdt.valid_scores[0]).max())
    require(vdiff <= 1e-9, f"lambdarank: Booster.predict differs from the "
            f"in-training valid scores by {vdiff}")
    # the lambdarank gradient alone, CUDA events
    obj, score = bst.gbdt.objective, bst.gbdt.train_score[0]
    grad_ms = time_ms(lambda i: obj.get_gradients(score), 5)
    g1, g2 = obj.get_gradients(score), obj.get_gradients(score)
    require(torch.equal(g1[0], g2[0]) and torch.equal(g1[1], g2[1]),
            "lambdarank gradients differ between two calls")
    rec = {"gen_s": gen_s, "bin_s": bin_s, "wall_s": wall, "iter_s": it_s,
           "iter_s_median": float(np.median(it_s)),
           "holdout": curves, "ndcg10_first_200k": nd10,
           "gradient_ms": grad_ms,
           "buckets": [(b["P"], b["C"], int(b["idx"].shape[0]))
                       for b in obj.buckets],
           "k3_step_launches": launches["histogram_segment_routed_step"],
           "device_loop": loop}
    log(f"lambdarank: {RANK_ITERS} iterations in {wall:.2f} s, median "
        f"iteration {np.median(it_s):.4f} s, gradient {grad_ms:.2f} ms a "
        f"call (buckets P, C, queries {rec['buckets']}); NDCG@10 first 200k "
        f"{nd10:.5f} (gate {RANK_GATE}); holdout ndcg@1..5 "
        f"{[round(c[-1], 5) for c in curves.values()]}; K3 step "
        f"{launches['histogram_segment_routed_step']}")
    del bst, ds, valid
    torch.cuda.empty_cache()
    return launches, rec


# --------------------------------------------------------------- phase 19
def _same_splits_near_tie(a_trees, b_trees, tag, forced=0):
    """Card = CPU: the same split feature and bin at gain > 1e-2, up to a
    near-tie (two gains within 1e-4: the rest of that model is not
    compared, its scores differ from there).  The first ``forced`` splits
    of each tree (a forced plan's, whatever their gains) must be the same.
    Returns (splits compared, near-ties met)."""
    require(len(a_trees) == len(b_trees), f"{tag}: {len(a_trees)} against "
            f"{len(b_trees)} trees")
    compared = 0
    for i, (a, b) in enumerate(zip(a_trees, b_trees)):
        for k in range(min(a.num_leaves, b.num_leaves) - 1):
            if k < forced:
                require((a.split_feature[k], a.threshold_in_bin[k]) == (
                    b.split_feature[k], b.threshold_in_bin[k]),
                    f"{tag}: tree {i} forced split {k} differs")
                compared += 1
                continue
            ga, gb = float(a.split_gain[k]), float(b.split_gain[k])
            if ga <= 1e-2 or gb <= 1e-2:
                break
            if (a.split_feature[k], a.threshold_in_bin[k]) != (
                    b.split_feature[k], b.threshold_in_bin[k]):
                require(abs(ga - gb) <= 1e-4 * max(ga, gb),
                        f"{tag}: tree {i} split {k} differs (gains {ga}, "
                        f"{gb})")
                return compared, 1
            compared += 1
    return compared, 0


def meta_parity_phase():
    """Phase 19: weighted L1 with init scores (renewal) at 200k rows,
    lambdarank at 100k documents and weighted multiclassova at 200k rows,
    31 leaves x 3 iterations on the card and on the CPU; a weighted and
    an unweighted booster in turns on the card grow their solo texts."""
    import numpy as np
    import lightgbm_tpu_torch as lt

    X, _ = higgs_like(PARITY_ROWS, 17)
    Xm, ym = multiclass_cat(PARITY_ROWS, 19)
    Xr, yr, gr = msltr_like(np.random.RandomState(23), 100_000)
    cases = {
        "l1_weighted_init": (X, objective_labels("regression_l1", X, 18),
                             dict(objective="regression_l1"),
                             dict(weight=mild_weights(PARITY_ROWS, 20),
                                  init_score=0.1 * np.random.RandomState(
                                      21).normal(size=PARITY_ROWS))),
        "lambdarank": (Xr, yr, dict(RANK_PARAMS, metric=[]),
                       dict(group=gr)),
        "multiclassova_weighted": (
            Xm, ym, dict(objective="multiclassova", num_class=MC_CLASSES),
            dict(weight=mild_weights(PARITY_ROWS, 22),
                 categorical_feature=MC_CAT)),
    }
    rec = {}
    for name, (Xc, yc, params, kw) in cases.items():
        out, times = {}, {}
        t0 = time.perf_counter()
        ds = lt.Dataset(Xc, yc, **kw)     # binned once, for both devices
        ds.construct(lt.Config.from_params(dict(params, device_type="cpu")))
        bin_s = time.perf_counter() - t0
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            p = dict(params, num_leaves=31, verbosity=-1, device_type=dev)
            bst = lt.Booster(p, ds)
            for _ in range(META_PARITY_ITERS):
                bst.update()
            out[dev] = bst
            times[dev] = time.perf_counter() - t0
        n, ties = _same_splits_near_tie(out["cuda"].gbdt.models,
                                        out["cpu"].gbdt.models, name)
        require(n >= 30, f"{name}: only {n} splits compared")
        diff = float(np.abs(out["cuda"].predict(Xc, raw_score=True)
                            - out["cpu"].predict(Xc, raw_score=True)).max())
        require(diff < 1e-3, f"{name}: card and CPU raw predictions differ "
                f"by {diff}")
        rec[name] = {"splits": n, "near_ties": ties, "raw_diff": diff,
                     "wall_s": times, "bin_s": bin_s}
        log(f"parity {name}: {n} splits identical"
            f"{' up to a near-tie' if ties else ''}, max |raw diff| "
            f"{diff:.3g}; card {times['cuda']:.1f} s, CPU "
            f"{times['cpu']:.1f} s")
        del out
    # a weighted and an unweighted booster in turns = alone
    Xb, yb = higgs_like(PARITY_ROWS, 29)
    params = dict(TRAIN_PARAMS, num_leaves=31, metric=[])
    base = lt.Dataset(Xb, yb).construct(lt.Config.from_params(params))
    weighted = with_metadata(base._handle,
                             weights=heavy_weights(PARITY_ROWS, 30))

    def boosters():
        return [lt.Booster(params, weighted), lt.Booster(params, base)]

    solo = []
    for b in boosters():
        for _ in range(3):
            b.update()
        solo.append(b.model_to_string())
        del b
    turns = boosters()
    for _ in range(3):
        for b in turns:
            b.update()
    require([b.model_to_string() for b in turns] == solo and
            solo[0] != solo[1], "a weighted and an unweighted booster in "
            "turns grew other models than alone")
    rec["weighted_in_turns"] = "bit for bit"
    log("parity: a weighted and an unweighted booster in turns grow their "
        "solo model texts, bit for bit")
    return rec


# --------------------------------------------------------------- phase 20
# BASELINE.json config 2 at bench_suite.py's shape and parameters
GOSS_ROWS = 2_000_000
GOSS_ITERS = 25
GOSS_GATE_ROWS = 200_000
GOSS_PARAMS = dict(objective="regression", boosting="goss", num_leaves=255,
                   max_bin=MAX_BIN, learning_rate=0.1,
                   min_sum_hessian_in_leaf=100.0, metric=["l2"],
                   verbosity=-1, device_type="cuda")


def goss_like(rng, n: int):
    """bench_suite.py's _gen_goss: 28 normal features, a nonlinear
    regression target."""
    import numpy as np
    X = rng.normal(size=(n, N_FEATURES)).astype(np.float32)
    y = (2.0 * X[:, 0] - X[:, 1] ** 2 + np.sin(3 * X[:, 2])
         + 0.3 * X[:, 3] * X[:, 4] + 0.2 * rng.normal(size=n))
    return X, y.astype(np.float64)


def goss_reference(grad, hess, key, top_k, other_k):
    """GOSS's selection in numpy, apart from the port's: the top_k rows by
    sum |g h| in a stable descending order, then of the rest the rows
    whose uniform key (the port's threefry on the CPU, held to jax.random
    by tests/test_torch_random.py) is at most the other_k-th smallest.
    Returns (mask, rows tied with the other_k-th key beyond other_k)."""
    import numpy as np
    from lightgbm_tpu_torch.utils import random
    n = grad.shape[1]
    score = np.abs(grad * hess).sum(axis=0)
    top = np.zeros(n, bool)
    top[np.argsort(-score, kind="stable")[:top_k]] = True
    u = random.uniform(key.cpu(), n).numpy()
    u[top] = np.inf
    kth = np.partition(u, other_k - 1)[other_k - 1]
    rest = (u <= kth) & ~top
    return (top | rest).astype(np.float32), int(rest.sum()) - other_k


def goss_phase():
    """Phase 20: goss_regression, BASELINE config 2: 2M x 28, 25
    iterations, 10 of warm-up; each GOSS iteration's bag is the
    selection, recomputed on the card from the iteration's own inputs,
    and the last one is the numpy reference's; bench_suite.py's gate on
    the first 200k rows and a 100k holdout's l2; K3 at phase 2's
    tolerance on the last GOSS iteration's amplified gradients.  Returns
    (launches, record, the booster, its raw rows) (phase 23 predicts
    them)."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import Config
    from lightgbm_tpu_torch.models.goss import goss_select
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops.split import FeatureMeta
    from lightgbm_tpu_torch.utils import random

    t0 = time.perf_counter()
    X, y = goss_like(np.random.RandomState(7), GOSS_ROWS)
    Xh, yh = goss_like(np.random.RandomState(8), HOLDOUT_ROWS)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = lt.Dataset(X, y)
    ds.construct(Config.from_params(GOSS_PARAMS))
    bin_s = time.perf_counter() - t0
    log(f"goss data: {GOSS_ROWS} x {N_FEATURES} generated in {gen_s:.1f} "
        f"s, binned in {bin_s:.1f} s")
    n = GOSS_ROWS
    top_k, other_k = int(n * 0.2), int(n * 0.1)
    warm = int(1.0 / GOSS_PARAMS["learning_rate"])
    bst = lt.Booster(GOSS_PARAMS, ds)
    bst.add_valid(ds.create_valid(Xh, yh), "holdout")
    gb = bst.gbdt
    bags, holdout_l2 = [], []
    kernels.reset_launches()
    t0 = time.perf_counter()
    with record_trees() as rec:
        for it in range(GOSS_ITERS):
            if it >= warm:
                # the iteration's own inputs: the score before it and the
                # key before its trees split it
                grad, hess = gb._gradients()
                key = random.fold_in(gb._key, 0x60550000 + it)
                want = goss_select(grad[:, :n], hess[:, :n],
                                   key.to(grad.device), top_k, other_k)
            bst.update()
            bags.append(int(gb.member[:n].sum().item()))
            if it >= warm:
                require(torch.equal(gb.member[:n], want[2]),
                        f"goss iteration {it}: the bag is not the "
                        "selection of the iteration's gradients and key")
            holdout_l2.append(bst.eval_valid()[0][2])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    require(not gb.member[n:].any(), "goss: a pad row is in the bag")
    require(bags[:warm] == [n] * warm, f"goss warm-up bags {bags[:warm]}")
    require(all(top_k + other_k <= b < n for b in bags[warm:]),
            f"goss bags {bags[warm:]}")
    # the last iteration's selection against numpy, and timed on the card
    mask_np, ties = goss_reference(grad[:, :n].cpu().numpy(),
                                   hess[:, :n].cpu().numpy(), key, top_k,
                                   other_k)
    require(np.array_equal(want[2].cpu().numpy(), mask_np),
            "goss: the card's selection differs from the numpy reference")
    require(bags[-1] == top_k + other_k + ties,
            f"goss: bag {bags[-1]} is not top_k {top_k} + other_k "
            f"{other_k} + {ties} rows tied at the other_k-th key")
    cpu = goss_select(grad[:, :n].cpu(), hess[:, :n].cpu(), key, top_k,
                      other_k)
    require(all(torch.equal(a.cpu(), b) for a, b in zip(want, cpu)),
            "goss: the card's selection and amplified gradients differ "
            "from the CPU's")
    select_ms = time_ms(lambda i: goss_select(grad[:, :n], hess[:, :n],
                                              key.to(grad.device), top_k,
                                              other_k), 10)
    # K3 on the amplified gradients at phase 2's tolerance
    handle = ds._handle
    rb, B = gb.grower.rb, gb.num_bins
    binsT = gb.bins
    nblk = binsT.shape[1] // rb
    pad = (0, binsT.shape[1] - n)
    w8 = th.pack_channels(torch.nn.functional.pad(want[0][0], pad),
                          torch.nn.functional.pad(want[1][0], pad),
                          torch.nn.functional.pad(want[2], pad))
    scales = th.fixed_point_scales(w8)
    infos = handle.feature_infos()
    fm = FeatureMeta(*(np.array([getattr(i, k) for i in infos], np.int32)
                       for k in ("num_bin", "missing_type", "default_bin")))
    route = th.pack_route(0, 1, 0, int(fm.num_bin[0]) // 2, False, False,
                          np.zeros(8, np.uint32), fm)
    lid0 = torch.zeros(binsT.shape[1], dtype=torch.int32,
                       device=binsT.device)
    want_lid, want_h = th.histogram_segment_routed_plain(
        binsT, w8, lid0.clone(), 0, nblk, 1, route, B, rb)
    got_lid, got_h = th.histogram_segment_routed(
        binsT, w8, lid0.clone(), 0, nblk, 1, route, B, rb, scales)
    require(torch.equal(got_lid, want_lid), "histogram_segment_routed on "
            "GOSS gradients: leaf ids differ from the plain version")
    k3_err = check_hist("histogram_segment_routed GOSS-amplified", got_h,
                        want_h, hist_abs_sums(th, binsT, w8, want_lid, 0,
                                              nblk, 1, B, rb))
    # bench_suite.py's gate: l2 on the first 200k rows, under 0.5 var(y)
    pred = bst.predict(X[:GOSS_GATE_ROWS])
    l2 = float(np.mean((pred - y[:GOSS_GATE_ROWS]) ** 2))
    var = float(np.var(y))
    require(l2 < 0.5 * var, f"goss: l2 {l2} on the first 200k rows is not "
            f"under 0.5 x var(y) = {0.5 * var}")
    # the metric reads the labels as the dataset keeps them, in float32
    hl2 = float(np.mean((bst.predict(Xh) - yh.astype(np.float32)) ** 2))
    require(hl2 < 0.5 * var and holdout_l2[-1] < holdout_l2[0],
            f"goss: holdout l2 {holdout_l2}")
    require(abs(hl2 - holdout_l2[-1]) <= 1e-9 * max(1.0, hl2),
            "goss: Booster.predict differs from the in-training holdout "
            "score")
    loop = device_loop_report("goss_regression", bst, rec.stats, launches,
                              "histogram_segment_routed_step", wall)
    require(launches["score_gather_add"] == GOSS_ITERS,
            "score_gather_add did not run once per iteration")
    it_s = list(gb.iter_seconds)
    out = {"gen_s": gen_s, "bin_s": bin_s, "wall_s": wall,
           "iter_s_warmup": it_s[:warm], "iter_s_goss": it_s[warm:],
           "iter_s_warmup_median": float(np.median(it_s[:warm])),
           "iter_s_goss_median": float(np.median(it_s[warm:])),
           "goss_select_ms": select_ms, "top_k": top_k, "other_k": other_k,
           "bags": bags, "last_ties": ties, "l2_first_200k": l2,
           "var_y": var, "holdout_l2": holdout_l2,
           "k3_goss_max_abs_err": k3_err, "grad_scale": float(scales[0]),
           "k3_step_launches": launches["histogram_segment_routed_step"],
           "device_loop": loop}
    log(f"goss_regression: {GOSS_ITERS} iterations in {wall:.2f} s; median "
        f"iteration warm-up {out['iter_s_warmup_median']:.4f} s, GOSS "
        f"{out['iter_s_goss_median']:.4f} s; goss_select {select_ms:.3f} ms "
        f"a call (card = CPU = numpy); bags {sorted(set(bags[warm:]))} "
        f"(top_k + other_k {top_k + other_k}); l2 first 200k {l2:.5f} < "
        f"{0.5 * var:.5f}; holdout l2 {hl2:.5f}; K3 on amplified gradients "
        f"max |diff| {k3_err:.3g}; K3 step "
        f"{launches['histogram_segment_routed_step']}")
    del gb, ds, w8, want, grad, hess
    torch.cuda.empty_cache()
    return launches, out, bst, X


# --------------------------------------------------------------- phase 21
# (params, iterations): the modes at HIGGS on phase 3's bins
MODE_RUNS = {
    "bagging": (dict(bagging_fraction=0.5, bagging_freq=1), 3),
    "balanced_bagging": (dict(pos_bagging_fraction=0.5,
                              neg_bagging_fraction=0.9, bagging_freq=1), 3),
    "feature_fraction": (dict(feature_fraction=0.5), 3),
    "bynode": (dict(feature_fraction=0.5, feature_fraction_bynode=0.5), 3),
    "dart": (dict(boosting="dart", drop_rate=0.5, skip_drop=0.0), 6),
    "rf": (dict(boosting="rf", bagging_fraction=0.632, bagging_freq=1), 3),
}


def graph_report(g):
    """The segment grower's two graphs after a tree: the device
    operations of a step replay and of a tree-start replay (torch.profiler;
    None where it sees none) and the device time of each (CUDA events)."""
    import torch
    start = g._start_graphs[False][0]
    rec = {}
    for name, graph in (("steps", g._graph), ("start", start)):
        ops = device_ops_per_call(graph.replay)
        rec[name] = {"kernels": None if ops is None else ops["kernel"],
                     "memcpy": None if ops is None else ops["memcpy"],
                     "ms": time_ms(lambda i: graph.replay(), 20)}
    torch.cuda.synchronize()
    return rec


def modes_phase(ds, Xh, yh):
    """Phase 21: each boosting mode 3 iterations at 255 leaves (DART 6)
    on phase 3's binned HIGGS rows.  Returns (launches, record)."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import kernels

    valid = ds.create_valid(Xh, yh)
    launches = collections.Counter()
    rec = {}
    for name, (extra, iters) in MODE_RUNS.items():
        params = dict(TRAIN_PARAMS, **extra)
        evals = {}
        kernels.reset_launches()
        t0 = time.perf_counter()
        bst = lt.train(params, ds, iters, valid_sets=[valid],
                       valid_names=["holdout"], evals_result=evals,
                       verbose_eval=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = dict(kernels.LAUNCHES)
        launches.update(run)
        gb = bst.gbdt
        auc = evals["holdout"]["auc"]
        require(len(gb.models) == iters and auc[-1] > auc[0],
                f"modes {name}: holdout AUC {auc}")
        require(run["histogram_segment_routed_step"] > 0
                and run["score_gather_add"] == iters,
                f"modes {name}: launches {run}")
        text = bst.model_to_string()
        loaded = lt.Booster(model_str=text)
        raw = loaded.predict(Xh, raw_score=True)
        vscore = gb.valid_scores[0] / (iters if gb.average_output else 1)
        vdiff = float(np.abs(raw - vscore).max())
        require(vdiff <= 1e-9, f"modes {name}: the loaded model's holdout "
                f"prediction differs from the valid score by {vdiff}")
        r = {"iter_s": list(gb.iter_seconds), "wall_s": wall,
             "holdout_auc": auc, "load_diff": vdiff,
             "leaves": [t.num_leaves for t in gb.models],
             "k3_step": run["histogram_segment_routed_step"]}
        if name == "rf":
            require("\naverage_output\n" in text and
                    loaded.gbdt.average_output, "modes rf: the model text "
                    "has no average_output")
        if name == "dart":
            drop = sum(gb.drop_seconds)
            r["drop_s"] = list(gb.drop_seconds)
            r["drop_share"] = drop / (drop + sum(gb.iter_seconds))
        if name in ("feature_fraction", "bynode"):
            r["graphs"] = graph_report(gb.grower)
        rec[name] = r
        log(f"modes {name}: {iters} iterations, iteration wall "
            f"{[round(s, 4) for s in r['iter_s']]} s, holdout AUC "
            f"{[round(a, 5) for a in auc]}, save -> load -> predict = valid "
            f"score ({vdiff:.3g})"
            + (f", drop share {r['drop_share']:.3f}" if name == "dart"
               else "")
            + (f", graphs {r['graphs']}" if "graphs" in r else ""))
        del bst, gb, loaded
        torch.cuda.empty_cache()
    return dict(launches), rec


# --------------------------------------------------------------- phase 22
# (data, params, iterations, Booster keywords) of each card = CPU case
MODES_PARITY_SEG = dict(bagging_fraction=0.7, bagging_freq=1,
                        feature_fraction=0.75, feature_fraction_bynode=0.5)


def modes_parity_phase():
    """Phase 22: the modes on the card and on the CPU at 200k rows, 31
    leaves: the same splits up to a near-tie, raw predictions within 1e-3
    where no near-tie was met; refit on both devices within 1e-9; the
    card's threefry draws = the CPU's; a bagged and an unbagged booster in
    turns on the card grow their solo texts.  Returns (launches,
    record)."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.models.grower import (GrowerParams,
                                                  node_feature_mask)
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.utils import random

    Xb, yb = higgs_like(PARITY_ROWS, 31)
    Xg, yg = goss_like(np.random.RandomState(32), PARITY_ROWS)
    Xm, ym = multiclass_cat(PARITY_ROWS, 33)
    binary = dict(objective="binary")
    cases = {
        "bag_ff_bynode_fused": ("b", dict(binary, **MODES_PARITY_SEG), 2,
                                {}),
        "bag_ff_bynode_unfused": ("b", dict(binary, **MODES_PARITY_SEG), 2,
                                  {"fused_route": False}),
        "bag_ff_bynode_frontier_off": (
            "b", dict(binary, tpu_tree_impl="frontier", tpu_frontier_width=4,
                      **MODES_PARITY_SEG), 2, {"frontier_tier": "off"}),
        "bag_ff_bynode_frontier_k1": (
            "b", dict(binary, tpu_tree_impl="frontier", tpu_frontier_width=4,
                      **MODES_PARITY_SEG), 2, {"frontier_tier": "k1"}),
        # two warm-up iterations at lr 0.5, then one of GOSS's selection
        "goss": ("g", dict(objective="regression", boosting="goss",
                           learning_rate=0.5), 3, {}),
        "dart": ("b", dict(binary, boosting="dart", drop_rate=0.5,
                           skip_drop=0.0), 3, {}),
        "rf": ("b", dict(binary, boosting="rf", bagging_fraction=0.632,
                         bagging_freq=1), 2, {}),
        "multiclass_bagging": ("m", dict(objective="multiclass",
                                         num_class=MC_CLASSES,
                                         bagging_fraction=0.7,
                                         bagging_freq=1), 2, {}),
    }
    data = {"b": (Xb, yb, {}), "g": (Xg, yg, {}),
            "m": (Xm, ym, {"categorical_feature": MC_CAT})}
    built = {}
    rec = {}
    kernels.reset_launches()
    for name, (dkey, params, iters, kw) in cases.items():
        Xc, yc, dkw = data[dkey]
        if dkey not in built:
            ds = lt.Dataset(Xc, yc, **dkw)
            ds.construct(lt.Config.from_params(dict(params,
                                                    device_type="cpu")))
            built[dkey] = ds
        ds = built[dkey]
        out, times = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            p = dict(params, num_leaves=31, verbosity=-1, device_type=dev)
            bst = lt.Booster(p, ds, **kw)
            for _ in range(iters):
                bst.update()
            out[dev] = bst
            times[dev] = time.perf_counter() - t0
        n, ties = _same_splits_near_tie(out["cuda"].gbdt.models,
                                        out["cpu"].gbdt.models, name)
        require(n >= 30, f"{name}: only {n} splits compared")
        diff = float(np.abs(out["cuda"].predict(Xc, raw_score=True)
                            - out["cpu"].predict(Xc, raw_score=True)).max())
        require(ties or diff < 1e-3, f"{name}: card and CPU raw "
                f"predictions differ by {diff}")
        bag_diff = int((out["cuda"].gbdt.member.cpu()
                        != out["cpu"].gbdt.member).sum())
        # numpy's bags are the same rows; GOSS's follow the scores, which
        # differ in their last bits (the card's fixed-point histogram sums
        # against the CPU's float64), so rows at the top_k boundary swap
        limit = PARITY_ROWS // 10_000 if dkey == "g" else 0
        require(ties or bag_diff <= limit, f"{name}: the card's bag differs "
                f"from the CPU's in {bag_diff} rows")
        rec[name] = {"splits": n, "near_ties": ties, "raw_diff": diff,
                     "bag_diff": bag_diff, "wall_s": times}
        log(f"modes parity {name}: {n} splits identical"
            f"{' up to a near-tie' if ties else ''}, max |raw diff| "
            f"{diff:.3g}, bags differ in {bag_diff} rows; card "
            f"{times['cuda']:.1f} s, CPU {times['cpu']:.1f} s")
        if name == "bag_ff_bynode_fused":
            # refit of the bagged model on both devices
            text = out["cuda"].model_to_string()
            Xr, yr = higgs_like(50_000, 34)
            refit = []
            for dev in ("cuda", "cpu"):
                b = lt.Booster(params={"device_type": dev}, model_str=text)
                b.refit(Xr, yr)
                refit.append(np.concatenate([t.leaf_value
                                             for t in b.gbdt.models]))
            rdiff = float(np.abs(refit[0] - refit[1]).max())
            require(rdiff <= 1e-6, f"refit: card and CPU leaf values differ "
                    f"by {rdiff}")
            rec["refit_leaf_diff"] = rdiff
            log(f"modes parity refit: card and CPU leaf values within "
                f"{rdiff:.3g}")
        del out
    launches = dict(kernels.LAUNCHES)
    # the card's threefry draws = the CPU's
    key = random.split(random.prng_key(7))[1]
    dev = torch.device("cuda")
    bits_equal = torch.equal(random.random_bits(key.to(dev), 1_000_003).cpu(),
                             random.random_bits(key, 1_000_003))
    steps = torch.arange(2 * 255 + 1)
    base = (torch.arange(N_FEATURES) % 3 != 1).float()
    gp = GrowerParams(num_leaves=255, feature_fraction_bynode=0.5)
    masks_equal = torch.equal(
        node_feature_mask(base.to(dev), key.to(dev), steps.to(dev),
                          gp).cpu(),
        node_feature_mask(base, key, steps, gp))
    require(bits_equal and masks_equal, "threefry: the card's draws differ "
            "from the CPU's")
    rec["threefry_card_equals_cpu"] = True
    # a bagged and an unbagged booster in turns = alone
    params = dict(TRAIN_PARAMS, num_leaves=31, metric=[])
    bagged = dict(params, **MODES_PARITY_SEG)
    ds = built["b"]

    def boosters():
        return [lt.Booster(bagged, ds), lt.Booster(params, ds)]

    solo = []
    for b in boosters():
        for _ in range(3):
            b.update()
        solo.append(b.model_to_string())
        del b
    turns = boosters()
    for _ in range(3):
        for b in turns:
            b.update()
    require([b.model_to_string() for b in turns] == solo and
            solo[0] != solo[1], "a bagged and an unbagged booster in turns "
            "grew other models than alone")
    rec["bagged_in_turns"] = "bit for bit"
    log("modes parity: threefry bits and node masks card = CPU; a bagged "
        "and an unbagged booster in turns grow their solo model texts, bit "
        "for bit")
    return launches, rec


# --------------------------------------------------------------- phase 23
PREDICT_ROWS = 1_000_000
PREDICT_REPS = 20
WALKS_PARAMS = dict(TRAIN_PARAMS, num_leaves=31, boosting="dart",
                    drop_rate=0.5, skip_drop=0.0, learning_rate=0.3)


def route_bytes(bins, stack, trees, num_bin, default_bin, n, C,
                tables=(None, None), packed4=False, wide=False):
    """The bytes P1 must move on these inputs, by the lesser of two counts
    of the bins: each tree's bins along each row's path (the rows' leaves
    by the plain route; a byte a read, packed or not, two for i16) or each
    row's bin columns once (the matrix's byte rows); plus the [C, n]
    float64 scores read and written once and the stack's buffer (records,
    leaf values, bitsets) read once.  ``tables``: the EFB feat_group /
    feat_offset of bundled bins.  Returns (bytes, {path_bytes,
    tile_bytes, scores_bytes, stack_bytes, bin_reads})."""
    import torch
    from lightgbm_tpu_torch.models.device_predict import leaf_depths
    from lightgbm_tpu_torch.ops.predict import route_leaves_plain
    reads = 0
    for t, tree in enumerate(trees):
        leaves = route_leaves_plain(bins, stack, t, num_bin, default_bin, n,
                                    *tables, packed4=packed4, wide=wide)
        depth = torch.from_numpy(leaf_depths(tree)).to(leaves.device)
        reads += int(depth[leaves].sum().item())
    records, _ = stack.records(num_bin.shape[0])
    parts = {"path_bytes": reads * bins.element_size(),
             "tile_bytes": bins.shape[0] * bins.element_size() * n,
             "scores_bytes": 16 * C * n,
             "stack_bytes": records.numel() * records.element_size(),
             "bin_reads": reads}
    nbytes = (min(parts["path_bytes"], parts["tile_bytes"])
              + parts["scores_bytes"] + parts["stack_bytes"])
    return nbytes, parts


def p1_times(bins, stack, num_bin, default_bin, out, trees, tag,
             tables=(None, None), packed4=False):
    """P1 against its plain version on ``bins`` from the values in
    ``out``: bit for bit, a relaunch adding the same again, one launch a
    call; its time (CUDA events over PREDICT_REPS launches; plain 3) in
    turns with the previous design's (tools/p1_time.py prev_route_trees:
    previous, shipped, shipped, previous; the previous design = the
    shipped one bit for bit), the bound from this run's paths by both
    counts (route_bytes) and the mode the shapes chose.  ``tables``: the
    EFB feat_group / feat_offset of bundled bins; ``packed4``: the bins
    hold two columns a byte.  Returns the measurement dict."""
    import torch
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops import predict as tp
    prev = prev_designs()
    C, n = out.shape
    p4 = {"packed4": packed4}
    kname = kernels.variant("route_trees", packed4)
    want = tp.route_trees_plain(bins, stack, num_bin, default_bin,
                                out.clone(), *tables, **p4)
    before = kernels.LAUNCHES[kname]
    got = tp.route_trees(bins, stack, num_bin, default_bin, out.clone(),
                         *tables, **p4)
    torch.cuda.synchronize()
    calls = kernels.LAUNCHES[kname] - before
    require(calls == 1, f"route_trees {tag}: {calls} launches a call")
    require(torch.equal(got, want), f"route_trees {tag}: differs from the "
            "plain version")
    again = tp.route_trees(bins, stack, num_bin, default_bin, got.clone(),
                           *tables, **p4)
    want2 = tp.route_trees_plain(bins, stack, num_bin, default_bin,
                                 want.clone(), *tables, **p4)
    require(torch.equal(again, want2), f"route_trees {tag}: a relaunch "
            "differs from the plain version")
    old = prev.prev_route_trees(bins, stack, num_bin, default_bin,
                                out.clone(), *tables, **p4)
    torch.cuda.synchronize()
    require(torch.equal(old, want), f"route_trees {tag}: the previous "
            "design differs from the plain version")
    scratch = out.clone()

    def shipped():
        return time_ms(lambda i: tp.route_trees(
            bins, stack, num_bin, default_bin, scratch, *tables, **p4),
            PREDICT_REPS)

    def previous():
        return time_ms(lambda i: prev.prev_route_trees(
            bins, stack, num_bin, default_bin, scratch, *tables, **p4),
            PREDICT_REPS)

    turns = [previous(), shipped(), shipped(), previous()]
    ms, prev_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    plain_ms = time_ms(lambda i: tp.route_trees_plain(
        bins, stack, num_bin, default_bin, scratch, *tables, **p4), 3)
    nbytes, parts = route_bytes(bins, stack, trees, num_bin, default_bin,
                                n, C, tables, packed4)
    bound, by = bound_ms(nbytes, float(n) * len(trees))
    path_bound = bound_ms(parts["path_bytes"] + parts["scores_bytes"]
                          + parts["stack_bytes"], 0.0)[0]
    tile_bound = bound_ms(parts["tile_bytes"] + parts["scores_bytes"]
                          + parts["stack_bytes"], 0.0)[0]
    rows, tiled = tp.route_plan(bins.shape[0], bins.element_size())
    rec = {"max_abs_err": float((got - want).abs().max().item()), "ms": ms,
           "prev_ms": prev_ms, "turns_ms": turns, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": by, "path_bound_ms": path_bound,
           "tile_bound_ms": tile_bound, "library_ms": None,
           "launches_a_call": calls, "bytes": nbytes, **parts,
           "mode": "tiled" if tiled else "direct", "rows_a_block": rows,
           "shape": f"{tag}: {n} rows x {bins.shape[0]} columns "
                    f"({bins.dtype}), {len(trees)} trees, C = {C}, "
                    f"max depth {stack.max_depth}"}
    log(f"route_trees {tag}: bit for bit the plain version and the "
        f"previous design, 1 launch a call, {rec['mode']} ({rows} rows a "
        f"block); {ms:.4f} ms (previous design {prev_ms:.4f} ms, plain "
        f"{plain_ms:.2f} ms), bound {bound:.4f} ms ({by}; by the path's "
        f"{parts['bin_reads']} bin reads {path_bound:.4f} ms, by the bin "
        f"rows once {tile_bound:.4f} ms)")
    return rec


def route_kernel_phase(bst, tag="HIGGS training bins"):
    """P1 on a booster's device bins (u8, the padded matrix) with its
    trees, each of class i % C, from the training score: against its
    plain version and timed (p1_times)."""
    import torch
    from lightgbm_tpu_torch.models.device_predict import TreeStack
    gb = bst.gbdt
    trees = gb.models
    C = gb.num_tree_per_iteration
    stack = TreeStack(trees, [i % C for i in range(len(trees))],
                      gb.train_set.num_used_features, gb.device,
                      gb.route_tables[0])
    out = gb.train_score.to(torch.float64).contiguous()
    tables = (gb.fmeta.feat_group, gb.fmeta.feat_offset)
    return p1_times(gb.bins, stack, gb.fmeta.num_bin, gb.fmeta.default_bin,
                    out, trees, tag, tables, packed4=gb.packed4)


def predict_phase(tag, bst, X):
    """Phase 23: Booster.predict of the raw rows ``X`` on the card:
    "auto" and "on" take P1 (the recorded route says so; one launch a
    call), "off" the host walk; raw scores and output (the objective's
    link of the host walk's raw scores) bit for bit; the walls (host
    clock, binning, upload, P1 and fetch); then P1 alone on these i16
    bins (p1_times).  Returns (launches, record)."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.models.device_predict import TreeStack, bin_rows
    from lightgbm_tpu_torch.ops import kernels
    gb = bst.gbdt
    kernels.reset_launches()
    # every tree (num_iteration 0), as P1 alone below takes them
    on_raw, on_raw_s = _timed(lambda: bst.predict(
        X, num_iteration=0, raw_score=True, predict_device="on"))
    route_on = gb.last_predict_route
    on, on_s = _timed(lambda: bst.predict(X, num_iteration=0))
    route_auto = gb.last_predict_route
    launches = dict(kernels.LAUNCHES)
    off_raw, off_raw_s = _timed(lambda: bst.predict(
        X, num_iteration=0, raw_score=True, predict_device="off"))
    # predict's output is its objective's link of the raw scores: the
    # host walk's output without walking the trees again
    off = gb.objective.convert_output(off_raw)
    require(route_on == route_auto == "device" and gb.last_predict_route
            == "host", f"predict {tag}: routes {route_on}, {route_auto}")
    require(launches["route_trees"] == 2, f"predict {tag}: route_trees "
            f"launched {launches['route_trees']} times for 2 calls")
    require(np.array_equal(on_raw, off_raw) and np.array_equal(on, off),
            f"predict {tag}: the card's predictions differ from the host "
            f"walk's (max {np.abs(on_raw - off_raw).max()})")
    require(np.all(np.isfinite(on)) and on.shape == (len(X),),
            f"predict {tag}: output not finite or of shape {on.shape}")
    t0 = time.perf_counter()
    bins = torch.from_numpy(bin_rows(gb.train_set, X)).to(gb.device)
    torch.cuda.synchronize()
    bin_s = time.perf_counter() - t0
    C = gb.num_tree_per_iteration
    trees = gb.models
    stack = TreeStack(trees, [i % C for i in range(len(trees))],
                      gb.train_set.num_used_features, gb.device,
                      gb.route_tables[1])
    out = torch.zeros((C, len(X)), dtype=torch.float64, device=gb.device)
    kernel = p1_times(bins, stack, gb.fmeta.num_bin, gb.fmeta.default_bin,
                      out, trees, f"{tag} predict bins")
    rec = {"rows": len(X), "trees": len(trees),
           "on_raw_s": on_raw_s, "auto_s": on_s, "off_raw_s": off_raw_s,
           "bin_and_upload_s": bin_s, "speedup_raw": off_raw_s / on_raw_s,
           "p1": kernel}
    log(f"predict {tag}: {len(X)} rows x {len(trees)} trees: card "
        f"{on_raw_s:.3f} s (raw), {on_s:.3f} s (auto) = host walk "
        f"{off_raw_s:.3f} s (raw) bit for bit; binning + upload "
        f"{bin_s:.3f} s")
    del bins, out, stack
    return launches, rec


def walks_parity_phase():
    """The training loop's walks on the card (P1: valid scores each
    iteration, DART's drops, rollback, init_model's seeding, a late
    add_valid's replay) against the host walks on the same card booster,
    bit for bit: model texts, training scores, valid scores.  DART
    (drop 0.5) at PARITY_ROWS, 31 leaves, 6 iterations, then 2 more
    from it as init_model; and its seeding and predict on the holdout
    rows, whose bins differ.  Returns the record."""
    import numpy as np
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.models.gbdt import GBDT
    from lightgbm_tpu_torch.ops import kernels
    X, y = higgs_like(PARITY_ROWS + HOLDOUT_ROWS, 23)
    Xh, yh = X[PARITY_ROWS:], y[PARITY_ROWS:]
    X, y = X[:PARITY_ROWS], y[:PARITY_ROWS]

    def run():
        ds = lt.Dataset(X, y)
        va = ds.create_valid(Xh, yh)
        t0 = time.perf_counter()
        bst = lt.train(WALKS_PARAMS, ds, 6, valid_sets=[va],
                       verbose_eval=False)
        bst.rollback_one_iter()
        bst.update()
        cont = lt.train(dict(WALKS_PARAMS, boosting="gbdt"),
                        lt.Dataset(X, y), 2, init_model=bst,
                        verbose_eval=False)
        cont.add_valid(lt.Dataset(Xh, yh, reference=cont.train_set), "late")
        # seeded on other rows: the trees' thresholds fall inside these
        # bins, so the seeding walks the raw rows (Tree.bins_exact)
        other = lt.train(dict(WALKS_PARAMS, boosting="gbdt"),
                         lt.Dataset(Xh, yh), 0, init_model=bst,
                         verbose_eval=False)
        wall = time.perf_counter() - t0
        out = [bst.model_to_string(), bst.gbdt.train_score.cpu().numpy(),
               *bst.gbdt.valid_scores, cont.model_to_string(),
               cont.gbdt.train_score.cpu().numpy(), *cont.gbdt.valid_scores,
               other.gbdt.train_score.cpu().numpy(),
               other.predict(Xh, raw_score=True)]
        return out, wall, sum(bst.gbdt.drop_seconds)

    kernels.reset_launches()
    card, card_s, card_drop = run()
    launches = kernels.LAUNCHES["route_trees"]
    require(launches > 0, "walks parity: P1 did not run")
    on_card = GBDT._walks_on_card
    GBDT._walks_on_card = lambda self: False
    try:
        host, host_s, host_drop = run()
    finally:
        GBDT._walks_on_card = on_card
    for i, (a, b) in enumerate(zip(card, host)):
        same = a == b if isinstance(a, str) else np.array_equal(a, b)
        require(same, f"walks parity: item {i} differs between the card's "
                "walks and the host's")
    rec = {"route_trees_launches": launches, "card_wall_s": card_s,
           "host_wall_s": host_s, "card_drop_s": card_drop,
           "host_drop_s": host_drop}
    log(f"walks parity: DART + rollback + init_model + late add_valid at "
        f"{PARITY_ROWS} rows, card walks = host walks bit for bit "
        f"({launches} P1 launches); wall {card_s:.2f} s against "
        f"{host_s:.2f} s, DART drops {card_drop:.3f} s against "
        f"{host_drop:.3f} s")
    return rec


# ---------------------------------------------------------------- phase 24
EXPO_SEED = 24
EXPO_ITERS = 10
EXPO_PARITY_ROWS = 1_000_000
EXPO_PARITY_ITERS = 3
# card = CPU at PARITY_ROWS: the CPU's multiclass run sets the wall
EXPO_CPU_ITERS = 2
# the JAX package's sparse-at-scale contract (tests/test_sparse_at_scale.py
# :31-67): 10,000 rows x 100,000 block one-hot features at 0.5%
SPARSE_ROWS, SPARSE_BLOCKS, SPARSE_WIDTH = 10_000, 500, 200
SPARSE_PARAMS = dict(objective="binary", num_leaves=7, max_bin=15,
                     min_data_in_leaf=5, verbosity=-1, device_type="cuda")
SPARSE_MAX_GROUPS = 6500
SPARSE_MAX_BYTES = 80 * 1024 * 1024
SPARSE_LOGLOSS_GATE = 0.6915


def host_meta(handle):
    """The dataset's FeatureMeta as host arrays, with its EFB tables (the
    route words' feature columns and bin offsets)."""
    import numpy as np
    from lightgbm_tpu_torch.ops.split import FeatureMeta
    infos = handle.feature_infos()

    def col(k):
        return np.array([getattr(i, k) for i in infos], np.int32)

    return FeatureMeta(col("num_bin"), col("missing_type"),
                       col("default_bin"), None, col("group"),
                       col("offset"))


def expo_kernel_phase(gb, reps=20, plain_reps=3):
    """Phase 24's kernels on the Expo booster's bundled device bins (G
    columns, 256 bins): K2, K1 (root) and K3 (the first tree's root split,
    and a split of a one-hot member stored at a bin offset of 128 or more)
    against their plain versions; K5 with C = 5 class gradient sets; a
    K = 16 frontier round (K6, K7 routed and fused-K) over numeric and
    one-hot members; P1 with the group tables over the trained trees.
    Times, bounds and library calls as in phases 2 and 9.  Returns
    {kernel: measurement dict}."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.models.device_predict import TreeStack
    from lightgbm_tpu_torch.objective import create_objective
    from lightgbm_tpu_torch.ops import histogram as th
    binsT = gb.bins
    G, npad = binsT.shape
    rb, B, n, dev = gb.grower.rb, gb.num_bins, gb.num_data, binsT.device
    nblk = npad // rb
    fm = host_meta(gb.train_set)
    F = len(fm.num_bin)
    obj = create_objective(gb.config)
    obj.init(gb.train_set.metadata, n, dev)
    score0 = torch.full((n,), obj.boost_from_score(), dtype=torch.float32,
                        device=dev)
    grad, hess = obj.get_gradients(score0)
    grad = torch.nn.functional.pad(grad, (0, npad - n))
    hess = torch.nn.functional.pad(hess, (0, npad - n))
    member = torch.zeros(npad, dtype=torch.float32, device=dev)
    member[:n] = 1.0
    w8 = th.pack_channels(grad, hess, member)
    scales = th.fixed_point_scales(w8)
    lid0 = torch.zeros(npad, dtype=torch.int32, device=dev)
    none = np.zeros(8, np.uint32)
    root = gb.models[0]
    f_root = int(root.split_feature_inner[0])
    routes = {"root split": th.pack_route(
        0, 1, f_root, int(root.threshold_in_bin[0]),
        bool(root.decision_type[0] & 2), False, none, fm)}
    # the one-hot member at an offset >= 128 with the most rows: its
    # category (bin 1) goes right
    cands = [j for j in range(F) if fm.feat_offset[j] >= 128
             and fm.num_bin[j] == 2]
    require(cands, "no one-hot member at a bin offset of 128 or more")
    rows_of = [int((binsT[fm.feat_group[j]] == fm.feat_offset[j] + 1).sum())
               for j in cands]
    f_mem = cands[int(np.argmax(rows_of))]
    routes["one-hot member"] = th.pack_route(0, 1, f_mem, 0, False, False,
                                             none, fm)
    require(int(routes["one-hot member"][10]) >= 128,
            "the member's route has no bin offset")
    log(f"expo kernels: G={G} F={F} B={B} Npad={npad} rb={rb}; routes: "
        f"feature {f_root} (column {fm.feat_group[f_root]}, offset "
        f"{fm.feat_offset[f_root]}), member {f_mem} (column "
        f"{fm.feat_group[f_mem]}, offset {fm.feat_offset[f_mem]}, "
        f"{max(rows_of)} rows)")
    res = {}
    err, split_ids = 0, {}
    for rname, route in routes.items():
        want = th.route_window_plain(binsT, lid0.clone(), 0, nblk, route, rb)
        got = [th.route_window(binsT, lid0.clone(), 0, nblk, route, rb)
               for _ in range(2)]
        torch.cuda.synchronize()
        for g in got:
            err = max(err, int((g != want).sum().item()))
        moved = int((want == 1).sum().item())
        require(err == 0 and 0 < moved < n, f"route_window expo {rname}: "
                f"{err} ids differ, {moved} rows moved")
        split_ids[rname] = want
        log(f"route_window expo {rname}: identical, {moved} rows moved")
    res["route_window"] = {"max_abs_err": float(err)}

    want = th.histogram_segment_plain(binsT, w8, lid0, 0, nblk, 0, B, rb)
    a = th.histogram_segment(binsT, w8, lid0, 0, nblk, 0, B, rb, scales)
    b = th.histogram_segment(binsT, w8, lid0, 0, nblk, 0, B, rb, scales)
    torch.cuda.synchronize()
    require(torch.equal(a, b), "histogram_segment expo: a second launch "
            "differs from the first")
    err = check_hist("histogram_segment expo root", a, want, hist_abs_sums(
        th, binsT, w8, lid0, 0, nblk, 0, B, rb))
    res["histogram_segment"] = {"max_abs_err": err}

    err = 0.0
    for rname, route in routes.items():
        want_lid, want = th.histogram_segment_routed_plain(
            binsT, w8, lid0.clone(), 0, nblk, 1, route, B, rb)
        runs = []
        for _ in range(2):
            ids = lid0.clone()
            runs.append(th.histogram_segment_routed(binsT, w8, ids, 0, nblk,
                                                    1, route, B, rb, scales))
        torch.cuda.synchronize()
        require(torch.equal(runs[0][1], runs[1][1]) and all(
            torch.equal(r[0], want_lid) for r in runs),
            f"histogram_segment_routed expo {rname}: ids differ or a "
            "relaunch differs")
        err = max(err, check_hist(
            f"histogram_segment_routed expo {rname}", runs[0][1], want,
            hist_abs_sums(th, binsT, w8, want_lid, 0, nblk, 1, B, rb)))
        # the step entry reads the same route from device memory
        step = th.pack_step(0, nblk, 1, route).to(dev)
        ids = lid0.clone()
        _, got = th.histogram_segment_routed_step(binsT, w8, ids, step, B,
                                                  rb, scales)
        torch.cuda.synchronize()
        require(torch.equal(ids, want_lid) and torch.equal(got, runs[0][1]),
                f"histogram_segment_routed_step expo {rname}: differs from "
                "the by-value entry")
        log(f"histogram_segment_routed expo {rname}: ids identical, counts "
            f"exact, max |diff| {err:.3g}; the step entry bit for bit")
    res["histogram_segment_routed"] = {"max_abs_err": err}

    # times at the first split (the root split's route)
    route = routes["root split"]
    moved = int((split_ids["root split"] == 1).sum().item())
    W, out_bytes = npad, G * B * 3 * 4
    t = res["histogram_segment"]
    t["ms"] = time_ms(lambda i: th.histogram_segment(
        binsT, w8, lid0, 0, nblk, 0, B, rb, scales), reps)
    t["plain_ms"] = time_ms(lambda i: th.histogram_segment_plain(
        binsT, w8, lid0, 0, nblk, 0, B, rb), plain_reps)
    t["bound_ms"], t["bound_by"] = bound_ms(W * (G + 14) + out_bytes,
                                            W * G * 3)
    t["library_ms"] = library_hist_ms(binsT, [w8], torch.arange(
        n, device=dev), B, reps)
    t["shape"] = f"Expo root: {W} rows x {G} bundled columns, {B} bins"
    t = res["histogram_segment_routed"]
    fresh = [lid0.clone() for _ in range(reps + 1)]
    t["ms"] = time_ms(lambda i: th.histogram_segment_routed(
        binsT, w8, fresh[i], 0, nblk, 1, route, B, rb, scales), reps)
    fresh = [lid0.clone() for _ in range(plain_reps + 1)]
    t["plain_ms"] = time_ms(lambda i: th.histogram_segment_routed_plain(
        binsT, w8, fresh[i], 0, nblk, 1, route, B, rb), plain_reps)
    t["bound_ms"], t["bound_by"] = bound_ms(
        W * 5 + moved * 4 + moved * (G - 1 + 10) + out_bytes,
        W * 20 + moved * G * 3)
    t["library_ms"] = library_hist_ms(binsT, [w8], torch.nonzero(
        split_ids["root split"] == 1)[:, 0], B, reps)
    t["shape"] = f"Expo first split: {W} rows, {moved} routed"
    t = res["route_window"]
    fresh = [lid0.clone() for _ in range(reps + 1)]
    t["ms"] = time_ms(lambda i: th.route_window(
        binsT, fresh[i], 0, nblk, route, rb), reps)
    fresh = [lid0.clone() for _ in range(plain_reps + 1)]
    t["plain_ms"] = time_ms(lambda i: th.route_window_plain(
        binsT, fresh[i], 0, nblk, route, rb), plain_reps)
    t["bound_ms"], t["bound_by"] = bound_ms(W * 5 + moved * 4, W * 20)
    t["library_ms"] = None
    t["shape"] = f"Expo first split: {W} rows, {moved} routed"
    del fresh

    # K5: five class gradient sets at random scores (made from a seed)
    gen = torch.Generator(device=dev).manual_seed(24)
    p = torch.softmax(torch.randn((MC_CLASSES, npad), generator=gen,
                                  device=dev), dim=0)
    lab = torch.randint(0, MC_CLASSES, (npad,), generator=gen, device=dev)
    w8C = th.pack_channel_sets(
        (p - torch.nn.functional.one_hot(lab, MC_CLASSES).T) * member,
        2.0 * p * (1.0 - p) * member, member)
    del p, lab
    err5, scales5 = check_histogram_all(th, binsT, w8C, B, rb, "Expo rows")
    C = MC_CLASSES
    t = {"max_abs_err": err5}
    t["ms"] = time_ms(lambda i: th.histogram_all(binsT, w8C, B, scales5),
                      reps)
    t["plain_ms"] = time_ms(lambda i: th.histogram_all_plain(binsT, w8C, B),
                            plain_reps)
    t["bound_ms"], t["bound_by"] = bound_ms(W * (G + 10 * C)
                                            + C * out_bytes, W * G * C * 3)
    t["library_ms"] = library_hist_ms(
        binsT, [w8C[8 * c:8 * c + 8] for c in range(C)],
        torch.arange(n, device=dev), B, reps)
    t["shape"] = f"Expo: {W} rows x {G} columns x {C} sets, {B} bins"
    res["histogram_all"] = t
    del w8C

    # a K = 16 frontier round: numeric features and one-hot members (a
    # member's category goes right)
    members = [j for j in range(F) if fm.feat_offset[j] > 0
               and fm.num_bin[j] == 2]
    feats = [(j, False) for j in range(4)] + [
        (members[k * len(members) // 12], False) for k in range(12)]
    # (the plain round walks every listed row a slot: one timed call)
    res.update(frontier_round(
        th, binsT, w8, scales, fm, feats, rb, 16, 5, B, "Expo", reps, 1,
        thr=lambda f: 0 if fm.num_bin[f] == 2
        else int(fm.num_bin[f]) // 2))

    # P1 with the group tables over the trained trees, from the training
    # score
    stack = TreeStack(gb.models, [0] * len(gb.models), F, dev,
                      gb.route_tables[0])
    res["route_trees"] = p1_times(
        binsT, stack, gb.fmeta.num_bin, gb.fmeta.default_bin,
        gb.train_score.to(torch.float64).contiguous(), gb.models,
        "Expo training bins", (gb.fmeta.feat_group, gb.fmeta.feat_offset))
    del w8, grad, hess, member, lid0, split_ids
    torch.cuda.empty_cache()
    return res


def expo_like_labels5(X, seed: int):
    """A 5-class label of Expo-shaped rows: (month + day of week) mod 5,
    a third of the rows drawn at random."""
    import numpy as np
    rng = np.random.RandomState(seed)
    month = np.asarray(X[:, 4:16].argmax(axis=1)).ravel()
    dow = np.asarray(X[:, 47:54].argmax(axis=1)).ravel()
    y = (month + dow) % 5
    noise = rng.uniform(size=len(y)) < 1.0 / 3.0
    y[noise] = rng.randint(0, 5, int(noise.sum()))
    return y.astype(np.float64)


def expo_phase():
    """Phase 24: Expo-shaped one-hot data from CSR at full width.  Returns
    (launches of the 11M run, record, the kernel measurements)."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import kernels
    rec = {}
    t0 = time.perf_counter()
    X, y = expo_like(EXPO_ROWS + EXPO_HOLDOUT, EXPO_SEED)
    Xh, yh = X[EXPO_ROWS:], y[EXPO_ROWS:]
    X, y = X[:EXPO_ROWS], y[:EXPO_ROWS]
    rec["generate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = lt.Dataset(X, y)
    ds.construct(lt.Config.from_params(EXPO_PARAMS))
    rec["bin_and_bundle_s"] = time.perf_counter() - t0
    h = ds._handle
    require(h.bundle is not None and h.num_used_features > 690,
            f"Expo: {h.num_used_features} used features, bundle "
            f"{h.bundle is not None}")
    sizes = [len(g) for g in h.bundle.groups]
    rec.update(rows=EXPO_ROWS, nnz=int(X.nnz), positive=float(y.mean()),
               features=int(h.num_used_features), columns=h.num_columns,
               group_sizes=sizes, column_bins=h.column_bins.tolist(),
               bundled_bytes=int(h.bins_t.nbytes),
               unbundled_bytes=int(h.num_used_features) * EXPO_ROWS,
               dense_f64_bytes=8 * EXPO_ROWS * X.shape[1])
    log(f"expo: {EXPO_ROWS} x {X.shape[1]} CSR ({X.nnz} nonzeros, "
        f"{rec['positive']:.3f} positive) generated in "
        f"{rec['generate_s']:.1f} s, binned and bundled in "
        f"{rec['bin_and_bundle_s']:.1f} s: {h.num_used_features} features "
        f"in {h.num_columns} columns (groups of {sizes}), "
        f"{rec['bundled_bytes'] / 1e9:.3f} GB of bins against "
        f"{rec['unbundled_bytes'] / 1e9:.2f} GB unbundled")
    va = ds.create_valid(Xh, yh)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    evals = {}
    bst, wall = _timed(lambda: lt.train(
        EXPO_PARAMS, ds, EXPO_ITERS, valid_sets=[va], evals_result=evals,
        verbose_eval=False))
    launches = dict(kernels.LAUNCHES)
    gb = bst.gbdt
    auc = evals["valid_0"]["auc"]
    rec.update(train_s=wall, iter_seconds=list(gb.iter_seconds),
               median_iter_s=float(np.median(gb.iter_seconds)),
               holdout_auc=auc,
               peak_device_bytes=int(torch.cuda.max_memory_allocated()),
               launches=launches)
    log(f"expo: {EXPO_ITERS} iterations in {wall:.1f} s, median iteration "
        f"{rec['median_iter_s']:.3f} s, holdout AUC "
        f"{[round(a, 5) for a in auc]}, peak device memory "
        f"{rec['peak_device_bytes'] / 1e9:.2f} GB")
    require(gb.fmeta.gather_idx is not None and gb.bins.shape[0]
            == h.num_columns and gb.num_bins == 256,
            "the Expo booster does not train on the bundled columns")
    require(all(np.isfinite(auc)) and auc[-1] > auc[0] + 0.01,
            f"Expo: holdout AUC does not rise: {auc}")
    require(launches["histogram_segment_routed_step"] > 0
            and launches["score_gather_add"] == EXPO_ITERS
            and launches["route_trees"] >= EXPO_ITERS,
            f"Expo did not run the path's kernels: {launches}")
    # the card's valid scores (P1 over the holdout's bundled bins, one
    # launch an iteration) = the host walk over the same bins
    vh = va._handle
    infos = h.feature_infos()
    host = np.full(vh.num_data, gb.init_scores[0])
    for tree in gb.models:
        host += tree.predict_binned(vh.bins_t, infos)
    require(np.array_equal(gb.valid_scores[0], host),
            "Expo: the card's valid scores differ from the host walk "
            f"(max {np.abs(gb.valid_scores[0] - host).max()})")
    on, on_s = _timed(lambda: bst.predict(Xh, raw_score=True,
                                          predict_device="on"))
    route_on = gb.last_predict_route
    off, off_s = _timed(lambda: bst.predict(Xh, raw_score=True,
                                            predict_device="off"))
    require(route_on == "device" and gb.last_predict_route == "host"
            and np.array_equal(on, off), "Expo: predict on differs from "
            f"off (max {np.abs(on - off).max()})")
    rec.update(predict_on_s=on_s, predict_off_s=off_s)
    log(f"expo: valid scores = the host walk bit for bit; predict of the "
        f"{EXPO_HOLDOUT} holdout rows on = off bit for bit ({on_s:.2f} s "
        f"against {off_s:.2f} s)")
    del X, y, Xh, yh, va
    t0 = time.perf_counter()
    kern = expo_kernel_phase(gb)
    rec["kernels_s"] = time.perf_counter() - t0
    del bst, gb, ds, h
    torch.cuda.empty_cache()
    return launches, rec, kern


def expo_bundle_parity_phase():
    """Phase 24: bundling is lossless at max_conflict_rate = 0 when the
    binning sample is every row (no row holds two members of a group off
    their default): at 1M Expo rows, enable_bundle on and off grow the
    same splits (gain > 1e-2) and training scores within 1e-3."""
    import numpy as np
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops.split import reconstruct_feature_column
    X, y = expo_like(EXPO_PARITY_ROWS, 25)
    params = dict(EXPO_PARAMS, bin_construct_sample_cnt=EXPO_PARITY_ROWS,
                  metric=[])
    out = {}
    for bundle in (True, False):
        p = dict(params, enable_bundle=bundle)
        t0 = time.perf_counter()
        ds = lt.Dataset(X, y)
        ds.construct(lt.Config.from_params(p))
        bin_s = time.perf_counter() - t0
        bst, wall = _timed(lambda: lt.train(p, ds, EXPO_PARITY_ITERS,
                                            verbose_eval=False))
        out[bundle] = (bst.gbdt, bin_s, wall)
    bg, ug = out[True][0], out[False][0]
    require(bg.train_set.bundle is not None
            and ug.train_set.bundle is None, "expo parity: the layouts")
    # every feature's bins read out of its column = its own column
    bad = 0
    for j in range(len(bg.fmeta.num_bin)):
        col = reconstruct_feature_column(
            bg.bins[int(bg.fmeta.feat_group[j])], j, bg.fmeta)
        bad += int((col != ug.bins[j].int()).sum().item())
    require(bad == 0, f"expo parity: {bad} bins lost to conflicts")
    n = _same_splits(bg.models, ug.models, "expo bundled / unbundled")
    diff = float((bg.train_score - ug.train_score).abs().max().item())
    require(n >= 100 and diff < 1e-3, f"expo parity: {n} splits compared, "
            f"training scores differ by {diff}")
    rec = {"rows": EXPO_PARITY_ROWS, "splits_compared": n,
           "max_score_diff": diff,
           "bundled": {"columns": bg.bins.shape[0], "bin_s": out[True][1],
                       "train_s": out[True][2],
                       "iter_seconds": list(bg.iter_seconds)},
           "unbundled": {"columns": ug.bins.shape[0], "bin_s": out[False][1],
                         "train_s": out[False][2],
                         "iter_seconds": list(ug.iter_seconds)}}
    log(f"expo parity: {EXPO_PARITY_ROWS} rows, bundled ({bg.bins.shape[0]} "
        f"columns) = unbundled ({ug.bins.shape[0]}): no bin lost, {n} "
        f"splits equal, scores within {diff:.3g}; iterations "
        f"{np.median(bg.iter_seconds):.3f} s against "
        f"{np.median(ug.iter_seconds):.3f} s")
    return rec


def expo_cpu_parity_phase():
    """Phase 24: card = CPU at 200k Expo rows from CSR, 31 leaves,
    EXPO_CPU_ITERS iterations: the segment grower fused and unfused, the
    frontier grower at K = 16 and 5-class multiclass (K5) on the same
    rows."""
    import numpy as np
    import lightgbm_tpu_torch as lt
    X, y = expo_like(PARITY_ROWS, 26)
    y5 = expo_like_labels5(X, 27)
    base = dict(EXPO_PARAMS, num_leaves=31, metric=[])
    cases = {"fused": (y, base, {}),
             "unfused": (y, base, {"fused_route": False}),
             "frontier": (y, dict(base, tpu_tree_impl="frontier",
                                  tpu_frontier_width=16), {}),
             "multiclass": (y5, dict(base, objective="multiclass",
                                     num_class=5), {})}
    rec = {}
    for name, (yc, params, kw) in cases.items():
        ds = lt.Dataset(X, yc)
        ds.construct(lt.Config.from_params(dict(params, device_type="cpu")))
        require(ds._handle.bundle is not None, f"expo {name}: no bundle")
        out, times = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            bst = lt.Booster(dict(params, device_type=dev), ds, **kw)
            for _ in range(EXPO_CPU_ITERS):
                bst.update()
            out[dev] = bst.gbdt
            times[dev] = time.perf_counter() - t0
        n, ties = _same_splits_near_tie(out["cuda"].models,
                                        out["cpu"].models, f"expo {name}")
        diff = float(np.abs(out["cuda"].train_score.cpu().numpy()
                            - out["cpu"].train_score.numpy()).max())
        require(n >= 30 and diff < 1e-3, f"expo {name}: {n} splits "
                f"compared, card and CPU scores differ by {diff}")
        rec[name] = {"splits_compared": n, "near_ties": ties,
                     "max_score_diff": diff, "card_s": times["cuda"],
                     "cpu_s": times["cpu"]}
        log(f"expo parity {name}: card = CPU on {n} splits (near ties "
            f"{ties}), scores within {diff:.3g}; card {times['cuda']:.1f} s,"
            f" CPU {times['cpu']:.1f} s")
    return rec


def sparse_at_scale_phase():
    """Phase 24: the JAX package's sparse-at-scale contract on the card
    (tests/test_sparse_at_scale.py:31-67): 10,000 x 100,000 block one-hot
    at 0.5% from CSR, max_bin 15, 7 leaves, 4 rounds: at most 6500
    columns, at most 80 MB of bins, log loss on the first 1000 rows under
    0.6915.  Returns (launches, record)."""
    import numpy as np
    import scipy.sparse as sp
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import kernels
    rng = np.random.RandomState(31)
    n, F = SPARSE_ROWS, SPARSE_BLOCKS * SPARSE_WIDTH
    cols = (np.arange(SPARSE_BLOCKS) * SPARSE_WIDTH + rng.randint(
        0, SPARSE_WIDTH, size=(n, SPARSE_BLOCKS))).ravel()
    X = sp.csr_matrix((rng.uniform(1.0, 2.0, size=n * SPARSE_BLOCKS),
                       (np.repeat(np.arange(n), SPARSE_BLOCKS), cols)),
                      shape=(n, F))
    y = np.asarray(X[:, :SPARSE_WIDTH].sum(axis=1)
                   - X[:, SPARSE_WIDTH:2 * SPARSE_WIDTH].sum(axis=1)).ravel()
    yb = (y > np.median(y)).astype(np.float64)
    t0 = time.perf_counter()
    ds = lt.Dataset(X, yb, params=SPARSE_PARAMS)
    ds.construct(lt.Config.from_params(SPARSE_PARAMS))
    bin_s = time.perf_counter() - t0
    h = ds._handle
    G = h.num_columns
    require(h.bundle is not None and G <= SPARSE_MAX_GROUPS
            and h.bins_t.nbytes <= SPARSE_MAX_BYTES,
            f"sparse at scale: {G} columns, {h.bins_t.nbytes} bytes")
    kernels.reset_launches()
    bst, wall = _timed(lambda: lt.train(SPARSE_PARAMS, ds, 4,
                                        verbose_eval=False))
    launches = dict(kernels.LAUNCHES)
    p = bst.predict(X[:1000])
    ll = float(-np.mean(yb[:1000] * np.log(p + 1e-9)
                        + (1 - yb[:1000]) * np.log(1 - p + 1e-9)))
    require(ll < SPARSE_LOGLOSS_GATE, f"sparse at scale: log loss {ll}")
    require(launches["histogram_segment_routed_step"]
            + launches["histogram_segment_routed_step_packed4"] > 0,
            f"sparse at scale did not launch K3: {launches}")
    rec = {"rows": n, "features": F, "columns": G,
           "bin_bytes": int(h.bins_t.nbytes), "bin_s": bin_s,
           "train_s": wall, "iter_seconds": list(bst.gbdt.iter_seconds),
           "logloss_1000": ll, "launches": launches}
    log(f"sparse at scale: {n} x {F} ({X.nnz} nonzeros) binned in "
        f"{bin_s:.1f} s into {G} columns ({h.bins_t.nbytes / 1e6:.1f} MB), "
        f"4 rounds in {wall:.2f} s, log loss {ll:.4f} < "
        f"{SPARSE_LOGLOSS_GATE}")
    return launches, rec


# ---------------------------------------------------------------- phase 25
P4_PARAMS = dict(TRAIN_PARAMS, max_bin=15)
P4_ITERS = 3
P4_PARITY_ROWS = 1_000_000
P4_RUNS = (("fused", {}, {}),
           ("unfused", {}, {"fused_route": False}),
           ("frontier", {"tpu_tree_impl": "frontier"}, {}),
           ("multiclass", {"objective": "multiclass",
                           "num_class": MC_CLASSES,
                           "metric": ["multi_logloss"]}, {}))
# the kernel each run's path must launch (packed) and, where the run has
# one, its split kernel
P4_RUN_KERNEL = {"fused": "histogram_segment_routed_step",
                 "unfused": "histogram_segment_step",
                 "frontier": "histogram_frontier",
                 "multiclass": "histogram_all"}
P4_TIERS = ("off", "k1", "fusedk")


def packed4_kernel_phase(gb, reps=20, plain_reps=1):
    """Phase 25's kernels on the packed HIGGS bins of a max_bin 15 booster
    ([14, Npad], 16 bins): K2, K1 (root) and K3 (the first tree's root
    split and a split on the other nibble of its byte), the K1/K2/K3 step
    entries at that split, K5 (5 class sets), a K = 16 frontier round (K6,
    K7 routed and fused-K) and P1 over the trained trees, each against
    its plain version on the packed bins and against the same kernel on
    the unpacked bins (bit for bit over the 28 columns: the sums are fixed
    point, the layout cannot move them), timed beside the unpacked kernel
    (``unpacked_ms``).  The unpacked [28, Npad] copy is made for these
    comparisons only, after training.  Returns {kernel: measurement
    dict}."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.models.device_predict import TreeStack
    from lightgbm_tpu_torch.objective import create_objective
    from lightgbm_tpu_torch.ops import histogram as th
    binsT = gb.bins
    P, npad = binsT.shape
    G = gb.train_set.num_columns
    rb, B, n, dev = gb.grower.rb, gb.num_bins, gb.num_data, binsT.device
    H, nblk = 2 * P, npad // rb
    flat = th.unpack_bins_4bit(binsT)[:G].contiguous()
    fm = host_meta(gb.train_set)
    obj = create_objective(gb.config)
    obj.init(gb.train_set.metadata, n, dev)
    score0 = torch.full((n,), obj.boost_from_score(), dtype=torch.float32,
                        device=dev)
    grad, hess = obj.get_gradients(score0)
    grad = torch.nn.functional.pad(grad, (0, npad - n))
    hess = torch.nn.functional.pad(hess, (0, npad - n))
    member = torch.zeros(npad, dtype=torch.float32, device=dev)
    member[:n] = 1.0
    w8 = th.pack_channels(grad, hess, member)
    scales = th.fixed_point_scales(w8)
    lid0 = torch.zeros(npad, dtype=torch.int32, device=dev)
    none = np.zeros(8, np.uint32)
    root = gb.models[0]
    f0 = int(root.split_feature_inner[0])
    splits = {"root split": (f0, int(root.threshold_in_bin[0]),
                             bool(root.decision_type[0] & 2)),
              "other nibble": (f0 ^ 1, int(fm.num_bin[f0 ^ 1]) // 2, False)}
    routes = {k: {p4: th.pack_route(0, 1, f, t, dl, False, none, fm, p4)
                  for p4 in (True, False)}
              for k, (f, t, dl) in splits.items()}
    log(f"packed4 kernels: G={G} in {P} byte rows, B={B} Npad={npad} "
        f"rb={rb}; routes on columns {f0} and {f0 ^ 1}")
    res, split_ids = {}, {}

    def same(tag, packed, unpacked):
        require(torch.equal(packed, unpacked),
                f"{tag}: the packed kernel differs from the unpacked one")

    err = 0
    for rname, r in routes.items():
        want = th.route_window_plain(binsT, lid0.clone(), 0, nblk, r[True],
                                     rb, True)
        got = [th.route_window(binsT, lid0.clone(), 0, nblk, r[True], rb,
                               True) for _ in range(2)]
        unp = th.route_window(flat, lid0.clone(), 0, nblk, r[False], rb)
        torch.cuda.synchronize()
        for g in got:
            err = max(err, int((g != want).sum().item()))
        same(f"route_window packed4 {rname}", got[0], unp)
        moved = int((want == 1).sum().item())
        require(err == 0 and 0 < moved < n, f"route_window packed4 {rname}: "
                f"{err} ids differ, {moved} rows moved")
        split_ids[rname] = want
    res["route_window"] = {"max_abs_err": float(err)}

    a = th.histogram_segment(binsT, w8, lid0, 0, nblk, 0, B, rb, scales,
                             True)
    b = th.histogram_segment(binsT, w8, lid0, 0, nblk, 0, B, rb, scales,
                             True)
    unp = th.histogram_segment(flat, w8, lid0, 0, nblk, 0, B, rb, scales)
    torch.cuda.synchronize()
    require(torch.equal(a, b), "histogram_segment packed4: a second launch "
            "differs from the first")
    same("histogram_segment packed4", a[:G], unp)
    want = th.histogram_segment_plain(binsT, w8, lid0, 0, nblk, 0, B, rb,
                                      True)
    res["histogram_segment"] = {"max_abs_err": check_hist(
        "histogram_segment packed4 root", a, want, hist_abs_sums(
            th, binsT, w8, lid0, 0, nblk, 0, B, rb, True))}

    err = 0.0
    for rname, r in routes.items():
        want_lid, want = th.histogram_segment_routed_plain(
            binsT, w8, lid0.clone(), 0, nblk, 1, r[True], B, rb, True)
        runs = [th.histogram_segment_routed(binsT, w8, lid0.clone(), 0, nblk,
                                            1, r[True], B, rb, scales, True)
                for _ in range(2)]
        ul, uh = th.histogram_segment_routed(flat, w8, lid0.clone(), 0, nblk,
                                             1, r[False], B, rb, scales)
        torch.cuda.synchronize()
        require(torch.equal(runs[0][1], runs[1][1]) and all(
            torch.equal(x[0], want_lid) for x in runs),
            f"histogram_segment_routed packed4 {rname}: ids differ or a "
            "relaunch differs")
        same(f"histogram_segment_routed packed4 {rname}", runs[0][1][:G], uh)
        same(f"histogram_segment_routed packed4 {rname} ids", runs[0][0], ul)
        err = max(err, check_hist(
            f"histogram_segment_routed packed4 {rname}", runs[0][1], want,
            hist_abs_sums(th, binsT, w8, want_lid, 0, nblk, 1, B, rb, True)))
    res["histogram_segment_routed"] = {"max_abs_err": err}
    # the step entries at the first split, a late window and an empty one
    r = routes["root split"][True]
    steps = check_step_entries(th, binsT, w8, scales, lid0, B, rb, (
        ("first split", 0, nblk, 1, r), ("late window", nblk - 2, 2, 1, r),
        ("empty window", 3, 0, 1, r)), "HIGGS packed4", packed4=True)
    for name, e in steps.items():
        res[name] = {"max_abs_err": float(e)}
    log(f"packed4 kernels: K1, K2 and K3 (by value and step entries) = "
        f"their plain versions and = the unpacked kernels bit for bit")

    # times at the first split; bounds at the packed bytes (P bytes of
    # bins a row instead of G)
    ids1 = split_ids["root split"]
    moved = int((ids1 == 1).sum().item())
    W, out_bytes = npad, H * B * 3 * 4
    step = th.pack_step(0, nblk, 1, r).to(dev)
    fr = routes["root split"][False]
    fstep = th.pack_step(0, nblk, 1, fr).to(dev)

    def timed(name, call, flat_call, plain, nbytes, flat_bytes, nops, rows,
              shape, fresh=False, start=lid0):
        """Times of kernel ``name`` from the leaf ids ``start`` (a copy a
        call where the call routes them)."""
        t = res[name]
        ids = ([start.clone() for _ in range(reps + 1)] if fresh
               else [start] * (reps + 1))
        t["ms"] = time_ms(lambda i: call(ids[i]), reps)
        t["unpacked_ms"] = time_ms(lambda i: flat_call(ids[i]), reps)
        ids = ([start.clone() for _ in range(plain_reps + 1)] if fresh
               else [start] * (plain_reps + 1))
        t["plain_ms"] = time_ms(lambda i: plain(ids[i]), plain_reps)
        t["bound_ms"], t["bound_by"] = bound_ms(nbytes, nops)
        t["unpacked_bound_ms"] = bound_ms(flat_bytes, nops)[0]
        t["library_ms"] = (None if rows is None
                           else library_hist_ms(flat, [w8], rows, B, reps))
        t["shape"] = shape
        log(f"{name} packed4: {t['ms']:.4f} ms (unpacked "
            f"{t['unpacked_ms']:.4f} ms, plain {t['plain_ms']:.2f} ms), "
            f"bound {t['bound_ms']:.4f} ms at {P} bytes a row (unpacked "
            f"{t['unpacked_bound_ms']:.4f} ms)")

    everyone = torch.arange(n, device=dev)
    routed_rows = torch.nonzero(ids1 == 1)[:, 0]
    timed("histogram_segment",
          lambda ids: th.histogram_segment(binsT, w8, ids, 0, nblk, 0, B, rb,
                                           scales, True),
          lambda ids: th.histogram_segment(flat, w8, ids, 0, nblk, 0, B, rb,
                                           scales),
          lambda ids: th.histogram_segment_plain(binsT, w8, ids, 0, nblk, 0,
                                                 B, rb, True),
          W * (P + 14) + out_bytes, W * (G + 14) + out_bytes, W * G * 3,
          everyone, f"HIGGS root: {W} rows x {G} columns in {P} bytes, "
          f"{B} bins")
    split_bytes = (W * 5 + moved * 4 + moved * (P - 1 + 10) + out_bytes,
                   W * 5 + moved * 4 + moved * (G - 1 + 10) + out_bytes,
                   W * 20 + moved * G * 3)
    timed("histogram_segment_routed",
          lambda ids: th.histogram_segment_routed(binsT, w8, ids, 0, nblk, 1,
                                                  r, B, rb, scales, True),
          lambda ids: th.histogram_segment_routed(flat, w8, ids, 0, nblk, 1,
                                                  fr, B, rb, scales),
          lambda ids: th.histogram_segment_routed_plain(
              binsT, w8, ids, 0, nblk, 1, r, B, rb, True),
          *split_bytes, routed_rows,
          f"HIGGS first split: {W} rows, {moved} routed", fresh=True)
    timed("histogram_segment_routed_step",
          lambda ids: th.histogram_segment_routed_step(
              binsT, w8, ids, step, B, rb, scales, packed4=True),
          lambda ids: th.histogram_segment_routed_step(
              flat, w8, ids, fstep, B, rb, scales),
          lambda ids: th.histogram_segment_routed_step_plain(
              binsT, w8, ids, step, B, rb, True),
          *split_bytes, routed_rows,
          f"HIGGS first split: {W} rows, {moved} routed", fresh=True)
    for name, by_value in (("route_window", False),
                           ("route_window_step", True)):
        timed(name,
              (lambda ids: th.route_window_step(binsT, ids, step, rb, True))
              if by_value else (lambda ids: th.route_window(
                  binsT, ids, 0, nblk, r, rb, True)),
              (lambda ids: th.route_window_step(flat, ids, fstep, rb))
              if by_value else (lambda ids: th.route_window(
                  flat, ids, 0, nblk, fr, rb)),
              lambda ids: th.route_window_plain(binsT, ids, 0, nblk, r, rb,
                                                True),
              W * 5 + moved * 4, W * 5 + moved * 4, W * 20, None,
              f"HIGGS first split: {W} rows, {moved} routed", fresh=True)
    # K1 over the routed ids, as the unfused split runs it after K2
    timed("histogram_segment_step",
          lambda ids: th.histogram_segment_step(binsT, w8, ids, step, B, rb,
                                                scales, packed4=True),
          lambda ids: th.histogram_segment_step(flat, w8, ids, fstep, B, rb,
                                                scales),
          lambda ids: th.histogram_segment_step_plain(binsT, w8, ids, step,
                                                      B, rb, True),
          W * 4 + moved * (P + 10) + out_bytes,
          W * 4 + moved * (G + 10) + out_bytes, moved * G * 3, routed_rows,
          f"HIGGS first split's smaller child: {W} rows, {moved} in it",
          start=ids1)

    # K5: five class gradient sets at random scores (made from a seed)
    C = MC_CLASSES
    gen = torch.Generator(device=dev).manual_seed(25)
    p = torch.softmax(torch.randn((C, npad), generator=gen, device=dev),
                      dim=0)
    lab = torch.randint(0, C, (npad,), generator=gen, device=dev)
    w8C = th.pack_channel_sets(
        (p - torch.nn.functional.one_hot(lab, C).T) * member,
        2.0 * p * (1.0 - p) * member, member)
    del p, lab
    err5, scales5 = check_histogram_all(th, binsT, w8C, B, rb,
                                        "HIGGS packed4", True)
    unp = th.histogram_all(flat, w8C, B, scales5)
    a = th.histogram_all(binsT, w8C, B, scales5, True)
    torch.cuda.synchronize()
    same("histogram_all packed4", a[:, :G], unp)
    t = {"max_abs_err": err5}
    t["ms"] = time_ms(lambda i: th.histogram_all(binsT, w8C, B, scales5,
                                                 True), reps)
    t["unpacked_ms"] = time_ms(lambda i: th.histogram_all(flat, w8C, B,
                                                          scales5), reps)
    t["plain_ms"] = time_ms(lambda i: th.histogram_all_plain(
        binsT, w8C, B, True), plain_reps)
    t["bound_ms"], t["bound_by"] = bound_ms(W * (P + 10 * C)
                                            + C * out_bytes, W * G * C * 3)
    t["unpacked_bound_ms"] = bound_ms(W * (G + 10 * C) + C * out_bytes,
                                      W * G * C * 3)[0]
    t["library_ms"] = library_hist_ms(
        flat, [w8C[8 * c:8 * c + 8] for c in range(C)], everyone, B, reps)
    t["shape"] = f"HIGGS: {W} rows x {G} columns in {P} bytes x {C} sets"
    res["histogram_all"] = t
    log(f"histogram_all packed4: {t['ms']:.4f} ms (unpacked "
        f"{t['unpacked_ms']:.4f} ms), bound {t['bound_ms']:.4f} ms")
    del w8C, a, unp

    # a K = 16 frontier round, each kernel also against the unpacked one
    res.update(frontier_round(
        th, binsT, w8, scales, fm, [(f, False) for f in range(G)], rb, 16, 5,
        B, "HIGGS packed4", reps, plain_reps, packed4=True))

    # P1 over the packed training bins with the trained trees, from the
    # training score; = P1 over the unpacked bins
    stack = TreeStack(gb.models, [0] * len(gb.models), G, dev,
                      gb.route_tables[0])
    start = gb.train_score.to(torch.float64).contiguous()
    res["route_trees"] = p1_times(
        binsT, stack, gb.fmeta.num_bin, gb.fmeta.default_bin, start,
        gb.models, "HIGGS packed training bins", packed4=True)
    from lightgbm_tpu_torch.ops import predict as tp
    got = tp.route_trees(binsT, stack, gb.fmeta.num_bin,
                         gb.fmeta.default_bin, start.clone(), packed4=True)
    unp = tp.route_trees(flat, stack, gb.fmeta.num_bin,
                         gb.fmeta.default_bin, start.clone())
    torch.cuda.synchronize()
    same("route_trees packed4", got, unp)
    scratch = start.clone()
    res["route_trees"]["unpacked_ms"] = time_ms(lambda i: tp.route_trees(
        flat, stack, gb.fmeta.num_bin, gb.fmeta.default_bin, scratch),
        PREDICT_REPS)
    del flat, w8, grad, hess, member, split_ids, got, unp, scratch
    torch.cuda.empty_cache()
    return res


def packed4_phase(X, y, Xh, yh):
    """Phase 25: HIGGS at max_bin 15 (16 bins) on the 4-bit packed layout,
    on phase 3's rows.  Returns ({run: launches}, record, the kernel
    measurements)."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.models.gbdt import block_rows, resolve_device
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import kernels
    rec = {}
    t0 = time.perf_counter()
    config = lt.Config.from_params(P4_PARAMS)
    ds = lt.Dataset(X, y)
    ds.construct(config)
    rec["bin_s"] = time.perf_counter() - t0
    h = ds._handle
    G = h.num_columns
    require(G == N_FEATURES and h.max_column_bin <= 16,
            f"packed4: {G} columns of up to {h.max_column_bin} bins")
    rb = block_rows(config, h.num_data)
    t0 = time.perf_counter()
    host_packed = th.pack_bins_4bit(h.bins_t)
    rec["pack_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev_bins = h.device_bins(rb, resolve_device(config), packed4=True)
    torch.cuda.synchronize()
    rec["pack_and_upload_s"] = time.perf_counter() - t0
    npad = dev_bins.shape[1]
    require(tuple(dev_bins.shape) == (-(-G // 2), npad) and torch.equal(
        dev_bins[:, :h.num_data].cpu(), torch.from_numpy(host_packed))
        and not dev_bins[:, h.num_data:].any(),
        "packed4: the card's bins are not the host's packed bytes")
    rec.update(rows=HIGGS_ROWS, columns=G, npad=npad,
               packed_bytes=int(dev_bins.numel()), unpacked_bytes=G * npad)
    del host_packed
    log(f"packed4: {HIGGS_ROWS} x {G} at max_bin 15 binned in "
        f"{rec['bin_s']:.1f} s, packed "
        f"in {rec['pack_s']:.2f} s ({rec['pack_and_upload_s']:.2f} s packed "
        f"and uploaded): {rec['packed_bytes'] / 1e6:.1f} MB of bins against "
        f"{rec['unpacked_bytes'] / 1e6:.1f} MB unpacked")
    va = ds.create_valid(Xh, yh)
    va.construct(config)
    # 5 classes of the same rows (their bins shared): the quintiles of a
    # mix of the label and two features
    def classes(Xc, yc):
        z = Xc[:, 0] + 0.5 * Xc[:, 1] + yc
        return np.digitize(z, np.quantile(z[:100_000], [0.2, 0.4, 0.6,
                                                        0.8])).astype(float)
    sets = {"multiclass": (with_metadata(h, label=classes(X, y)),
                           with_metadata(va._handle,
                                         label=classes(Xh, yh)))}
    launches, kern = {}, None
    for name, extra, kw in P4_RUNS:
        params = dict(P4_PARAMS, **extra)
        train_set, valid_set = sets.get(name, (ds, va))
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with record_trees() as trees_rec:
            bst = lt.Booster(params, train_set, **kw)
            bst.add_valid(valid_set, "holdout")
            metric = []
            for _ in range(P4_ITERS):
                bst.update()
                metric.append(bst.eval_valid()[0][2])
            if name == "fused":
                # a card walk over the packed training bins (P1)
                before = bst.gbdt.train_score.clone()
                bst.rollback_one_iter()
                require(not torch.equal(before, bst.gbdt.train_score),
                        "packed4: the rollback changed no score")
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = dict(kernels.LAUNCHES)
        gb = bst.gbdt
        require(gb.packed4 and gb.bins.data_ptr() == dev_bins.data_ptr(),
                f"packed4 {name}: the booster does not train on the packed "
                "bins")
        kname = P4_RUN_KERNEL[name]
        C = gb.num_tree_per_iteration
        require(run[kname + "_packed4"] > 0 and run[kname] == 0
                and run["score_gather_add"] == P4_ITERS * C,
                f"packed4 {name}: the packed kernels did not run: {run}")
        ok = (metric[-1] > 0.8 if name != "multiclass"
              else metric[-1] < metric[0])
        require(all(np.isfinite(metric)) and ok,
                f"packed4 {name}: holdout {params['metric'][0]} {metric}")
        r = {"iter_seconds": list(gb.iter_seconds),
             "median_iter_s": float(np.median(gb.iter_seconds)),
             "wall_s": wall, "holdout": {params["metric"][0]: metric},
             "peak_device_bytes": int(torch.cuda.max_memory_allocated()),
             "launches": {k: v for k, v in run.items() if v}}
        if name == "frontier":
            require(gb.grower.K == 16, f"packed4 frontier: K {gb.grower.K}")
        else:
            step = ("histogram_segment_step" if name == "unfused"
                    else "histogram_segment_routed_step")
            r["device_loop"] = device_loop_report(
                f"HIGGS packed4 {name}", bst, trees_rec.stats, run,
                step + "_packed4", wall)
        rec[name] = r
        launches[name] = run
        log(f"packed4 {name}: {P4_ITERS} iterations, median "
            f"{r['median_iter_s']:.3f} s, holdout {params['metric'][0]} "
            f"{[round(a, 5) for a in metric]}, peak device memory "
            f"{r['peak_device_bytes'] / 1e9:.2f} GB")
        if name == "fused":
            t0 = time.perf_counter()
            kern = packed4_kernel_phase(gb)
            rec["kernels_s"] = time.perf_counter() - t0
        del bst, gb
        torch.cuda.empty_cache()
    del ds, va, sets, dev_bins, X, y, Xh, yh
    torch.cuda.empty_cache()
    tier_launches, rec["parity"] = packed4_parity_phase()
    launches.update(tier_launches)
    return launches, rec, kern


def packed4_parity_phase():
    """Phase 25: at 1M rows, packed = unpacked (packed4=False) bit for bit
    (model text, training and valid scores; the fused segment grower and
    the frontier grower's three tiers, "k1" = "off"), and P1's walk over
    the packed training bins = the host walk; at 200k rows, card = CPU.
    Returns ({"parity_" + run: launches}, record)."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import kernels
    X, y = higgs_like(P4_PARITY_ROWS + HOLDOUT_ROWS, 44)
    Xh, yh = X[P4_PARITY_ROWS:], y[P4_PARITY_ROWS:]
    X, y = X[:P4_PARITY_ROWS], y[:P4_PARITY_ROWS]
    ds = lt.Dataset(X, y)
    ds.construct(lt.Config.from_params(P4_PARAMS))
    va = ds.create_valid(Xh, yh)
    rec, launches, texts = {}, {}, {}
    cases = [("fused", {}, {})] + [
        (f"frontier_{tier}", {"tpu_tree_impl": "frontier"},
         {"frontier_tier": tier}) for tier in P4_TIERS]
    for name, extra, kw in cases:
        out = {}
        for packed4 in (None, False):
            kernels.reset_launches()
            bst = lt.Booster(dict(P4_PARAMS, **extra), ds, packed4=packed4,
                             **kw)
            bst.add_valid(va, "holdout")
            for _ in range(P4_ITERS):
                bst.update()
            if packed4 is None:
                launches[name] = dict(kernels.LAUNCHES)
            out[packed4] = bst
        a, b = out[None].gbdt, out[False].gbdt
        require(a.packed4 and not b.packed4, "packed4 parity: the layouts")
        require(out[None].model_to_string() == out[False].model_to_string()
                and torch.equal(a.train_score, b.train_score)
                and np.array_equal(a.valid_scores[0], b.valid_scores[0]),
                f"packed4 parity {name}: packed differs from unpacked")
        # P1 over the packed training bins = the host walk over the bins
        tree = a.models[-1]
        card = a._card_delta(a.train_set, [tree], [0])[0].cpu().numpy()
        host = tree.predict_binned(a.train_set.bins_t,
                                   a.train_set.feature_infos())
        require(np.array_equal(card, host), f"packed4 parity {name}: P1 "
                "over the packed bins differs from the host walk")
        texts[name] = out[None].model_to_string().split("parameters:")[0]
        rec[name] = {"rows": P4_PARITY_ROWS, "model_text_equal": True,
                     "splits": int(sum(t.num_leaves - 1 for t in a.models)),
                     "packed_iter_s": list(a.iter_seconds),
                     "unpacked_iter_s": list(b.iter_seconds)}
        log(f"packed4 parity {name}: {P4_PARITY_ROWS} rows, packed = "
            f"unpacked bit for bit ({rec[name]['splits']} splits, model "
            f"text, scores); P1 over the packed bins = the host walk")
        del out, a, b
    # "k1" shares "off"'s subtraction: the same model text
    require(texts["frontier_k1"] == texts["frontier_off"],
            "packed4 parity: frontier tier k1 grew another model than off")
    for tier, kname in FRONTIER_TIER_KERNEL.items():
        run = launches[f"frontier_{tier}"]
        require(run[kname + "_packed4"] > 0 and run[kname] == 0,
                f"packed4 frontier {tier}: {kname} was not launched packed")
    # card = CPU at 200k rows
    Xp, yp = X[:PARITY_ROWS], y[:PARITY_ROWS]
    params = dict(P4_PARAMS, num_leaves=31, metric=[])
    out = {}
    for dev in ("cuda", "cpu"):
        ds = lt.Dataset(Xp, yp)
        t0 = time.perf_counter()
        bst = lt.Booster(dict(params, device_type=dev), ds)
        for _ in range(P4_ITERS):
            bst.update()
        require(bst.gbdt.packed4, f"packed4 parity {dev}: not packed")
        out[dev] = (bst.gbdt, time.perf_counter() - t0)
    n, ties = _same_splits_near_tie(out["cuda"][0].models,
                                    out["cpu"][0].models, "packed4 card/CPU")
    diff = float(np.abs(out["cuda"][0].train_score.cpu().numpy()
                        - out["cpu"][0].train_score.numpy()).max())
    require(n >= 60 and diff < 1e-3, f"packed4 card/CPU: {n} splits "
            f"compared, scores differ by {diff}")
    rec["card_cpu"] = {"rows": PARITY_ROWS, "splits_compared": n,
                       "near_ties": ties, "max_score_diff": diff,
                       "card_s": out["cuda"][1], "cpu_s": out["cpu"][1]}
    log(f"packed4 parity: card = CPU at {PARITY_ROWS} rows on {n} splits "
        f"(near ties {ties}), scores within {diff:.3g}")
    return {f"parity_{k}": v for k, v in launches.items()}, rec


# ---------------------------------------------------------------- phase 26
ACC_ITERS = 3
ACC_SMALL_ROWS = 1_000_000
ACC_AUC_SLACK = 0.005
ACC_LOGLOSS_RTOL = 0.01
# Q1's integer operations a row: two threefry2x32 hashes (20 rounds of an
# add, a rotate and a xor, five key injections of three adds) and a dozen
# for the rounding, the clip and the pack; counted at PEAK_INT32_OPS_PER_S
ACC_Q1_OPS = 2 * (20 * 3 + 5 * 3) + 12
# phase 26's training runs at HIGGS, in turns with the f32 mode: the
# segment grower unfused (the default under packed_acc) and fused, the
# frontier grower at K = 16 ("off", the default under packed_acc)
ACC_RUNS = (("segment_unfused", {}, {}),
            ("segment_fused", {}, {"fused_route": True}),
            ("frontier", {"tpu_tree_impl": "frontier"}, {}))
# at 1M rows: the frontier's fused tiers (max_bin 63), and max_bin 15 with
# the 4-bit bins, where every histogram kernel runs in both modes at once
ACC_SMALL_RUNS = (
    ("tier_k1", {"tpu_tree_impl": "frontier"}, {"frontier_tier": "k1"}),
    ("tier_fusedk", {"tpu_tree_impl": "frontier"},
     {"frontier_tier": "fusedk"}),
    ("p4_segment_unfused", {"max_bin": 15}, {}),
    ("p4_segment_fused", {"max_bin": 15}, {"fused_route": True}),
    ("p4_frontier", {"max_bin": 15, "tpu_tree_impl": "frontier"}, {}),
    ("p4_tier_k1", {"max_bin": 15, "tpu_tree_impl": "frontier"},
     {"frontier_tier": "k1"}),
    ("p4_tier_fusedk", {"max_bin": 15, "tpu_tree_impl": "frontier"},
     {"frontier_tier": "fusedk"}))
# the histogram kernel each run's splits launch
ACC_RUN_KERNEL = {"segment_unfused": "histogram_segment_step",
                  "segment_fused": "histogram_segment_routed_step",
                  "frontier": "histogram_frontier",
                  "tier_k1": "histogram_frontier_routed",
                  "tier_fusedk": "histogram_frontier_fusedk",
                  "multiclass_cat": "histogram_segment_step"}
# where each packed-accumulator kernel replaces the TPU kernels' int32
# stream branch (pallas_histogram.py)
ACC_REPLACES = {
    "histogram_segment": "lightgbm_tpu/ops/pallas_histogram.py:418",
    "histogram_segment_step": "lightgbm_tpu/ops/pallas_histogram.py:418",
    "histogram_segment_routed": "lightgbm_tpu/ops/pallas_histogram.py:1065",
    "histogram_segment_routed_step":
        "lightgbm_tpu/ops/pallas_histogram.py:1065",
    "histogram_all": "lightgbm_tpu/ops/pallas_histogram.py:395",
    "histogram_frontier": "lightgbm_tpu/ops/pallas_histogram.py:777",
    "histogram_frontier_routed": "lightgbm_tpu/ops/pallas_histogram.py:1203",
    "histogram_frontier_fusedk": "lightgbm_tpu/ops/pallas_histogram.py:1203",
}


def acc_channels(th, w2, scales):
    """A packed-accumulator stream as library_hist_ms reads channels: [g,
    0, h, 0, member] float32, the quantized values in real units."""
    import torch
    g, h, m = th.packed_weight_channels(w2, slice(None)).float()
    z = torch.zeros_like(m)
    return torch.stack([g * float(scales[0]), z, h * float(scales[1]), z, m])


def require_packed_acc(tag, run, packed4, roots_f32=False):
    """The run's histograms came from the packed-accumulator kernels only
    (K5's f32 roots aside for multiclass), fed by Q1."""
    from lightgbm_tpu_torch.ops import kernels
    f32 = {k: run[kernels.variant(k, packed4)]
           for k in kernels.PACKED_ACC_KERNELS
           if not (roots_f32 and k == "histogram_all")}
    acc = {k: run[kernels.variant(k, packed4, True)]
           for k in kernels.PACKED_ACC_KERNELS}
    require(not any(f32.values()) and any(acc.values())
            and run["quantize_pack"] > 0,
            f"packed_acc {tag}: histograms in the f32 mode {f32}, in the "
            f"packed-accumulator mode {acc}, Q1 {run['quantize_pack']}")


def acc_runs(tag, runs, ds, va, base, metric_key):
    """Each run of ``runs`` ((name, params, kwargs)) in the f32 mode, then
    with packed_acc, ACC_ITERS iterations on ``ds`` with the holdout
    ``va``: median iteration wall, peak device memory and the holdout
    metric of each, and the packed run's launches.  Returns ({name:
    launches}, {name: record})."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import kernels
    launches, rec = {}, {}
    for name, extra, kw in runs:
        params = dict(base, **extra)
        r = {}
        for acc in (False, True):
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            bst = lt.Booster(params, ds, packed_acc=acc, **kw)
            bst.add_valid(va, "holdout")
            metric = []
            for _ in range(ACC_ITERS):
                bst.update()
                metric.append(bst.eval_valid()[0][2])
            torch.cuda.synchronize()
            gb = bst.gbdt
            mode = "packed_acc" if acc else "f32"
            r[mode] = {"iter_seconds": list(gb.iter_seconds),
                       "median_iter_s": float(np.median(gb.iter_seconds)),
                       "peak_device_bytes": int(
                           torch.cuda.max_memory_allocated()),
                       metric_key: metric}
            if acc:
                run = dict(kernels.LAUNCHES)
                r["launches"] = {k: v for k, v in run.items() if v}
                r["quant_clips_last_tree"] = gb.grower.last_stats[
                    "quant_clips"]
                require(gb.grower.p.packed_acc, f"{tag} {name}: not packed")
            del bst, gb
            torch.cuda.empty_cache()
        packed4 = params.get("max_bin", 255) <= 15
        require_packed_acc(f"{tag} {name}", run, packed4,
                           roots_f32=params.get("num_class", 1) > 1)
        kname = ACC_RUN_KERNEL.get(name.replace("p4_", ""))
        if kname is not None:
            require(run[kernels.variant(kname, packed4, True)] > 0,
                    f"{tag} {name}: {kname} was not launched packed_acc")
        a, b = r["f32"][metric_key][-1], r["packed_acc"][metric_key][-1]
        ok = (b >= a - ACC_AUC_SLACK if metric_key == "auc"
              else b <= a * (1.0 + ACC_LOGLOSS_RTOL))
        require(all(np.isfinite(r["packed_acc"][metric_key])) and ok,
                f"{tag} {name}: holdout {metric_key} {b} against the f32 "
                f"mode's {a}")
        log(f"packed_acc {tag} {name}: median iteration "
            f"{r['packed_acc']['median_iter_s']:.4f} s (f32 "
            f"{r['f32']['median_iter_s']:.4f} s), peak "
            f"{r['packed_acc']['peak_device_bytes'] / 1e9:.2f} GB (f32 "
            f"{r['f32']['peak_device_bytes'] / 1e9:.2f} GB), holdout "
            f"{metric_key} {b:.5f} (f32 {a:.5f})")
        rec[name] = r
        launches[name] = run
    return launches, rec


# Q1's device operations a call, counted by q1_device_ops_phase in the
# run's first profiler session (later sessions of a long process may see
# no device activity, and device_ops_per_call then gives None)
Q1_DEVICE_OPS = {}


def q1_device_ops_phase(n=1 << 20):
    """The device operations of one Q1 call and of one call of its
    previous design on n random rows (device_ops_per_call, right after
    the build): the shipped call must be two kernels, no copy, no
    memset."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as th
    prev = prev_designs()
    gen = torch.Generator(device="cuda").manual_seed(15)
    grad = torch.randn(n, generator=gen, device="cuda")
    hess = torch.rand(n, generator=gen, device="cuda")
    member = torch.ones(n, device="cuda")
    Q1_DEVICE_OPS["shipped"] = device_ops_per_call(
        lambda: th.quantize_pack(grad, hess, member))
    Q1_DEVICE_OPS["previous"] = device_ops_per_call(
        lambda: prev.prev_quantize_pack(grad, hess, member))
    ops = Q1_DEVICE_OPS["shipped"]
    require(ops is None or (ops["kernel"] == 2 and ops["memcpy"] == 0
                            and ops["memset"] == 0),
            f"quantize_pack: device operations a call {ops}")
    log(f"quantize_pack: device operations a call {ops} (previous design "
        f"{Q1_DEVICE_OPS['previous']})")


def q1_times(grad, hess, member, tag, reps=20, plain_reps=1):
    """Q1 at 8 bits on these rows against its plain version (the stream,
    the scales and the clip count bit for bit) and the previous design
    (tools/p1_time.py prev_quantize_pack, the same bits); the device
    operations of a call (device_ops_per_call: two kernels, no copy or
    memset), its time in turns with the previous design's (previous,
    shipped, shipped, previous; CUDA events over ``reps`` calls), the f32
    channels it replaces in torch and the plain version; the bound by 32
    bytes a row (the rows read twice: the scales need a whole pass first)
    and by ACC_Q1_OPS integer operations a row at the card's INT32 rate,
    beside the 20-byte figure (each input read once).  Returns the
    measurement dict."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as th
    prev = prev_designs()
    npad = grad.shape[0]
    w2, qs, clips = th.quantize_pack(grad, hess, member)
    sc, seed = th.quantize_inputs(grad, hess, member, 8)
    want, want_clips = th.quantize_pack_plain(grad, hess, member, sc, seed,
                                              8)
    old = prev.prev_quantize_pack(grad, hess, member)
    old_want, old_clips = th.quantize_pack_plain(grad, hess, member, old[1],
                                                 seed, 8)
    torch.cuda.synchronize()
    require(torch.equal(w2, want) and torch.equal(qs, sc)
            and int(clips) == int(want_clips[0]),
            f"quantize_pack {tag}: differs from its plain version")
    # the previous design took ATen's scales on the card (a reciprocal
    # multiply), which can differ by an ulp: it is held to the plain
    # version at its own scales
    require(torch.equal(old[0], old_want) and int(old[2]) == int(old_clips[0]),
            f"quantize_pack {tag}: the previous design differs from the "
            f"plain version at its scales")
    ops = device_ops_per_call(lambda: th.quantize_pack(grad, hess, member))
    prev_ops = device_ops_per_call(
        lambda: prev.prev_quantize_pack(grad, hess, member))
    if ops is None:
        # this session saw no device activity: the count of the run's
        # first session (q1_device_ops_phase)
        ops, prev_ops = (Q1_DEVICE_OPS.get("shipped"),
                         Q1_DEVICE_OPS.get("previous"))
    require(ops is None or (ops["kernel"] == 2 and ops["memcpy"] == 0
                            and ops["memset"] == 0),
            f"quantize_pack {tag}: device operations a call {ops}")

    def shipped():
        return time_ms(lambda i: th.quantize_pack(grad, hess, member), reps)

    def previous():
        return time_ms(lambda i: prev.prev_quantize_pack(grad, hess, member),
                       reps)

    turns = [previous(), shipped(), shipped(), previous()]
    t = {"max_abs_err": 0.0, "clips": int(clips),
         "prev_scales_equal": bool(torch.equal(old[1], qs)),
         "ms": (turns[1] + turns[2]) / 2, "prev_ms": (turns[0] + turns[3]) / 2,
         "turns_ms": turns, "device_ops_per_call": ops,
         "prev_device_ops_per_call": prev_ops}
    t["f32_ms"] = time_ms(lambda i: th.fixed_point_scales(
        th.pack_channels(grad, hess, member)), reps)
    t["plain_ms"] = time_ms(lambda i: th.quantize_pack_plain(
        grad, hess, member, sc, seed, 8), plain_reps)
    t["bound_ms"], t["bound_by"] = bound_ms(npad * (12 + 12 + 8),
                                            npad * ACC_Q1_OPS,
                                            PEAK_INT32_OPS_PER_S)
    t["bytes_bound_ms"] = bound_ms(npad * (12 + 12 + 8), 0.0)[0]
    t["one_pass_bound_ms"] = bound_ms(npad * (12 + 8), 0.0)[0]
    t["int32_ops_bound_ms"] = npad * ACC_Q1_OPS / PEAK_INT32_OPS_PER_S * 1e3
    t["library_ms"] = None
    t["shape"] = f"{tag}: {npad} rows, 8 bits"
    log(f"quantize_pack {tag}: = its plain version and the previous design "
        f"bit for bit ({t['clips']} clipped), {t['ms']:.4f} ms (previous "
        f"design {t['prev_ms']:.4f} ms; f32 channels in torch "
        f"{t['f32_ms']:.4f} ms, plain {t['plain_ms']:.2f} ms), bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}: 32 B a row "
        f"{t['bytes_bound_ms']:.4f} ms, INT32 ops "
        f"{t['int32_ops_bound_ms']:.4f} ms; one pass of 20 B a row "
        f"{t['one_pass_bound_ms']:.4f} ms); device operations a call "
        f"{ops} (previous {prev_ops})")
    return t


def acc_kernel_set(th, binsT, grad, hess, member, fm, rb, B, G, packed4,
                   tag, reps, plain_reps, split_col, with_q1=False):
    """Every packed-accumulator kernel on these bins at the gradients
    ``grad``/``hess``: Q1 (``with_q1``), K1 at the root, K3 at a split of
    column ``split_col`` at its middle bin, the K1 and K3 step entries
    there, K5 (one set, leaf_histogram's launch) and a K = 16 frontier
    round (K6, K7 routed and fused-K), each against its plain version bit
    for bit (leaf ids and histograms), a relaunch bit-identical, timed
    (``ms``) beside the same kernel on the f32 channels (``f32_ms``), its
    plain version, the bound and the library's index_add_.  Returns
    {kernel: measurement dict}."""
    import numpy as np
    import torch
    dev = binsT.device
    P, npad = binsT.shape
    H, nblk = th.logical_columns(binsT, packed4), npad // rb
    n = int(member.sum().item())
    w8 = th.pack_channels(grad, hess, member)
    s8 = th.fixed_point_scales(w8)
    w2, qs, clips = th.quantize_pack(grad, hess, member)
    ch = acc_channels(th, w2, qs)
    res = {}

    def same(name, got, want):
        require(torch.equal(got, want), f"{name} packed_acc {tag}: differs "
                "from its plain version")

    if with_q1:
        res["quantize_pack"] = q1_times(grad, hess, member, tag, reps,
                                        plain_reps)

    lid0 = torch.zeros(npad, dtype=torch.int32, device=dev)
    none = np.zeros(8, np.uint32)
    route = th.pack_route(0, 1, split_col, int(fm.num_bin[split_col]) // 2,
                          False, False, none, fm, packed4)
    step = th.pack_step(0, nblk, 1, route).to(dev)
    want_ids, want3 = th.histogram_segment_routed_plain(
        binsT, w2, lid0.clone(), 0, nblk, 1, route, B, rb, packed4, qs)
    moved = int((want_ids == 1).sum().item())
    require(0 < moved < n, f"packed_acc {tag}: the split moved {moved} rows")
    everyone = torch.arange(n, device=dev)
    routed_rows = torch.nonzero(want_ids == 1)[:, 0]
    W, out_bytes = npad, H * B * 3 * 4
    split_ops = W * 20 + moved * G * 3
    # name: (call on (ids, weights, scales), plain on ids, start ids,
    # whether the call routes them, bytes, ops, library rows)
    cases = {
        "histogram_segment": (
            lambda ids, w, s: th.histogram_segment(binsT, w, ids, 0, nblk, 0,
                                                   B, rb, s, packed4),
            lambda ids: th.histogram_segment_plain(binsT, w2, ids, 0, nblk,
                                                   0, B, rb, packed4, qs),
            lid0, False, W * (P + 12) + out_bytes, W * G * 3, everyone),
        "histogram_segment_routed": (
            lambda ids, w, s: th.histogram_segment_routed(
                binsT, w, ids, 0, nblk, 1, route, B, rb, s, packed4)[1],
            lambda ids: th.histogram_segment_routed_plain(
                binsT, w2, ids, 0, nblk, 1, route, B, rb, packed4, qs)[1],
            lid0, True, W * 5 + moved * 4 + moved * (P - 1 + 8) + out_bytes,
            split_ops, routed_rows),
        "histogram_segment_routed_step": (
            lambda ids, w, s: th.histogram_segment_routed_step(
                binsT, w, ids, step, B, rb, s, packed4=packed4)[1],
            lambda ids: th.histogram_segment_routed_step_plain(
                binsT, w2, ids, step, B, rb, packed4, qs)[1],
            lid0, True, W * 5 + moved * 4 + moved * (P - 1 + 8) + out_bytes,
            split_ops, routed_rows),
        "histogram_segment_step": (
            lambda ids, w, s: th.histogram_segment_step(
                binsT, w, ids, step, B, rb, s, packed4=packed4),
            lambda ids: th.histogram_segment_step_plain(
                binsT, w2, ids, step, B, rb, packed4, qs),
            want_ids, False, W * 4 + moved * (P + 8) + out_bytes,
            moved * G * 3, routed_rows),
        "histogram_all": (
            lambda ids, w, s: th.histogram_all(
                binsT, w, B, s if w.dtype == torch.int32 else s[None],
                packed4),
            lambda ids: th.histogram_all_plain(binsT, w2, B, packed4, qs),
            lid0, False, W * (P + 8) + out_bytes, W * G * 3, everyone),
    }
    for name, (call, plain, start, routes, nbytes, nops, rows) in \
            cases.items():
        a_ids, b_ids = start.clone(), start.clone()
        a, b = call(a_ids, w2, qs), call(b_ids, w2, qs)
        want = plain(start.clone())
        torch.cuda.synchronize()
        same(name, a, want)
        require(torch.equal(a, b), f"{name} packed_acc {tag}: a relaunch "
                "differs")
        if routes:
            require(torch.equal(a_ids, want_ids), f"{name} packed_acc {tag}:"
                    " leaf ids differ from the plain version")
        ids = [start.clone() for _ in range(reps + 1)]
        t = {"max_abs_err": 0.0}
        t["ms"] = time_ms(lambda i: call(ids[i], w2, qs), reps)
        t["f32_ms"] = time_ms(lambda i: call(ids[i], w8, s8), reps)
        ids = [start.clone() for _ in range(plain_reps + 1)]
        t["plain_ms"] = time_ms(lambda i: plain(ids[i]), plain_reps)
        del ids
        t["bound_ms"], t["bound_by"] = bound_ms(nbytes, nops)
        t["library_ms"] = library_hist_ms(
            binsT if not packed4 else th.unpack_bins_4bit(binsT)[:G],
            [ch], rows, B, reps)
        t["shape"] = (f"{tag}: {W} rows x {G} columns"
                      + (f" in {P} bytes" if packed4 else "")
                      + f", {B} bins" + (f", {moved} routed" if routes
                                         else ""))
        res[name] = t
        log(f"{name} packed_acc {tag}: = its plain version bit for bit, "
            f"{t['ms']:.4f} ms (f32 mode {t['f32_ms']:.4f} ms, plain "
            f"{t['plain_ms']:.2f} ms), bound {t['bound_ms']:.4f} ms, "
            f"index_add_ {t['library_ms']:.4f} ms")

    # a K = 16 frontier round on a 32-leaf layout sorted by leaf
    K = 16
    perm, lid, lo, hi = leaf_layout(th, binsT, fm, rb, 5, packed4)
    fb = binsT.index_select(1, perm)
    fw2, fw8 = w2.index_select(1, perm), w8.index_select(1, perm)
    fch = ch.index_select(1, perm)
    every_other = np.full(8, 0x55555555, np.uint32)
    routes = torch.stack([th.pack_route(
        k, 32 + k, k % G, int(fm.num_bin[k % G]) // 2, k % 2 == 1, False,
        every_other * 0, fm, packed4) for k in range(K)])
    bl, nbl = th.union_block_list(lo[:K], hi[:K], [True] * K)
    bl = bl.to(dev)
    routed, _ = th.histogram_frontier_routed_plain(
        fb, fw2, lid.clone(), bl, nbl, torch.arange(32, 32 + K,
                                                    dtype=torch.int32),
        routes, B, rb, packed4, qs)
    counts = torch.bincount(routed.long(), minlength=32 + K)
    smaller = torch.tensor([k if counts[k] <= counts[32 + k] else 32 + k
                            for k in range(K)], dtype=torch.int32)
    targets2 = torch.tensor(list(range(K)) + list(range(32, 32 + K)),
                            dtype=torch.int32)
    U = nbl * rb
    urows = (bl[:nbl].long()[:, None] * rb
             + torch.arange(rb, device=dev)).reshape(-1)
    flat = th.unpack_bins_4bit(fb)[:G] if packed4 else fb
    for name, targets, rts in (
            ("histogram_frontier", smaller, None),
            ("histogram_frontier_routed", smaller, routes),
            ("histogram_frontier_fusedk", targets2, routes)):
        start = routed if rts is None else lid
        KT = int(targets.shape[0])

        def call(ids, w, s, name=name, targets=targets, rts=rts):
            if rts is None:
                return th.histogram_frontier(fb, w, ids, bl, nbl, targets,
                                             B, rb, s, packed4)
            return getattr(th, name)(fb, w, ids, bl, nbl, targets, rts, B,
                                     rb, s, packed4)[1]

        if rts is None:
            want_lid = routed
            want = th.histogram_frontier_plain(fb, fw2, routed, bl, nbl,
                                               targets, B, rb, packed4, qs)
        else:
            want_lid, want = th.histogram_frontier_routed_plain(
                fb, fw2, lid.clone(), bl, nbl, targets, rts, B, rb, packed4,
                qs)
        a_ids, b_ids = start.clone(), start.clone()
        a, b = call(a_ids, fw2, qs), call(b_ids, fw2, qs)
        torch.cuda.synchronize()
        same(name, a, want)
        require(torch.equal(a, b) and torch.equal(a_ids, want_lid),
                f"{name} packed_acc {tag}: a relaunch or the ids differ")
        sel = torch.isin(want_lid[urows], targets.to(dev))
        M = int(sel.sum().item())
        R = 0 if rts is None else int(torch.isin(
            lid[urows], torch.arange(K, device=dev, dtype=lid.dtype)
        ).sum().item())
        mv = int((want_lid != start).sum().item())
        nbytes = (U * 4 + 4 * nbl + R + mv * 4 + M * (P + 8)
                  + KT * H * B * 12)
        nops = U * (KT + (0 if rts is None else K)) + R * 20 + M * G * 3
        t = {"max_abs_err": 0.0, "K": K, "KT": KT,
             "tiling": th.frontier_tiling(
                 H, B, KT, 0 if rts is None else K,
                 int(th.frontier_params(targets, rts)[2]), packed4, True),
             "f32_tiling": th.frontier_tiling(
                 H, B, KT, 0 if rts is None else K,
                 int(th.frontier_params(targets, rts)[2]), packed4)}
        ids = [start.clone() for _ in range(reps + 1)]
        t["ms"] = time_ms(lambda i: call(ids[i], fw2, qs), reps)
        t["f32_ms"] = time_ms(lambda i: call(ids[i], fw8, s8), reps)
        ids = [start.clone() for _ in range(plain_reps + 1)]
        if rts is None:
            t["plain_ms"] = time_ms(lambda i: th.histogram_frontier_plain(
                fb, fw2, ids[i], bl, nbl, targets, B, rb, packed4, qs),
                plain_reps)
        else:
            t["plain_ms"] = time_ms(
                lambda i: th.histogram_frontier_routed_plain(
                    fb, fw2, ids[i], bl, nbl, targets, rts, B, rb, packed4,
                    qs), plain_reps)
        del ids
        t["bound_ms"], t["bound_by"] = bound_ms(nbytes, nops)
        rows = urows[sel]
        slot_of = torch.full((32 + K,), -1, dtype=torch.int64, device=dev)
        slot_of[targets.long().to(dev)] = torch.arange(KT, device=dev)
        t["library_ms"] = library_hist_ms(flat, [fch], rows, B, reps,
                                          slots=slot_of[want_lid[rows].long()],
                                          n_slots=KT)
        t["shape"] = (f"{tag}: K = {K} round, {U} listed rows, {M} in the "
                      f"{KT} targets, {mv} routed, {G} x {B} bins")
        res[name] = t
        log(f"{name} packed_acc {tag}: = its plain version bit for bit, "
            f"{t['ms']:.4f} ms (f32 mode {t['f32_ms']:.4f} ms), tiling "
            f"{t['tiling']} (f32 {t['f32_tiling']})")
    del fb, fw2, fw8, fch, w8, w2, ch, flat
    torch.cuda.empty_cache()
    return res


def acc_gradients(gb):
    """The first iteration's gradients of booster ``gb``'s objective (at
    the boost-from-average score), padded to the layout, and member."""
    import torch
    from lightgbm_tpu_torch.objective import create_objective
    n, npad, dev = gb.num_data, gb.bins.shape[1], gb.bins.device
    obj = create_objective(gb.config)
    obj.init(gb.train_set.metadata, n, dev)
    score0 = torch.full((n,), obj.boost_from_score(), dtype=torch.float32,
                        device=dev)
    grad, hess = obj.get_gradients(score0)
    member = torch.zeros(npad, dtype=torch.float32, device=dev)
    member[:n] = 1.0
    return (torch.nn.functional.pad(grad, (0, npad - n)),
            torch.nn.functional.pad(hess, (0, npad - n)), member)


def packed_acc_phase(ds, Xh, yh):
    """Phase 26 at HIGGS (phase 3's binned rows): the segment grower
    unfused and fused and the frontier grower at K = 16 trained with
    packed_acc beside the f32 mode (holdout AUC within ACC_AUC_SLACK);
    every packed-accumulator kernel and Q1 against their plain versions,
    timed beside the f32 mode; leaf_histogram's K5 launch; at 1M rows the
    frontier's fused tiers and, at max_bin 15, the 4-bit bins with
    packed_acc (runs and kernels); at 200k rows card = CPU.  Returns
    ({path: launches}, record, {kernel variant: measurement})."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    va = ds.create_valid(Xh, yh)
    launches, rec = acc_runs("HIGGS", ACC_RUNS, ds, va, TRAIN_PARAMS, "auc")
    launches = {f"packed_acc_{k}": v for k, v in launches.items()}
    rec["higgs_runs_s"] = time.perf_counter() - t0
    # the kernels on the HIGGS bins of an unfused packed booster
    t0 = time.perf_counter()
    bst = lt.Booster(TRAIN_PARAMS, ds, packed_acc=True)
    gb = bst.gbdt
    grad, hess, member = acc_gradients(gb)
    fm = host_meta(gb.train_set)
    kern = {(k if k == "quantize_pack" else kernels.variant(k, False, True)):
            v for k, v in acc_kernel_set(
                th, gb.bins, grad, hess, member, fm, gb.grower.rb,
                gb.num_bins, gb.train_set.num_columns, False, "HIGGS", 20,
                1, 0, with_q1=True).items()}
    # leaf_histogram: K5 on the stream, quantized for the call (its own
    # path: no grower of the port calls it)
    kernels.reset_launches()
    leaf = th.leaf_histogram(gb.bins, grad, hess, member, gb.num_bins,
                             packed_acc=True)
    torch.cuda.synchronize()
    launches["leaf_histogram"] = dict(kernels.LAUNCHES)
    require(leaf.shape[0] == gb.train_set.num_columns
            and launches["leaf_histogram"]["histogram_all_packed_acc"] == 1,
            "leaf_histogram did not launch K5 packed_acc")
    rec["kernels_s"] = time.perf_counter() - t0
    del bst, gb, grad, hess, member, leaf
    torch.cuda.empty_cache()

    # at 1M rows: the fused frontier tiers, and the 4-bit bins
    t0 = time.perf_counter()
    X, y = higgs_like(ACC_SMALL_ROWS + HOLDOUT_ROWS, 46)
    Xs, ys = X[:ACC_SMALL_ROWS], y[:ACC_SMALL_ROWS]
    Xv, yv = X[ACC_SMALL_ROWS:], y[ACC_SMALL_ROWS:]
    sets = {}
    for max_bin in (MAX_BIN, 15):
        d = lt.Dataset(Xs, ys)
        d.construct(lt.Config.from_params(dict(TRAIN_PARAMS,
                                               max_bin=max_bin)))
        sets[max_bin] = (d, d.create_valid(Xv, yv))
    small_launches = {}
    for name, extra, kw in ACC_SMALL_RUNS:
        d, v = sets[extra.get("max_bin", MAX_BIN)]
        ln, r = acc_runs("1M", [(name, extra, kw)], d, v, TRAIN_PARAMS,
                         "auc")
        small_launches.update(ln)
        rec[f"small_{name}"] = r[name]
    launches.update({f"packed_acc_{k}": v for k, v in small_launches.items()})
    bst = lt.Booster(dict(TRAIN_PARAMS, max_bin=15), sets[15][0],
                     packed_acc=True)
    gb = bst.gbdt
    require(gb.packed4, "packed_acc max_bin 15: the bins are not packed")
    grad, hess, member = acc_gradients(gb)
    p4 = acc_kernel_set(th, gb.bins, grad, hess, member,
                        host_meta(gb.train_set), gb.grower.rb, gb.num_bins,
                        gb.train_set.num_columns, True, "1M packed4", 20, 1,
                        1)
    kernels.reset_launches()
    th.leaf_histogram(gb.bins, grad, hess, member, gb.num_bins, packed4=True,
                      packed_acc=True)
    torch.cuda.synchronize()
    launches["leaf_histogram_packed4"] = dict(kernels.LAUNCHES)
    kern.update({kernels.variant(k, True, True): v for k, v in p4.items()})
    rec["small_s"] = time.perf_counter() - t0
    del bst, gb, grad, hess, member, sets
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rec["card_cpu"] = acc_card_cpu_phase(X[:PARITY_ROWS], y[:PARITY_ROWS],
                                         Xv, yv)
    rec["card_cpu"]["wall_s"] = time.perf_counter() - t0
    return launches, rec, kern


def acc_card_cpu_phase(X, y, Xv, yv):
    """Phase 26's card = CPU at 200k rows.  Fed the same gradient arrays
    (three draws from a seed), the segment grower with packed_acc grows
    the same trees on the card and the CPU, split for split up to a
    near-tie, with the same quant_clips.  Boosters: the first iteration's
    trees likewise; later trees quantize gradients whose bits differ by
    the f32 rounding of the two devices' root sums, so they draw other
    uniforms, and the models are held to the JAX package's gate for a
    quantized model (predictions within 0.12).  Returns the record."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.models.grower_seg import SegmentGrower
    params = dict(TRAIN_PARAMS, num_leaves=31, metric=[])
    out, preds = {}, {}
    for dev in ("cuda", "cpu"):
        b = lt.Booster(dict(params, device_type=dev), lt.Dataset(X, y),
                       packed_acc=True)
        for _ in range(ACC_ITERS):
            b.update()
        out[dev] = b.gbdt
        preds[dev] = b.predict(Xv)
    first, ties = _same_splits_near_tie(out["cuda"].models[:1],
                                        out["cpu"].models[:1],
                                        "packed_acc card/CPU first tree")
    pdiff = float(np.abs(preds["cuda"] - preds["cpu"]).max())
    require(first >= 20 and pdiff <= 0.12, f"packed_acc card/CPU: "
            f"{first} splits of the first tree compared, predictions "
            f"differ by {pdiff}")
    gb = out["cuda"]
    growers = {d: SegmentGrower(gb.num_bins, gb.grower.p, gb.grower.rb)
               for d in ("cuda", "cpu")}
    fmeta = {"cuda": gb.fmeta, "cpu": type(gb.fmeta)(*(
        None if t is None else t.cpu() for t in gb.fmeta))}
    bins = {"cuda": gb.bins, "cpu": gb.bins.cpu()}
    member = gb.member.cpu()
    gen = np.random.RandomState(26)
    compared = 0
    for t in range(ACC_ITERS):
        p = gen.uniform(0.05, 0.95, size=member.shape[0])
        lab = gen.uniform(size=member.shape[0]) < p
        grad = torch.from_numpy((p - lab).astype(np.float32)) * member
        hess = torch.from_numpy((p * (1 - p)).astype(np.float32)) * member
        trees = {}
        for d in ("cuda", "cpu"):
            tree, lid = growers[d].grow(bins[d], grad.to(d), hess.to(d),
                                        member.to(d), fmeta[d])
            trees[d] = (tree, lid.cpu(), growers[d].last_stats[
                "quant_clips"])
        a, b = trees["cuda"][0], trees["cpu"][0]
        require(a.num_leaves == b.num_leaves
                and trees["cuda"][2] == trees["cpu"][2],
                f"packed_acc card/CPU grower tree {t}: {a.num_leaves} / "
                f"{b.num_leaves} leaves, clips {trees['cuda'][2]} / "
                f"{trees['cpu'][2]}")
        for k in range(a.num_leaves - 1):
            ga, gc = float(a.split_gain[k]), float(b.split_gain[k])
            if ga <= 1e-2 or gc <= 1e-2:
                break
            if (a.split_feature[k], a.threshold_bin[k]) != (
                    b.split_feature[k], b.threshold_bin[k]):
                require(abs(ga - gc) <= 1e-4 * max(ga, gc),
                        f"packed_acc card/CPU grower tree {t} split {k} "
                        f"differs (gains {ga}, {gc})")
                ties += 1
                break
            compared += 1
    require(compared >= 60, f"packed_acc card/CPU growers: {compared} "
            "splits compared")
    log(f"packed_acc card = CPU at {X.shape[0]} rows: the first tree on "
        f"{first} splits, the growers fed the same gradients on {compared} "
        f"splits (near ties {ties}); 3-iteration predictions within "
        f"{pdiff:.3g}")
    return {"rows": int(X.shape[0]), "first_tree_splits": first,
            "grower_splits": compared, "near_ties": ties,
            "max_pred_diff": pdiff}


def packed_acc_mc_phase(ds, Xh, yh):
    """Phase 26 at multiclass_cat (phase 7's binned rows): 5-class training
    with packed_acc beside the f32 mode, K5's roots on the f32 channels
    and every split on the stream (holdout multi_logloss within
    ACC_LOGLOSS_RTOL).  Returns ({path: launches}, record)."""
    va = ds.create_valid(Xh, yh)
    launches, rec = acc_runs("multiclass_cat", [("multiclass_cat", {}, {})],
                             ds, va, MC_PARAMS, "multi_logloss")
    run = launches["multiclass_cat"]
    require(run["histogram_all"] == ACC_ITERS
            and run["histogram_all_packed_acc"] == 0
            and run["quantize_pack"] == ACC_ITERS * MC_CLASSES,
            f"packed_acc multiclass_cat: K5 roots or Q1 launches {run}")
    return {"packed_acc_multiclass_cat": run}, rec["multiclass_cat"]

# ---------------------------------------------------------------- phase 27
SF_ITERS = 3
SF_PARITY_ITERS = 2
SF_SWEEP_ROWS = 1000
# monotone constraints on 9 of the 28 features, both signs: higgs_like's
# coefficients give +1 to X0 (2 X0) and X1 (+X1); X2-X4 enter without a
# sign (-X2 X3, sin 3 X4); the noise columns 5-11 alternate -1, +1
SF_MONOTONE = [1, 1, 0, 0, 0, -1, 1, -1, 1, -1, 1, -1] + [0] * 16
SF_CONTRI = [1.0, 0.9, 1.0, 0.7, 0.8] + [0.6, 1.0] * 11 + [1.0]
# runs (a) and (b): every split feature of the segment and frontier growers
SF_FEATURES = dict(monotone_constraints=SF_MONOTONE, feature_contri=SF_CONTRI,
                   cegb_penalty_split=2e-6,
                   cegb_penalty_feature_coupled=[5.0] * 5 + [20.0] * 23)
# run (c): a forced plan of three levels, CEGB-lazy and the constraints,
# reached as the JAX package reaches its fused grower (auto + a plan)
SF_PLAN = {"feature": 0, "threshold": 0.0,
           "left": {"feature": 1, "threshold": 0.0,
                    "left": {"feature": 2, "threshold": 0.0},
                    "right": {"feature": 4, "threshold": 0.0}},
           "right": {"feature": 1, "threshold": 0.5,
                     "left": {"feature": 3, "threshold": 0.0},
                     "right": {"feature": 2, "threshold": -0.5}}}
SF_LAZY = [1e-3] * 5 + [5e-3] * 23
# (name, the run without the features, the features' parameters); the
# two of a run go in turns, without then with
SF_RUNS = (
    ("segment", {}, SF_FEATURES),
    ("frontier", {"tpu_tree_impl": "frontier", "tpu_frontier_width": 16},
     SF_FEATURES),
    ("fused", {"tpu_tree_impl": "fused"},
     {"monotone_constraints": SF_MONOTONE,
      "cegb_penalty_feature_lazy": SF_LAZY}))
SF_GROWER = {"segment": "SegmentGrower", "frontier": "FrontierGrower",
             "fused": "FusedGrower"}


def monotone_sweep_violation(bst, X, monotone, rows=SF_SWEEP_ROWS):
    """The largest step against its constraint of ``bst``'s raw prediction
    over a sweep of ``rows`` values of each constrained feature (its 0.1%
    to 99.9% quantiles), the other features at X[0]'s values; 0.0 when
    every sweep is monotone."""
    import numpy as np
    worst = 0.0
    for f, sign in enumerate(monotone):
        if sign == 0:
            continue
        lo, hi = np.quantile(X[:100_000, f], [0.001, 0.999])
        Xs = np.repeat(X[:1].astype(np.float64), rows, axis=0)
        Xs[:, f] = np.linspace(lo, hi, rows)
        pred = bst.predict(Xs, raw_score=True)
        worst = max(worst, float(np.max(-sign * np.diff(pred))))
    return worst


def seen_share_ms(gb, splits):
    """CEGB-lazy's bookkeeping a split on the fused grower at this booster's
    shape, timed with CUDA events (FusedGrower._mark_seen: the children's
    path features, and the left child's rows counted from the routed leaf
    ids), on random leaf ids.  Returns (ms a split, ms a tree = splits x
    that)."""
    import torch
    g = gb.grower
    F, npad = gb.fmeta.num_bin.shape[0], gb.bins.shape[1]
    L = g.p.num_leaves
    g._path = torch.zeros((L, F), dtype=torch.bool, device=gb.device)
    g._leaf_rows = torch.full((L,), npad, dtype=torch.int64,
                              device=gb.device)
    lid = torch.randint(0, 2, (npad,), dtype=torch.int32, device=gb.device)
    ms = time_ms(lambda i: g._mark_seen(lid, 0, 1, i % F), 20)
    g._path = g._leaf_rows = None
    return ms, ms * splits


def fused_k5_measure(gb, reps=20):
    """K5 as the fused grower launches it on booster ``gb``'s bins: one
    channel set whose member channel holds a leaf's rows (every other row:
    the most a smaller child holds), against its plain version (counts
    exact, sums in tolerance), timed alone and as ``leaf_histogram`` calls
    it (the channels packed, then K5), beside its bound by (G + 10) B a
    row and one index_add_.  Returns the measurement."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as th
    grad, hess, member = acc_gradients(gb)
    bins, B = gb.bins, gb.num_bins
    W = bins.shape[1]
    F = th.logical_columns(bins, gb.packed4)
    leaf = member * (torch.arange(W, device=bins.device) % 2 == 0).float()
    w8 = th.pack_channels(grad, hess, leaf)
    scales = th.class_scales(w8)
    got = th.histogram_all(bins, w8, B, scales)[0]
    want = th.histogram_all_plain(bins, w8, B)[0]
    abs_sums = th.histogram_all_plain(bins, abs_channel_sets(w8), B)[0]
    t = {"max_abs_err": check_hist("histogram_all fused leaf", got, want,
                                   abs_sums)}
    t["ms"] = time_ms(lambda i: th.histogram_all(bins, w8, B, scales), reps)
    t["leaf_histogram_ms"] = time_ms(lambda i: th.leaf_histogram(
        bins, grad, hess, leaf, B), reps)
    t["plain_ms"] = time_ms(lambda i: th.histogram_all_plain(bins, w8, B), 1)
    t["bound_ms"], t["bound_by"] = bound_ms(W * (F + 10) + F * B * 12,
                                            W * F * 3)
    t["library_ms"] = library_hist_ms(bins, [w8], torch.arange(
        W, device=bins.device), B, reps)
    t["shape"] = f"{W} rows x {F} features x 1 set, {B} bins"
    log(f"histogram_all as the fused grower's leaf histogram: {t['ms']:.4f} "
        f"ms (leaf_histogram {t['leaf_histogram_ms']:.4f} ms), bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
        f"{t['plain_ms']:.2f} ms, index_add_ {t['library_ms']:.3f} ms, max "
        f"|diff| {t['max_abs_err']:.3g}")
    return t


def split_features_phase(ds, X, y, Xh, yh):
    """Phase 27 at HIGGS (phase 3's binned rows, their raw X and y for
    the card = CPU runs): runs (a) segment, (b) frontier K = 16 and (c)
    fused (SF_RUNS), SF_ITERS iterations each beside the same run without
    the features, in turns: iteration walls, peak device memory, holdout
    AUC (no gate); each feature run monotone over SF_SWEEP_ROWS-value
    sweeps of every constrained feature, at least one split off the run
    without the features, its grower's kernels launched; the fused run K5
    once for each tree's root and once a split, and the share of its
    iteration CEGB-lazy's bookkeeping takes.  The constraints and gain
    multipliers are a dataset's settings, set on a copy of phase 3's
    dataset (the bins and their device copy shared).  Then at
    PARITY_ROWS rows the three feature runs on the card and the CPU: the
    same splits up to a near-tie.  Returns ({path: launches}, record)."""
    import copy
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import kernels
    plan_dir = tempfile.mkdtemp(prefix="split_features_")
    plan_path = os.path.join(plan_dir, "forced_splits.json")
    with open(plan_path, "w") as fh:
        json.dump(SF_PLAN, fh)
    handle = copy.copy(ds._handle)
    handle.set_feature_settings(SF_MONOTONE, SF_CONTRI)
    feat_ds = lt.Dataset(handle)
    va = {False: ds.create_valid(Xh, yh),
          True: feat_ds.create_valid(Xh, yh)}
    launches, rec = {}, {}
    for name, base_extra, feat_extra in SF_RUNS:
        r, split_sets = {}, {}
        for with_features in (False, True):
            params = dict(TRAIN_PARAMS, **(
                dict(feat_extra, forcedsplits_filename=plan_path)
                if with_features and name == "fused"
                else feat_extra if with_features else base_extra))
            if with_features and name == "frontier":
                params.update(base_extra)
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            bst = lt.Booster(params, feat_ds if with_features else ds)
            bst.add_valid(va[with_features], "holdout")
            auc = []
            for _ in range(SF_ITERS):
                bst.update()
                auc.append(bst.eval_valid()[0][2])
            torch.cuda.synchronize()
            gb = bst.gbdt
            require(type(gb.grower).__name__ == SF_GROWER[name],
                    f"split features {name}: grew with "
                    f"{type(gb.grower).__name__}")
            key = "features" if with_features else "plain"
            r[key] = {"iter_seconds": list(gb.iter_seconds),
                      "median_iter_s": float(np.median(gb.iter_seconds)),
                      "peak_device_bytes": int(
                          torch.cuda.max_memory_allocated()),
                      "holdout_auc": auc,
                      "leaves": [t.num_leaves for t in gb.models]}
            split_sets[key] = [
                list(zip(t.split_feature_inner[:t.num_leaves - 1].tolist(),
                         t.threshold_in_bin[:t.num_leaves - 1].tolist()))
                for t in gb.models]
            if with_features:
                run = dict(kernels.LAUNCHES)
                r["launches"] = {k: v for k, v in run.items() if v}
                worst = monotone_sweep_violation(bst, X, SF_MONOTONE)
                r["monotone_worst_step"] = worst
                require(worst <= 0.0, f"split features {name}: a sweep "
                        f"steps {worst} against its constraint")
                if name == "fused":
                    nodes = sum(t.num_leaves for t in gb.models)
                    forced = len(gb.grower.p.forced_plan)
                    require(forced == 7 and all(
                        s[:forced] == [(f, t) for _, f, t in
                                       gb.grower.p.forced_plan]
                        for s in split_sets[key]),
                        f"split features fused: the plan {forced} splits "
                        "do not head every tree")
                    require(run["histogram_all"] == nodes,
                            f"split features fused: {run['histogram_all']} "
                            f"K5 launches for {nodes} roots and splits")
                    splits = gb.grower.last_stats["splits"]
                    ms, tree_ms = seen_share_ms(gb, splits)
                    r["k5_launches_a_tree"] = nodes / len(gb.models)
                    r["lazy_ms_a_split"] = ms
                    r["lazy_share_of_iteration"] = tree_ms / (
                        1e3 * r["features"]["median_iter_s"])
                    r["k5"] = fused_k5_measure(gb)
                else:
                    kname = {"segment": "histogram_segment_routed_step",
                             "frontier": "histogram_frontier"}[name]
                    require(run[kname] > 0 and run["score_gather_add"] > 0,
                            f"split features {name}: {kname} or K4 not "
                            f"launched: {r['launches']}")
                launches[f"split_features_{name}"] = run
            del bst, gb
            torch.cuda.empty_cache()
        moved = sum(a != b for a, b in zip(split_sets["plain"],
                                           split_sets["features"]))
        require(moved > 0, f"split features {name}: every tree split as "
                "without the features")
        r["trees_changed"] = moved
        f, p = r["features"], r["plain"]
        log(f"split features {name}: median iteration "
            f"{f['median_iter_s']:.4f} s (without {p['median_iter_s']:.4f} "
            f"s), peak {f['peak_device_bytes'] / 1e9:.2f} GB (without "
            f"{p['peak_device_bytes'] / 1e9:.2f} GB), holdout AUC "
            f"{f['holdout_auc'][-1]:.5f} (without "
            f"{p['holdout_auc'][-1]:.5f}), {moved} of {SF_ITERS} trees "
            f"changed, worst sweep step {r['monotone_worst_step']}"
            + (f", K5 {r['k5_launches_a_tree']:.1f} a tree, CEGB-lazy "
               f"{r['lazy_ms_a_split']:.4f} ms a split "
               f"({r['lazy_share_of_iteration']:.4f} of the iteration)"
               if name == "fused" else ""))
        rec[name] = r
    del feat_ds, handle, va
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["card_cpu"] = split_features_parity(X[:PARITY_ROWS], y[:PARITY_ROWS],
                                            plan_path)
    rec["card_cpu"]["wall_s"] = time.perf_counter() - t0
    return launches, rec


def split_features_parity(X, y, plan_path):
    """Phase 27's card = CPU: the three feature runs at 31 leaves, through
    lt.Dataset (the settings from the parameters), SF_PARITY_ITERS
    iterations on each device: the same splits up to a near-tie."""
    import lightgbm_tpu_torch as lt
    out = {}
    for name, base_extra, feat_extra in SF_RUNS:
        extra = dict(feat_extra)
        if name == "fused":
            extra["forcedsplits_filename"] = plan_path
        if name == "frontier":
            extra.update(base_extra)
        trees = {}
        for dev in ("cuda", "cpu"):
            params = dict(TRAIN_PARAMS, num_leaves=31, device_type=dev,
                          **extra)
            bst = lt.train(params, lt.Dataset(X, y), SF_PARITY_ITERS)
            require(type(bst.gbdt.grower).__name__ == SF_GROWER[name],
                    f"split features parity {name} on {dev}: "
                    f"{type(bst.gbdt.grower).__name__}")
            trees[dev] = bst.gbdt.models
            forced = len(bst.gbdt.grower.p.forced_plan)
        n, ties = _same_splits_near_tie(trees["cuda"], trees["cpu"],
                                        f"split features {name} card/CPU",
                                        forced)
        require(n >= 20, f"split features {name} card/CPU: {n} splits "
                "compared")
        out[name] = {"splits_compared": n, "near_ties": ties}
        log(f"split features {name}: card = CPU at {X.shape[0]} rows on "
            f"{n} splits (near ties {ties})")
    return out


# --------------------------------------------------------------- phase 28
# the second histogram path (B3 on the fused grower) and file input
WIDE_MAX_BIN = 1023
WIDE_ITERS = 3
WIDE_PARAMS = dict(TRAIN_PARAMS, max_bin=WIDE_MAX_BIN)
# (b): multiclass_cat's categorical columns re-drawn from this many
# categories, Zipf-like (p ~ 1 / rank), so each holds more than 256 bins
WIDE_CATEGORIES = 1000
# (d): the file's rows, cut from the 10.5M for the run's time limit
FILE_ROWS = 1_000_000
# the Python tokenizer and binner are timed on this many of the rows
FILE_PY_ROWS = 20_000
WIDE_PARITY_ITERS = 2
# max_bin_by_feature of the card = CPU run: wide, narrow and default
WIDE_BY_FEATURE = [1023, 15, 300, 63] * 7
B3_SWEEP = ((64, False), (256, False), (64, True), (256, True), (1024, True),
            (65536, True))
B3_SWEEP_ROWS = 1_000_000


def wide_multiclass_cat(n: int, seed: int):
    """multiclass_cat's rows (bench_suite.py:95-112) with columns 20-27
    re-drawn from WIDE_CATEGORIES Zipf-like categories each (merchant,
    product or ZIP-code columns), the label from the first of them as
    before."""
    import numpy as np
    X, _ = multiclass_cat(n, seed)
    rng = np.random.RandomState(seed + 1)
    p = 1.0 / np.arange(1, WIDE_CATEGORIES + 1)
    cats = rng.choice(WIDE_CATEGORIES, size=(n, 8), p=p / p.sum())
    X[:, 20:28] = cats
    logits = np.stack([
        X[:, 0] + (cats[:, 0] % 5 == k) * 1.5
        + 0.5 * X[:, k % 4] * (1 if k % 2 else -1)
        for k in range(MC_CLASSES)], axis=1)
    y = np.argmax(2.0 * logits + rng.gumbel(size=(n, MC_CLASSES)), axis=1)
    return X, y.astype(np.float64)


def _holdout_auc(bst):
    return float(bst.eval_valid()[0][2])


def wide_runs_phase(ds63, X, y, Xh, yh):
    """(a) HIGGS at max_bin 1023 (two-byte bins, B3 on the fused grower)
    in turns with phase 3's max_bin 63 run (63, 1023, 1023, 63), WIDE_ITERS
    iterations each: iteration walls, B3 launches a tree, peak device
    memory, holdout AUC (no gate); then one more 1023 tree timed split by
    split (a synchronize around each part) for the scan's share of a
    split.  Returns (launches of the 1023 runs, record, the 1023
    booster)."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.core import native
    from lightgbm_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    used0 = dict(native.USED)
    ds = lt.Dataset(X, y, params=WIDE_PARAMS)
    ds.construct(lt.Config.from_params(WIDE_PARAMS))
    bin_s = time.perf_counter() - t0
    require(ds._handle.wide and ds._handle.max_num_bin > 256,
            f"max_bin {WIDE_MAX_BIN}: {ds._handle.bins_t.dtype} bins, "
            f"{ds._handle.max_num_bin} the most a feature holds")
    require(native.USED["fastbin"] > used0["fastbin"],
            "the native binner did not run")
    va = {63: ds63.create_valid(Xh, yh), WIDE_MAX_BIN: ds.create_valid(
        Xh, yh)}
    rec = {"binning_s": bin_s, "max_num_bin": int(ds._handle.max_num_bin),
           "runs": []}
    launches, wide_bst = {}, None
    for mb in (63, WIDE_MAX_BIN, WIDE_MAX_BIN, 63):
        params = WIDE_PARAMS if mb == WIDE_MAX_BIN else TRAIN_PARAMS
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        bst = lt.Booster(params, ds if mb == WIDE_MAX_BIN else ds63)
        bst.add_valid(va[mb], "holdout")
        auc = []
        for _ in range(WIDE_ITERS):
            bst.update()
            auc.append(_holdout_auc(bst))
        torch.cuda.synchronize()
        gb = bst.gbdt
        run = dict(kernels.LAUNCHES)
        r = {"max_bin": mb, "hist_backend": gb.hist_backend,
             "grower": type(gb.grower).__name__,
             "iter_seconds": list(gb.iter_seconds),
             "median_iter_s": float(np.median(gb.iter_seconds)),
             "peak_device_bytes": int(torch.cuda.max_memory_allocated()),
             "holdout_auc": auc}
        if mb == WIDE_MAX_BIN:
            nodes = sum(t.num_leaves for t in gb.models)
            splits = nodes - len(gb.models)
            require(gb.hist_backend == "onehot"
                    and r["grower"] == "FusedGrower",
                    f"max_bin {mb}: {gb.hist_backend}, {r['grower']}")
            require(run["histogram_chunked_u16"] == nodes
                    and run["histogram_chunked_select"] == nodes
                    and run["route_window_u16"] == splits,
                    f"max_bin {mb}: B3 {run['histogram_chunked_u16']} "
                    f"launches for {nodes} nodes, K2-u16 "
                    f"{run['route_window_u16']} for {splits} splits")
            require(not any(run[k] for k in (
                "histogram_all", "histogram_segment_routed_step",
                "histogram_chunked", "route_window")),
                f"max_bin {mb}: a one-byte kernel ran: "
                f"{ {k: v for k, v in run.items() if v} }")
            r["b3_launches_a_tree"] = nodes / len(gb.models)
            launches = run
            wide_bst = bst
        else:
            require(gb.hist_backend == "pallas",
                    f"max_bin 63 took {gb.hist_backend}")
        r["launches"] = {k: v for k, v in run.items() if v}
        rec["runs"].append(r)
        log(f"wide bins: max_bin {mb} ({r['grower']}, {gb.hist_backend}) "
            f"median iteration {r['median_iter_s']:.4f} s, peak "
            f"{r['peak_device_bytes'] / 1e9:.2f} GB, holdout AUC "
            f"{auc[-1]:.5f}")
        if bst is not wide_bst:
            del bst
        del gb
        torch.cuda.empty_cache()
    rec["split_breakdown"] = split_breakdown(wide_bst)
    return launches, rec, wide_bst


def split_breakdown(bst):
    """One more tree of ``bst`` (the fused grower on the onehot path),
    each part of a split synchronized and timed on the host clock: the
    route (K2), the histogram (the channels and B3), and the scan (the
    best splits of both children, HostGrower._scan, host fetch included).
    The synchronizes lengthen the tree; the shares are of the timed
    parts.  Returns {ms a split of each part, the scan's share}."""
    import torch
    from lightgbm_tpu_torch.models import grower_fused
    g = bst.gbdt.grower
    parts = collections.defaultdict(float)
    orig_hist, orig_scan = g._hist, g._scan
    orig_route = grower_fused.route_window

    def timed(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            parts[name] += time.perf_counter() - t0
            return out
        return call

    g._hist = timed("hist", orig_hist)
    g._scan = timed("scan", orig_scan)
    grower_fused.route_window = timed("route", orig_route)
    try:
        bst.update()
    finally:
        g._hist, g._scan = orig_hist, orig_scan
        grower_fused.route_window = orig_route
    splits = g.last_stats["splits"]
    total = sum(parts.values())
    rec = {f"{k}_ms_a_split": 1e3 * v / splits for k, v in parts.items()}
    rec["scan_share_of_split"] = parts["scan"] / total
    rec["splits"] = splits
    log(f"wide bins: a split's parts (synchronized) "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in rec.items()
                    if k.endswith("_ms_a_split"))
        + f"; the scan's share {rec['scan_share_of_split']:.3f}")
    return rec


def b3_check(bins, rows, B, tag, grad, hess, member, lid=None, leaf=-1,
             w3=None, reps=10, plain_reps=1):
    """B3 at one shape: the leaf entry (histogram_chunked_leaf: the rows of
    leaf ``leaf`` of ``lid``, every member row without ``lid``), or with
    ``w3`` the entry on channels (histogram_chunked at channel_scales(w3)),
    over the row-major bins ``rows``.  Against its plain version bit for
    bit, a relaunch bit for bit, one launch of each kernel a call; its time
    in turns with the previous design (tools/p1_time.py
    prev_histogram_chunked on the [3, Npad] channels of the same rows at
    channel_scales: previous, shipped, shipped, previous), pass 1's alone,
    the plain version's; the bound under the channels' count (12 B of
    [3, Npad] channels a row, each member row's bins, the output: the
    previous design's inputs) and under what the inputs need (the leaf id
    and member a row, the channels and bins a member row, the output), and
    by its operations (three adds a (member row, column) pair); one
    index_add_ of the member rows' three channels into [G * B, 3]."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import kernels
    prev = prev_designs()
    G, W = bins.shape
    wide = bins.dtype == torch.int16
    name = kernels.variant("histogram_chunked", wide=wide)
    if w3 is None:
        m = member if lid is None else (lid == leaf).to(grad.dtype) * member
        chan = th.chunked_channels(grad, hess, m)
        scales = th.channel_scales(chan)
        want = th.histogram_chunked_leaf_plain(bins, grad, hess, member, B,
                                               lid, leaf)

        def call(i=0):
            return th.histogram_chunked_leaf(bins, grad, hess, member, B, lid,
                                             leaf, rows=rows)

        def plain(i=0):
            return th.histogram_chunked_leaf_plain(bins, grad, hess, member,
                                                   B, lid, leaf)

        def select(i=0):
            return th._launch_select(grad, hess, member, lid, leaf, False,
                                     None)
    else:
        chan, scales = w3, th.channel_scales(w3)
        want = th.histogram_chunked_plain(bins, w3, B, scales)

        def call(i=0):
            return th.histogram_chunked(bins, w3, B, scales, rows=rows)

        def plain(i=0):
            return th.histogram_chunked_plain(bins, w3, B, scales)

        def select(i=0):
            return th._launch_select(w3[0], w3[1], w3[2], None, -1, True,
                                     scales)
    before = (kernels.LAUNCHES[name], kernels.LAUNCHES[
        "histogram_chunked_select"])
    got = call()
    again = call()
    old = prev.prev_histogram_chunked(bins, chan, B, scales)
    torch.cuda.synchronize()
    calls = (kernels.LAUNCHES[name] - before[0],
             kernels.LAUNCHES["histogram_chunked_select"] - before[1])
    require(calls == (2, 2), f"B3 {tag}: {calls} launches (histogram, "
            "pass 1) for two calls")
    require(torch.equal(got, want), f"B3 {tag}: differs from the plain "
            "version")
    require(torch.equal(again, got), f"B3 {tag}: a relaunch differs")
    require(torch.equal(old, want), f"B3 {tag}: the previous design "
            "differs from the plain version")
    tiling = th.chunked_tiling(G, B)
    members = int((chan[2] != 0).sum().item())
    es = bins.element_size()
    out_bytes = 12 * G * B
    channel_bytes = 12 * W + es * G * members + out_bytes
    reread = 12 * W * (1 if tiling["global"] else
                       -(-G // prev.prev_tile_columns(G, B))) \
        + es * G * members + out_bytes
    need_bytes = (4 if lid is not None else 0) * W + 4 * W \
        + members * (8 + es * G) + out_bytes
    ops = 3.0 * members * G

    def shipped():
        return time_ms(call, reps)

    def previous():
        return time_ms(lambda i: prev.prev_histogram_chunked(
            bins, chan, B, scales), reps)

    turns = [previous(), shipped(), shipped(), previous()]
    rec = {"max_abs_err": float((got - want).abs().max().item()),
           "ms": (turns[1] + turns[2]) / 2,
           "prev_ms": (turns[0] + turns[3]) / 2, "turns_ms": turns,
           "select_ms": time_ms(select, reps),
           "plain_ms": time_ms(plain, plain_reps),
           "tiling": tiling, "member_rows": members,
           "shape": f"{tag}: {W} rows ({members} members) x {G} columns "
                    f"({bins.dtype}), {B} bins"}
    rec["bound_ms"], rec["bound_by"] = bound_ms(need_bytes, ops)
    rec["bound_channels_ms"], rec["bound_channels_by"] = bound_ms(
        channel_bytes, ops)
    rec["bound_with_rereads_ms"] = bound_ms(reread, ops)[0]
    rec["library_ms"] = (library_b3_ms(bins, chan, B, reps) if B <= 8192
                         else None)
    log(f"B3 {tag}: bit for bit the plain version, {rec['ms']:.4f} ms "
        f"(previous design {rec['prev_ms']:.4f} ms; pass 1 "
        f"{rec['select_ms']:.4f} ms), bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}; the channels' count "
        f"{rec['bound_channels_ms']:.4f} ms, with its re-reads "
        f"{rec['bound_with_rereads_ms']:.4f} ms), plain "
        f"{rec['plain_ms']:.2f} ms, index_add_ "
        + (f"{rec['library_ms']:.3f} ms" if rec["library_ms"] is not None
           else "not timed"))
    return rec


def b3_split_ops(bins, rows, B, grad, hess, member, lid, leaf):
    """The device operations of one onehot split's histogram before (PR
    17's: the member mask, the [3, Npad] channels, their scales, the
    previous kernel) and after (histogram_chunked_leaf: two kernels), from
    device_ops_per_call; the shipped call must be two kernels, no copy, no
    memset."""
    from lightgbm_tpu_torch.ops import histogram as th
    prev = prev_designs()

    def before():
        m = (lid == leaf).to(grad.dtype) * member
        w3 = th.chunked_channels(grad, hess, m)
        return prev.prev_histogram_chunked(bins, w3, B, th.channel_scales(w3))

    rec = {"before": device_ops_per_call(before),
           "after": device_ops_per_call(
               lambda: th.histogram_chunked_leaf(bins, grad, hess, member, B,
                                                 lid, leaf, rows=rows))}
    ops = rec["after"]
    require(ops is None or (ops["kernel"] == 2 and ops["memcpy"] == 0
                            and ops["memset"] == 0),
            f"B3: device operations a split {ops}")
    log("B3: device operations of a split's histogram, before "
        + json.dumps({k: v for k, v in (rec["before"] or {}).items()
                      if k != "names"})
        + ", after " + json.dumps({k: v for k, v in (ops or {}).items()
                                   if k != "names"}))
    return rec


def b3_tree_check(bst):
    """One more tree of ``bst`` (the fused grower on the onehot path) with
    every B3 call held to its plain version bit for bit (the grower's
    _hist hooked as split_breakdown hooks it).  Returns (record, the
    tree's gradients, hessians, member and final leaf ids)."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as th
    g = bst.gbdt.grower
    orig = g._hist
    seen = {"calls": 0, "member_rows": []}

    def hooked(binsT, grad, hess, member, leaf_id=None, leaf=-1):
        out = orig(binsT, grad, hess, member, leaf_id, leaf)
        want = th.histogram_chunked_leaf_plain(binsT, grad, hess, member,
                                               g.B, leaf_id, leaf)
        require(torch.equal(out, want), f"B3 call {seen['calls']} of the "
                "checked tree differs from its plain version")
        seen["calls"] += 1
        m = member if leaf_id is None else (leaf_id == leaf) * member
        seen["member_rows"].append(int((m != 0).sum().item()))
        seen["inputs"] = (grad, hess, member, leaf_id)
        return out

    g._hist = hooked
    try:
        bst.update()
    finally:
        g._hist = orig
    grad, hess, member, lid = seen.pop("inputs")
    rows = seen.pop("member_rows")
    rec = {"calls": seen["calls"], "rows_summed": int(sum(rows)),
           "root_rows": rows[0], "rows_over_root": sum(rows) / rows[0]}
    log(f"B3: every call of one more tree = its plain version "
        f"({rec['calls']} calls; their member rows {rec['rows_over_root']:.2f}"
        f" x the root's)")
    return rec, (grad, hess, member, lid.clone())


def library_b3_ms(bins, w3, B, reps):
    """One torch index_add_ of the three channels of the member rows into
    [G * B, 3]: what B3 computes, its flat keys and values made before
    the clock starts."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as th
    G = bins.shape[0]
    rows = torch.nonzero(w3[2] != 0).squeeze(1)
    b = th.widen_bins(bins[:, rows]).long()
    keys = (b + torch.arange(G, device=b.device)[:, None] * B).reshape(-1)
    del b
    vals = w3[:, rows].t().contiguous()[None].expand(G, -1, -1).reshape(
        -1, 3)
    out = torch.zeros((G * B, 3), dtype=torch.float32, device=bins.device)
    ms = time_ms(lambda i: out.index_add_(0, keys, vals), reps)
    del keys, vals, out
    torch.cuda.empty_cache()
    return ms


def wide_kernel_phase(bst):
    """B3, K2-u16 and P1-u16 at the main path's shapes on the max_bin 1023
    booster's device bins.  B3: one more tree with every call held to its
    plain version (b3_tree_check), then with that tree's gradients its
    root, every other row, the tree's leaves nearest 5% and 0.5% of the
    rows, one row and no row (b3_check, in turns with the previous
    design), the device operations of a split (b3_split_ops), pass 1
    alone against its plain version (the list and the scales) at the root
    and the 5% leaf, then B3 at B3_SWEEP_ROWS random rows for each B of
    B3_SWEEP through the entry on channels; K2-u16 with the first tree's
    first split over every row; P1-u16 over the bins with the booster's
    trees.  Each against its plain version bit for bit, timed beside its
    bound.  Returns {kernel name: record}."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.models.device_predict import TreeStack
    from lightgbm_tpu_torch.models.grower_frontier import host_meta
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops import predict as tp
    gb = bst.gbdt
    bins, B = gb.bins, gb.num_bins
    G, W = bins.shape
    dev = bins.device
    tree, (grad, hess, member, lid) = b3_tree_check(bst)
    rows = th.chunked_rows(bins)
    n = int((member != 0).sum().item())
    sizes = torch.bincount(lid[member != 0].long()).float()
    near = {f: int((sizes - f * n).abs().argmin().item())
            for f in (0.05, 0.005)}
    half = (torch.arange(W, device=dev) % 2).to(torch.int32)
    one = torch.full_like(lid, -1)
    one[n // 2] = 0
    out = {}
    tag = "HIGGS max_bin 1023, "
    b3 = b3_check(bins, rows, B, tag + "root", grad, hess, member)
    for key, shape, L, leaf in (
            ("half_rows", "every other row", half, 0),
            ("leaf_5pct", f"the tree's leaf {near[0.05]}", lid, near[0.05]),
            ("leaf_0_5pct", f"the tree's leaf {near[0.005]}", lid,
             near[0.005]),
            ("one_row", "one row", one, 0),
            ("empty_leaf", "no row", lid, int(sizes.numel()) + 7)):
        b3[key] = b3_check(bins, rows, B, tag + shape, grad, hess, member,
                           L, leaf)
    b3["tree"] = tree
    b3["split_device_ops"] = b3_split_ops(bins, rows, B, grad, hess, member,
                                          lid, near[0.05])
    # pass 1 alone: the list and the scales against its plain version
    sel = None
    for key, L, leaf in (("root", None, -1), ("leaf_5pct", lid, near[0.05])):
        want = th.chunked_select_plain(grad, hess, member, L, leaf)
        got = th.chunked_select(grad, hess, member, L, leaf)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"B3 pass 1 ({key}): differs from its plain version")
        members = int(want[0].numel())
        r = {"max_abs_err": 0.0, "member_rows": members,
             "ms": time_ms(lambda i: th._launch_select(
                 grad, hess, member, L, leaf, False, None), 10),
             "plain_ms": time_ms(lambda i: th.chunked_select_plain(
                 grad, hess, member, L, leaf), 1),
             "library_ms": None,
             "shape": f"{tag}{key}: {W} rows, {members} members"}
        # member (and leaf id) a row, a member's channels, its list entry
        r["bound_ms"], r["bound_by"] = bound_ms(
            (4 if L is not None else 0) * W + 4 * W + members * (8 + 12),
            0.0)
        log(f"B3 pass 1 {key}: bit for bit its plain version, "
            f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.2f} ms")
        if sel is None:
            sel = r
        else:
            sel[key] = r
    out["histogram_chunked_select"] = sel
    sweep = []
    g = torch.Generator(device=dev).manual_seed(28)
    n = B3_SWEEP_ROWS
    gs = torch.randn(n, device=dev, generator=g)
    hs = torch.rand(n, device=dev, generator=g) * 0.25
    ms = (torch.rand(n, device=dev, generator=g) < 0.8).float()
    w3 = th.chunked_channels(gs, hs, ms)
    for nb, wide in B3_SWEEP:
        raw = torch.randint(0, nb, (G, n), device=dev, generator=g)
        sb = (raw.to(torch.int32).to(torch.int16) if wide
              else raw.to(torch.uint8))
        del raw
        r = b3_check(sb, th.chunked_rows(sb), nb,
                     f"{n} random rows, B {nb}", gs, hs, ms, w3=w3,
                     reps=3 if nb > 8192 else 10)
        r.update(B=nb, u16=wide)
        sweep.append(r)
        del sb
    b3["sweep"] = sweep
    out["histogram_chunked_u16"] = b3
    del rows
    torch.cuda.empty_cache()
    # K2-u16: the first tree's first split, every row in leaf 0
    t = gb.models[0]
    f = int(t.split_feature_inner[0])
    fm = host_meta(gb.fmeta)
    route = th.pack_route(0, 1, f, int(t.threshold_in_bin[0]),
                          bool(t.decision_type[0] & 2),
                          bool(t.decision_type[0] & 1),
                          np.zeros(8, np.uint32), fm)
    rb = gb.grower.rb
    lid0 = torch.zeros(W, dtype=torch.int32, device=bins.device)
    want = th.route_window_plain(bins, lid0.clone(), 0, W // rb, route, rb)
    before = kernels.LAUNCHES["route_window_u16"]
    got = th.route_window(bins, lid0.clone(), 0, W // rb, route, rb)
    torch.cuda.synchronize()
    require(kernels.LAUNCHES["route_window_u16"] - before == 1,
            "K2-u16: not one launch a call")
    require(torch.equal(got, want), "K2-u16: differs from the plain "
            "version")
    moved = int((want == 1).sum().item())
    ids = [lid0.clone() for _ in range(11)]
    k2 = {"max_abs_err": 0.0,
          "ms": time_ms(lambda i: th.route_window(bins, ids[i], 0, W // rb,
                                                  route, rb), 10),
          "plain_ms": time_ms(lambda i: th.route_window_plain(
              bins, lid0.clone(), 0, W // rb, route, rb), 1),
          "library_ms": None, "moved_rows": moved,
          "shape": f"first split: {W} rows, {moved} routed, u16 bins"}
    k2["bound_ms"], k2["bound_by"] = bound_ms(W * (2 + 4) + moved * 4, W)
    log(f"K2-u16: bit for bit the plain version, {k2['ms']:.4f} ms, bound "
        f"{k2['bound_ms']:.4f} ms, plain {k2['plain_ms']:.2f} ms")
    out["route_window_u16"] = k2
    # P1-u16 over the training bins with the booster's trees
    trees = gb.models
    stack = TreeStack(trees, [0] * len(trees),
                      gb.train_set.num_used_features, gb.device,
                      gb.route_tables[0])
    start = gb.train_score.to(torch.float64).reshape(1, -1).contiguous()
    nb_, db_ = gb.fmeta.num_bin, gb.fmeta.default_bin
    want = tp.route_trees_plain(bins, stack, nb_, db_, start.clone(),
                                wide=True)
    before = kernels.LAUNCHES["route_trees_u16"]
    got = tp.route_trees(bins, stack, nb_, db_, start.clone(), wide=True)
    torch.cuda.synchronize()
    require(kernels.LAUNCHES["route_trees_u16"] - before == 1,
            "P1-u16: not one launch a call")
    require(torch.equal(got, want), "P1-u16: differs from the plain version")
    scratch = start.clone()
    nbytes, parts = route_bytes(bins, stack, trees, nb_, db_,
                                start.shape[1], 1, wide=True)
    p1 = {"max_abs_err": 0.0,
          "ms": time_ms(lambda i: tp.route_trees(bins, stack, nb_, db_,
                                                 scratch, wide=True), 10),
          "plain_ms": time_ms(lambda i: tp.route_trees_plain(
              bins, stack, nb_, db_, scratch, wide=True), 1),
          "library_ms": None, **parts,
          "shape": f"{start.shape[1]} rows x {G} u16 columns, "
                   f"{len(trees)} trees of 255 leaves"}
    p1["bound_ms"], p1["bound_by"] = bound_ms(nbytes,
                                              float(W) * len(trees))
    log(f"P1-u16: bit for bit the plain version, {p1['ms']:.4f} ms, bound "
        f"{p1['bound_ms']:.4f} ms ({p1['bound_by']}), plain "
        f"{p1['plain_ms']:.2f} ms")
    out["route_trees_u16"] = p1
    return out


def wide_cat_phase():
    """(b) multiclass_cat's 1M rows with 8 categorical columns of
    WIDE_CATEGORIES Zipf-like categories (more than 256 bins each), 5
    classes, 31 leaves, WIDE_ITERS iterations on the onehot path: B3-u16
    once a node, holdout multi_logloss (no gate).  Returns (launches,
    record)."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import kernels
    X, y = wide_multiclass_cat(MC_ROWS + HOLDOUT_ROWS, 70)
    Xh, yh = X[MC_ROWS:], y[MC_ROWS:]
    X, y = X[:MC_ROWS], y[:MC_ROWS]
    t0 = time.perf_counter()
    ds = lt.Dataset(X, y, categorical_feature=MC_CAT)
    ds.construct(lt.Config.from_params(MC_PARAMS))
    bin_s = time.perf_counter() - t0
    h = ds._handle
    cat_bins = [int(h.bin_mappers[f].num_bin) for f in MC_CAT]
    require(min(cat_bins) > 256, f"the wide categoricals hold {cat_bins} "
            "bins")
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    bst = lt.Booster(MC_PARAMS, ds)
    bst.add_valid(ds.create_valid(Xh, yh), "holdout")
    loss = []
    for _ in range(WIDE_ITERS):
        bst.update()
        loss.append(float(bst.eval_valid()[0][2]))
    torch.cuda.synchronize()
    run = dict(kernels.LAUNCHES)
    gb = bst.gbdt
    nodes = sum(t.num_leaves for t in gb.models)
    require(gb.hist_backend == "onehot"
            and run["histogram_chunked_u16"] == nodes
            and run["histogram_chunked_select"] == nodes,
            f"wide categoricals: {gb.hist_backend}, B3-u16 "
            f"{run['histogram_chunked_u16']} launches for {nodes} nodes")
    cat_nodes = sum(int(t.num_cat) for t in gb.models)
    rec = {"binning_s": bin_s, "categorical_bins": cat_bins,
           "iter_seconds": list(gb.iter_seconds),
           "median_iter_s": float(np.median(gb.iter_seconds)),
           "peak_device_bytes": int(torch.cuda.max_memory_allocated()),
           "holdout_multi_logloss": loss, "categorical_nodes": cat_nodes,
           "launches": {k: v for k, v in run.items() if v}}
    log(f"wide categoricals: {cat_bins} bins, median iteration "
        f"{rec['median_iter_s']:.4f} s, holdout multi_logloss {loss[-1]:.5f}"
        f", {cat_nodes} categorical nodes")
    del bst, gb, ds
    torch.cuda.empty_cache()
    return run, rec, (X[:PARITY_ROWS], y[:PARITY_ROWS])


def gpu_use_dp_phase(ds63, Xh, yh, auc63):
    """(c) gpu_use_dp=True on phase 3's max_bin 63 bins: one-byte bins
    through B3 on the fused grower, WIDE_ITERS iterations: B3 once a node,
    holdout AUC beside the max_bin 63 run's.  Returns (launches, record)."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import kernels
    params = dict(TRAIN_PARAMS, gpu_use_dp=True)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    bst = lt.Booster(params, ds63)
    bst.add_valid(ds63.create_valid(Xh, yh), "holdout")
    auc = []
    for _ in range(WIDE_ITERS):
        bst.update()
        auc.append(_holdout_auc(bst))
    torch.cuda.synchronize()
    run = dict(kernels.LAUNCHES)
    gb = bst.gbdt
    nodes = sum(t.num_leaves for t in gb.models)
    require(gb.hist_backend == "onehot" and not gb.train_set.wide
            and run["histogram_chunked"] == nodes
            and run["histogram_chunked_select"] == nodes
            and run["route_window"] == nodes - len(gb.models),
            f"gpu_use_dp: {gb.hist_backend}, B3 {run['histogram_chunked']} "
            f"launches for {nodes} nodes")
    rec = {"iter_seconds": list(gb.iter_seconds),
           "median_iter_s": float(np.median(gb.iter_seconds)),
           "peak_device_bytes": int(torch.cuda.max_memory_allocated()),
           "holdout_auc": auc, "holdout_auc_max_bin_63_run": auc63,
           "launches": {k: v for k, v in run.items() if v}}
    from lightgbm_tpu_torch.ops import histogram as th
    grad, hess, member = acc_gradients(gb)
    rec["b3_root"] = b3_check(gb.bins, th.chunked_rows(gb.bins),
                              gb.num_bins, "HIGGS root, max_bin 63 (u8)",
                              grad, hess, member)
    log(f"gpu_use_dp: median iteration {rec['median_iter_s']:.4f} s, "
        f"holdout AUC {auc[-1]:.5f} (the max_bin 63 run {auc63:.5f})")
    del bst, gb
    torch.cuda.empty_cache()
    return run, rec


def _format_rows(args):
    """One block of rows as text (a process of file_phase's pool):
    ("csv", label, weight-free features) or ("svm", ...)."""
    import io
    import numpy as np
    kind, y, X = args
    buf = io.BytesIO()
    if kind == "csv":
        np.savetxt(buf, np.column_stack([y, X]), fmt="%.9g", delimiter=",")
    else:
        fmt = " ".join(["%d"] + [f"{i}:%.9g" for i in range(X.shape[1])])
        np.savetxt(buf, np.column_stack([y, X]), fmt=fmt)
    return buf.getvalue()


def write_text_files(X, y, w, directory):
    """The rows as a CSV with a header (label column "label") and a
    ``.weight`` side file, and as LibSVM; formatted by processes, one
    block of rows each, which stop before this returns.  Returns
    (csv path, libsvm path)."""
    import multiprocessing
    import numpy as np
    from concurrent.futures import ProcessPoolExecutor
    n = X.shape[0]
    blocks = [(s, min(s + 65536, n)) for s in range(0, n, 65536)]
    paths = {}
    # spawned, not forked: the parent holds a CUDA context and threads
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        for kind in ("csv", "svm"):
            path = os.path.join(directory, f"higgs.{kind}")
            with open(path, "wb") as fh:
                if kind == "csv":
                    fh.write((",".join(["label"] + [
                        f"f{i}" for i in range(X.shape[1])]) + "\n").encode())
                for part in pool.map(_format_rows, [
                        (kind, y[a:b], X[a:b]) for a, b in blocks]):
                    fh.write(part)
            paths[kind] = path
    np.savetxt(paths["csv"] + ".weight", w, fmt="%.6g")
    return paths["csv"], paths["svm"]


def model_body(text, names=True):
    """A model text without its parameters section (the dataset's file
    parameters print there), and without the feature_names line unless
    ``names``."""
    body = text.split("\nparameters:")[0]
    if not names:
        body = "\n".join(line for line in body.splitlines()
                          if not line.startswith("feature_names="))
    return body


def file_phase(X, y):
    """(d) file input on the first FILE_ROWS HIGGS rows: written as a CSV
    (header, named label column, ``.weight`` side file) and as LibSVM;
    each loaded with lt.Dataset(path), the CSV with two_round off and on:
    the bins byte for byte lt.Dataset(matrix) of the parsed values (with
    two_round, binned on its dataset's bounds, which its reservoir sample
    sets: the JAX loader's), the native tokenizer and binner run;
    WIDE_ITERS iterations from each file = the matrix's model text;
    save_binary then the .bin's model = it too; predict(path) =
    predict(matrix).  Parse MB/s and binning seconds,
    native against the Python versions (on FILE_PY_ROWS rows).  Returns
    (launches, record)."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.core import binning, native, parser
    from lightgbm_tpu_torch.ops import kernels
    d = tempfile.mkdtemp(prefix="file_input_")
    n = min(FILE_ROWS, X.shape[0])
    Xf, yf = X[:n], y[:n]
    w = np.round(np.random.RandomState(9).uniform(0.5, 1.5, n), 3)
    t0 = time.perf_counter()
    csv, svm = write_text_files(Xf, yf, w, d)
    rec = {"rows": n, "write_s": time.perf_counter() - t0,
           "csv_mb": os.path.getsize(csv) / 1e6,
           "libsvm_mb": os.path.getsize(svm) / 1e6}
    base = dict(TRAIN_PARAMS, num_leaves=63)
    csv_params = dict(base, header=True, label_column="name:label")
    used0 = dict(native.USED)
    loads = {}
    for name, path, params in (
            ("csv", csv, csv_params),
            ("csv_two_round", csv, dict(csv_params, two_round=True)),
            ("libsvm", svm, base)):
        t0 = time.perf_counter()
        ds = lt.Dataset(path, params=params)
        ds.construct(lt.Config.from_params(params))
        loads[name] = (ds, params, time.perf_counter() - t0)
    require(native.USED["densetext"] > used0["densetext"]
            and native.USED["textparse"] > used0["textparse"]
            and native.USED["fastbin"] > used0["fastbin"],
            f"the native tokenizers and binner did not all run: "
            f"{native.USED} (before {used0})")
    # the parsed values, as a matrix
    mat = parser._read_dense_matrix(csv, ",", 1)
    Xm = np.ascontiguousarray(mat[:, 1:])
    require(np.array_equal(mat[:, 0], yf), "the CSV's labels differ")
    t0 = time.perf_counter()
    mds = lt.Dataset(Xm, yf, weight=w, feature_name=[
        f"f{i}" for i in range(Xm.shape[1])])
    mds.construct(lt.Config.from_params(base))
    rec["matrix_binning_s"] = time.perf_counter() - t0
    # two_round bins on its reservoir sample's bounds (the JAX loader's):
    # the parsed matrix binned on those bounds
    tds = lt.Dataset(Xm, yf, weight=w, reference=loads["csv_two_round"][0])
    tds.construct(lt.Config.from_params(base))
    for name, (ds, params, wall) in loads.items():
        h = ds._handle
        ref = tds if name == "csv_two_round" else mds
        require(np.array_equal(h.bins_t, ref._handle.bins_t),
                f"file input {name}: bins differ from the parsed matrix's")
        if name != "libsvm":
            require(np.array_equal(h.metadata.weights,
                                   mds._handle.metadata.weights),
                    f"file input {name}: the .weight side file differs")
        rec[f"{name}_load_s"] = wall
    kernels.reset_launches()
    models = {}
    for name, ds in (("matrix", mds), ("csv", loads["csv"][0]),
                     ("matrix_two_round", tds),
                     ("csv_two_round", loads["csv_two_round"][0])):
        bst = lt.train(base, ds, WIDE_ITERS)
        models[name] = bst.model_to_string()
        if name == "matrix":
            mbst = bst
    run = dict(kernels.LAUNCHES)
    for name, ref in (("csv", "matrix"), ("csv_two_round",
                                          "matrix_two_round")):
        require(model_body(models[name]) == model_body(models[ref]),
                f"file input {name}: the model differs from the matrix's")
    # LibSVM has no weights: its model is the unweighted matrix's
    svm_model = lt.train(base, loads["libsvm"][0], WIDE_ITERS)
    plain = lt.train(base, lt.Dataset(Xm, yf), WIDE_ITERS)
    require(model_body(svm_model.model_to_string(), False)
            == model_body(plain.model_to_string(), False),
            "file input libsvm: the model differs from the matrix's")
    binp = os.path.join(d, "higgs.bin")
    loads["csv"][0].save_binary(binp)
    again = lt.train(base, lt.Dataset(binp), WIDE_ITERS).model_to_string()
    require(model_body(again) == model_body(models["matrix"]),
            "file input: the binary dataset's model differs")
    pred_file = mbst.predict(csv, data_has_header=True, raw_score=True)
    pred_mat = mbst.predict(Xm, raw_score=True)
    require(np.array_equal(pred_file, pred_mat),
            "file input: predict(path) differs from predict(matrix)")
    # parse rates: the native readers as lt.Dataset(path) runs them (a
    # piece of the file a thread) over the whole file, and on one thread
    # and the Python readers over FILE_PY_ROWS rows
    with open(csv, "rb") as fh:
        data = fh.read()
    body = data.split(b"\n", 1)[1]
    with open(svm, "rb") as fh:
        sdata = fh.read()
    for kind, text, threads, one, python in (
            ("csv", body, lambda b: parser._dense_block(b, ","),
             lambda b: native.parse_dense_native(b, ","),
             lambda b: parser._parse_dense(b.decode().splitlines(), ",")),
            ("libsvm", sdata, parser._libsvm_native,
             native.parse_libsvm_native,
             lambda b: parser._parse_libsvm(b.decode().splitlines()))):
        head = text[:text.find(b"\n", len(text) * FILE_PY_ROWS // n) + 1]
        for name, fn, part in (("native", threads, text),
                               ("native_1_thread", one, head),
                               ("python", python, head)):
            t0 = time.perf_counter()
            fn(part)
            rec[f"{kind}_parse_{name}_mb_s"] = len(part) / 1e6 / (
                time.perf_counter() - t0)
    # binning: the bounds of every feature, native and Python
    sample = Xm[:200_000]
    t_nat = t_py = 0.0
    for f in range(Xm.shape[1]):
        v = np.sort(sample[:, f])
        dv, cnt = np.unique(v, return_counts=True)
        t0 = time.perf_counter()
        a = binning.greedy_find_bin(dv, cnt, 63, len(v), 3)
        t1 = time.perf_counter()
        b = binning.greedy_find_bin_py(dv, cnt, 63, len(v), 3)
        t_py += time.perf_counter() - t1
        t_nat += t1 - t0
        require(a == b, f"feature {f}: native bounds differ from Python's")
    rec["bin_bounds_native_s"], rec["bin_bounds_python_s"] = t_nat, t_py
    ms = mds._handle.bin_mappers
    used = list(range(Xm.shape[1]))
    t0 = time.perf_counter()
    q = native.quantize_rows_native(Xm, used, ms, np.uint8)
    rec["quantize_native_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for f in used:
        require(np.array_equal(q[:, f], ms[f].value_to_bin(Xm[:, f])),
                f"feature {f}: native bins differ from value_to_bin")
    rec["quantize_python_s"] = time.perf_counter() - t0
    log(f"file input: {n} rows, CSV {rec['csv_mb']:.1f} MB (load "
        f"{rec['csv_load_s']:.2f} s, two-round "
        f"{rec['csv_two_round_load_s']:.2f} s), LibSVM "
        f"{rec['libsvm_mb']:.1f} MB (load {rec['libsvm_load_s']:.2f} s); "
        f"parse CSV "
        f"{rec['csv_parse_native_mb_s']:.1f} MB/s native "
        f"({rec['csv_parse_native_1_thread_mb_s']:.1f} on one thread), "
        f"{rec['csv_parse_python_mb_s']:.1f} Python; LibSVM "
        f"{rec['libsvm_parse_native_mb_s']:.1f} native "
        f"({rec['libsvm_parse_native_1_thread_mb_s']:.1f} on one thread), "
        f"{rec['libsvm_parse_python_mb_s']:.1f} Python; bounds "
        f"{t_nat:.3f} s native, {t_py:.3f} Python; quantize "
        f"{rec['quantize_native_s']:.2f} s native, "
        f"{rec['quantize_python_s']:.2f} Python; the models of both files "
        f"and the .bin = the matrix's, predict(path) = predict(matrix)")
    import shutil
    shutil.rmtree(d, ignore_errors=True)
    del loads, mds, mbst
    torch.cuda.empty_cache()
    return run, rec


def wide_parity_phase(X, y, Xc, yc):
    """Card = CPU at PARITY_ROWS rows and 31 leaves, WIDE_PARITY_ITERS
    iterations: max_bin 1023, max_bin_by_feature, and (b)'s categoricals
    (5 classes, one iteration): the same splits up to a near-tie;
    whether the model texts are equal is recorded."""
    import lightgbm_tpu_torch as lt
    out = {}
    runs = (("max_bin_1023", X, y, dict(WIDE_PARAMS, num_leaves=31), None),
            ("max_bin_by_feature", X, y,
             dict(TRAIN_PARAMS, num_leaves=31,
                  max_bin_by_feature=WIDE_BY_FEATURE), None),
            ("wide_categoricals", Xc, yc, MC_PARAMS, MC_CAT))
    for name, Xr, yr, params, cats in runs:
        trees, texts = {}, {}
        # the 5-class run one iteration: the CPU's B3 twin is its wall
        iters = 1 if cats else WIDE_PARITY_ITERS
        for dev in ("cuda", "cpu"):
            p = dict(params, device_type=dev)
            ds = lt.Dataset(Xr, yr, categorical_feature=cats or "auto")
            bst = lt.train(p, ds, iters)
            require(bst.gbdt.hist_backend == "onehot",
                    f"wide parity {name} on {dev}: {bst.gbdt.hist_backend}")
            trees[dev] = bst.gbdt.models
            texts[dev] = bst.model_to_string()
        n, ties = _same_splits_near_tie(trees["cuda"], trees["cpu"],
                                        f"wide parity {name} card/CPU")
        require(n >= 20, f"wide parity {name}: {n} splits compared")
        out[name] = {"splits_compared": n, "near_ties": ties,
                     "model_text_equal": model_body(texts["cuda"])
                     == model_body(texts["cpu"])}
        log(f"wide parity {name}: card = CPU on {n} splits (near ties "
            f"{ties}), model text equal: {out[name]['model_text_equal']}")
    return out


def wide_phase(ds63, X, y, Xh, yh):
    """Phase 28: (a) wide_runs_phase and wide_kernel_phase, (b)
    wide_cat_phase, (c) gpu_use_dp_phase, (d) file_phase, card = CPU
    (wide_parity_phase).  Returns ({path: launches}, record, {kernel:
    record})."""
    import torch
    t0 = time.perf_counter()
    walls = {}

    def lap(name, t):
        walls[name] = time.perf_counter() - t
        return time.perf_counter()

    a_launches, rec, wbst = wide_runs_phase(ds63, X, y, Xh, yh)
    t = lap("wide_runs", t0)
    kern = wide_kernel_phase(wbst)
    auc63 = rec["runs"][0]["holdout_auc"][-1]
    del wbst
    torch.cuda.empty_cache()
    t = lap("kernels", t)
    b_launches, rec["wide_categoricals"], (Xc, yc) = wide_cat_phase()
    t = lap("wide_categoricals", t)
    c_launches, rec["gpu_use_dp"] = gpu_use_dp_phase(ds63, Xh, yh, auc63)
    kern["histogram_chunked"] = rec["gpu_use_dp"]["b3_root"]
    t = lap("gpu_use_dp", t)
    d_launches, rec["file_input"] = file_phase(X, y)
    t = lap("file_input", t)
    rec["card_cpu"] = wide_parity_phase(X[:PARITY_ROWS], y[:PARITY_ROWS],
                                        Xc, yc)
    lap("card_cpu", t)
    rec["walls_s"] = walls
    rec["phase_wall_s"] = time.perf_counter() - t0
    log(f"wide bins and file input: phase took {rec['phase_wall_s']:.1f} s "
        + json.dumps({k: round(v, 1) for k, v in walls.items()}))
    return ({"wide_bins": a_launches, "wide_categoricals": b_launches,
             "gpu_use_dp": c_launches, "file_input": d_launches},
            rec, kern)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import lightgbm_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: lightgbm_tpu_torch is not importable ({e}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2
    pkg = os.path.dirname(os.path.abspath(lightgbm_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        print(f"chip_smoke: lightgbm_tpu_torch was imported from {pkg}, not "
              "from this checkout", file=sys.stderr)
        return 2
    from lightgbm_tpu_torch import Config
    from lightgbm_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.perf_counter()
    _MARK[:] = [t_start, t_start]
    build = build_phase()
    card = card_line()
    mark("1 build")
    q1_device_ops_phase()
    mark("1 q1 device ops")

    t0 = time.perf_counter()
    X, y = higgs_like(HIGGS_ROWS + HOLDOUT_ROWS, 42)
    Xh, yh = X[HIGGS_ROWS:], y[HIGGS_ROWS:]
    X, y = X[:HIGGS_ROWS], y[:HIGGS_ROWS]
    ds = lightgbm_tpu_torch.Dataset(X, y)
    ds.construct(Config.from_params(TRAIN_PARAMS))
    log(f"data: {HIGGS_ROWS} x {N_FEATURES} generated and binned in "
        f"{time.perf_counter() - t0:.1f} s")
    mark("higgs data")

    t0 = time.perf_counter()
    results = kernel_phase(ds._handle, Config.from_params(TRAIN_PARAMS),
                           device)
    torch.cuda.empty_cache()
    log(f"kernels: phase took {time.perf_counter() - t0:.1f} s")
    mark("2 kernels")

    t0 = time.perf_counter()
    fk_results = frontier_kernel_phase(
        ds._handle, Config.from_params(TRAIN_PARAMS), device, "HIGGS",
        ((16, 5, True),))
    log(f"frontier kernels: HIGGS took {time.perf_counter() - t0:.1f} s")
    mark("9 frontier kernels")

    main_launches, train_stats, bst = train_phase(ds, Xh, yh)
    mark("3 train")
    late = late_split_phase(bst)
    mark("3b late split")
    results["histogram_segment_routed"]["late_split"] = late["by_value"]
    results["histogram_segment_routed_step"]["late_split"] = late["step"]
    # phase 23 at HIGGS: the in-training valid scores (P1 each iteration)
    # = the host walk, P1 against its plain version, predict on and off
    # every tree (phase 3b grew a fourth after train's best_iteration)
    valid_off = bst.predict(Xh, raw_score=True, num_iteration=0,
                            predict_device="off")
    require(np.array_equal(bst.gbdt.valid_scores[0], valid_off),
            "the card's in-training valid scores differ from the host walk")
    t_predict = time.perf_counter()
    results["route_trees"] = route_kernel_phase(bst)
    Xp, _ = higgs_like(PREDICT_ROWS, 43)
    predict_launches, predict_higgs = predict_phase("HIGGS", bst, Xp)
    t_predict = time.perf_counter() - t_predict
    del bst, Xp
    mark("23 predict")
    fr_launches, fr_stats, bst = frontier_train_phase(ds, Xh, yh,
                                                      train_stats)
    results["route_window"]["late_window"] = route_late_phase(bst)
    del bst
    mark("10 frontier train")
    unfused_launches, ds_1m, unfused_loop = unfused_phase()
    mark("4 unfused")
    tier_launches = frontier_tiers_phase(ds_1m)
    del ds_1m
    mark("11 frontier tiers")
    seg_text = parity_phase()
    mark("5 parity")
    fr_parity = frontier_parity_phase(seg_text)
    mark("12-13 frontier parity")
    t_session = time.perf_counter()
    session_launches, session = session_phase(ds, Xh, yh)
    mark("14 session")
    session["parity"] = session_parity_phase()
    mark("15 session parity")
    t_session = time.perf_counter() - t_session
    t_obj = time.perf_counter()
    weighted_kernels = weighted_kernel_phase(ds._handle, X)
    obj_launches, objectives = objectives_phase(ds, X, Xh, yh)
    objectives["weighted_kernels"] = weighted_kernels
    t_obj = time.perf_counter() - t_obj
    mark("17 objectives")
    t_modes = time.perf_counter()
    modes_launches, modes = modes_phase(ds, Xh, yh)
    t_modes = time.perf_counter() - t_modes
    mark("21 modes")
    t_acc = time.perf_counter()
    acc_launches, packed_acc, acc_kernels = packed_acc_phase(ds, Xh, yh)
    t_acc = time.perf_counter() - t_acc
    mark("26 packed_acc")
    t0 = time.perf_counter()
    sf_launches, split_features = split_features_phase(ds, X, y, Xh, yh)
    split_features["phase_wall_s"] = time.perf_counter() - t0
    log(f"split features: phase took {split_features['phase_wall_s']:.1f} s")
    mark("27 split features")
    wide_launches, wide, wide_kernels = wide_phase(ds, X, y, Xh, yh)
    del ds
    torch.cuda.empty_cache()
    mark("28 wide bins")
    t0 = time.perf_counter()
    p4_launches, packed4, p4_kernels = packed4_phase(X, y, Xh, yh)
    packed4["phase_wall_s"] = time.perf_counter() - t0
    log(f"packed4: phase took {packed4['phase_wall_s']:.1f} s")
    del X, y, Xh, yh
    torch.cuda.empty_cache()
    mark("25 packed4")

    t0 = time.perf_counter()
    X, y = multiclass_cat(MC_ROWS + HOLDOUT_ROWS, 7)
    Xh, yh = X[MC_ROWS:], y[MC_ROWS:]
    X, y = X[:MC_ROWS], y[:MC_ROWS]
    mc_config = Config.from_params(MC_PARAMS)
    ds = lightgbm_tpu_torch.Dataset(X, y, categorical_feature=MC_CAT)
    ds.construct(mc_config)
    log(f"mc data: {MC_ROWS} x {N_FEATURES} generated and binned in "
        f"{time.perf_counter() - t0:.1f} s")
    mark("mc data")
    t0 = time.perf_counter()
    mc_results = mc_kernel_phase(ds._handle, mc_config, device)
    torch.cuda.empty_cache()
    log(f"mc kernels: phase took {time.perf_counter() - t0:.1f} s")
    mark("6 mc kernels")
    t0 = time.perf_counter()
    fk_mc = frontier_kernel_phase(ds._handle, mc_config, device,
                                  "multiclass_cat",
                                  ((2, 5, True), (16, 5, False)))
    log(f"frontier kernels: multiclass_cat took "
        f"{time.perf_counter() - t0:.1f} s")
    mark("9 frontier kernels")
    mc_launches, mc_stats = mc_train_phase(ds, Xh, yh)
    mark("7 mc train")
    mc_parity_phase()
    mark("8 mc parity")
    t0 = time.perf_counter()
    mc_acc_launches, packed_acc["multiclass_cat"] = packed_acc_mc_phase(
        ds, Xh, yh)
    acc_launches.update(mc_acc_launches)
    packed_acc["phase_wall_s"] = t_acc + time.perf_counter() - t0
    log(f"packed_acc: phase took {packed_acc['phase_wall_s']:.1f} s")
    mark("26 packed_acc")
    t0 = time.perf_counter()
    mc_session_launches, session["multiclass_cat"] = session_mc_phase(
        ds, Xh, yh)
    t_session += time.perf_counter() - t0
    for k, v in mc_session_launches.items():
        session_launches[k] += v
    mark("16 session mc")
    t0 = time.perf_counter()
    ova_launches, objectives["multiclassova"] = ova_phase(ds, Xh, yh)
    t_obj += time.perf_counter() - t0
    for k, v in ova_launches.items():
        obj_launches[k] += v
    require(obj_launches["histogram_segment_routed_step"] > 0
            and obj_launches["score_gather_add"] > 0
            and obj_launches["histogram_all"] > 0,
            f"the objectives did not run the path's kernels: {obj_launches}")
    del ds, X, y, Xh, yh
    torch.cuda.empty_cache()
    mark("17 objectives")
    t0 = time.perf_counter()
    rank_launches, rank = lambdarank_phase()
    rank["phase_wall_s"] = time.perf_counter() - t0
    mark("18 lambdarank")
    require(rank_launches["histogram_segment_routed_step"] > 0,
            "lambdarank did not launch the K3 step entry")
    t0 = time.perf_counter()
    meta_parity = meta_parity_phase()
    meta_parity["phase_wall_s"] = time.perf_counter() - t0
    mark("19 meta parity")
    t0 = time.perf_counter()
    goss_launches, goss, goss_bst, goss_X = goss_phase()
    goss["phase_wall_s"] = time.perf_counter() - t0
    mark("20 goss")
    t0 = time.perf_counter()
    parity_launches, modes["parity"] = modes_parity_phase()
    modes["phase_wall_s"] = t_modes + time.perf_counter() - t0
    mark("22 modes parity")
    t0 = time.perf_counter()
    goss_predict_launches, predict_goss = predict_phase(
        "goss_regression", goss_bst, goss_X)
    del goss_bst, goss_X
    torch.cuda.empty_cache()
    mark("23 predict")
    walks = walks_parity_phase()
    t_predict += time.perf_counter() - t0
    mark("23 walks parity")
    predict_launches = {k: predict_launches[k] + goss_predict_launches[k]
                        for k in predict_launches}
    predict = {"higgs": predict_higgs, "goss_regression": predict_goss,
               "walks_parity": walks, "launches": predict_launches,
               "phase_wall_s": t_predict}
    modes_launches = {k: modes_launches[k] + parity_launches[k]
                      for k in modes_launches}
    require(goss_launches["histogram_segment_routed_step"] > 0
            and goss_launches["score_gather_add"] > 0,
            f"goss_regression did not run the path's kernels: "
            f"{goss_launches}")
    require(all(modes_launches[k] > 0 for k in (
        "histogram_segment_routed_step", "histogram_segment_step",
        "route_window_step", "score_gather_add", "histogram_all",
        "histogram_frontier", "histogram_frontier_routed")),
        f"the modes did not run the path's kernels: {modes_launches}")
    t0 = time.perf_counter()
    expo_launches, expo, expo_kernels = expo_phase()
    mark("24 expo")
    expo["bundle_parity"] = expo_bundle_parity_phase()
    mark("24 expo bundle parity")
    expo["cpu_parity"] = expo_cpu_parity_phase()
    mark("24 expo cpu parity")
    sparse_launches, expo["sparse_at_scale"] = sparse_at_scale_phase()
    mark("24 sparse at scale")
    expo["phase_wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    session["launches"] = session_launches
    session["phase_wall_s"] = t_session
    require(session_launches["histogram_segment_routed_step"] > 0
            and session_launches["score_gather_add"] > 0
            and session_launches["histogram_all"] > 0,
            f"the session did not run the path's kernels: {session_launches}")

    paths = {"unfused": unfused_launches, "fused": main_launches,
             "multiclass": mc_launches, "frontier": fr_launches,
             "frontier_k1": tier_launches["k1"],
             "frontier_fusedk": tier_launches["fusedk"],
             "session": session_launches, "objectives": obj_launches,
             "lambdarank": rank_launches, "goss_regression": goss_launches,
             "modes": modes_launches, "predict": predict_launches,
             "expo": expo_launches, "sparse_at_scale": sparse_launches}
    paths.update({f"packed4_{k}": v for k, v in p4_launches.items()})
    paths.update(acc_launches)
    paths.update(sf_launches)
    paths.update(wide_launches)
    records = []
    for name in kernels.KERNEL_NAMES:
        if name.endswith(kernels.WIDE_SUFFIX) or name in (
                "histogram_chunked", "histogram_chunked_select"):
            # phase 28's rows: B3's two kernels (pass 1; the histogram on
            # one-byte bins under gpu_use_dp, two-byte at max_bin 1023)
            # and the u16 modes of K2 and P1
            base = name.replace(kernels.WIDE_SUFFIX, "")
            path = "gpu_use_dp" if name == "histogram_chunked" \
                else "wide_bins"
            src, replaces = SOURCES[base]
            rec = {"name": name, "route": "cuda", "source": src,
                   "replaces": replaces,
                   "variant": ("pass 1" if name == "histogram_chunked_select"
                               else "u16" if name != base else "u8"),
                   "launches": paths[path][name], "path": path,
                   "launches_by_path": {k: v[name] for k, v in paths.items()
                                        if v[name]}}
            if base in ("histogram_chunked", "histogram_chunked_select",
                        "route_trees"):
                rec["no_pallas_site"] = (
                    "the JAX package computes this with XLA "
                    + ("(lightgbm_tpu/models/device_predict.py:99-149)"
                       if base == "route_trees" else
                       "(lightgbm_tpu/ops/histogram.py:32-97)"))
            rec.update(wide_kernels[name])
            records.append(rec)
            require(rec["launches"] > 0,
                    f"{name} was not launched on its path")
            log(json.dumps({k: v for k, v in rec.items() if k != "sweep"}))
            continue
        if (name.endswith(kernels.PACKED_ACC_SUFFIX)
                or name == "quantize_pack"):
            # phase 26's row: the packed-accumulator mode, and Q1
            p4 = kernels.PACKED4_SUFFIX in name
            base = name.replace(kernels.PACKED_ACC_SUFFIX, "").replace(
                kernels.PACKED4_SUFFIX, "")
            path = "packed_acc_" + ("p4_" if p4 else "") + {
                "histogram_segment": "segment_unfused",
                "histogram_segment_step": "segment_unfused",
                "quantize_pack": "segment_unfused",
                "histogram_segment_routed": "segment_fused",
                "histogram_segment_routed_step": "segment_fused",
                "histogram_frontier": "frontier",
                "histogram_frontier_routed": "tier_k1",
                "histogram_frontier_fusedk": "tier_fusedk"}.get(base, "")
            if base == "histogram_all":
                path = "leaf_histogram" + ("_packed4" if p4 else "")
            src, replaces = SOURCES[base]
            rec = {"name": name, "route": "cuda", "source": src,
                   "replaces": ACC_REPLACES.get(base, replaces),
                   "variant": ("packed4_" if p4 else "") + (
                       "packed_acc" if base != "quantize_pack" else "q1"),
                   "launches": paths[path][name], "path": path,
                   "launches_by_path": {k: v[name] for k, v in paths.items()
                                        if v[name]}}
            if base == "quantize_pack":
                rec["no_pallas_site"] = (
                    "the JAX package quantizes with XLA "
                    "(lightgbm_tpu/ops/pallas_histogram.py:188-233)")
            rec.update(acc_kernels[name])
            records.append(rec)
            require(rec["launches"] > 0,
                    f"{name} was not launched on its path")
            log(json.dumps(rec))
            continue
        if name.endswith(kernels.PACKED4_SUFFIX):
            # phase 25's row: the kernel's 4-bit packed input mode
            base = name[:-len(kernels.PACKED4_SUFFIX)]
            path = "packed4_" + {
                "histogram_segment": "unfused",
                "histogram_segment_step": "unfused",
                "route_window_step": "unfused",
                "route_window": "frontier",
                "histogram_all": "multiclass",
                "histogram_frontier": "frontier",
                "histogram_frontier_routed": "parity_frontier_k1",
                "histogram_frontier_fusedk": "parity_frontier_fusedk",
            }.get(base, "fused")
            src, replaces = SOURCES[base]
            rec = {"name": name, "route": "cuda", "source": src,
                   "replaces": replaces, "variant": "packed4",
                   "launches": paths[path][name], "path": path,
                   "launches_by_path": {k: v[name] for k, v in paths.items()
                                        if v[name]}}
            rec.update(p4_kernels[base])
            records.append(rec)
            require(rec["launches"] > 0,
                    f"{name} was not launched on its path")
            log(json.dumps(rec))
            continue
        r = dict(results.get(name, {}))
        r.update(mc_results.get(name, {}))
        r.update(fk_results.get(name, {}))
        path = {"histogram_segment": "unfused",
                "histogram_segment_step": "unfused",
                "route_window_step": "unfused",
                "route_window": "frontier",
                "histogram_all": "multiclass",
                "histogram_frontier": "frontier",
                "histogram_frontier_routed": "frontier_k1",
                "histogram_frontier_fusedk": "frontier_fusedk",
                "route_trees": "predict"}.get(name, "fused")
        src, replaces = SOURCES[name]
        rec = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": paths[path][name],
               "path": path, "launches_by_path": {
                   k: v[name] for k, v in paths.items()}}
        rec.update(r)
        if name == "histogram_all":
            rec["higgs"] = results["histogram_all_higgs"]
            # the fused grower's leaf histogram (phase 27)
            rec["fused_leaf"] = split_features["fused"]["k5"]
        if name in ("histogram_segment", "histogram_segment_routed",
                    "histogram_segment_step", "histogram_segment_routed_step",
                    "route_window", "route_window_step"):
            rec["build"] = build[{
                "histogram_segment": "K1", "histogram_segment_routed": "K3",
                "histogram_segment_step": "K1 step",
                "histogram_segment_routed_step": "K3 step",
                "route_window": "K2", "route_window_step": "K2 step"}[name]]
        if name == "route_trees":
            rec["no_pallas_site"] = (
                "the JAX package computes this route as XLA gathers "
                "(lightgbm_tpu/models/device_predict.py:99-149)")
            rec["predict_bins"] = {"higgs": predict_higgs["p1"],
                                   "goss_regression": predict_goss["p1"]}
            rec["multiclass_cat"] = mc_stats["p1"]
        if name in expo_kernels:
            # on the Expo rows' bundled columns (phase 24)
            rec["expo"] = expo_kernels[name]
        if name in fk_mc:
            rec["mc"] = fk_mc[name]
            rec["mc_k16"] = fk_mc[f"{name}_k16"]
            rec["build"] = build[
                "K6" if name == "histogram_frontier" else "K7"]
        records.append(rec)
        require(rec["launches"] > 0, f"{name} was not launched on its path")
        log(json.dumps(rec))
    log(json.dumps({"frontier_train": fr_stats,
                    "frontier_parity": fr_parity}))
    log(json.dumps({"device_loop": {
        "higgs_fused": train_stats["device_loop"],
        "higgs_1m_unfused": unfused_loop,
        "multiclass_cat": mc_stats["device_loop"]}}))
    log(json.dumps({"train": train_stats}))
    log(json.dumps({"mc_train": mc_stats}))
    log(json.dumps({"session": session}))
    log(json.dumps({"objectives": objectives, "objectives_wall_s": t_obj,
                    "lambdarank": rank, "meta_parity": meta_parity}))
    log(json.dumps({"goss_regression": goss, "modes": modes}))
    log(json.dumps({"predict": predict}))
    log(json.dumps({"expo_onehot": expo}))
    log(json.dumps({"packed4": packed4}))
    log(json.dumps({"packed_acc": packed_acc}))
    log(json.dumps({"split_features": split_features}))
    log(json.dumps({"wide_bins": wide}))
    mark("report")
    log(json.dumps({"phase_walls_s": PHASE_WALLS}))
    log(json.dumps({"kernels": records}))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
