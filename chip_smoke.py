#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port, lightgbm_tpu_torch, on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``lightgbm_tpu_torch/csrc`` and runs
sixteen phases; any failure exits non-zero:

  1. build    nvcc for sm_90a; prints ptxas's register/shared-memory lines
              and the card's name and power limit, and for the K1/K3,
              K5, K6/K7 and K2 kernels (their by-value and step entries)
              their registers, spills and atomic SASS opcodes (no
              ATOMS.CAS loop allowed).
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
              and categorical nodes.
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

Launch counts: a kernel captured into a CUDA graph counts at each replay
(ops/kernels.py count_replay), when the card runs it.

Output: one JSON line per kernel, a ``{"device_loop": ...}`` line (phases
3, 4 and 7), a ``{"session": ...}`` line (phases 14-16: walls, seeding
times, peak memory, launches by kernel; the kernels' ``launches_by_path``
holds them as "session"), one ``{"kernels": [...]}`` line, the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Without a
card, or run from a directory that does not hold the package, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
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


def bound_ms(nbytes: float, nops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1
def build_phase():
    """Builds the kernels; returns the build report of each hand-written
    histogram and route body: ptxas's stack, spill and register lines and
    the atomic SASS opcodes of each instantiation.  A 64-bit shared add,
    which sm_90a lacks, would show as an ATOMS.CAS loop: each histogram
    body must have none."""
    from lightgbm_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    kernels.library()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log().splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("ptxas: " + line.strip())
    report = {}
    # body -> (name of the instantiation without, with a route)
    for body, names in (("segment_window_kernel", ("K1", "K3")),
                        ("segment_step_kernel", ("K1 step", "K3 step")),
                        ("frontier_hist_kernel", ("K6", "K7")),
                        ("all_hist_kernel", ("K5", "K5")),
                        ("route_window_kernel", ("K2", "K2")),
                        ("route_step_kernel", ("K2 step", "K2 step"))):
        ptxas = kernels.ptxas_lines(body)
        sass = kernels.sass_opcodes(body)
        part = {}
        for fn in sorted(set(ptxas) | set(sass)):
            ops = sass.get(fn, {})
            part[names[1] if "ILb1E" in fn else names[0]] = {
                "ptxas": ptxas.get(fn, []),
                "atomics": {k: v for k, v in sorted(ops.items())
                            if k.startswith(("ATOMS", "ATOM", "RED"))},
                "atoms_cas": sum(v for k, v in ops.items()
                                 if k.startswith("ATOMS.CAS"))}
        log(f"{body} build: {json.dumps(part)}")
        require(set(part) == set(names) and len(ptxas) == len(set(names)),
                f"{body}'s instantiations are missing from the build")
        for name, rec in part.items():
            require(rec["atoms_cas"] == 0, f"{name} ({body}) has "
                    f"{rec['atoms_cas']} ATOMS.CAS loops")
        report.update(part)
    return report


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 2
def hist_abs_sums(th, binsT, w8, lid, lo_blk, n_blk, target, B, rb):
    """Per-bin sums of |gradient| and |hessian| (the tolerance's scale),
    by the plain histogram over absolute-valued channels."""
    return th.histogram_segment_plain(binsT, abs_channel_sets(w8), lid,
                                      lo_blk, n_blk, target, B, rb)


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


def check_histogram_all(th, binsT, w8C, B, rb, tag):
    """K5 against its plain version: counts exact, sums in tolerance, a
    relaunch bit-identical, and class c's slice bit-identical to K1 on a
    root of class c at the class's scale.  Returns (max |diff|, scales)."""
    import torch
    F, npad = binsT.shape
    C = w8C.shape[0] // 8
    scales = th.class_scales(w8C)
    want = th.histogram_all_plain(binsT, w8C, B)
    a = th.histogram_all(binsT, w8C, B, scales)
    b = th.histogram_all(binsT, w8C, B, scales)
    torch.cuda.synchronize()
    require(torch.equal(a, b), f"histogram_all {tag}: a second launch "
            "differs from the first")
    abs_sums = th.histogram_all_plain(binsT, abs_channel_sets(w8C), B)
    err = check_hist(f"histogram_all {tag}", a, want, abs_sums)
    lid0 = torch.zeros(npad, dtype=torch.int32, device=binsT.device)
    for c in range(C):
        root = th.histogram_segment(binsT, w8C[8 * c:8 * c + 8], lid0, 0,
                                    npad // rb, 0, B, rb, scales[c])
        require(torch.equal(a[c], root), f"histogram_all {tag}: class {c} "
                "differs from the K1 root of that class")
    log(f"histogram_all {tag}: {C} sets, counts exact, max |diff| "
        f"{err:.3g}, class slices equal the K1 roots")
    return err, scales


def check_step_entries(th, binsT, w8, scales, lid, B, rb, cases, tag):
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
                                              target, route, B, rb, scales)
        ids = lid.clone()
        _, got = th.histogram_segment_routed_step(binsT, w8, ids, step, B,
                                                  rb, scales)
        k2 = th.route_window_step(binsT, lid.clone(), step, rb)
        k1 = th.histogram_segment_step(binsT, w8, want_ids, step, B, rb,
                                       scales)
        k1_by = th.histogram_segment(binsT, w8, want_ids, lo, nb, target, B,
                                     rb, scales)
        torch.cuda.synchronize()
        require(torch.equal(ids, want_ids) and torch.equal(got, want),
                f"histogram_segment_routed_step {tag} {name}: differs from "
                "the by-value entry")
        require(torch.equal(k2, want_ids), f"route_window_step {tag} {name}: "
                "differs from the by-value entry")
        require(torch.equal(k1, k1_by), f"histogram_segment_step {tag} "
                f"{name}: differs from the by-value entry")
        plain_ids, plain = th.histogram_segment_routed_step_plain(
            binsT, w8, lid.clone(), step, B, rb)
        require(torch.equal(plain_ids, ids), f"histogram_segment_routed_step "
                f"{tag} {name}: leaf ids differ from the plain version")
        abs_sums = hist_abs_sums(th, binsT, w8, ids, lo, nb, target, B, rb)
        key = "histogram_segment_routed_step"
        err[key] = max(err[key], check_hist(f"{key} {tag} {name}", got,
                                            plain, abs_sums))
        plain_k2 = th.route_window_step_plain(binsT, lid.clone(), step, rb)
        moved = int((k2 != plain_k2).sum().item())
        require(moved == 0, f"route_window_step {tag} {name}: {moved} leaf "
                "ids differ from the plain version")
        err["route_window_step"] = max(err["route_window_step"], moved)
        # K1 over the routed ids, as the unfused split runs it after K2
        plain_k1 = th.histogram_segment_step_plain(binsT, w8, want_ids, step,
                                                   B, rb)
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
    return launches, {"wall_s": wall, "iter_s": it_s,
                      "holdout_multi_logloss": ll, "splits": splits,
                      "categorical_splits": n_cat, "device_loop": loop}


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
def leaf_layout(th, binsT, fm, rb, levels):
    """2^levels leaves of the rows, each a split of every leaf on feature
    (level) at its middle bin, then the rows sorted by leaf as compaction
    leaves them.  Returns (perm, leaf_id, lo, hi) in the sorted order, lo
    and hi each leaf's window in blocks."""
    import numpy as np
    import torch
    F, npad = binsT.shape
    lid = torch.zeros(npad, dtype=torch.int32, device=binsT.device)
    none = np.zeros(8, np.uint32)
    for lvl in range(levels):
        f = lvl % F
        for leaf in range(1 << lvl):
            route = th.pack_route(leaf, leaf + (1 << lvl), f,
                                  int(fm.num_bin[f]) // 2, False, False,
                                  none, fm)
            th.route_window(binsT, lid, 0, npad // rb, route, rb)
    lid, perm = torch.sort(lid, stable=True)
    leaves = torch.arange(1 << levels, dtype=lid.dtype, device=lid.device)
    starts = torch.searchsorted(lid, leaves).tolist()
    ends = torch.searchsorted(lid, leaves, side="right").tolist()
    lo = [a // rb for a in starts]
    hi = [-(-b // rb) for b in ends]
    return perm, lid, lo, hi


def frontier_round(th, binsT, w8, scales, fm, feats, rb, K, levels, B, tag,
                   reps, plain_reps, timed=True):
    """One frontier round at this shape: leaves 0..K-1 of a 2^levels-leaf
    layout split into new leaves 2^levels + k, leaf k on feature
    feats[k % len(feats)] = (f, categorical): a numeric split at its middle
    bin, or a categorical one by a bitset of every other bin.  K6 on the
    routed ids (targets: the smaller children), K7 routed (the same
    targets) and K7 fused-K (parents then new leaves) against their plain
    versions.  Returns {kernel: measurement dict}."""
    import numpy as np
    import torch
    F, npad = binsT.shape
    perm, lid, lo, hi = leaf_layout(th, binsT, fm, rb, levels)
    binsT = binsT.index_select(1, perm)
    w8 = w8.index_select(1, perm)
    n_leaves = 1 << levels
    every_other = np.full(8, 0x55555555, np.uint32)
    routes, new = [], []
    for k in range(K):
        f, cat = feats[k % len(feats)]
        routes.append(th.pack_route(k, n_leaves + k, f,
                                    int(fm.num_bin[f]) // 2, k % 2 == 1,
                                    cat, every_other * cat, fm))
        new.append(n_leaves + k)
    routes = torch.stack(routes)
    bl, n = th.union_block_list(lo[:K], hi[:K], [True] * K)
    bl = bl.to(binsT.device)
    routed_lid, _ = th.histogram_frontier_routed_plain(
        binsT, w8, lid.clone(), bl, n, torch.tensor(new, dtype=torch.int32),
        routes, B, rb)
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
    for name, targets, rts in cases:
        KT = int(targets.shape[0])
        if rts is None:
            want_lid = routed_lid
            want = th.histogram_frontier_plain(binsT, w8, routed_lid, bl, n,
                                               targets, B, rb)
            runs = [(routed_lid, th.histogram_frontier(
                binsT, w8, routed_lid, bl, n, targets, B, rb, scales))
                for _ in range(2)]
        else:
            fn = getattr(th, name)
            want_lid, want = th.histogram_frontier_routed_plain(
                binsT, w8, lid.clone(), bl, n, targets, rts, B, rb)
            runs = []
            for _ in range(2):
                ids = lid.clone()
                got_lid, got = fn(binsT, w8, ids, bl, n, targets, rts, B, rb,
                                  scales)
                require(got_lid.data_ptr() == ids.data_ptr(),
                        f"{name}: leaf_id not updated in place")
                runs.append((got_lid, got))
        torch.cuda.synchronize()
        for got_lid, _ in runs:
            require(torch.equal(got_lid, want_lid), f"{name} {tag}: leaf ids "
                    "differ from the plain version")
        require(torch.equal(runs[0][1], runs[1][1]),
                f"{name} {tag}: a second launch differs from the first")
        abs_sums = th.histogram_frontier_plain(
            binsT, abs_channel_sets(w8), want_lid, bl, n, targets, B, rb)
        err = check_hist(f"{name} {tag}", runs[0][1], want, abs_sums)
        # slot j is K1 of its target over the window of the parent it came
        # from (split k = j mod K), bit for bit
        for j, t in enumerate(targets.tolist()):
            k = j % K
            k1 = th.histogram_segment(binsT, w8, want_lid, lo[k],
                                      hi[k] - lo[k], t, B, rb, scales)
            require(torch.equal(runs[0][1][j], k1), f"{name} {tag}: slot {j} "
                    f"differs from K1 of leaf {t}")
        tiling = th.frontier_tiling(F, B, KT, 0 if rts is None else K,
                                    int(th.frontier_params(targets, rts)[2]))
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
            nbytes = (U * 4 + 4 * n + R + moved * 4 * (rts is not None)
                      + M * (F + 10) + KT * F * B * 12)
            nops = U * (KT + (0 if rts is None else K)) + R * 20 + M * F * 3
            rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, nops)
            if rts is None:
                rec["ms"] = time_ms(lambda i: th.histogram_frontier(
                    binsT, w8, routed_lid, bl, n, targets, B, rb, scales),
                    reps)
                rec["plain_ms"] = time_ms(lambda i: th.histogram_frontier_plain(
                    binsT, w8, routed_lid, bl, n, targets, B, rb),
                    plain_reps)
            else:
                fn = getattr(th, name)
                ids = [lid.clone() for _ in range(reps + 1)]
                rec["ms"] = time_ms(lambda i: fn(
                    binsT, w8, ids[i], bl, n, targets, rts, B, rb, scales),
                    reps)
                ids = [lid.clone() for _ in range(plain_reps + 1)]
                rec["plain_ms"] = time_ms(
                    lambda i: th.histogram_frontier_routed_plain(
                        binsT, w8, ids[i], bl, n, targets, rts, B, rb),
                    plain_reps)
                del ids
            rows = _rows(bl, n, rb)[sel]
            slot_of = torch.full((n_leaves + K,), -1, dtype=torch.int64,
                                 device=lid.device)
            slot_of[targets.long().to(lid.device)] = torch.arange(
                KT, device=lid.device)
            rec["library_ms"] = library_hist_ms(
                binsT, [w8], rows, B, reps, slots=slot_of[want_lid[rows].long()],
                n_slots=KT)
            rec["shape"] = (f"{tag}: {U} listed rows of {npad}, {M} in the "
                            f"{KT} targets, {moved} routed, {F} x {B} bins")
            # one call is one launch: what the profiler sees on the card,
            # and a CUDA graph's capture and replay (a stream sync or a
            # pageable copy in the call would fail the capture)
            start = routed_lid if rts is None else lid
            call = ((lambda ids: th.histogram_frontier(
                binsT, w8, ids, bl, n, targets, B, rb, scales))
                if rts is None else (lambda ids: getattr(th, name)(
                    binsT, w8, ids, bl, n, targets, rts, B, rb, scales)[1]))
            rec.update(launch_report(f"{name} {tag}", call, start,
                                     runs[0][1], want_lid, reps))
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

    def recorded(binsT, leaf_id, start_block, n_blocks, route, block_rows):
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
    _, walk_s = _timed(lambda: last.predict_binned(vh.bins_t,
                                                   vh.feature_infos()))
    rec.update(best_iteration=bst.best_iteration, iterations=iters,
               wall_s=wall, iter_s=it_s, curve=curve,
               es_iteration_wall_s=wall / iters,
               iter_s_median=float(np.median(it_s)),
               eval_valid_s=ev_valid_s, eval_train_s=ev_train_s,
               valid_walk_tree_s=walk_s)
    log(f"session: an early-stopping iteration {wall / iters:.4f} s wall "
        f"against iter_seconds median {np.median(it_s):.4f} s; eval_valid "
        f"{ev_valid_s:.4f} s, eval_train {ev_train_s:.4f} s, one tree's "
        f"valid walk ({len(Xh)} rows) {walk_s:.4f} s")

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
    rec.update(continue_wall_s=cont_s, seed_host_walk_s=seed["host_walk"],
               seed_device_add_s=seed["device_add"],
               continue_iter_s=list(cont.gbdt.iter_seconds),
               continue_curve=cc)
    log(f"session: init_model + 5 rounds in {cont_s:.2f} s: seeding "
        f"{seed['host_walk']:.2f} s host walk of {iters} trees over "
        f"{ds.num_data()} raw rows, {seed['device_add']:.4f} s device adds; "
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
    log(f"session: rollback_one_iter {rb_s:.3f} s (a host walk of the "
        f"training bins), the next update {up_s:.3f} s")
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


def main() -> int:
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
    build = build_phase()
    card = card_line()

    t0 = time.perf_counter()
    X, y = higgs_like(HIGGS_ROWS + HOLDOUT_ROWS, 42)
    Xh, yh = X[HIGGS_ROWS:], y[HIGGS_ROWS:]
    X, y = X[:HIGGS_ROWS], y[:HIGGS_ROWS]
    ds = lightgbm_tpu_torch.Dataset(X, y)
    ds.construct(Config.from_params(TRAIN_PARAMS))
    log(f"data: {HIGGS_ROWS} x {N_FEATURES} generated and binned in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    results = kernel_phase(ds._handle, Config.from_params(TRAIN_PARAMS),
                           device)
    torch.cuda.empty_cache()
    log(f"kernels: phase took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    fk_results = frontier_kernel_phase(
        ds._handle, Config.from_params(TRAIN_PARAMS), device, "HIGGS",
        ((16, 5, True),))
    log(f"frontier kernels: HIGGS took {time.perf_counter() - t0:.1f} s")

    main_launches, train_stats, bst = train_phase(ds, Xh, yh)
    late = late_split_phase(bst)
    results["histogram_segment_routed"]["late_split"] = late["by_value"]
    results["histogram_segment_routed_step"]["late_split"] = late["step"]
    del bst
    fr_launches, fr_stats, bst = frontier_train_phase(ds, Xh, yh,
                                                      train_stats)
    results["route_window"]["late_window"] = route_late_phase(bst)
    del bst
    unfused_launches, ds_1m, unfused_loop = unfused_phase()
    tier_launches = frontier_tiers_phase(ds_1m)
    del ds_1m
    seg_text = parity_phase()
    fr_parity = frontier_parity_phase(seg_text)
    t_session = time.perf_counter()
    session_launches, session = session_phase(ds, Xh, yh)
    session["parity"] = session_parity_phase()
    t_session = time.perf_counter() - t_session
    del ds, X, y, Xh, yh
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    X, y = multiclass_cat(MC_ROWS + HOLDOUT_ROWS, 7)
    Xh, yh = X[MC_ROWS:], y[MC_ROWS:]
    X, y = X[:MC_ROWS], y[:MC_ROWS]
    mc_config = Config.from_params(MC_PARAMS)
    ds = lightgbm_tpu_torch.Dataset(X, y, categorical_feature=MC_CAT)
    ds.construct(mc_config)
    log(f"mc data: {MC_ROWS} x {N_FEATURES} generated and binned in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mc_results = mc_kernel_phase(ds._handle, mc_config, device)
    torch.cuda.empty_cache()
    log(f"mc kernels: phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fk_mc = frontier_kernel_phase(ds._handle, mc_config, device,
                                  "multiclass_cat",
                                  ((2, 5, True), (16, 5, False)))
    log(f"frontier kernels: multiclass_cat took "
        f"{time.perf_counter() - t0:.1f} s")
    mc_launches, mc_stats = mc_train_phase(ds, Xh, yh)
    mc_parity_phase()
    t0 = time.perf_counter()
    mc_session_launches, session["multiclass_cat"] = session_mc_phase(
        ds, Xh, yh)
    t_session += time.perf_counter() - t0
    for k, v in mc_session_launches.items():
        session_launches[k] += v
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
             "session": session_launches}
    records = []
    for name in kernels.KERNEL_NAMES:
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
                "histogram_frontier_fusedk": "frontier_fusedk"}.get(
                    name, "fused")
        src, replaces = SOURCES[name]
        rec = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": paths[path][name],
               "path": path, "launches_by_path": {
                   k: v[name] for k, v in paths.items()}}
        rec.update(r)
        if name == "histogram_all":
            rec["higgs"] = results["histogram_all_higgs"]
        if name in ("histogram_segment", "histogram_segment_routed",
                    "histogram_segment_step", "histogram_segment_routed_step",
                    "route_window", "route_window_step"):
            rec["build"] = build[{
                "histogram_segment": "K1", "histogram_segment_routed": "K3",
                "histogram_segment_step": "K1 step",
                "histogram_segment_routed_step": "K3 step",
                "route_window": "K2", "route_window_step": "K2 step"}[name]]
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
    log(json.dumps({"kernels": records}))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
