#!/usr/bin/env python3
"""Where one training iteration of lightgbm_tpu_torch spends its time, on
one NVIDIA card.

    python3 tools/profile_torch_iter.py
        [--config higgs,higgs_unfused,higgs_frontier,multiclass_cat]
        [--rows N] [--steps S,...] [--untraced K] [--package DIR]
        [--out FILE]

Trains each of the given configurations of chip_smoke.py (comma-separated;
default ``higgs``): ``higgs`` is the HIGGS-shaped binary path (28
features, max_bin 63, 255 leaves, 10.5M rows) through the segment grower,
fused route; ``higgs_unfused`` the same with ``fused_route=False``;
``higgs_frontier`` the same through the frontier grower
(``tpu_tree_impl=frontier``, K = 16, default tier: K2 a split, K6 a
round); ``multiclass_cat`` is the 5-class softmax path with 8 categorical
features (31 leaves, 256 bins, 1M rows, five trees and one K5 launch an
iteration).  The HIGGS configurations share one dataset.  The iterations
of each:

  1. warm-up (kernel build, first launches, the segment grower's CUDA
     graph capture);
  2. ``--untraced`` untraced iterations (default 3): their wall times are
     the end-to-end number, each one given;
  3. host spans only: inclusive wall clock of the grower's pieces,
     measured by wrapping them in this script.  The segment grower (a
     device loop): graph replays (the host's enqueue), status fetches
     (they wait for the replay), compaction, the tree's start (its own
     graph's replay: the root's pass and scan), the tree's fetch.  The frontier grower (a host loop): its rounds,
     best-split scans with their fetch, K2 and K6 wrapper calls,
     compaction.  Both: gradients, the class roots' K5 call, the whole
     grow, the score update, the tree's finalisation.  A span a package
     does not have is left out;
  4. host spans and ``torch.profiler`` (CPU and CUDA activities): the
     device's busy time (the union of kernel intervals), its idle share,
     and device time and launch count by kernel name, the port's
     kernels and PyTorch's own.

The wall times of 2, 3 and 4 show what the spans and the profiler cost;
the untraced idle share is 1 - (4's busy time) / (2's median wall).
After each configuration its Booster is dropped and the cache emptied;
the record's ``after`` says whether the grower (and so its CUDA graphs)
was freed, the bytes the allocator still reserves, and the live Python
objects, so a later configuration's walls can be read knowing that.
``--steps`` sets the segment grower's steps a replay before its first
tree, each value of the list timed in turn (a Booster each).  ``--package DIR`` imports lightgbm_tpu_torch from the checkout DIR
instead of this one (a parent commit unpacked with ``git archive``), so
two commits are timed with the same spans, in turns, in one call.  The
summary goes to stdout and, with ``--out FILE``, the records (every
kernel name) to FILE as JSON.  Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import functools
import gc
import json
import os
import statistics
import sys
import time
import weakref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CONFIGS = ("higgs", "higgs_unfused", "higgs_frontier", "multiclass_cat")


def _wrap(owner, attr, spans, label):
    """Time ``owner.attr`` into ``spans[label]``; returns an undo, or None
    where the owner has no such attribute."""
    fn = getattr(owner, attr, None)
    if fn is None:
        return None
    own = attr in vars(owner)

    @functools.wraps(fn)
    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            spans[label][0] += time.perf_counter() - t0
            spans[label][1] += 1

    setattr(owner, attr, timed)
    # an instance's method goes back to its class's (no bound-method cycle
    # that would keep the Booster, and its CUDA graph, alive)
    return (lambda: setattr(owner, attr, fn)) if own else (
        lambda: delattr(owner, attr))


def _busy_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _profile(lt, chip_smoke, config, ds, steps, untraced_n, torch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lightgbm_tpu_torch.models import gbdt, grower_frontier, grower_seg
    from lightgbm_tpu_torch.models.tree import Tree

    base = (chip_smoke.MC_PARAMS if config == "multiclass_cat"
            else chip_smoke.FRONTIER_PARAMS if config == "higgs_frontier"
            else chip_smoke.TRAIN_PARAMS)
    bst = lt.Booster(dict(base, metric=[]), ds,
                     fused_route=config != "higgs_unfused")
    g = bst.gbdt
    grower = weakref.ref(g.grower)
    if steps is not None and hasattr(g.grower, "steps"):
        g.grower.steps = steps

    def iteration_ms():
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    iteration_ms()                                   # 1: warm-up, capture
    untraced = [iteration_ms() for _ in range(untraced_n)]   # 2

    spans = collections.defaultdict(lambda: [0.0, 0])
    undo = [
        _wrap(g.objective, "get_gradients", spans, "gradients"),
        _wrap(gbdt, "histogram_all", spans, "class roots (K5)"),
        _wrap(g.grower, "grow", spans, "grow (whole tree)"),
        _wrap(gbdt, "score_gather_add", spans, "score update (K4)"),
        _wrap(Tree, "from_grown", spans, "tree to host"),
    ]
    if config == "higgs_frontier":
        undo += [
            _wrap(g.grower, "_round", spans, "frontier rounds"),
            _wrap(g.grower, "_scan", spans, "best-split scans + fetch"),
            _wrap(grower_frontier, "route_window", spans,
                  "K2 wrapper calls"),
            _wrap(grower_frontier, "histogram_frontier", spans,
                  "K6 wrapper calls"),
            _wrap(grower_frontier, "compact_state", spans, "compaction")]
    else:
        # the device loop's pieces, or a host-loop package's
        undo += [
            _wrap(g.grower, "_run_steps", spans, "graph replays (enqueue)"),
            _wrap(g.grower, "_fetch_status", spans, "status fetches"),
            _wrap(g.grower, "_compact", spans, "compaction"),
            _wrap(g.grower, "_begin", spans, "tree start (graph)"),
            _wrap(getattr(g.grower, "s", None), "tree", spans,
                  "tree fetch"),
            _wrap(g.grower, "_scan", spans, "best-split scans + fetch"),
            _wrap(grower_seg, "histogram_segment_routed", spans,
                  "K3 wrapper calls"),
            _wrap(grower_seg, "compact_state", spans, "compaction")]
    spans_ms = iteration_ms()                        # 3: host spans only
    host = {k: {"ms": v[0] * 1e3, "calls": v[1]} for k, v in spans.items()}

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = iteration_ms()                 # 4: spans + profiler
    for u in undo:
        if u is not None:
            u()

    kernels = collections.defaultdict(lambda: [0.0, 0])
    intervals = []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        s, e = evt.time_range.start, evt.time_range.end
        intervals.append((s, e))
        kernels[evt.name][0] += (e - s) / 1e3
        kernels[evt.name][1] += 1
    busy_ms = _busy_us(intervals) / 1e3
    med = statistics.median(untraced)
    return grower, {
        "config": config,
        "leaves": [t.num_leaves for t in g.models],
        "untraced_ms": untraced, "untraced_median_ms": med,
        "spans_ms": spans_ms, "profiled_ms": profiled_ms,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / profiled_ms,
        "untraced_idle_share": 1.0 - busy_ms / med,
        "device_ops": len(intervals),
        "grower_stats": dict(g.grower.last_stats),
        "kernels_ms": {k: {"ms": v[0], "count": v[1]} for k, v in sorted(
            kernels.items(), key=lambda kv: -kv[1][0])},
        "host_ms": host,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="higgs",
                    help="comma-separated, of " + ", ".join(CONFIGS))
    ap.add_argument("--rows", type=int, default=None,
                    help="default 10500000 (HIGGS) or 1000000")
    ap.add_argument("--steps", default=None,
                    help="comma-separated steps a replay of the segment "
                         "grower, each timed in turn (default: its own)")
    ap.add_argument("--untraced", type=int, default=3)
    ap.add_argument("--package", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    configs = args.config.split(",")
    bad = [c for c in configs if c not in CONFIGS]
    if bad:
        ap.error(f"unknown configurations {bad}")
    steps_list = ([int(x) for x in args.steps.split(",")] if args.steps
                  else [None])
    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_iter: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import lightgbm_tpu_torch as lt
    card = chip_smoke.card_line()

    datasets = {}
    records = []
    for config in configs:
        kind = "mc" if config == "multiclass_cat" else "higgs"
        if kind not in datasets:
            t0 = time.perf_counter()
            if kind == "higgs":
                X, y = chip_smoke.higgs_like(
                    args.rows or chip_smoke.HIGGS_ROWS, 42)
                datasets[kind] = lt.Dataset(X, y)
            else:
                X, y = chip_smoke.multiclass_cat(
                    args.rows or chip_smoke.MC_ROWS, 7)
                datasets[kind] = lt.Dataset(
                    X, y, categorical_feature=chip_smoke.MC_CAT)
            datasets[kind].rows = len(y)
            del X, y
            print(f"{kind} data in {time.perf_counter() - t0:.1f} s",
                  flush=True)
        ds = datasets[kind]
        for steps in steps_list if config != "higgs_frontier" else [None]:
            grower, rec = _profile(lt, chip_smoke, config, ds, steps,
                                   args.untraced, torch)
            rec.update(device=torch.cuda.get_device_name(0), card=card,
                       rows=ds.rows, package=os.path.dirname(
                           os.path.abspath(lt.__file__)))
            records.append(rec)
            _summary(rec)
            # each configuration starts from a card that holds no earlier
            # Booster's buffers or graph: checked, not assumed
            gc.collect()
            torch.cuda.empty_cache()
            rec["after"] = {"grower_freed": grower() is None,
                            "reserved_bytes": torch.cuda.memory_reserved(),
                            "gc_objects": len(gc.get_objects())}
            print(json.dumps({"config": rec["config"], **rec["after"]}),
                  flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(records, fh, indent=1)
    return 0


def _summary(rec) -> None:
    steps = rec["grower_stats"].get("steps")
    tag = rec["config"] + (f" steps {steps}" if steps else "")
    print(f"[{tag}] iteration wall: untraced "
          f"{[round(x, 1) for x in rec['untraced_ms']]} ms (median "
          f"{rec['untraced_median_ms']:.1f}), with host spans "
          f"{rec['spans_ms']:.1f} ms, with spans and profiler "
          f"{rec['profiled_ms']:.1f} ms; leaves {rec['leaves']}")
    print(f"[{tag}] profiled iteration: device busy "
          f"{rec['device_busy_ms']:.1f} ms, idle share "
          f"{rec['idle_share']:.3f} (untraced "
          f"{rec['untraced_idle_share']:.3f}), {rec['device_ops']} device "
          f"ops, grower {rec['grower_stats']}")
    print(f"[{tag}] host, iteration 3 (inclusive):")
    for k, v in rec["host_ms"].items():
        print(f"  {k:28s} {v['ms']:9.1f} ms  {v['calls']:5d} calls")
    print(f"[{tag}] device by kernel, iteration 4 (top 12):")
    for k, v in list(rec["kernels_ms"].items())[:12]:
        print(f"  {v['ms']:9.2f} ms  {v['count']:6d}  {k[:90]}")
    print(json.dumps({k: rec[k] for k in (
        "device", "card", "config", "rows", "untraced_ms",
        "untraced_median_ms", "spans_ms", "profiled_ms", "device_busy_ms",
        "idle_share", "untraced_idle_share", "device_ops", "package")}),
        flush=True)


if __name__ == "__main__":
    sys.exit(main())
