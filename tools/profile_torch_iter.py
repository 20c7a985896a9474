#!/usr/bin/env python3
"""Where one training iteration of lightgbm_tpu_torch spends its time, on
one NVIDIA card.

    python3 tools/profile_torch_iter.py
        [--config higgs|higgs_frontier|multiclass_cat] [--rows N] [--out FILE]

Trains one of chip_smoke.py's configurations for four iterations:
``higgs`` (the default) is the HIGGS-shaped binary path (28 features,
max_bin 63, 255 leaves, 10.5M rows) through the segment grower, fused
route; ``higgs_frontier`` the same through the frontier grower
(``tpu_tree_impl=frontier``, K = 16, default tier: K2 a split, K6 a
round); ``multiclass_cat`` is the 5-class softmax path with 8 categorical
features (31 leaves, 256 bins, 1M rows, five trees and one K5 launch an
iteration).  The iterations:

  1. warm-up (kernel build, first launches);
  2. untraced: its wall time is the end-to-end number;
  3. host spans only: inclusive wall clock of the grower's pieces,
     measured by wrapping them in this script (gradients, the class
     roots' K5 call, the whole grow, the best-split scans with their
     device-to-host fetch, the K3 wrapper calls, or the frontier grower's
     rounds and its K2 and K6 wrapper calls, compaction, the score update,
     the tree's finalisation);
  4. host spans and ``torch.profiler`` (CPU and CUDA activities): the
     device's busy time (the union of kernel intervals), its idle share,
     and device time and launch count by kernel name, the port's
     kernels and PyTorch's own.

The wall times of 2, 3 and 4 show what the spans and the profiler cost.
The summary goes to stdout and, with ``--out FILE``, the full record
(every kernel name) to FILE as JSON.  Needs a card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _wrap(owner, attr, spans, label):
    fn = getattr(owner, attr)

    @functools.wraps(fn)
    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            spans[label][0] += time.perf_counter() - t0
            spans[label][1] += 1

    setattr(owner, attr, timed)


def _busy_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config",
                    choices=("higgs", "higgs_frontier", "multiclass_cat"),
                    default="higgs")
    ap.add_argument("--rows", type=int, default=None,
                    help="default 10500000 (higgs) or 1000000")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_iter: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.models import gbdt, grower_frontier, grower_seg
    from lightgbm_tpu_torch.models.tree import Tree

    if args.config in ("higgs", "higgs_frontier"):
        rows = args.rows or chip_smoke.HIGGS_ROWS
        X, y = chip_smoke.higgs_like(rows, 42)
        params = dict(chip_smoke.TRAIN_PARAMS if args.config == "higgs"
                      else chip_smoke.FRONTIER_PARAMS, metric=[])
        ds = lt.Dataset(X, y)
    else:
        rows = args.rows or chip_smoke.MC_ROWS
        X, y = chip_smoke.multiclass_cat(rows, 7)
        params = dict(chip_smoke.MC_PARAMS, metric=[])
        ds = lt.Dataset(X, y, categorical_feature=chip_smoke.MC_CAT)
    bst = lt.Booster(params, ds)
    g = bst.gbdt

    def iteration_ms():
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    iteration_ms()                                  # 1: warm-up (and build)
    untraced_ms = iteration_ms()                    # 2: untraced

    spans = collections.defaultdict(lambda: [0.0, 0])
    _wrap(g.objective, "get_gradients", spans, "gradients")
    _wrap(gbdt, "histogram_all", spans, "class roots (K5)")
    _wrap(g.grower, "grow", spans, "grow (whole tree)")
    _wrap(g.grower, "_scan", spans, "best-split scans + fetch")
    _wrap(grower_seg, "histogram_segment_routed", spans,
          "K3 wrapper calls")
    _wrap(grower_seg, "compact_state", spans, "compaction")
    if args.config == "higgs_frontier":
        _wrap(g.grower, "_round", spans, "frontier rounds")
        _wrap(grower_frontier, "route_window", spans, "K2 wrapper calls")
        _wrap(grower_frontier, "histogram_frontier", spans,
              "K6 wrapper calls")
        _wrap(grower_frontier, "compact_state", spans, "compaction")
    _wrap(gbdt, "score_gather_add", spans, "score update (K4)")
    _wrap(Tree, "from_grown", spans, "tree to host")
    spans_ms = iteration_ms()                       # 3: host spans only
    host = {k: {"ms": v[0] * 1e3, "calls": v[1]} for k, v in spans.items()}

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = iteration_ms()                # 4: spans + profiler

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
    record = {
        "device": torch.cuda.get_device_name(0),
        "config": args.config,
        "rows": rows,
        "leaves": [t.num_leaves for t in g.models],
        "untraced_ms": untraced_ms, "spans_ms": spans_ms,
        "profiled_ms": profiled_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / profiled_ms,
        "device_ops": len(intervals),
        "grower_stats": dict(g.grower.last_stats),
        "kernels_ms": {k: {"ms": v[0], "count": v[1]} for k, v in sorted(
            kernels.items(), key=lambda kv: -kv[1][0])},
        "host_ms": host,
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(record, fh, indent=1)

    print(f"iteration wall: untraced {untraced_ms:.1f} ms, with host spans "
          f"{spans_ms:.1f} ms, with spans and profiler {profiled_ms:.1f} ms; "
          f"leaves {record['leaves']}")
    print(f"profiled iteration: device busy {busy_ms:.1f} ms, idle share "
          f"{record['idle_share']:.3f}, {len(intervals)} device ops, "
          f"grower {record['grower_stats']}")
    print("host, iteration 3 (inclusive):")
    for k, v in host.items():
        print(f"  {k:28s} {v['ms']:9.1f} ms  {v['calls']:5d} calls")
    print("device by kernel, iteration 4 (top 15):")
    for k, v in list(record["kernels_ms"].items())[:15]:
        print(f"  {v['ms']:9.2f} ms  {v['count']:6d}  {k[:90]}")
    print(json.dumps({k: record[k] for k in (
        "device", "config", "rows", "untraced_ms", "spans_ms", "profiled_ms",
        "device_busy_ms", "idle_share", "device_ops")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
