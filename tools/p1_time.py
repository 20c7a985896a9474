#!/usr/bin/env python3
"""P1 (``route_trees``, lightgbm_tpu_torch/csrc/predict.cu) at HIGGS on one
NVIDIA card, alone or after the kernel phases that precede it in
``chip_smoke.py``: the question is whether P1's time over the training
bins depends on what the process ran before it.

    python3 tools/p1_time.py alone  [--rounds N] [--out FILE]
    python3 tools/p1_time.py prefix [--rounds N] [--out FILE]

Run from the root of a checkout; it imports that checkout's
``chip_smoke.py`` and package.  Both modes generate and bin chip_smoke's
HIGGS rows (10.5M x 28), train its main path (3 iterations, then the
late split's fourth tree, as phases 3 and 3b do) and time P1 over the
training bins with chip_smoke's ``p1_times`` (CUDA events over its
PREDICT_REPS launches, checked bit for bit against the plain version)
``--rounds`` times, then once more over a fresh copy of the bins (a new
allocation).  ``prefix`` first runs chip_smoke's kernel and frontier
kernel phases at HIGGS, in chip_smoke's order.  Prints one JSON line:
the card, the mode and the P1 times in ms.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("alone", "prefix"))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    import lightgbm_tpu_torch
    from lightgbm_tpu_torch import Config
    from lightgbm_tpu_torch.models.device_predict import TreeStack
    if not torch.cuda.is_available():
        print("p1_time: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    X, y = cs.higgs_like(cs.HIGGS_ROWS + cs.HOLDOUT_ROWS, 42)
    Xh, yh = X[cs.HIGGS_ROWS:], y[cs.HIGGS_ROWS:]
    X, y = X[:cs.HIGGS_ROWS], y[:cs.HIGGS_ROWS]
    ds = lightgbm_tpu_torch.Dataset(X, y)
    ds.construct(Config.from_params(cs.TRAIN_PARAMS))
    if args.mode == "prefix":
        device = torch.device("cuda")
        cs.kernel_phase(ds._handle, Config.from_params(cs.TRAIN_PARAMS),
                        device)
        torch.cuda.empty_cache()
        cs.frontier_kernel_phase(
            ds._handle, Config.from_params(cs.TRAIN_PARAMS), device,
            "HIGGS", ((16, 5, True),))
    _, _, bst = cs.train_phase(ds, Xh, yh)
    cs.late_split_phase(bst)
    ms = [cs.route_kernel_phase(bst)["ms"] for _ in range(args.rounds)]
    gb = bst.gbdt
    stack = TreeStack(gb.models, [0] * len(gb.models),
                      gb.train_set.num_used_features, gb.device)
    copy = cs.p1_times(gb.bins.clone(), stack, gb.fmeta.num_bin,
                       gb.fmeta.default_bin,
                       gb.train_score.to(torch.float64).contiguous(),
                       gb.models, "HIGGS training bins, a fresh copy")
    rec = {"card": card, "mode": args.mode, "trees": len(gb.models),
           "p1_ms": ms, "p1_fresh_copy_ms": copy["ms"],
           "bound_ms": copy["bound_ms"],
           "wall_s": time.perf_counter() - t0}
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
