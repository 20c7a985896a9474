#!/usr/bin/env python3
"""Candidate designs of K2 (route_window: ``route_window_kernel``) and of
K5's tiling (histogram_all: ``all_hist_kernel`` and ``lgbt_all_tiling``)
in lightgbm_tpu_torch/csrc/histogram.cu, side by side on one NVIDIA card.

    python3 tools/route_candidates.py [--reps N] [--out FILE]

Builds the shipped source and each candidate derived from it by a textual
change (tools/segment_candidates.py's way), prints each build's ptxas
registers and spills, checks that every candidate gives the shipped
kernel's leaf ids or histograms bit for bit, and times each at these
calls:

  K2, on HIGGS-shaped rows (10,502,144 rows, row blocks of 8,192):
  * ``higgs_split``   the first split: a numeric route over every row,
                      about half of them moved;
  * ``mid_window``    a window of 100 row blocks of one leaf;
  * ``late_window``   a window of 3 row blocks;
  * ``mc_split``      1,007,616 rows, a categorical route of a bitset.
  K5, five channel sets:
  * ``mc``            1,007,616 rows x 28 features x 256 bins;
  * ``higgs``         10,502,144 rows x 28 features x 64 bins.

Candidates:

  * K2 ``rows4`` (shipped): the route table, 4 rows a thread;
    ``rows16``, ``rows1``: 16 or 1 rows a thread; ``rows4_no_table``,
    ``rows1_no_table``: routed_leaf on every row (rows1_no_table is the
    first version's body at this grid);
  * K5 ``one_set`` (shipped): every feature that fits of one set a block
    (gridDim.z = sets); ``min_bytes``: the (feature, set) tiling that
    reads the fewest bytes; ``all_sets``: as many features of all sets as
    fit.

Each call is timed with CUDA events around the replay of a CUDA graph of
N calls (default 20; the device's time, with no host between calls),
each K2 call on its own copy of the leaf ids, in turns: shipped,
candidate, candidate, shipped.  Inputs are made on the card from a seed.
Needs a card and nvcc; prints one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TOOLS))
sys.path.insert(0, TOOLS)

from segment_candidates import SOURCE, _build, _variant  # noqa: E402

_ROWS = "constexpr int kRouteRows = 4;"
_TABLE = "constexpr bool kRouteTable = true;"
ROUTE = {
    "rows4": [],
    "rows16": [(_ROWS, "constexpr int kRouteRows = 16;")],
    "rows1": [(_ROWS, "constexpr int kRouteRows = 1;")],
    "rows4_no_table": [(_TABLE, "constexpr bool kRouteTable = false;")],
    "rows1_no_table": [(_ROWS, "constexpr int kRouteRows = 1;"),
                       (_TABLE, "constexpr bool kRouteTable = false;")],
}
# K5's tiling policy, lgbt_all_tiling's body, replaced by the candidates'
_POLICY = ("SPAN", "  // one set a block, its features spread evenly",
           "  return 0;\n}\n\n// K5, one kernel launch")
# the (feature, set) tiling that reads the fewest bytes a row (every set
# tile reads F bytes of bins, every feature tile 10 bytes a set); or
# (ALL_SETS) the most sets a tile that fit, all of them where they do
_SETS_POLICY = """  long long best = -1, best_tiles = 0;
  for (int st = @FIRST@) {
    long long most = budget / (per_feature * st);
    if (most < 1) continue;
    if (most > num_features) most = num_features;
    const long long ty = div_up(num_features, most);
    const long long tz = div_up(num_sets, st);
    const long long bytes = tz * num_features + ty * 10ll * num_sets;
    if (best < 0 || bytes < best || (bytes == best && ty * tz < best_tiles)) {
      best = bytes;
      best_tiles = ty * tz;
      out[0] = (int)div_up(num_features, ty);
      out[1] = (int)div_up(num_sets, tz);
    }
  }
  out[2] = (int)(per_feature * out[0] * out[1]);
"""
ALL = {
    "one_set": [],
    "min_bytes": [(_POLICY, _SETS_POLICY.replace(
        "@FIRST@", "1; st <= num_sets; ++st"))],
    "all_sets": [(_POLICY, _SETS_POLICY.replace(
        "@FIRST@", "num_sets; st >= 1 && best < 0; --st"))],
}


class _Lib:
    """One build of histogram.cu, its K2 and K5 entry points called as
    ops/histogram.py calls them, with a zeroed scratch of its own."""

    def __init__(self, path, torch, dev):
        from lightgbm_tpu_torch.ops import kernels
        self.lib = ctypes.CDLL(path)
        for name in ("lgbt_route_window", "lgbt_histogram_all",
                     "lgbt_all_tiling"):
            fn = getattr(self.lib, name)
            fn.argtypes = kernels._SIGNATURES[name]
            fn.restype = ctypes.c_int
        self.torch = torch
        self.scratch = torch.zeros(1 << 20, dtype=torch.int64, device=dev)

    def route(self, binsT, ids, lo, hi, route):
        rc = self.lib.lgbt_route_window(
            binsT.data_ptr(), ids.data_ptr(), binsT.shape[1], lo, hi,
            route.data_ptr(), self.torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"route launch failed: {rc}")
        return ids

    def tiling(self, F, B, C):
        out = (ctypes.c_int * 3)()
        rc = self.lib.lgbt_all_tiling(F, B, C, ctypes.addressof(out))
        return list(out) if rc == 0 else None

    def hist_all(self, binsT, w8C, B, scales):
        F, npad = binsT.shape
        C = w8C.shape[0] // 8
        out = self.torch.empty((C, F, B, 3), dtype=self.torch.float32,
                               device=binsT.device)
        rc = self.lib.lgbt_histogram_all(
            binsT.data_ptr(), w8C.data_ptr(), npad, F, B, C,
            scales.data_ptr(), self.scratch.data_ptr(), out.data_ptr(),
            self.torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"histogram_all launch failed: {rc}")
        return out


def _bins(torch, npad, F, B, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return gen, torch.randint(0, B - 1, (F, npad), generator=gen, device=dev,
                              dtype=torch.uint8)


def _route_shapes(torch, th, dev):
    """(shape, (binsT, ids, row_lo, row_hi, route))."""
    import numpy as np
    from lightgbm_tpu_torch.ops.split import FeatureMeta
    rb = 8192
    none = np.zeros(8, np.uint32)
    _, binsT = _bins(torch, 1282 * rb, 28, 64, 3, dev)
    npad = binsT.shape[1]
    fm = FeatureMeta(np.full(28, 63, np.int32), np.zeros(28, np.int32),
                     np.zeros(28, np.int32))
    lid0 = torch.zeros(npad, dtype=torch.int32, device=dev)
    yield "higgs_split", (binsT, lid0, 0, npad,
                          th.pack_route(0, 1, 0, 31, False, False, none, fm))
    mid = lid0.clone()
    mid[400 * rb:500 * rb] = 5
    yield "mid_window", (binsT, mid, 400 * rb, 500 * rb,
                         th.pack_route(5, 9, 2, 20, False, False, none, fm))
    late = lid0.clone()
    late[500 * rb:503 * rb] = 7
    yield "late_window", (binsT, late, 500 * rb, 503 * rb,
                          th.pack_route(7, 8, 3, 50, False, False, none, fm))
    del binsT, lid0, mid, late
    torch.cuda.empty_cache()
    _, binsT = _bins(torch, 123 * rb, 28, 256, 4, dev)
    npad = binsT.shape[1]
    fm = FeatureMeta(np.full(28, 255, np.int32), np.zeros(28, np.int32),
                     np.zeros(28, np.int32))
    yield "mc_split", (binsT, torch.zeros(npad, dtype=torch.int32,
                                          device=dev), 0, npad,
                       th.pack_route(0, 1, 20, 0, False, True,
                                     np.full(8, 0x55555555, np.uint32), fm))


def _all_shapes(torch, th, dev):
    """(shape, (binsT, w8C, B, scales)): five channel sets of softmax-like
    gradients."""
    for shape, npad, B, seed in (("mc", 123 * 8192, 256, 4),
                                 ("higgs", 1282 * 8192, 64, 3)):
        gen, binsT = _bins(torch, npad, 28, B, seed, dev)
        grads = torch.randn((5, npad), generator=gen, device=dev)
        hess = torch.rand((5, npad), generator=gen, device=dev) * 0.25
        w8C = th.pack_channel_sets(grads, hess, torch.ones(npad, device=dev))
        del grads, hess
        yield shape, (binsT, w8C, B, th.class_scales(w8C))
        del binsT, w8C
        torch.cuda.empty_cache()


def _graph_ms(torch, call, start, reps):
    """Device ms a call: ``reps`` calls, each on its own copy of
    ``start``, in one replayed CUDA graph (a warm-up replay, a timed
    one)."""
    ids = [start.clone() for _ in range(reps)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for x in ids:
            call(x)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    for _ in range(2):
        for x in ids:
            x.copy_(start)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
    del graph, ids
    return a.elapsed_time(b) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import kernels
    if not torch.cuda.is_available():
        print("route_candidates: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    with open(SOURCE) as fh:
        base = fh.read()
    work = tempfile.mkdtemp(prefix="route_cand_")
    libs = {}
    for group, body in ((ROUTE, "route_window_kernel"),
                        (ALL, "all_hist_kernel")):
        for name, edits in group.items():
            path, log = _build(_variant(base, edits), work, name)
            libs[name] = _Lib(path, torch, dev)
            print(json.dumps({"candidate": name, "ptxas": kernels.ptxas_lines(
                body, log)}), flush=True)
    records = []

    def compare(kernel, shape, shipped, calls, start, check, extra):
        ref = check(calls[shipped](start.clone()))
        for name, call in calls.items():
            got = check(call(start.clone()))
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise SystemExit(f"{name} differs from the shipped kernel "
                                 f"at {shape}")
        for name, call in calls.items():
            if name == shipped:
                continue
            t = [_graph_ms(torch, calls[shipped], start, args.reps),
                 _graph_ms(torch, call, start, args.reps),
                 _graph_ms(torch, call, start, args.reps),
                 _graph_ms(torch, calls[shipped], start, args.reps)]
            rec = {"kernel": kernel, "shape": shape, "candidate": name,
                   "ms": (t[1] + t[2]) / 2, "shipped_ms": (t[0] + t[3]) / 2,
                   "turns_ms": t, "reps": args.reps, "card": card}
            rec.update(extra(name))
            records.append(rec)
            print(json.dumps(rec), flush=True)

    for shape, (binsT, ids0, lo, hi, route) in _route_shapes(torch, th, dev):
        calls = {name: (lambda lib: lambda ids: lib.route(
            binsT, ids, lo, hi, route))(libs[name]) for name in ROUTE}
        moved = int((calls["rows4"](ids0.clone()) != ids0).sum().item())
        compare("route_window", shape, "rows4", calls, ids0, lambda x: x,
                lambda name: {"rows": hi - lo, "moved_rows": moved})
        torch.cuda.empty_cache()
    for shape, (binsT, w8C, B, scales) in _all_shapes(torch, th, dev):
        F, C = binsT.shape[0], w8C.shape[0] // 8
        calls = {name: (lambda lib: lambda _ids: lib.hist_all(
            binsT, w8C, B, scales))(libs[name]) for name in ALL}
        dummy = torch.zeros(1, dtype=torch.int32, device=dev)
        compare("histogram_all", shape, "one_set", calls, dummy,
                lambda x: x, lambda name: {
                    "rows": binsT.shape[1], "features": F, "bins": B,
                    "sets": C, "tiling": libs[name].tiling(F, B, C),
                    "shipped_tiling": libs["one_set"].tiling(F, B, C)})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(records, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
