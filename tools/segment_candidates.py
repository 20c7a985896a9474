#!/usr/bin/env python3
"""Candidate designs of the segment histogram body (K1 histogram_segment,
K3 histogram_segment_routed: ``segment_window_kernel`` in
lightgbm_tpu_torch/csrc/histogram.cu), side by side on one NVIDIA card,
in both weight modes.

    python3 tools/segment_candidates.py [--reps N] [--out FILE]

Builds the shipped source and each candidate derived from it by a textual
change, prints each build's ptxas registers and spills and its atomic SASS
opcodes, checks that every candidate gives the shipped kernel's histograms
and leaf ids bit for bit, and times each call of these shapes:

  * ``higgs_root``   K1 over 10,502,144 rows x 28 features x 64 bins, every
                     row in the target (the unfused path's root);
  * ``higgs_root_null``  the same through K3 with the null route (the
                     fused path's root);
  * ``higgs_split``  K3, a numeric split of the root, the half that moves as
                     the target;
  * ``late_split``   K3 over a window of 3 row blocks (24,576 rows) of that
                     layout, a split that moves about a fifth of them, the
                     moved rows as the target;
  * ``mc_root``      K1 over 1,007,616 rows x 28 features x 256 bins;
  * ``mc_split``     K3, a categorical split of that root.

Each shape runs in both weight modes: ``f32`` (pack_channels' bf16 hi/lo
channels, 64-bit fixed-point sums: five shared atomics a (row, feature))
and ``packed_acc`` (quantize_pack's int32 stream at 8 bits: three).  A
``mode`` record times the shipped kernel's two modes against each other
(f32, packed_acc, packed_acc, f32).

Candidates:

  * ``prefetch``     the shipped design: each warp adds 32 queued rows, a
                     row a lane, every lane the same feature at once into a
                     feature-major histogram, four features at a time while
                     the next four features' bins load from device memory;
  * ``no_prefetch``  four features' bins loaded, then their adds;
  * ``min_rows_4k``  the shipped body, a block walking at least 4,096 rows
                     of the window (one 1,024-row step shipped);
  * ``k6_body``      the frontier kernel (K6, and K7 for K3) unchanged,
                     called with one target slot over the window's blocks;
  * ``no_hi``, ``count_only``  diagnostics, not exact and not checked: the
                     shipped body without the high-word adds (three shared
                     atomics a pair in the f32 mode; the packed_acc mode
                     has none), or with the count alone (one).

The designs measured and dropped before the packed-accumulator mode
(prefetch2, eight_prefetch, hi_behind, eight, prefetch_ids, and stage,
rotate and replicas4, which replaced the body: PERF.md has their numbers)
edited code that the body no longer has and are not rebuilt here.

Each call is timed with CUDA events around the replay of a CUDA graph of
N calls (default 20; the device's time, with no host between calls), each
on its own copy of the leaf ids, in turns: shipped, candidate, candidate,
shipped.  Inputs are made on the card from a seed.  Needs a card and nvcc;
prints one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = os.path.join(ROOT, "lightgbm_tpu_torch", "csrc", "histogram.cu")

# the shipped kernel's span in histogram.cu, where ("KERNEL", old) edits
# apply
_KERNEL_FROM = ("template <bool kRouted, bool kPacked4, bool kAcc>\n"
                "__device__ __forceinline__ void\nsegment_window(")
_KERNEL_TO = "// K1's and K3's kernels: the window, target and route"

# the shipped add loop: the next four features' bins load while these add
_LOOP = """    load_bins4<kPacked4>(brow, npad, 0, nf, num_bins, nb);
    for (int f = 0; f < nf; f += 4) {
      int k[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // the TPU one-hot drops bins >= num_bins too
        k[j] = nb[j] < num_bins ? (f + j) * num_bins + nb[j] : -1;
      }
      load_bins4<kPacked4>(brow, npad, f + 4, nf, num_bins, nb);
      pl.add4(k, a);
    }
"""
# no_prefetch: four features' bins loaded, then their adds
_NO_PREFETCH = """    for (int f = 0; f < nf; f += 4) {
      int k[4];
      load_bins4<kPacked4>(brow, npad, f, nf, num_bins, nb);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        k[j] = nb[j] < num_bins ? (f + j) * num_bins + nb[j] : -1;
      pl.add4(k, a);
    }
"""
# Planes::add4's high-word adds and low-word adds (every body's)
_HI_ADDS = """      atomicAdd(g_hi + k[j], a[1] + carry_of(og[j], a[0]));
      atomicAdd(h_hi + k[j], a[3] + carry_of(oh[j], a[2]));
"""
_LO_ADDS = """      og[j] = atomicAdd(g_lo + k[j], a[0]);
      oh[j] = atomicAdd(h_lo + k[j], a[2]);
"""
_MIN_ROWS = "constexpr int kSegMinRows = kSegThreads;"
CANDIDATES = {
    "prefetch": [],
    "no_prefetch": [(("KERNEL", _LOOP), _NO_PREFETCH)],
    "min_rows_4k": [(_MIN_ROWS,
                     "constexpr int kSegMinRows = 4 * kSegThreads;")],
    # diagnostics, not exact: the shipped body with fewer shared atomics
    "no_hi": [(_HI_ADDS, "      (void)og[j]; (void)oh[j];\n")],
    "count_only": [(_HI_ADDS, "      (void)og[j]; (void)oh[j];\n"),
                   (_LO_ADDS, "      og[j] = oh[j] = 0u;\n")],
}
DIAGNOSTIC = ("no_hi", "count_only")
MODES = ("f32", "packed_acc")


def _variant(text: str, edits) -> str:
    """The source with each edit made: ``old`` replaced where it occurs
    once; ("KERNEL", old) replaced wherever it occurs in the shipped
    kernel's span (at least once)."""
    for old, new in edits:
        if isinstance(old, tuple):
            a, b = text.find(_KERNEL_FROM), text.find(_KERNEL_TO)
            body = text[a:b]
            if a < 0 or b < a or old[1] not in body:
                raise SystemExit(f"kernel edit does not match:\n{old[1]}")
            text = text[:a] + body.replace(old[1], new) + text[b:]
            continue
        if text.count(old) != 1:
            raise SystemExit(f"candidate edit does not match the source "
                             f"once:\n{old}")
        text = text.replace(old, new)
    return text


def _build(src_text: str, out_dir: str, name: str):
    """nvcc as ops/kernels.py builds, into one shared library; returns
    (path, ptxas output)."""
    from lightgbm_tpu_torch.ops import kernels
    cu = os.path.join(out_dir, name + ".cu")
    with open(cu, "w") as fh:
        fh.write(src_text)
    lib = os.path.join(out_dir, name + ".so")
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                          "-o", lib, cu], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}:\n{res.stdout}{res.stderr}")
    return lib, res.stdout + res.stderr


class _Lib:
    """One build of histogram.cu, called as ops/histogram.py calls K1/K3,
    with a zeroed scratch of its own."""

    def __init__(self, path, torch, dev):
        from lightgbm_tpu_torch.ops import kernels
        self.lib = ctypes.CDLL(path)
        self.entry = self.lib.lgbt_histogram_segment
        self.entry.argtypes = kernels._SIGNATURES["lgbt_histogram_segment"]
        self.entry.restype = ctypes.c_int
        self.lib.lgbt_segment_tiling.argtypes = kernels._SIGNATURES[
            "lgbt_segment_tiling"]
        self.lib.lgbt_segment_tiling.restype = ctypes.c_int
        self.torch = torch
        self.scratch = torch.zeros(1 << 20, dtype=torch.int64, device=dev)

    def tiling(self, F, B, acc):
        out = (ctypes.c_int * 2)()
        rc = self.lib.lgbt_segment_tiling(F, B, 0, int(acc),
                                          ctypes.addressof(out))
        return list(out) if rc == 0 else None

    def call(self, binsT, w, ids, lo, hi, target, route, B, scales):
        F, npad = binsT.shape
        out = self.torch.empty((F, B, 3), dtype=self.torch.float32,
                               device=binsT.device)
        rc = self.entry(
            binsT.data_ptr(), w.data_ptr(), ids.data_ptr(), npad, F, B, lo,
            hi, target, scales.data_ptr(),
            None if route is None else route.data_ptr(),
            self.scratch.data_ptr(), out.data_ptr(), 0,
            int(w.dtype == self.torch.int32),
            self.torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: {rc}")
        return out


def _layout(torch, th, npad, F, B, seed, dev):
    """Bins uniform over B - 1 bins, gradients and hessians from a seed,
    every row a member: (bins, {mode: (weights, scales)}, metadata)."""
    import numpy as np
    from lightgbm_tpu_torch.ops.split import FeatureMeta
    gen = torch.Generator(device=dev).manual_seed(seed)
    binsT = torch.randint(0, B - 1, (F, npad), generator=gen, device=dev,
                          dtype=torch.uint8)
    grad = torch.randn(npad, generator=gen, device=dev)
    hess = torch.rand(npad, generator=gen, device=dev) * 0.25
    member = torch.ones(npad, device=dev)
    w8 = th.pack_channels(grad, hess, member)
    w2, qscales, _ = th.quantize_pack(grad, hess, member)
    fm = FeatureMeta(np.full(F, B - 1, np.int32), np.zeros(F, np.int32),
                     np.zeros(F, np.int32))
    return binsT, {"f32": (w8, th.fixed_point_scales(w8)),
                   "packed_acc": (w2, qscales)}, fm


def _shapes(torch, th, dev):
    """(shape, (binsT, weights by mode, leaf ids, row_lo, row_hi, target,
    route or None, bins)), one layout at a time."""
    import numpy as np
    rb = 8192
    none = np.zeros(8, np.uint32)
    binsT, ws, fm = _layout(torch, th, 1282 * rb, 28, 64, 3, dev)
    npad = binsT.shape[1]
    lid0 = torch.zeros(npad, dtype=torch.int32, device=dev)
    split = th.pack_route(0, 1, 0, 31, False, False, none, fm)
    late = lid0.clone()
    late[500 * rb:503 * rb] = 7
    yield "higgs_root", (binsT, ws, lid0, 0, npad, 0, None, 64)
    yield "higgs_root_null", (binsT, ws, lid0, 0, npad, 0, th.null_route(),
                              64)
    yield "higgs_split", (binsT, ws, lid0, 0, npad, 1, split, 64)
    yield "late_split", (binsT, ws, late, 500 * rb, 503 * rb, 8,
                         th.pack_route(7, 8, 3, 50, False, False, none, fm),
                         64)
    del binsT, ws, lid0, late
    torch.cuda.empty_cache()
    binsT, ws, fm = _layout(torch, th, 123 * rb, 28, 256, 4, dev)
    npad = binsT.shape[1]
    lid0 = torch.zeros(npad, dtype=torch.int32, device=dev)
    every_other = np.full(8, 0x55555555, np.uint32)
    yield "mc_root", (binsT, ws, lid0, 0, npad, 0, None, 256)
    yield "mc_split", (binsT, ws, lid0, 0, npad, 1,
                       th.pack_route(0, 1, 20, 0, False, True, every_other,
                                     fm), 256)


def _k6_call(th, torch, binsT, w, ids, lo, hi, target, route, B, scales):
    """K6 (no route) or K7 routed with one target over the window's
    blocks."""
    rb = 8192
    blocks = torch.arange(lo // rb, hi // rb, dtype=torch.int32,
                          device=binsT.device)
    t = torch.tensor([target], dtype=torch.int32)
    if route is None:
        return th.histogram_frontier(binsT, w, ids, blocks, blocks.numel(),
                                     t, B, rb, scales)[0]
    return th.histogram_frontier_routed(binsT, w, ids, blocks,
                                        blocks.numel(), t, route[None], B,
                                        rb, scales)[1][0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import kernels
    if not torch.cuda.is_available():
        print("segment_candidates: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    with open(SOURCE) as fh:
        base = fh.read()
    work = tempfile.mkdtemp(prefix="segment_cand_")
    libs = {}
    for name, edits in CANDIDATES.items():
        path, log = _build(_variant(base, edits), work, name)
        libs[name] = _Lib(path, torch, dev)
        body = "segment_window_kernel"
        sass = kernels.sass_opcodes(body, path)
        print(json.dumps({"candidate": name, "ptxas": kernels.ptxas_lines(
            body, log), "atomics": {fn: {k: v for k, v in sorted(ops.items())
                                         if k.startswith(("ATOMS", "ATOM",
                                                          "RED"))}
                                    for fn, ops in sass.items()}}),
              flush=True)
    shipped = libs["prefetch"]
    records = []

    def time_ms(call, ids0):
        # reps calls, each on its own copy of the ids, in one CUDA graph:
        # the device's time, with no host between calls
        ids = [ids0.clone() for _ in range(args.reps)]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for x in ids:
                call(x)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        for _ in range(2):       # a warm-up replay, a timed one
            for x in ids:
                x.copy_(ids0)
            a.record()
            graph.replay()
            b.record()
            torch.cuda.synchronize()
        del graph, ids
        return a.elapsed_time(b) / args.reps

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    for shape, (binsT, ws, ids0, lo, hi, target, route,
                B) in _shapes(torch, th, dev):
        F = binsT.shape[0]
        kname = ("histogram_segment" if route is None
                 else "histogram_segment_routed")
        w8 = ws["f32"][0]
        ref_ids = ids0.clone()
        shipped.call(binsT, w8, ref_ids, lo, hi, target, route, B,
                     ws["f32"][1])
        matched = int(((ref_ids[lo:hi] == target)
                       & (w8[4, lo:hi] != 0)).sum().item())
        calls_by_mode = {}
        for mode in MODES:
            w, scales = ws[mode]
            acc = mode == "packed_acc"
            # each call bound to this mode's weights (the mode record
            # below calls both modes' after the loop)
            calls = {name: (lambda lib, w, scales: lambda ids: lib.call(
                binsT, w, ids, lo, hi, target, route, B, scales))(
                    lib, w, scales) for name, lib in libs.items()}
            calls["k6_body"] = (lambda w, scales: lambda ids: _k6_call(
                th, torch, binsT, w, ids, lo, hi, target, route, B,
                scales))(w, scales)
            calls_by_mode[mode] = calls
            ref_ids = ids0.clone()
            ref = calls["prefetch"](ref_ids)
            for name, call in calls.items():
                if name in DIAGNOSTIC:
                    continue
                ids = ids0.clone()
                got = call(ids)
                torch.cuda.synchronize()
                if not (torch.equal(got, ref) and torch.equal(ids, ref_ids)):
                    raise SystemExit(f"{name} differs from the shipped "
                                     f"kernel at {shape} ({mode})")
            for name, call in calls.items():
                if name == "prefetch":
                    continue
                t = [time_ms(calls["prefetch"], ids0), time_ms(call, ids0),
                     time_ms(call, ids0), time_ms(calls["prefetch"], ids0)]
                emit({"shape": shape, "kernel": kname, "mode": mode,
                      "candidate": name, "exact": name not in DIAGNOSTIC,
                      "ms": (t[1] + t[2]) / 2,
                      "shipped_ms": (t[0] + t[3]) / 2, "turns_ms": t,
                      "rows": hi - lo, "target_rows": matched,
                      "features": F, "bins": B,
                      "tiling": libs.get(name, shipped).tiling(F, B, acc),
                      "shipped_tiling": shipped.tiling(F, B, acc),
                      "reps": args.reps, "card": card})
        f32, acc = (calls_by_mode[m]["prefetch"] for m in MODES)
        t = [time_ms(f32, ids0), time_ms(acc, ids0), time_ms(acc, ids0),
             time_ms(f32, ids0)]
        emit({"shape": shape, "kernel": kname, "candidate": "mode",
              "packed_acc_ms": (t[1] + t[2]) / 2, "f32_ms": (t[0] + t[3]) / 2,
              "turns_ms": t, "rows": hi - lo, "target_rows": matched,
              "features": F, "bins": B,
              "tiling": {m: shipped.tiling(F, B, m == "packed_acc")
                         for m in MODES},
              "reps": args.reps, "card": card})
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(records, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
