#!/usr/bin/env python3
"""Candidate designs of the frontier histogram body (K6/K7,
``frontier_hist_kernel`` in lightgbm_tpu_torch/csrc/histogram.cu), side by
side on one NVIDIA card.

    python3 tools/frontier_candidates.py sass [SOURCE.cu ...]
    python3 tools/frontier_candidates.py time [--reps N] [--out FILE]
    python3 tools/frontier_candidates.py host [--reps N] [--out FILE]

``sass`` compiles each source (default: the checkout's histogram.cu) for
sm_90a and prints, for every ``frontier_hist_kernel`` instantiation,
ptxas's registers, shared memory and spills and the count of each atomic
SASS opcode (ATOMS.* on shared memory, RED/ATOM on device memory): whether
a 64-bit shared add is one instruction or a compare-and-swap loop.

``time`` builds the shipped source and each candidate derived from it by
a textual change, checks that every candidate gives the shipped kernel's
histograms and leaf ids bit for bit, and times K6, K7 routed and K7
fused-K of each at two frontier rounds: the HIGGS round (10.5M rows x 28
features x 64 bins, 16 of 32 leaves split, about half the rows listed)
and the multiclass_cat round (1M rows x 28 x 256 bins, 2 of 32 leaves
split), in both weight modes: ``f32`` (pack_channels' fixed-point
channels) and ``packed_acc`` (quantize_pack's int32 stream at 8 bits); a
``mode`` record times the shipped kernel's two modes against each other
(f32, packed_acc, packed_acc, f32).  Warp aggregation with
__match_any_sync (+52-67% at HIGGS, PERF.md) edited an add loop the body
no longer has and is not rebuilt here.  Candidates:

  * ``1x1024``    the shipped design: one 1024-thread block an SM with the
                  SM's whole shared memory;
  * ``2x512``     two 512-thread blocks an SM, each half the shared memory
                  (more feature tiles re-walk the rows);
  * ``no_queue``  no queue of matching rows: each thread adds its own row
                  where it finds a match, with the lanes of its warp that
                  match too.

``host`` times the host's side of a call at the same two rounds: the
whole wrapper, its parameter packing, and the library's entry point
alone, the latter also for a build whose parameter block holds 16 routes
and 32 targets instead of 256 and 512.

Each kernel is timed with CUDA events around the replay of a CUDA graph
of N launches (default 20; the device's time, with no host between
launches), in turns: shipped, candidate, candidate, shipped.  Inputs are
made on the card from a seed; the rows of a leaf are contiguous, as
compaction leaves them.  Needs a card and nvcc; prints one JSON line per
measurement.
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

MODES = ("f32", "packed_acc")
# no_queue: each thread adds its own matching row where it finds it, with
# the lanes of its warp that match (no queue)
CANDIDATES = {
    "1x1024": [],
    "2x512": [("constexpr int kFrontierBlocksPerSm = 1;",
               "constexpr int kFrontierBlocksPerSm = 2;")],
    "no_queue": [("QUEUE", """    if (slot >= 0) {
      q_row[lane] = (int)row;
      q_slot[lane] = (short)slot;
      add_row(lane);
    }
  }
""")],
}
# the span of the shipped source that no_queue replaces
_QUEUE_FROM = ("    const unsigned match = __ballot_sync(0xffffffffu, "
               "slot >= 0);")
_QUEUE_TO = "  if ((int)lane < queued) add_row(lane);\n"


def _variant(text: str, edits) -> str:
    for old, new in edits:
        if old == "QUEUE":
            a, b = text.find(_QUEUE_FROM), text.find(_QUEUE_TO)
            if a < 0 or b < a:
                raise SystemExit("no_queue: the queue span is not in the "
                                 "source")
            old = text[a:b + len(_QUEUE_TO)]
        if text.count(old) != 1:
            raise SystemExit(f"candidate edit does not match the source once:"
                             f"\n{old[:200]}")
        text = text.replace(old, new)
    return text


def _build(src_text: str, out_dir: str, name: str, shared: bool):
    """nvcc as ops/kernels.py builds (plus -cubin for ``sass``); returns
    (artifact path, ptxas output)."""
    from lightgbm_tpu_torch.ops import kernels
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, name + ".cu")
    with open(cu, "w") as fh:
        fh.write(src_text)
    art = os.path.join(out_dir, name + (".so" if shared else ".cubin"))
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS,
           *(["-shared"] if shared else ["-cubin"]), "-o", art, cu]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}:\n{res.stdout}{res.stderr}")
    return art, res.stdout + res.stderr


def sass_main(sources) -> int:
    from lightgbm_tpu_torch.ops import kernels
    work = tempfile.mkdtemp(prefix="frontier_sass_")
    for i, src in enumerate(sources or [SOURCE]):
        with open(src) as fh:
            text = fh.read()
        art, log = _build(text, work, f"src{i}", shared=False)
        ops = kernels.sass_opcodes("frontier_hist_kernel", art)
        ptxas = kernels.ptxas_lines("frontier_hist_kernel", log)
        for fn, counts in ops.items():
            atomics = {k: v for k, v in sorted(counts.items())
                       if k.startswith(("ATOMS", "ATOM", "RED"))}
            print(json.dumps({"source": os.path.relpath(src, ROOT),
                              "function": fn, "ptxas": ptxas.get(fn),
                              "atomics": atomics,
                              "instructions": sum(counts.values())}),
                  flush=True)
    return 0


# ------------------------------------------------------------------ time
def _round_inputs(torch, th, npad, F, B, rb, K, n_leaves, seed, dev):
    """A frontier round on the card: bins uniform over B - 1 bins, leaf ids
    0..n_leaves-1 in contiguous runs, the first K leaves split at the
    middle bin of features 5 + k (new leaves n_leaves + k); the union of
    their windows listed.  Returns the tensors and the three calls' target
    lists; the weights and scales by mode."""
    import numpy as np
    from lightgbm_tpu_torch.ops.split import FeatureMeta
    gen = torch.Generator(device=dev).manual_seed(seed)
    binsT = torch.randint(0, B - 1, (F, npad), generator=gen, device=dev,
                          dtype=torch.uint8)
    lid = torch.sort(torch.randint(0, n_leaves, (npad,), generator=gen,
                                   device=dev, dtype=torch.int32)).values
    grad = torch.randn(npad, generator=gen, device=dev)
    hess = torch.rand(npad, generator=gen, device=dev) * 0.25
    member = torch.ones(npad, device=dev)
    w8 = th.pack_channels(grad, hess, member)
    w2, qscales, _ = th.quantize_pack(grad, hess, member)
    ws = {"f32": (w8, th.fixed_point_scales(w8)),
          "packed_acc": (w2, qscales)}
    fm = FeatureMeta(np.full(F, B - 1, np.int32), np.zeros(F, np.int32),
                     np.zeros(F, np.int32))
    none = np.zeros(8, np.uint32)
    routes = torch.stack([th.pack_route(k, n_leaves + k, 5 + k % (F - 5),
                                        (B - 1) // 2, False, False, none, fm)
                          for k in range(K)])
    leaves = torch.arange(n_leaves + 1, device=dev, dtype=torch.int32)
    edges = torch.searchsorted(lid, leaves).tolist()
    bl, n = th.union_block_list([edges[k] // rb for k in range(K)],
                                [-(-edges[k + 1] // rb) for k in range(K)],
                                [True] * K)
    smaller = torch.tensor([k if k % 2 else n_leaves + k for k in range(K)],
                           dtype=torch.int32)
    both = torch.tensor(list(range(K)) + [n_leaves + k for k in range(K)],
                        dtype=torch.int32)
    return binsT, ws, lid, routes, bl.to(dev), n, smaller, both


class _Lib:
    """One build of histogram.cu, called as ops/histogram.py calls the
    shipped one, with a zeroed scratch of its own."""

    def __init__(self, path, torch, dev):
        from lightgbm_tpu_torch.ops import kernels
        self.lib = ctypes.CDLL(path)
        for name in ("lgbt_histogram_frontier", "lgbt_frontier_tiling"):
            argtypes = kernels._SIGNATURES[name]
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.torch = torch
        self.scratch = torch.zeros(1 << 22, dtype=torch.int64, device=dev)

    def call(self, th, binsT, w8, lid, bl, n, targets, routes, B, rb, scales,
             params=None):
        """``w8``: the f32 mode's channels or a packed-accumulator stream
        (int32), which picks the kernel's mode."""
        torch = self.torch
        F, npad = binsT.shape
        if params is None:
            params = th.frontier_params(targets, routes)
        KT = int(params[0])
        out = torch.empty((KT, F, B, 3), dtype=torch.float32,
                          device=binsT.device)
        rc = self.lib.lgbt_histogram_frontier(
            binsT.data_ptr(), w8.data_ptr(), lid.data_ptr(), npad, F, B, rb,
            bl.data_ptr(), n, params.ctypes.data, params.nbytes,
            scales.data_ptr(), self.scratch.data_ptr(), out.data_ptr(), 0,
            int(w8.dtype == torch.int32),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: {rc}")
        return out

    def tiling(self, F, B, KT, K, n_ids, acc):
        out = (ctypes.c_int * 3)()
        rc = self.lib.lgbt_frontier_tiling(F, B, KT, K, n_ids, 0, int(acc),
                                           ctypes.addressof(out))
        return list(out) if rc == 0 else None


def time_main(reps: int, out_path) -> int:
    import torch
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import kernels
    if not torch.cuda.is_available():
        print("frontier_candidates: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    with open(SOURCE) as fh:
        base = fh.read()
    work = tempfile.mkdtemp(prefix="frontier_cand_")
    libs = {}
    for name, edits in CANDIDATES.items():
        art, log = _build(_variant(base, edits), work, name, shared=True)
        libs[name] = _Lib(art, torch, dev)
        print(json.dumps({"candidate": name, "ptxas": kernels.ptxas_lines(
            "frontier_hist_kernel", log)}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    shapes = {"higgs": (10_502_144, 28, 64, 8192, 16, 32),
              "mc": (1_007_616, 28, 256, 8192, 2, 32)}
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    shipped = libs["1x1024"]
    for shape, (npad, F, B, rb, K, L) in shapes.items():
        binsT, ws, lid, routes, bl, n, smaller, both = _round_inputs(
            torch, th, npad, F, B, rb, K, L, 3, dev)
        routed = lid.clone()
        shipped.call(th, binsT, *ws["f32"][:1], routed, bl, n, smaller,
                     routes, B, rb, ws["f32"][1])
        cases = {"histogram_frontier": (routed, smaller, None),
                 "histogram_frontier_routed": (lid, smaller, routes),
                 "histogram_frontier_fusedk": (lid, both, routes)}
        for kname, (ids0, targets, rts) in cases.items():
            def run(lib, ids, mode):
                w, scales = ws[mode]
                return lib.call(th, binsT, w, ids, bl, n, targets, rts, B,
                                rb, scales)

            def time_ms(lib, mode):
                # reps calls, each on its own copy of the ids, in one CUDA
                # graph: the device's time, with no host between calls
                ids = [ids0.clone() for _ in range(reps)]
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    for x in ids:
                        run(lib, x, mode)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                for _ in range(2):       # a warm-up replay, a timed one
                    for x in ids:
                        x.copy_(ids0)
                    a.record()
                    graph.replay()
                    b.record()
                    torch.cuda.synchronize()
                return a.elapsed_time(b) / reps

            KT = int(targets.shape[0])
            nk = 0 if rts is None else K
            n_ids = int(th.frontier_params(targets, rts)[2])
            for mode in MODES:
                acc = mode == "packed_acc"
                ref_ids = ids0.clone()
                ref = run(shipped, ref_ids, mode)
                for name, lib in libs.items():
                    ids = ids0.clone()
                    got = run(lib, ids, mode)
                    torch.cuda.synchronize()
                    if not (torch.equal(got, ref)
                            and torch.equal(ids, ref_ids)):
                        raise SystemExit(f"{name} differs from the shipped "
                                         f"kernel on {kname} {shape} "
                                         f"({mode})")
                for name, lib in libs.items():
                    if name == "1x1024":
                        continue
                    t = [time_ms(shipped, mode), time_ms(lib, mode),
                         time_ms(lib, mode), time_ms(shipped, mode)]
                    emit({"shape": shape, "kernel": kname, "mode": mode,
                          "candidate": name, "ms": (t[1] + t[2]) / 2,
                          "shipped_ms": (t[0] + t[3]) / 2, "turns_ms": t,
                          "tiling": lib.tiling(F, B, KT, nk, n_ids, acc),
                          "shipped_tiling": shipped.tiling(F, B, KT, nk,
                                                           n_ids, acc),
                          "listed_rows": n * rb, "reps": reps,
                          "card": card})
            t = [time_ms(shipped, "f32"), time_ms(shipped, "packed_acc"),
                 time_ms(shipped, "packed_acc"), time_ms(shipped, "f32")]
            emit({"shape": shape, "kernel": kname, "candidate": "mode",
                  "packed_acc_ms": (t[1] + t[2]) / 2,
                  "f32_ms": (t[0] + t[3]) / 2, "turns_ms": t,
                  "tiling": {m: shipped.tiling(F, B, KT, nk, n_ids,
                                               m == "packed_acc")
                             for m in MODES},
                  "listed_rows": n * rb, "reps": reps, "card": card})
        del binsT, ws, lid, routed
        torch.cuda.empty_cache()
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(records, fh, indent=1)
    return 0


def _small_block(th, block, max_routes, max_targets):
    """frontier_params's block repacked for a build whose FrontierParams
    holds max_routes routes and max_targets targets."""
    import numpy as np
    at = 4 + th.FRONTIER_MAX_TARGETS
    return np.concatenate([block[:4 + max_targets],
                           block[at:at + max_routes * th.ROUTE_WORDS]])


def host_main(reps: int, out_path) -> int:
    """The host's time a call: the whole wrapper, frontier_params alone,
    and the library's entry point alone (parameter copy and launch), for
    the shipped build and a build whose parameter block holds 16 routes
    and 32 targets (1.4 KB against 21.5 KB).  Each over ``reps`` calls,
    enqueue only."""
    import time
    import torch
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import kernels
    if not torch.cuda.is_available():
        print("frontier_candidates: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    with open(SOURCE) as fh:
        base = fh.read()
    small_src = _variant(base, [
        ("constexpr int kFrontierMaxRoutes = 256;",
         "constexpr int kFrontierMaxRoutes = 16;"),
        ("constexpr int kFrontierMaxTargets = 512;",
         "constexpr int kFrontierMaxTargets = 32;")])
    art, _ = _build(small_src, tempfile.mkdtemp(prefix="frontier_host_"),
                    "small_params", shared=True)
    small = _Lib(art, torch, dev)
    shipped = kernels.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()

    def host_us(fn):
        fn(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return us

    records = []
    shapes = {"higgs": (10_502_144, 28, 64, 8192, 16, 32),
              "mc": (1_007_616, 28, 256, 8192, 2, 32)}
    for shape, (npad, F, B, rb, K, L) in shapes.items():
        binsT, ws, lid, routes, bl, n, smaller, both = _round_inputs(
            torch, th, npad, F, B, rb, K, L, 3, dev)
        w8, scales = ws["f32"]
        cases = {"histogram_frontier": (smaller, None),
                 "histogram_frontier_routed": (smaller, routes),
                 "histogram_frontier_fusedk": (both, routes)}
        for kname, (targets, rts) in cases.items():
            ids = lid.clone()   # routed once; later calls move no row
            wrapper = getattr(th, kname)
            args = ((binsT, w8, ids, bl, n, targets) if rts is None else
                    (binsT, w8, ids, bl, n, targets, rts))
            block = th.frontier_params(targets, rts)
            KT = int(block[0])
            scratch = th._kernel_scratch(dev, KT * F * B * 3 + 64)
            out = torch.empty((KT, F, B, 3), dtype=torch.float32,
                              device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def entry(lib, params):
                return lambda i: lib.lgbt_histogram_frontier(
                    binsT.data_ptr(), w8.data_ptr(), ids.data_ptr(), npad,
                    F, B, rb, bl.data_ptr(), n, params.ctypes.data,
                    params.nbytes, scales.data_ptr(), scratch.data_ptr(),
                    out.data_ptr(), 0, 0, stream)

            sblock = _small_block(th, block, 16, 32)
            rec = {"shape": shape, "kernel": kname, "reps": reps,
                   "card": card,
                   "wrapper_us": host_us(lambda i: wrapper(*args, B, rb,
                                                           scales)),
                   "params_us": host_us(lambda i: th.frontier_params(
                       targets, rts)),
                   "entry_us": host_us(entry(shipped, block)),
                   "entry_small_params_us": host_us(entry(small.lib,
                                                          sblock)),
                   "params_bytes": int(block.nbytes),
                   "small_params_bytes": int(sblock.nbytes)}
            records.append(rec)
            print(json.dumps(rec), flush=True)
        del binsT, ws, w8, lid
        torch.cuda.empty_cache()
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(records, fh, indent=1)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("sass")
    s.add_argument("sources", nargs="*")
    t = sub.add_parser("time")
    t.add_argument("--reps", type=int, default=20)
    t.add_argument("--out", default=None)
    h = sub.add_parser("host")
    h.add_argument("--reps", type=int, default=200)
    h.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.cmd == "sass":
        return sass_main(args.sources)
    if args.cmd == "host":
        return host_main(args.reps, args.out)
    return time_main(args.reps, args.out)


if __name__ == "__main__":
    sys.exit(main())
