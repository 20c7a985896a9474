#!/usr/bin/env python3
"""B3 (``histogram_chunked_leaf``, lightgbm_tpu_torch/csrc/wide_hist.cu)
design candidates on one NVIDIA card, each held bit for bit to the plain
version and timed beside the shipped design and the previous one.

    python3 tools/b3_candidates.py [--out FILE]

Run from the root of a checkout.  The candidates are built with nvcc into
libraries of their own, side by side: the shipped source with diagnostic
edits (``count_only``: the count's add alone; ``no_atomics``: no add, the
loads alone; both give wrong sums and are timed only), and
tools/b3_candidates/two_limb.cu, the two-limb design (five adds a pair, a
renormalising barrier every ~4,000 rows at HIGGS), with its diagnostics
(``two_limb_no_renorm``, wrong sums, and its ``count_only`` and
``no_atomics``).  Data: 10,502,144 rows of 28 random columns at 1,024
bins (two-byte) and 64 bins (one-byte), random gradients; leaves of every
other row, ~5% and ~0.5% of the rows and none, and the root.  Each
candidate is timed twice (chip_smoke's time_ms, CUDA events over 10 calls
of both launches), the shipped design's two passes also alone, the
previous design (tools/p1_time.py prev_histogram_chunked) before and
after.  Prints one JSON line a shape.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(ROOT, "lightgbm_tpu_torch", "csrc", "wide_hist.cu")
TWO_LIMB = os.path.join(ROOT, "tools", "b3_candidates", "two_limb.cu")

# the shipped pass 2's adds of a pair, and the two-limb design's
_SHIPPED_ADDS = """            atomicAdd(p, ag0);
            atomicAdd(p + words, ag1);
            atomicAdd(p + 2 * words, ag2);
            atomicAdd(p + 3 * words, ah0);
            atomicAdd(p + 4 * words, ah1);
            atomicAdd(p + 5 * words, ah2);
"""
_TWO_LIMB_ADDS = """            atomicAdd(planes + k, a0);
            atomicAdd(planes + words + k, a1);
            atomicAdd(planes + 2 * words + k, a2);
            atomicAdd(planes + 3 * words + k, a3);
"""
# name -> (source, [(old, new)] textual edits)
CANDIDATES = {
    "shipped": (SHIPPED, []),
    "count_only": (SHIPPED, [(_SHIPPED_ADDS, "")]),
    "no_atomics": (SHIPPED, [(_SHIPPED_ADDS + "            atomicAdd(p + 6 * "
                              "words, 1u);",
                              "            if (ag0 == 0x12345u && b == 77) "
                              "atomicAdd(p, ag1);")]),
    "two_limb": (TWO_LIMB, []),
    "two_limb_no_renorm": (TWO_LIMB, [(
        "    if (!kGlobal && since + step > interval) {",
        "    if (false) {")]),
    "two_limb_count_only": (TWO_LIMB, [(_TWO_LIMB_ADDS, "")]),
    "two_limb_no_atomics": (TWO_LIMB, [(
        _TWO_LIMB_ADDS + "            atomicAdd(planes + 4 * words + k, 1u);",
        "            if (a0 == 0x12345u && b == 77) "
        "atomicAdd(planes + k, a1);")]),
}
SIGNATURES = ("lgbt_chunked_select", "lgbt_histogram_chunked",
              "lgbt_chunked_tiling")


def build(kernels):
    """{name: ctypes library} of every candidate, nvcc in parallel."""
    out = os.path.join(str(kernels.BUILD_ROOT), "b3-candidates")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, (src, edits) in CANDIDATES.items():
        text = open(src).read()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"candidate {name}: an edit does not "
                                   f"match {os.path.basename(src)} once")
            text = text.replace(old, new)
        cu = os.path.join(out, name + ".cu")
        with open(cu, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
             os.path.join(out, name + ".so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out, name + ".so"))
        for fn in SIGNATURES:
            getattr(lib, fn).argtypes = kernels._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


class Launcher:
    """B3's two launches through one candidate library, with a state, a
    list and a scratch of its own (ops/histogram.py _launch_chunked's
    arguments)."""

    def __init__(self, lib, npad, num_cols, dev):
        import torch
        self.lib = lib
        self.state = torch.zeros(2048, dtype=torch.int64, device=dev)
        self.list = torch.empty(3 * npad, dtype=torch.int32, device=dev)
        self.scratch = torch.zeros(num_cols * 65536 * 3 + 64,
                                   dtype=torch.int64, device=dev)

    def __call__(self, rows, G, grad, hess, member, lid, leaf, B,
                 part="both"):
        import torch
        from lightgbm_tpu_torch.ops import kernels
        npad, stride = rows.shape
        stream = kernels.stream_ptr(rows.device)
        if part in ("both", "select"):
            rc = self.lib.lgbt_chunked_select(
                grad.data_ptr(), hess.data_ptr(), member.data_ptr(),
                None if lid is None else lid.data_ptr(), leaf, 0, npad,
                None, self.state.data_ptr(), self.list.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"pass 1 failed: CUDA error {rc}")
        out = torch.empty((G, B, 3), dtype=torch.float32, device=rows.device)
        if part in ("both", "hist"):
            rc = self.lib.lgbt_histogram_chunked(
                rows.data_ptr(), rows.element_size(), stride, npad, G, B,
                self.state.data_ptr(), self.list.data_ptr(),
                self.scratch.data_ptr(), out.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"pass 2 failed: CUDA error {rc}")
        return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch
    if not torch.cuda.is_available():
        print("b3_candidates: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import p1_time
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import kernels
    card = cs.card_line()
    dev = torch.device("cuda")
    G, N = 28, 10_502_144
    libs = build(kernels)
    gen = torch.Generator(device=dev).manual_seed(5)
    grad = torch.randn(N, device=dev, generator=gen)
    hess = torch.rand(N, device=dev, generator=gen) * 0.25
    member = torch.ones(N, device=dev)
    member[10_500_000:] = 0
    lid = torch.randint(3, 9, (N,), device=dev, generator=gen,
                        dtype=torch.int32)
    lid[::2] = 0
    r = torch.rand(N, device=dev, generator=gen)
    lid[(r < 0.1) & (lid != 0)] = 1
    lid[(r > 0.99) & (lid != 0)] = 2
    launchers = {name: Launcher(lib, N, G, dev) for name, lib in libs.items()}
    for B, wide in ((1024, True), (64, False)):
        raw = torch.randint(0, B, (G, N), device=dev, generator=gen)
        bins = (raw.to(torch.int32).to(torch.int16) if wide
                else raw.to(torch.uint8))
        del raw
        rows = th.chunked_rows(bins)
        cases = [("root", None, -1), ("half", lid, 0), ("5pct", lid, 1),
                 ("0.5pct", lid, 2), ("empty", lid, 11)]
        for tag, L, leaf in cases if wide else cases[:1]:
            want = th.histogram_chunked_leaf_plain(bins, grad, hess, member,
                                                   B, L, leaf)
            m = member if L is None else (L == leaf).float() * member
            w3 = th.chunked_channels(grad, hess, m)
            sc = th.channel_scales(w3)

            def prev(i):
                return p1_time.prev_histogram_chunked(bins, w3, B, sc)

            rec = {"card": card, "B": B, "case": tag,
                   "members": int((m != 0).sum()), "prev_ms": [
                       cs.time_ms(prev, 10)]}
            for name, call in launchers.items():
                got = call(rows, G, grad, hess, member, L, leaf, B)
                torch.cuda.synchronize()

                def both(i, call=call):
                    return call(rows, G, grad, hess, member, L, leaf, B)

                rec[name] = {"equal": bool(torch.equal(got, want)),
                             "ms": [cs.time_ms(both, 10),
                                    cs.time_ms(both, 10)]}
                if name == "shipped":
                    for part in ("select", "hist"):
                        rec[name][part + "_ms"] = cs.time_ms(
                            lambda i, part=part: call(
                                rows, G, grad, hess, member, L, leaf, B,
                                part), 10)
            rec["prev_ms"].append(cs.time_ms(prev, 10))
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
        del bins, rows
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
