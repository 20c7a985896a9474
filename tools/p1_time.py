#!/usr/bin/env python3
"""P1 (``route_trees``, lightgbm_tpu_torch/csrc/predict.cu) and Q1
(``quantize_pack``, csrc/quantize.cu) on one NVIDIA card, beside their
previous designs.

    python3 tools/p1_time.py alone  [--rounds N] [--out FILE]
    python3 tools/p1_time.py prefix [--rounds N] [--out FILE]
    python3 tools/p1_time.py turns  [--out FILE]
    python3 tools/p1_time.py candidates [--out FILE]

Run from the root of a checkout; it imports that checkout's
``chip_smoke.py`` and package.  The previous designs, P1 before its
node records (one row a thread, nine dependent loads a step) and Q1
before its reduction kernel (torch reductions, then one kernel), are
kept as they were under
``tools/prev_kernels/`` and built here into a library of their own
(``prev_library``); ``prev_route_trees`` and ``prev_quantize_pack`` call
them as the package called them, so ``chip_smoke.py`` and this script can
time each previous design in turns with the shipped one in one process
(previous, shipped, shipped, previous).

``alone`` and ``prefix`` generate and bin chip_smoke's HIGGS rows (10.5M
x 28), train its main path (3 iterations, then the late split's fourth
tree, as phases 3 and 3b do) and time P1 over the training bins with
chip_smoke's ``p1_times`` (CUDA events over its PREDICT_REPS launches,
checked bit for bit against the plain version and the previous design, in
turns with it) ``--rounds`` times, then once more over a fresh copy of the
bins (a new allocation); ``prefix`` first runs chip_smoke's kernel and
frontier kernel phases at HIGGS, in chip_smoke's order.  ``turns`` does
the training and P1 once, then Q1 at the HIGGS rows (chip_smoke's
``q1_times``).  ``candidates`` does the training, then times the P1
designs tried beside the shipped one (``P1_CANDIDATES``: textual edits
of csrc/predict.cu, built with nvcc; and the shipped kernel in its
direct mode and at smaller blocks) on the HIGGS training bins, on 1M
rows' i16 predict bins and on multiclass_cat's training bins with its
125 trees (chip_smoke's MC_PARAMS, 25 iterations), each checked bit for
bit against the shipped kernel, in turns with it.
Prints one JSON line: the card, the mode and the times in ms.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREV_SOURCES = ("predict_previous.cu", "quantize_previous.cu")
_PREV = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_PREV_SIGNATURES = {
    "lgbt_route_trees": [_P, _I, _LL, _LL] + [_P] * 9 + [_I] * 4
    + [_P, _P, _P, _P, _I, _P, _I, _P],
    "lgbt_quantize_pack": [_P, _P, _P, _LL, _P, _P, _I, _P, _P, _P],
}


def prev_build_start():
    """Starts nvcc on the previous designs' sources (one process a
    source, as ops/kernels.py builds) into the package's git-ignored build
    directory; returns the handle ``prev_library`` finishes, or None when
    the library is already built."""
    sys.path.insert(0, ROOT)
    from lightgbm_tpu_torch.ops import kernels
    srcs = [os.path.join(ROOT, "tools", "prev_kernels", s)
            for s in PREV_SOURCES]
    h = hashlib.sha256(" ".join(kernels.NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as fh:
            h.update(fh.read())
    out = os.path.join(str(kernels.BUILD_ROOT), "prev-" + h.hexdigest()[:16])
    lib = os.path.join(out, "libprev.so")
    if os.path.exists(lib):
        return lib, []
    os.makedirs(out, exist_ok=True)
    procs = [(s, subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-c", s, "-o",
         os.path.join(out, os.path.basename(s) + ".o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for s in srcs]
    return lib, procs


def prev_library(handle=None) -> ctypes.CDLL:
    """The previous designs' library, built on first use (or from
    ``prev_build_start``'s handle)."""
    global _PREV
    if _PREV is not None:
        return _PREV
    sys.path.insert(0, ROOT)
    from lightgbm_tpu_torch.ops import kernels
    lib, procs = handle if handle is not None else prev_build_start()
    if procs:
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        objs = [p.args[-1] for _, p in procs]
        res = subprocess.run([kernels._nvcc(), *kernels.ARCH_FLAGS,
                              "-shared", "-o", lib + ".tmp", *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}"
                               f"{res.stderr}")
        os.replace(lib + ".tmp", lib)
    _PREV = ctypes.CDLL(lib)
    for name, argtypes in _PREV_SIGNATURES.items():
        fn = getattr(_PREV, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return _PREV


def _check(name, rc):
    if rc != 0:
        raise RuntimeError(f"previous {name} failed: CUDA error {rc}")


def prev_route_trees(bins, stack, num_bin, default_bin, out,
                     feat_group=None, feat_offset=None, packed4=False):
    """The previous P1 design on the stack's plain tensors, in place
    into ``out`` [C, n] float64, as the package called it."""
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops.predict import identity_tables
    C, n = out.shape
    T, M = stack.split_feature.shape
    if feat_group is None:
        feat_group, feat_offset = identity_tables(num_bin.shape[0],
                                                  out.device)
    _check("route_trees", prev_library().lgbt_route_trees(
        bins.data_ptr(), bins.element_size(), bins.shape[1], n,
        stack.split_feature.data_ptr(), stack.threshold_bin.data_ptr(),
        stack.decision_type.data_ptr(), stack.left_child.data_ptr(),
        stack.right_child.data_ptr(), stack.cat_bitset.data_ptr(),
        stack.leaf_value.data_ptr(), stack.num_leaves.data_ptr(),
        stack.tree_class.data_ptr(), T, M, stack.leaf_value.shape[1],
        stack.max_depth, num_bin.data_ptr(), default_bin.data_ptr(),
        feat_group.data_ptr(), feat_offset.data_ptr(), C, out.data_ptr(),
        int(packed4), kernels.stream_ptr(out.device)))
    return out


def prev_quantize_pack(grad, hess, member, bits=8):
    """The previous Q1 design: the scales and seed by torch reductions
    (its quantize_inputs, whose division by a Python number ATen makes a
    multiplication by the reciprocal on a card), then one kernel."""
    import torch
    from lightgbm_tpu_torch.ops import kernels
    n = grad.shape[0]
    qmax = float(2 ** (bits - 1) - 1)
    gm = grad * member
    hm = hess * member
    mags = torch.stack([gm.abs().max(), hm.abs().max()])
    scales = torch.clamp(mags, min=1e-30) / qmax
    bits8 = gm[:8].contiguous().view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    seed = (bits8.sum() & 0xFFFFFFFF).reshape(1)
    w2 = torch.empty((2, n), dtype=torch.int32, device=grad.device)
    clips = torch.zeros(1, dtype=torch.int32, device=grad.device)
    _check("quantize_pack", prev_library().lgbt_quantize_pack(
        grad.data_ptr(), hess.data_ptr(), member.data_ptr(), n,
        scales.data_ptr(), seed.data_ptr(), bits, w2.data_ptr(),
        clips.data_ptr(), kernels.stream_ptr(grad.device)))
    return w2, scales, clips.reshape(())


# P1 designs tried beside the shipped one: textual edits of
# csrc/predict.cu (``candidates`` mode); "bins_in_place" is the shipped
# library called in its direct mode (the bins read from device memory at
# every step) at shapes whose tile fits, "block_512" / "block_256" the
# shipped library at smaller blocks (and tiles)
P1_CANDIDATES = {
    "rows2": [("constexpr int kRowsPerThread = 4;",
               "constexpr int kRowsPerThread = 2;")],
    "rows8": [("constexpr int kRowsPerThread = 4;",
               "constexpr int kRowsPerThread = 8;")],
    "rows1": [("constexpr int kRowsPerThread = 4;",
               "constexpr int kRowsPerThread = 1;")],
    # a diagnostic, not exact: no steps (the tile, the stack's stages and
    # the scores' reads and writes alone)
    "no_walk": [("  for (int s = 0; s < steps; ++s) {",
                 "  for (int s = 0; s < 0; ++s) {")],
    # a diagnostic, not exact: a second record load a step (a neighbour's,
    # its result kept from being dropped), to see whether the record
    # loads' shared-memory traffic sets the walk's time
    "two_record_loads": [
        ("    if constexpr (kStaged) r = recs[node];",
         "    if constexpr (kStaged) {\n      r = recs[node];\n"
         "      const uint2 r2 = recs[node ^ 1];\n"
         "      if (r2.x == 0xFFFFFFFFu && r2.y == 0xFFFFFFFFu) r.x = 0u;\n"
         "    }")],
    "records_in_place": [
        ("  if (__ldg(chunks + 5))\n", "  if (0)\n"),
        ("if (c + 1 < num_chunks && __ldg(ch + kChunkWords + 5))", "if (0)"),
        ("    if (__ldg(ch + 5)) {", "    if (0) {")],
}


P1_DIAGNOSTICS = ("no_walk", "two_record_loads")


def build_candidates(names):
    """{name: ctypes library} of the P1 candidates ``names``, each the
    shipped predict.cu with its edits, built with nvcc in parallel."""
    sys.path.insert(0, ROOT)
    from lightgbm_tpu_torch.ops import kernels
    src = open(os.path.join(ROOT, "lightgbm_tpu_torch", "csrc",
                            "predict.cu")).read()
    out = os.path.join(str(kernels.BUILD_ROOT), "p1-candidates")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in P1_CANDIDATES[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"candidate {name}: {old!r} is not in "
                                   f"predict.cu once")
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
        lib.lgbt_route_trees.argtypes = kernels._SIGNATURES[
            "lgbt_route_trees"]
        lib.lgbt_route_trees.restype = ctypes.c_int
        libs[name] = lib
    return libs


def call_route(lib, bins, stack, num_bin, out, packed4=False,
               rows_per_thread=4, tiled=None, rows=None):
    """One P1 launch of ``lib`` (the shipped library or a candidate) as
    ops/predict.py route_trees makes it; ``tiled`` False forces the
    direct mode, ``rows`` another block size."""
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops import predict as tp
    records, layout = stack.records(num_bin.shape[0])
    plan_rows, fits = tp.route_plan(bins.shape[0], bins.element_size())
    rows = min(plan_rows if rows is None else rows, 256 * rows_per_thread)
    base = records.data_ptr()
    _check("route_trees", lib.lgbt_route_trees(
        bins.data_ptr(), bins.element_size(), bins.shape[0], bins.shape[1],
        out.shape[1], base, layout.num_chunks,
        base + 4 * layout.trees, base + 4 * layout.data,
        rows, int(fits if tiled is None else tiled),
        tp.STAGE_BYTES, tp.TILE_BUDGET, rows_per_thread, out.data_ptr(),
        int(packed4), kernels.stream_ptr(out.device)))
    return out


def p1_candidates(cs, cases, reps):
    """Each P1 candidate against the shipped kernel on each case (tag,
    bins, stack, num_bin, out): bit for bit, then timed in turns (shipped,
    candidate, candidate, shipped; chip_smoke's time_ms over ``reps``
    launches).  Returns a list of records."""
    import torch
    from lightgbm_tpu_torch.ops import kernels
    libs = build_candidates(sorted(P1_CANDIDATES))
    shipped = kernels.library()
    variants = [("bins_in_place", shipped, 4, False, None),
                ("block_512", shipped, 4, None, 512),
                ("block_256", shipped, 4, None, 256)] + [
        (name, lib, {"rows1": 1, "rows2": 2, "rows8": 8}.get(name, 4), None,
         None) for name, lib in libs.items()]
    recs = []
    for tag, bins, stack, num_bin, out in cases:
        want = call_route(shipped, bins, stack, num_bin, out.clone())
        scratch = out.clone()
        for name, lib, k, tiled, rows in variants:
            got = call_route(lib, bins, stack, num_bin, out.clone(),
                             rows_per_thread=k, tiled=tiled, rows=rows)
            torch.cuda.synchronize()
            if name not in P1_DIAGNOSTICS and not torch.equal(got, want):
                raise RuntimeError(f"P1 candidate {name} differs on {tag}")

            def ship():
                return cs.time_ms(lambda i: call_route(
                    shipped, bins, stack, num_bin, scratch), reps)

            def cand():
                return cs.time_ms(lambda i: call_route(
                    lib, bins, stack, num_bin, scratch, rows_per_thread=k,
                    tiled=tiled, rows=rows), reps)

            turns = [ship(), cand(), cand(), ship()]
            recs.append({"case": tag, "candidate": name, "turns_ms": turns,
                         "shipped_ms": (turns[0] + turns[3]) / 2,
                         "candidate_ms": (turns[1] + turns[2]) / 2})
            print(json.dumps(recs[-1]), flush=True)
    return recs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("alone", "prefix", "turns",
                                     "candidates"))
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
    if args.mode == "candidates":
        from lightgbm_tpu_torch.models.device_predict import bin_rows
        gb = bst.gbdt
        stack = TreeStack(gb.models, [0] * len(gb.models),
                          gb.train_set.num_used_features, gb.device,
                          gb.route_tables[0])
        Xp, _ = cs.higgs_like(cs.PREDICT_ROWS, 43)
        pbins = torch.from_numpy(bin_rows(gb.train_set, Xp)).to(gb.device)
        pstack = TreeStack(gb.models, [0] * len(gb.models),
                           gb.train_set.num_used_features, gb.device,
                           gb.route_tables[1])
        Xm, ym = cs.multiclass_cat(cs.MC_ROWS, 7)
        mc = lightgbm_tpu_torch.train(
            cs.MC_PARAMS, lightgbm_tpu_torch.Dataset(
                Xm, ym, categorical_feature=cs.MC_CAT), cs.MC_ITERS).gbdt
        C = mc.num_tree_per_iteration
        mstack = TreeStack(mc.models, [i % C for i in range(len(mc.models))],
                           mc.train_set.num_used_features, mc.device,
                           mc.route_tables[0])
        cases = [("HIGGS training bins", gb.bins, stack, gb.fmeta.num_bin,
                  gb.train_score.to(torch.float64).contiguous()),
                 ("HIGGS i16 predict bins", pbins, pstack, gb.fmeta.num_bin,
                  torch.zeros((1, len(Xp)), dtype=torch.float64,
                              device=gb.device)),
                 ("multiclass_cat training bins", mc.bins, mstack,
                  mc.fmeta.num_bin,
                  mc.train_score.to(torch.float64).contiguous())]
        rec = {"card": card, "mode": args.mode,
               "candidates": p1_candidates(cs, cases, cs.PREDICT_REPS),
               "wall_s": time.perf_counter() - t0}
        line = json.dumps(rec)
        print(line)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        return 0
    rounds = 1 if args.mode == "turns" else args.rounds
    p1 = [cs.route_kernel_phase(bst) for _ in range(rounds)]
    rec = {"card": card, "mode": args.mode, "trees": len(bst.gbdt.models),
           "p1_ms": [r["ms"] for r in p1],
           "p1_prev_ms": [r["prev_ms"] for r in p1],
           "bound_ms": p1[0]["bound_ms"]}
    gb = bst.gbdt
    if args.mode == "turns":
        grad = torch.randn(gb.bins.shape[1], device=gb.device)
        hess = torch.rand(gb.bins.shape[1], device=gb.device) * 0.25
        rec["q1"] = cs.q1_times(grad, hess, gb.member, "HIGGS rows")
    else:
        stack = TreeStack(gb.models, [0] * len(gb.models),
                          gb.train_set.num_used_features, gb.device,
                          gb.route_tables[0])
        copy = cs.p1_times(gb.bins.clone(), stack, gb.fmeta.num_bin,
                           gb.fmeta.default_bin,
                           gb.train_score.to(torch.float64).contiguous(),
                           gb.models, "HIGGS training bins, a fresh copy")
        rec["p1_fresh_copy_ms"] = copy["ms"]
    rec["wall_s"] = time.perf_counter() - t0
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
