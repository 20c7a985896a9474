#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port, lightgbm_tpu_torch, on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``lightgbm_tpu_torch/csrc`` and runs
five phases; any failure exits non-zero:

  1. build    nvcc for sm_90a; prints ptxas's register/shared-memory lines
              and the card's name and power limit.
  2. kernels  at the HIGGS shape (10.5M rows x 28 features, 64 bins), every
              kernel against its plain PyTorch version on the card: counts,
              leaf ids and scores exact, gradient/hessian sums within
              1e-5 x the bin's sum of |value|, a second launch bit-identical
              to the first; route descriptors cover numeric, NaN-missing,
              zero-missing and categorical-bitset splits and a partial
              window.  Times each kernel, its plain version and, for the
              score update, the one PyTorch expression that computes it.
  3. train    the main path: ``lightgbm_tpu_torch.train`` on synthetic
              HIGGS-shaped data (as bench.py makes it), 255 leaves,
              3 iterations, fused route (K3 + K4).  Train AUC must rise,
              held-out predictions must match the in-training valid
              scores, the model text is saved.
  4. unfused  1M rows, 2 iterations, ``fused_route=False`` (K1 + K2); the
              same data through the fused path must give the same model.
  5. parity   200k rows, 31 leaves, 3 iterations on the card and on the
              CPU: the same split features and bin thresholds for splits
              with gain > 1e-2, raw predictions within 1e-3.

Output: one JSON line per kernel, one ``{"kernels": [...]}`` line, the
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
    "score_gather_add": ("lightgbm_tpu_torch/csrc/score.cu",
                         "lightgbm_tpu/ops/pallas_score.py:106"),
}


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
    from lightgbm_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    kernels.library()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log().splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("ptxas: " + line.strip())


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
    import torch
    g = (w8[0].float() + w8[1].float()).abs()
    h = (w8[2].float() + w8[3].float()).abs()
    z = torch.zeros_like(g)
    wabs = torch.stack([g, z, h, z, w8[4].float(), z, z, z])
    return th.histogram_segment_plain(binsT, wabs, lid, lo_blk, n_blk,
                                      target, B, rb)


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
        m = FeatureMeta(*(a.copy() for a in fm))
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

    # K4 score_gather_add: leaf ids of a 255-leaf tree; ids >= L add 0
    L = 255
    lid_score = torch.from_numpy(
        rng.randint(0, L, size=n).astype(np.int32)).to(device)
    score = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(device)
    table = torch.from_numpy(rng.normal(size=L).astype(np.float32)).to(device)
    want = ts.score_gather_add_plain(score, lid_score, table)
    a = ts.score_gather_add(score, lid_score, table)
    b = ts.score_gather_add(score, lid_score, table)
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
    t["library_ms"] = None
    t["shape"] = f"root: {W} rows x {F} features, all of leaf 0"

    t = results["histogram_segment_routed"]
    ids = fresh_ids(reps)
    t["ms"] = time_ms(lambda i: th.histogram_segment_routed(
        binsT, w8, ids[i], 0, nblk, 1, route, B, rb, scales), reps)
    ids = fresh_ids(plain_reps)
    t["plain_ms"] = time_ms(lambda i: th.histogram_segment_routed_plain(
        binsT, w8, ids[i], 0, nblk, 1, route, B, rb), plain_reps)
    t["bound_ms"], t["bound_by"] = bound_ms(k3_bytes, k3_ops)
    t["library_ms"] = None
    t["shape"] = (f"first split: {W} rows, {moved} routed to the target "
                  "child")
    # the root case of the fused path (null route)
    t["root_ms"] = time_ms(lambda i: th.histogram_segment_routed(
        binsT, w8, lid0, 0, nblk, 0, th.null_route(), B, rb, scales), reps)

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

    t = results["score_gather_add"]
    t["ms"] = time_ms(lambda i: ts.score_gather_add(score, lid_score, table),
                      reps)
    t["plain_ms"] = time_ms(lambda i: ts.score_gather_add_plain(
        score, lid_score, table), reps)
    t["library_ms"] = time_ms(lambda i: score + table[lid_score], reps)
    t["bound_ms"], t["bound_by"] = bound_ms(k4_bytes, k4_ops)
    t["shape"] = f"{n} rows, {L} leaves"
    return results


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
    leaves = sum(t.num_leaves for t in trees)
    require(launches["histogram_segment_routed"] == leaves,
            f"histogram_segment_routed launched "
            f"{launches['histogram_segment_routed']} times, expected one "
            f"per leaf ({leaves})")
    require(launches["score_gather_add"] == 3,
            "score_gather_add did not run once per iteration")
    require(launches["histogram_segment"] == 0
            and launches["route_window"] == 0,
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
                      "leaves": [t.num_leaves for t in trees]}


# ---------------------------------------------------------------- phase 4
def unfused_phase():
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import kernels

    X, y = higgs_like(UNFUSED_ROWS, 7)
    ds = lt.Dataset(X, y)
    models = {}
    launches = None
    for fused in (False, True):
        bst = lt.Booster(TRAIN_PARAMS, ds, fused_route=fused)
        kernels.reset_launches()
        for _ in range(2):
            bst.update()
        torch.cuda.synchronize()
        if not fused:
            launches = dict(kernels.LAUNCHES)
            trees = bst.gbdt.models
            leaves = sum(t.num_leaves for t in trees)
            log(f"unfused: leaves per tree {[t.num_leaves for t in trees]}, "
                f"per iteration {[round(s, 3) for s in bst.gbdt.iter_seconds]}"
                f" s, launches {launches}")
            require(len(trees) == 2, "unfused training stopped early")
            require(launches["histogram_segment"] == leaves
                    and launches["route_window"] == leaves - len(trees),
                    "unfused path: histogram_segment must launch once per "
                    "leaf and route_window once per split")
            require(launches["histogram_segment_routed"] == 0,
                    "unfused path launched the fused kernel")
        models[fused] = bst.model_to_string()
    require(models[False] == models[True],
            "fused and unfused paths grew different models")
    log("unfused: same model text as the fused path")
    return launches


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


# ------------------------------------------------------------------ main
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
    build_phase()
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

    main_launches, train_stats = train_phase(ds, Xh, yh)
    unfused_launches = unfused_phase()
    parity_phase()

    records = []
    for name in kernels.KERNEL_NAMES:
        r = results[name]
        on_unfused = name in ("histogram_segment", "route_window")
        src, replaces = SOURCES[name]
        rec = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces,
               "launches": (unfused_launches if on_unfused
                            else main_launches)[name],
               "path": "unfused" if on_unfused else "fused",
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"],
               "shape": r["shape"]}
        if "root_ms" in r:
            rec["root_ms"] = r["root_ms"]
        records.append(rec)
        require(rec["launches"] > 0, f"{name} was not launched on its path")
        log(json.dumps(rec))
    log(json.dumps({"train": train_stats}))
    log(json.dumps({"kernels": records}))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
