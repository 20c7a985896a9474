"""ctypes loader for the host's native data path: bin bounds, the
quantizer and the text tokenizers.

The port's own loader (lightgbm_tpu/core/native.py is the JAX package's)
for three C++ sources:

  * ``src/native/fastbin.cpp``: GreedyFindBin (bin.cpp:74-150) and the
    one-pass row quantizer, shared with the JAX package and read as they
    are;
  * ``src/native/textparse.cpp``: the LibSVM tokenizer, shared likewise;
  * ``lightgbm_tpu_torch/csrc/densetext.cpp``: the port's CSV/TSV
    tokenizer (the JAX package reads those files with pandas, which the
    card's machine does not have).

Each is built on first use with the system ``g++`` into
``lightgbm_tpu_torch/_build/native/`` (git-ignored), keyed by a hash of
the source, the flags and the host's CPU, and never under ``src/``.  The
Python versions in core/binning.py and core/parser.py are the plain
versions: the tests hold the two byte for byte.  Where a library does not
build, its callers take the Python version after the JAX package's
warning.  ``USED`` counts the calls that each library served, so a run
can show that the native path ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..utils.log import log_warning

_PKG = Path(__file__).resolve().parent.parent
_REPO = _PKG.parent
BUILD_DIR = _PKG / "_build" / "native"
SOURCES = {"fastbin": _REPO / "src" / "native" / "fastbin.cpp",
           "textparse": _REPO / "src" / "native" / "textparse.cpp",
           "densetext": _PKG / "csrc" / "densetext.cpp"}
_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
# the JAX package's fallback notes (lightgbm_tpu/core/native.py)
_FALLBACK = {"fastbin": "the (much slower) Python bin-bound loop",
             "textparse": "the Python LibSVM parser",
             "densetext": "the Python CSV/TSV parser"}

_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}
# calls served natively, by library
USED: Dict[str, int] = {k: 0 for k in SOURCES}

_D = ctypes.POINTER(ctypes.c_double)
_L = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "fastbin": {
        "lgbmtpu_greedy_find_bin": (ctypes.c_int64, [
            _D, _L, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, _D]),
        "lgbmtpu_quantize_rows": (None, [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            _L, ctypes.c_int64, _D, _L, _I32, _I32, ctypes.c_int64,
            ctypes.c_void_p]),
        "lgbmtpu_quantize_rows_f32": (None, [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, _L,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float), _L, _I32, _I32,
            ctypes.c_void_p])},
    "textparse": {
        "lgbmtpu_libsvm_scan": (ctypes.c_int64, [
            ctypes.c_char_p, ctypes.c_int64, _L, _L]),
        "lgbmtpu_libsvm_fill": (ctypes.c_int64, [
            ctypes.c_char_p, ctypes.c_int64, _D, ctypes.c_int64,
            ctypes.c_int64])},
    "densetext": {
        "lgbtt_dense_scan": (ctypes.c_int64, [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, _L, _L]),
        "lgbtt_dense_fill": (ctypes.c_int64, [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, _D,
            ctypes.c_int64, ctypes.c_int64])},
}


def _host_tag() -> str:
    """The host's CPU capabilities, hashed: ``-march=native`` builds are
    keyed by it, so a checkout shared by unlike hosts rebuilds."""
    raw = platform.machine()
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("flags"):
                    raw += line
                    break
    except OSError:
        pass
    return raw


def library_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _host_tag().encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"


def _build(src: Path, out: Path) -> None:
    """g++ into a temporary file beside ``out``, then renamed onto it, so
    processes that build at once never load a half-written library."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *_FLAGS, str(src), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(proc.stderr[-500:])
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def lib(name: str) -> Optional[ctypes.CDLL]:
    """The loaded library ``name`` ("fastbin", "textparse" or
    "densetext"), built on first use; None where it cannot be built (no
    g++), after a warning: its callers take the Python version."""
    if name in _LIBS:
        return _LIBS[name]
    handle = None
    try:
        out = library_path(name)
        if not out.exists():
            _build(SOURCES[name], out)
        handle = ctypes.CDLL(str(out))
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            f = getattr(handle, fn)
            f.restype = restype
            f.argtypes = argtypes
    except Exception as e:  # noqa: BLE001 - the Python versions stand in
        log_warning(f"native {name} unavailable ({type(e).__name__}: "
                    f"{str(e)[-200:]}); falling back to {_FALLBACK[name]}")
        handle = None
    _LIBS[name] = handle
    return handle


def greedy_find_bin_native(distinct_values: np.ndarray, counts: np.ndarray,
                           max_bin: int, total_cnt: int,
                           min_data_in_bin: int):
    """GreedyFindBin in C++: the bounds as a list, equal to
    core/binning.py's greedy_find_bin; None without the library."""
    L = lib("fastbin")
    if L is None:
        return None
    dv = np.ascontiguousarray(distinct_values, dtype=np.float64)
    ct = np.ascontiguousarray(counts, dtype=np.int64)
    out = np.empty(max(int(max_bin), 1) + 1, dtype=np.float64)
    n = L.lgbmtpu_greedy_find_bin(
        dv.ctypes.data_as(_D), ct.ctypes.data_as(_L), len(dv), int(max_bin),
        int(total_cnt), int(min_data_in_bin), out.ctypes.data_as(_D))
    USED["fastbin"] += 1
    return [float(x) for x in out[:n]]


def parse_libsvm_native(data: bytes) -> Optional[np.ndarray]:
    """LibSVM bytes -> dense [n, max_idx + 2] float64, the label in column
    0 and feature i in column i + 1 (core/parser.py _parse_libsvm's
    layout); None without the library or on a token it leaves to the
    Python parser."""
    L = lib("textparse")
    if L is None:
        return None
    n_rows, max_idx = ctypes.c_int64(0), ctypes.c_int64(-1)
    if L.lgbmtpu_libsvm_scan(data, len(data), ctypes.byref(n_rows),
                             ctypes.byref(max_idx)) != 0:
        return None
    out = np.zeros((n_rows.value, max(max_idx.value, -1) + 2),
                   dtype=np.float64)
    filled = L.lgbmtpu_libsvm_fill(data, len(data), out.ctypes.data_as(_D),
                                   n_rows.value, out.shape[1])
    if filled != n_rows.value:
        return None
    USED["textparse"] += 1
    return out


def parse_dense_native(data: bytes, sep: str) -> Optional[np.ndarray]:
    """CSV/TSV bytes (no header) -> [n, width] float64, an empty or NA
    token NaN (core/parser.py _parse_dense); None without the library, or
    where a row's width differs from the first row's or a token is not a
    number: the Python parser then decides."""
    L = lib("densetext")
    if L is None:
        return None
    sep_b = sep.encode()
    rows, cols = ctypes.c_int64(0), ctypes.c_int64(0)
    if L.lgbtt_dense_scan(data, len(data), sep_b, ctypes.byref(rows),
                          ctypes.byref(cols)) != 0:
        return None
    out = np.empty((rows.value, cols.value), dtype=np.float64)
    if L.lgbtt_dense_fill(data, len(data), sep_b, out.ctypes.data_as(_D),
                          rows.value, cols.value) != rows.value:
        return None
    USED["densetext"] += 1
    return out


def quantize_rows_native(data: np.ndarray, feat_idx, mappers,
                         out_dtype) -> Optional[np.ndarray]:
    """The bins [N, len(feat_idx)] of the numerical columns ``feat_idx`` of
    a row-major float32/float64 matrix in one native pass, equal to
    BinMapper.value_to_bin column by column (lightgbm_tpu/core/native.py
    quantize_rows_native); None without the library, for another dtype or
    where a column is categorical.  The call releases the GIL, so threads
    can quantize row ranges at once."""
    if data.dtype not in (np.float32, np.float64) or any(
            mappers[f].is_categorical for f in feat_idx):
        return None
    L = lib("fastbin")
    if L is None:
        return None
    data = np.ascontiguousarray(data)
    n, f_total = data.shape
    bounds = []
    offs = np.zeros(len(feat_idx) + 1, dtype=np.int64)
    mt = np.zeros(len(feat_idx), dtype=np.int32)
    nb = np.zeros(len(feat_idx), dtype=np.int32)
    for j, f in enumerate(feat_idx):
        m = mappers[f]
        n_search = m.num_bin - (1 if m.missing_type == 2 else 0)
        ub = np.asarray(m.bin_upper_bound,
                        dtype=np.float64)[:max(n_search - 1, 0)]
        bounds.append(ub)
        offs[j + 1] = offs[j] + len(ub)
        mt[j], nb[j] = m.missing_type, m.num_bin
    flat = np.ascontiguousarray(np.concatenate(bounds) if bounds
                                else np.zeros(0), dtype=np.float64)
    fidx = np.asarray(feat_idx, dtype=np.int64)
    out = np.empty((n, len(feat_idx)), dtype=out_dtype)
    widest = int(np.max(offs[1:] - offs[:-1], initial=0))
    if data.dtype == np.float32 and out_dtype == np.uint8 and widest <= 128:
        # exact f32 thresholds: the least float past each f64 bound, so
        # ub < (double)v <=> v >= t (the JAX loader's fast path)
        t = flat.astype(np.float32)
        t = np.ascontiguousarray(np.where(
            t.astype(np.float64) <= flat,
            np.nextafter(t, np.float32(np.inf)), t), dtype=np.float32)
        L.lgbmtpu_quantize_rows_f32(
            data.ctypes.data_as(ctypes.c_void_p), n, f_total,
            fidx.ctypes.data_as(_L), len(feat_idx),
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            offs.ctypes.data_as(_L), mt.ctypes.data_as(_I32),
            nb.ctypes.data_as(_I32), out.ctypes.data_as(ctypes.c_void_p))
    else:
        L.lgbmtpu_quantize_rows(
            data.ctypes.data_as(ctypes.c_void_p),
            int(data.dtype == np.float64), n, f_total,
            fidx.ctypes.data_as(_L), len(feat_idx), flat.ctypes.data_as(_D),
            offs.ctypes.data_as(_L), mt.ctypes.data_as(_I32),
            nb.ctypes.data_as(_I32), int(out_dtype == np.uint16),
            out.ctypes.data_as(ctypes.c_void_p))
    USED["fastbin"] += 1
    return out
