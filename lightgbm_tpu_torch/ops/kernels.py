"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``lightgbm_tpu_torch/csrc/*.cu`` have a plain C interface.
On first use they are compiled with ``nvcc`` for ``sm_90a`` — one
``nvcc -c`` per source, all started together — and linked into one shared
library, loaded with ctypes.  The library lives in
``lightgbm_tpu_torch/_build/<hash>/`` (git-ignored), keyed by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused.  A failed build raises.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a run
resets it with ``reset_launches()`` and reads it after, to show which
kernels a path went through.  A kernel's 4-bit packed input mode (two bin
columns a byte) counts under its own name, ``variant(name, True)``, and so
does a histogram kernel's packed-accumulator mode (the int32 quantized
weight stream), ``variant(name, packed4, True)``: ``<name>_packed_acc``,
``<name>_packed4_packed_acc`` with both.  A kernel's mode for
two-byte bins (a column of more than 256) counts as
``variant(name, wide=True)``, ``<name>_u16``: B3 ``histogram_chunked``
(csrc/wide_hist.cu), K2 and P1.  B3 is two launches a call: its first
pass, which lists the leaf's rows and computes the scales, counts as
``histogram_chunked_select`` (it reads no bins, so it has one name), its
histogram as ``histogram_chunked`` or ``histogram_chunked_u16``.  A
call made while a CUDA graph is being captured launches nothing then: it
is counted in ``CAPTURED``, which the capturing code keeps as the graph's
launches and adds to ``LAUNCHES`` at every replay (``count_replay``),
when the card runs them.  Nothing here
runs at import time: the CPU tests import every module of the package
without a compiler or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

from ..utils.log import LightGBMError

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "liblgbt_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

BASE_KERNEL_NAMES = ("histogram_segment", "route_window",
                     "histogram_segment_routed", "histogram_segment_step",
                     "route_window_step", "histogram_segment_routed_step",
                     "score_gather_add", "histogram_all",
                     "histogram_frontier", "histogram_frontier_routed",
                     "histogram_frontier_fusedk", "route_trees",
                     "quantize_pack", "histogram_chunked_select",
                     "histogram_chunked")
# the kernels that read training bins, and so have a packed4 input mode
PACKED4_KERNELS = tuple(k for k in BASE_KERNEL_NAMES
                        if k not in ("score_gather_add", "quantize_pack",
                                     "histogram_chunked_select",
                                     "histogram_chunked"))
PACKED4_SUFFIX = "_packed4"
# the histogram kernels, which read weights, and so have a
# packed-accumulator input mode
PACKED_ACC_KERNELS = ("histogram_segment", "histogram_segment_routed",
                      "histogram_segment_step",
                      "histogram_segment_routed_step", "histogram_all",
                      "histogram_frontier", "histogram_frontier_routed",
                      "histogram_frontier_fusedk")
PACKED_ACC_SUFFIX = "_packed_acc"
# the kernels with a mode for two-byte bins
WIDE_KERNELS = ("histogram_chunked", "route_window", "route_trees")
WIDE_SUFFIX = "_u16"


def variant(name: str, packed4: bool = False, packed_acc: bool = False,
            wide: bool = False) -> str:
    """The launch-count name of kernel ``name`` in its packed4 input mode
    (two bin columns a byte), its packed-accumulator mode and its mode
    for two-byte bins, or ``name``."""
    return (name + (PACKED4_SUFFIX if packed4 else "")
            + (PACKED_ACC_SUFFIX if packed_acc else "")
            + (WIDE_SUFFIX if wide else ""))


KERNEL_NAMES = (BASE_KERNEL_NAMES
                + tuple(variant(k, True) for k in PACKED4_KERNELS)
                + tuple(variant(k, p4, True) for p4 in (False, True)
                        for k in PACKED_ACC_KERNELS)
                + tuple(variant(k, wide=True) for k in WIDE_KERNELS))
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNEL_NAMES}
# the launches recorded into the CUDA graph under capture, by kernel
CAPTURED: Dict[str, int] = {}

_LIB: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# the last int of each route entry is packed4 (0 or 1: two bin columns a
# byte); the histogram and tiling entries take packed4, then packed_acc
# (0 or 1: the int32 packed-accumulator stream)
_SIGNATURES = {
    "lgbt_histogram_segment": [_P, _P, _P, _LL, _I, _I, _LL, _LL, _I, _P,
                               _P, _P, _P, _I, _I, _P],
    "lgbt_histogram_all": [_P, _P, _LL, _I, _I, _I, _P, _P, _P, _I, _I,
                           _P],
    "lgbt_route_window": [_P, _P, _LL, _LL, _LL, _P, _I, _P],
    "lgbt_histogram_segment_step": [_P, _P, _P, _LL, _I, _I, _I, _P, _I,
                                    _P, _P, _P, _I, _I, _P],
    "lgbt_route_window_step": [_P, _P, _LL, _I, _I, _P, _I, _P],
    "lgbt_score_gather_add": [_P, _P, _P, _P, _LL, _I, _P],
    "lgbt_all_tiling": [_I, _I, _I, _I, _I, _P],
    "lgbt_histogram_frontier": [_P, _P, _P, _LL, _I, _I, _I, _P, _LL, _P,
                                _LL, _P, _P, _P, _I, _I, _P],
    "lgbt_frontier_tiling": [_I, _I, _I, _I, _I, _I, _I, _P],
    "lgbt_segment_tiling": [_I, _I, _I, _I, _P],
    "lgbt_quantize_pack": [_P, _P, _P, _LL, _I, _P, _P, _P, _P],
    "lgbt_route_trees": [_P, _I, _I, _LL, _LL, _P, _I, _P, _P, _I, _I, _I,
                         _I, _I, _P, _I, _I, _P],
    "lgbt_route_window_u16": [_P, _P, _LL, _LL, _LL, _P, _P],
    "lgbt_chunked_select": [_P, _P, _P, _P, _I, _I, _LL, _P, _P, _P, _P],
    "lgbt_histogram_chunked": [_P, _I, _I, _LL, _I, _I, _P, _P, _P, _P,
                               _P],
    "lgbt_chunked_tiling": [_I, _I, _P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_replay(graph_launches: Dict[str, int]) -> None:
    """Count the kernel launches of one replay of a CUDA graph whose
    capture recorded ``graph_launches`` (a copy of ``CAPTURED``)."""
    for k, v in graph_launches.items():
        LAUNCHES[k] += v


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise LightGBMError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                        "of lightgbm_tpu_torch cannot be built")


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile the kernels (once per source hash); returns the .so path."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    out_dir = BUILD_ROOT / _source_hash(sources)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stage = Path(tempfile.mkdtemp(dir=out_dir))
    cu = [s for s in sources if s.suffix == ".cu"]
    procs = [(src, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
         str(stage / (src.stem + ".o"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in cu]
    log, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc={proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(stage / LIB_NAME)]
            + [str(stage / (s.stem + ".o")) for s in cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc={link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        shutil.rmtree(stage, ignore_errors=True)
        raise LightGBMError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    os.replace(stage / LIB_NAME, lib)
    shutil.rmtree(stage, ignore_errors=True)
    return lib


def build_log() -> str:
    """The compiler's output of the current build (ptxas register and
    shared-memory lines included)."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    path = BUILD_ROOT / _source_hash(sources) / "build.log"
    return path.read_text() if path.exists() else ""


def ptxas_lines(name_part: str, log: Optional[str] = None
                ) -> Dict[str, list]:
    """Per kernel entry whose mangled name contains ``name_part``: ptxas's
    stack, spill and register lines from ``log`` (default: the current
    build's, ``build_log()``)."""
    out: Dict[str, list] = {}
    cur = None
    for line in (build_log() if log is None else log).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if name_part in m.group(1) else None
            if cur is not None:
                out[cur] = []
        elif cur is not None and ("registers" in line or "spill" in line):
            out[cur].append(line.split("info    :")[-1].strip())
    return out


def sass_opcodes(name_part: str, lib: Optional[Path] = None
                 ) -> Dict[str, Dict[str, int]]:
    """Per function of the built library (or ``lib``) whose mangled name
    contains ``name_part``: how often each SASS opcode occurs, from
    ``cuobjdump -sass`` (the toolkit beside nvcc)."""
    lib = Path(lib) if lib is not None else build_library()
    counts = _sass_counts(str(lib), lib.stat().st_mtime_ns)
    return {fn: dict(ops) for fn, ops in counts.items() if name_part in fn}


@functools.lru_cache(maxsize=8)
def _sass_counts(lib: str, mtime_ns: int) -> Dict[str, Dict[str, int]]:
    """Every function's SASS opcode counts from one ``cuobjdump -sass`` of
    ``lib`` (a dump of the whole library takes seconds: one per file and
    modification time)."""
    dump = subprocess.run(
        [str(Path(_nvcc()).parent / "cuobjdump"), "-sass", lib],
        capture_output=True, text=True, check=True).stdout
    counts: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = counts[m.group(1)] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if cur is not None and m:
            cur[m.group(1)] = cur.get(m.group(1), 0) + 1
    return counts


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.lgbt_error_string.argtypes = [ctypes.c_int]
        lib.lgbt_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check_launch(name: str, rc: int) -> None:
    """Raise on a launch the card refused; count it otherwise."""
    if rc != 0:
        msg = library().lgbt_error_string(rc).decode()
        raise LightGBMError(f"CUDA kernel {name} failed: {msg} ({rc})")
    import torch
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] = CAPTURED.get(name, 0) + 1
    else:
        LAUNCHES[name] += 1


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
