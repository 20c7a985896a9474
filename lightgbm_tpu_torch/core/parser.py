"""Text data files: CSV / TSV / LibSVM with format detection.

The port's copy of lightgbm_tpu/core/parser.py (reference: src/io/
parser.{cpp,hpp}, Parser::CreateParser :92 detects the format by counting
separators on sample lines; the DatasetLoader text pipeline,
src/io/dataset_loader.cpp:162-260: the label, weight, query and ignored
columns, a header line, two-round loading).  The tokenizers are native
(core/native.py: src/native/textparse.cpp for LibSVM, csrc/densetext.cpp
for CSV/TSV, which the JAX package reads with pandas), a piece of the
file a thread; ``_parse_dense``
and ``_parse_libsvm`` are their plain versions and take over where a
library does not build or leaves a file to them.  The dataset is the one
``TorchDataset.from_numpy`` builds from the parsed matrix, or with
``two_round`` the JAX loader's: a reservoir sample for the bin bounds on
a first pass, the bins on a second, one chunk of rows at a time.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from ..config import Config
from ..models.tree import _walk_workers
from ..utils import file_io
from ..utils.file_io import open_file
from ..utils.log import LightGBMError, check, log_info
from . import native


def _detect_format(sample_lines: List[str]) -> str:
    """Count separators like Parser::CreateParser (parser.cpp:30-90)."""
    cnt = [(line.count(","), line.count("\t"), line.count(":"))
           for line in sample_lines if line.strip()]
    if not cnt:
        raise LightGBMError("Empty data file")
    if min(c[1] for c in cnt) > 0:
        return "tsv"
    if min(c[0] for c in cnt) > 0:
        return "csv"
    if min(c[2] for c in cnt) > 0:
        return "libsvm"
    return "csv"  # single-column fallback


_NA_TOKENS = ("", "na", "nan", "NaN", "NULL", "N/A", "NA", "null")


def _parse_dense(lines: List[str], sep: str) -> np.ndarray:
    """The plain CSV/TSV reader: a row a line, a missing token NaN, a
    short row padded with NaN."""
    rows = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        rows.append([float(tok) if tok not in _NA_TOKENS
                     else np.nan for tok in line.split(sep)])
    width = max(len(r) for r in rows)
    out = np.full((len(rows), width), np.nan)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def _parse_libsvm(lines: List[str]) -> np.ndarray:
    """The plain LibSVM reader: label idx:val idx:val ... -> [n, max_idx
    + 2], the label in column 0, feature idx in column idx + 1 (a
    non-integer index, such as qid:, is skipped)."""
    parsed = []
    max_idx = -1
    for line in lines:
        line = line.strip()
        if not line:
            continue
        toks = line.split()
        feats = {}
        for tok in toks[1:]:
            if ":" not in tok:
                continue
            k, v = tok.split(":", 1)
            try:
                idx = int(k)
            except ValueError:
                continue
            feats[idx] = float(v)
            max_idx = max(max_idx, idx)
        parsed.append((float(toks[0]), feats))
    out = np.zeros((len(parsed), max_idx + 2))
    for i, (label, feats) in enumerate(parsed):
        out[i, 0] = label
        for k, v in feats.items():
            out[i, k + 1] = v
    return out


def _read_head(filename: str, max_bytes: int = 1 << 16,
               want_lines: int = 34) -> List[str]:
    """The file's first lines, for its format and width: the buffer grows
    until it holds ``want_lines`` whole lines."""
    with open_file(filename) as fh:
        head = fh.read(max_bytes)
        truncated = len(head) == max_bytes
        while truncated and head.count("\n") < want_lines:
            more = fh.read(max_bytes)
            head += more
            truncated = len(more) == max_bytes
    lines = head.splitlines()
    if truncated and len(lines) > 1 and not head.endswith("\n"):
        lines = lines[:-1]
    return lines


def _skip_lines(data: bytes, skip_rows: int) -> bytes:
    for _ in range(skip_rows):
        nl = data.find(b"\n")
        data = b"" if nl < 0 else data[nl + 1:]
    return data


# a buffer past this many bytes is tokenized a piece a thread
_PARALLEL_BYTES = 8 << 20


def _native_pieces(data: bytes, parse) -> Optional[List[np.ndarray]]:
    """``parse`` (a native tokenizer, which releases the GIL) over ``data``
    cut at line ends into a piece a core, the pieces in threads; the
    non-empty results in order, or None where a piece is left to the
    Python reader."""
    n, workers = len(data), _walk_workers()
    if n < _PARALLEL_BYTES or workers == 1:
        mat = parse(data)
        return None if mat is None else [mat]
    cuts = [0]
    for k in range(1, workers):
        c = data.find(b"\n", max(n * k // workers, cuts[-1]))
        cuts.append(n if c < 0 else c + 1)
    cuts.append(n)
    pieces = [data[a:b] for a, b in zip(cuts, cuts[1:]) if b > a]
    with ThreadPoolExecutor(len(pieces)) as pool:
        mats = list(pool.map(parse, pieces))
    if any(m is None for m in mats):
        return None
    return [m for m in mats if m.shape[0]]


def _dense_block(data: bytes, sep: str) -> np.ndarray:
    """One block of CSV/TSV bytes -> [n, width] float64: the native
    tokenizer, else the plain reader (also for pieces of other widths)."""
    mats = _native_pieces(data, lambda b: native.parse_dense_native(b, sep))
    if mats == []:
        return np.zeros((0, 0))
    if mats and len({m.shape[1] for m in mats}) == 1:
        return mats[0] if len(mats) == 1 else np.concatenate(mats)
    return _parse_dense(data.decode().splitlines(), sep)


def _libsvm_native(data: bytes) -> Optional[np.ndarray]:
    """LibSVM bytes by the native tokenizer, a piece a thread, the pieces'
    widths padded with zeros (LibSVM's absent value) to the widest; None
    where it leaves the file to the Python reader."""
    mats = _native_pieces(data, native.parse_libsvm_native)
    if mats is None:
        return None
    if not mats:
        return np.zeros((0, 1))
    width = max(m.shape[1] for m in mats)
    out = np.zeros((sum(m.shape[0] for m in mats), width))
    row = 0
    for m in mats:
        out[row:row + m.shape[0], :m.shape[1]] = m
        row += m.shape[0]
    return out


def _read_dense_matrix(filename: str, sep: str, skip_rows: int) -> np.ndarray:
    with open_file(filename, "rb") as fh:
        data = fh.read()
    return _dense_block(_skip_lines(data, skip_rows), sep)


# the two-round loader's block of raw bytes (whole lines)
_CHUNK_BYTES = 64 << 20


def _iter_dense_chunks(filename: str, sep: str, skip_rows: int,
                       chunk_bytes: int = _CHUNK_BYTES):
    """[rows, width] float64 blocks of a CSV/TSV file, read ``chunk_bytes``
    of whole lines at a time (peak memory: one block)."""
    with open_file(filename, "rb") as fh:
        for _ in range(skip_rows):
            fh.readline()
        rest = b""
        while True:
            data = fh.read(chunk_bytes)
            buf = rest + data
            if data:
                cut = buf.rfind(b"\n") + 1
                block, rest = buf[:cut], buf[cut:]
            else:
                block, rest = buf, b""
            if block.strip():
                yield _dense_block(block, sep)
            if not data:
                return


def _column_index(spec: str, header_names: Optional[List[str]]) -> int:
    """A column spec, "name:<col>" or an index (config.h label_column)."""
    if spec.startswith("name:"):
        name = spec[5:]
        if header_names is None or name not in header_names:
            raise LightGBMError(f"Column name {name} not found in header")
        return header_names.index(name)
    return int(spec)


def load_file_to_dataset(filename: str, config: Config, reference=None):
    """A text or binary data file -> TorchDataset
    (DatasetLoader::LoadFromFile, dataset_loader.cpp:162; the JAX
    package's load_file_to_dataset): the side files ``<file>.weight``,
    ``.query`` and ``.init`` where the file has no such column; with
    ``reference`` binned by its bin mappers."""
    from .dataset import BINARY_MAGIC, TorchDataset

    if not file_io.exists(filename):
        raise LightGBMError(f"Data file {filename} doesn't exist")
    if filename.endswith(".bin") or _is_binary(filename, BINARY_MAGIC):
        return TorchDataset.load_binary(filename)

    t0 = time.perf_counter()
    head = _read_head(filename)
    header_names: Optional[List[str]] = None
    skip_rows = 0
    if config.header and head:
        first = head[0].strip()
        header_names = first.split("\t" if "\t" in first else ",")
        head = head[1:]
        skip_rows = 1
    if not head:
        raise LightGBMError(
            f"Data file {filename} contains no data rows"
            + (" (only a header)" if config.header else ""))
    fmt = _detect_format(head[:32])
    log_info(f"Loading {filename} as {fmt}")
    sep = "\t" if fmt == "tsv" else ","
    ncol = (_parse_libsvm(head[:32]).shape[1] if fmt == "libsvm"
            else len(head[0].strip().split(sep)))
    label_col = (0 if fmt == "libsvm"
                 else (_column_index(config.label_column, header_names)
                       if config.label_column else 0))
    weight_col = (_column_index(config.weight_column, header_names)
                  if config.weight_column else -1)
    group_col = (_column_index(config.group_column, header_names)
                 if config.group_column else -1)
    ignore_cols = set()
    for tok in str(config.ignore_column or "").split(","):
        if tok.strip():
            ignore_cols.add(_column_index(tok.strip(), header_names))
    drop = {label_col} | ignore_cols | ({weight_col} - {-1}) \
        | ({group_col} - {-1})

    def resolve_cols(width):
        """The feature columns, names and categorical indices at the
        parsed width (a LibSVM or ragged file can pass the head's)."""
        cols = [c for c in range(width) if c not in drop]
        names = ([header_names[c] for c in cols]
                 if header_names and width <= len(header_names) else None)
        cats: List[int] = []
        for tok in str(config.categorical_feature or "").split(","):
            tok = tok.strip()
            if tok:
                orig = _column_index(tok, header_names)
                if orig in cols:
                    cats.append(cols.index(orig))
        return cols, names, cats

    feat_cols, feat_names, cat_idx = resolve_cols(ncol)
    if fmt != "libsvm" and config.two_round:
        ds, qids = _load_two_round(filename, sep, skip_rows, config,
                                   label_col, weight_col, group_col,
                                   reference, ncol, resolve_cols)
    else:
        if fmt == "libsvm":
            mat = None
            if skip_rows == 0:
                with open_file(filename, "rb") as fh:
                    mat = _libsvm_native(fh.read())
            if mat is None:
                with open_file(filename) as fh:
                    mat = _parse_libsvm(fh.readlines()[skip_rows:])
        else:
            mat = _read_dense_matrix(filename, sep, skip_rows)
        if mat.shape[1] != ncol:
            feat_cols, feat_names, cat_idx = resolve_cols(mat.shape[1])
        t_read = time.perf_counter() - t0
        qids = mat[:, group_col] if group_col >= 0 else None
        t1 = time.perf_counter()
        ds = TorchDataset.from_numpy(
            mat[:, feat_cols], label=mat[:, label_col], config=config,
            weights=mat[:, weight_col] if weight_col >= 0 else None,
            categorical_features=cat_idx, feature_names=feat_names,
            reference=reference)
        log_info(f"load: read={t_read:.2f}s "
                 f"bin={time.perf_counter() - t1:.2f}s")
    if qids is not None:
        ds.metadata.set_query_from_ids(qids)
    qfile = filename + ".query"
    if qids is None and os.path.exists(qfile):
        ds.metadata.set_query(np.loadtxt(qfile, dtype=np.int64, ndmin=1))
    wfile = filename + ".weight"
    if ds.metadata.weights is None and os.path.exists(wfile):
        ds.metadata.set_weights(np.loadtxt(wfile, ndmin=1))
    ifile = filename + ".init"
    if os.path.exists(ifile):
        ds.metadata.set_init_score(np.loadtxt(ifile, ndmin=1).ravel())
    return ds


def _load_two_round(filename: str, sep: str, skip_rows: int, config: Config,
                    label_col: int, weight_col: int, group_col: int,
                    reference, ncol: int, resolve_cols) -> Tuple:
    """Two passes in low memory (two_round; dataset_loader.cpp:741-840,
    the JAX package's _load_two_round): the first keeps a uniform
    reservoir sample of the rows for the bin bounds, and the label,
    weight and query columns; the second bins each block into the
    preallocated bin matrix.  Peak memory: the bins, one block and the
    sample.  Returns (dataset, query ids or None)."""
    from .dataset import TorchDataset

    t0 = time.perf_counter()
    feat_cols, feat_names, cat_idx = resolve_cols(ncol)
    rng = np.random.RandomState(config.data_random_seed)
    S_target = int(config.bin_construct_sample_cnt)
    sample_rows: List[np.ndarray] = []
    sample: Optional[np.ndarray] = None
    labels, weights, qids = [], [], []
    n_seen = 0
    for chunk in _iter_dense_chunks(filename, sep, skip_rows):
        k = chunk.shape[0]
        if n_seen == 0 and chunk.shape[1] != ncol:
            feat_cols, feat_names, cat_idx = resolve_cols(chunk.shape[1])
        labels.append(np.ascontiguousarray(chunk[:, label_col]))
        if weight_col >= 0:
            weights.append(np.ascontiguousarray(chunk[:, weight_col]))
        if group_col >= 0:
            qids.append(np.ascontiguousarray(chunk[:, group_col]))
        if reference is None:
            feats = chunk[:, feat_cols]
            take = max(0, min(S_target - n_seen, k))
            if take:
                sample_rows.append(feats[:take].copy())
            if take < k:
                if sample is None:
                    sample = np.vstack(sample_rows)
                    sample_rows = []
                # row i replaces a random slot with probability S / (i + 1)
                gi = n_seen + np.arange(take, k)
                slots = (rng.random_sample(len(gi))
                         * (gi + 1)).astype(np.int64)
                hit = slots < S_target
                for r, s in zip(np.nonzero(hit)[0], slots[hit]):
                    sample[s] = feats[take + r]
        n_seen += k
    if reference is None and sample is None:
        sample = (np.vstack(sample_rows) if sample_rows
                  else np.zeros((0, len(feat_cols))))
    t_pass1 = time.perf_counter() - t0

    ds = TorchDataset._new((n_seen, len(feat_cols)), feat_names, reference)
    if reference is None:
        S = sample.shape[0]
        ds._fit_bin_mappers(config, set(int(c) for c in cat_idx),
                            lambda f: np.ascontiguousarray(sample[:, f]), S)
        ds._set_feature_settings(config)
        mappers = [ds.bin_mappers[f] for f in ds.used_feature_indices]
        ds._build_bundle(config, S, lambda j: (
            mappers[j].value_to_bin(sample[:, ds.used_feature_indices[j]])
            != mappers[j].default_bin))
    t_bin = time.perf_counter() - t0 - t_pass1
    out = np.empty((ds.num_columns, n_seen), dtype=ds._bins_dtype())
    off = 0
    for chunk in _iter_dense_chunks(filename, sep, skip_rows):
        k = chunk.shape[0]
        out[:, off:off + k] = ds._bin_matrix(
            np.ascontiguousarray(chunk[:, feat_cols]))
        off += k
    check(off == n_seen, "the data file changed between the two passes")
    ds.bins_t = out
    log_info(f"two-round load: sample_pass={t_pass1:.2f}s bin={t_bin:.2f}s "
             f"quantize_pass={time.perf_counter() - t0 - t_pass1 - t_bin:.2f}"
             f"s rows={n_seen}")
    ds._set_metadata(np.concatenate(labels) if labels else np.zeros(0),
                     np.concatenate(weights) if weights else None, None,
                     None)
    return ds, (np.concatenate(qids) if qids else None)


def _is_binary(filename: str, magic: bytes) -> bool:
    with open_file(filename, "rb") as fh:
        return fh.read(len(magic)) == magic


def parse_file_to_matrix(filename: str, has_header: bool,
                         num_features: int, label_column: str = ""):
    """A prediction file -> (X [N, num_features], label or None), as the
    JAX package's parse_file_to_matrix reads it (the CLI's predict
    pipeline, reference src/application/predictor.hpp:69-110): the
    format detected, the label column (0 unless ``label_column`` names
    another) dropped, the width aligned to the model's features.  A dense
    file exactly ``num_features`` wide has no label; LibSVM always has
    one."""
    head = _read_head(filename)
    header_names = None
    skip_rows = 0
    if has_header and head:
        sep = "\t" if "\t" in head[0] else ","
        header_names = head[0].strip().split(sep)
        head = head[1:]
        skip_rows = 1
    fmt = _detect_format(head[:32])
    if fmt == "libsvm":
        mat = None
        if skip_rows == 0:
            with open_file(filename, "rb") as fh:
                mat = _libsvm_native(fh.read())
        if mat is None:
            with open_file(filename) as fh:
                mat = _parse_libsvm(fh.readlines()[skip_rows:])
        label_col = 0
    else:
        mat = _read_dense_matrix(filename, "\t" if fmt == "tsv" else ",",
                                 skip_rows)
        if mat.shape[1] == num_features:
            return mat, None
        label_col = (_column_index(label_column, header_names)
                     if label_column else 0)
    label = mat[:, label_col]
    X = np.delete(mat, label_col, axis=1)
    if X.shape[1] < num_features:
        X = np.pad(X, ((0, 0), (0, num_features - X.shape[1])))
    elif X.shape[1] > num_features:
        X = X[:, :num_features]
    return X, label

