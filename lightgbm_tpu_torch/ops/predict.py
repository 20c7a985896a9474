"""Ensemble routing over binned rows: kernel P1 ``route_trees`` and its
plain version.

Counterpart of the JAX package's stacked-tree route
(lightgbm_tpu/models/device_predict.py ``_tree_leaves`` :99-149, which
XLA computes as gathers; there is no Pallas kernel behind it).  P1 is in
``csrc/predict.cu``.  Given a column-major bin matrix ``[G, S]`` (u8
device bins of a training or valid set, EFB-bundled or not, or i16
predict-time bins, one column a feature, that carry the -1 sentinel of
an unseen category), a stack of trees (models/device_predict.py
``TreeStack``), per-feature ``num_bin``, ``default_bin`` and EFB tables
``feat_group`` / ``feat_offset`` (feature f's bins are in column
``feat_group[f]`` at ``feat_offset[f] + bin``; a feature of offset 0 owns
its column) and an ``[C, n]`` float64 ``out`` (n <= S) holding each
class's starting values, it adds, per row and in tree order, each tree's
leaf value into the row of the tree's class (``TreeStack.tree_class``),
in place.  The additions are the host walk's, in its order, so the
result has the host walk's bits.

A dataset with a column of more than 256 bins holds two-byte bins
(``wide``): its device bins and its model's predict-time bins are int16
tensors of the uint16 bits (core/dataset.py device_bins), which P1 reads
unsigned in its u16 mode and the plain version widens (``widen_bins``); a
predict-time sentinel -1 reads as 0xFFFF there.  A categorical node sends
a bin of 256 or more right (no bitset holds one: the host walk's
FindInBitset), so the sentinel routes as it does in i16.

The training set's u8 bins may be 4-bit packed (``packed4``: two columns
a byte, ops/histogram.py pack_bins_4bit, the layout of a dataset whose bin
axis is at most 16): feature f is then the nibble of column
``feat_group[f]`` in byte row ``feat_group[f] >> 1``, before
``feat_offset`` applies.

The kernel reads the stack as one buffer of 16-byte node records
(``pack_route_records``: each node's column, the feature's tables, its
threshold, decision type and children folded into one record), cut into
chunks that a block stages in shared memory, and, where a block's tile of
bin rows fits (``route_plan``, from the shapes alone), the bins from a
tile in shared memory.

A CPU ``out`` goes to the plain version (the JAX route's gather loop in
torch); a CUDA one to the kernel, or the wrapper raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from .histogram import unpack_nibble, widen_bins

MISSING_ZERO = 1
MISSING_NAN = 2
CAT_WORDS = 8
# csrc/predict.cu's constants (the C entry checks they agree): a stage of
# the stack in shared memory, the most shared memory a block's bin tile
# takes, a tile row's padding and the rows a thread walks
STAGE_BYTES = 12288
TILE_BUDGET = 96 * 1024
TILE_PAD = 16
ROWS_PER_THREAD = 4
# the rows a block takes, most first (blockDim = rows / ROWS_PER_THREAD)
BLOCK_ROWS = (1024, 512, 256, 128)
RECORD_WORDS = 4
CHUNK_WORDS = 8
TREE_WORDS = 4
# a tree's kind, the least record and step its nodes need
# (csrc/predict.cu): 8-byte records, every node numerical on a column its
# feature owns (columns below COMPACT_COLUMNS, at most 256 bins);
# categorical nodes too (or larger columns or bins); a feature that
# shares its column (EFB)
KIND_COMPACT, KIND_CATEGORICAL, KIND_BUNDLED = 0, 1, 2
COMPACT_COLUMNS = 1 << 15
# a record's flags: a categorical node, and where a bin outside the
# feature's range goes (csrc/predict.cu kFlag*); a node's default
# direction is in its missing bin (pack_route_records)
FLAG_CAT = 1
FLAG_LEFT_OUTSIDE = 4
# what a record's fields hold: a 24-bit column, a 16-bit offset, span,
# threshold (or bitset index) and missing bin, int16 children; NO_BIN is
# the span of a feature that owns its column (every bin >= 0 in range)
# and the missing bin of a node without one
_COLUMN_MAX = (1 << 24) - 1
_FIELD_MAX = (1 << 16) - 1
NO_BIN = _FIELD_MAX
_CHILD_MIN, _CHILD_MAX = -(1 << 15), (1 << 15) - 1


class RouteTables(NamedTuple):
    """Per-feature tables on the host, int64 [F]: what a node record
    folds in.  ``feat_group`` / ``feat_offset``: the feature's bin column
    and bin offset (identity tables for one column a feature)."""
    num_bin: np.ndarray
    default_bin: np.ndarray
    feat_group: np.ndarray
    feat_offset: np.ndarray


def route_tables(num_bin, default_bin, feat_group=None,
                 feat_offset=None) -> RouteTables:
    """RouteTables of the given arrays or tensors (None: one column a
    feature, offset 0)."""
    def host(x):
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()
        return np.asarray(x, dtype=np.int64)

    nb = host(num_bin)
    F = nb.shape[0]
    return RouteTables(
        nb, host(default_bin),
        np.arange(F, dtype=np.int64) if feat_group is None
        else host(feat_group),
        np.zeros(F, dtype=np.int64) if feat_offset is None
        else host(feat_offset))


class RecordLayout(NamedTuple):
    """A packed stack's buffer: its chunk count, and where its tree table
    and its data start (int32 words; the chunk table starts it)."""
    num_chunks: int
    trees: int
    data: int


def _check_field(name: str, v: np.ndarray, lo: int, hi: int) -> None:
    if v.size and (int(v.min()) < lo or int(v.max()) > hi):
        raise ValueError(f"a node record cannot hold {name} outside "
                         f"[{lo}, {hi}] (got {int(v.min())}..{int(v.max())})")


def pack_route_records(split_feature: np.ndarray,
                       threshold_bin: np.ndarray,
                       decision_type: np.ndarray, left_child: np.ndarray,
                       right_child: np.ndarray, cat_bitset: np.ndarray,
                       leaf_value: np.ndarray, num_leaves: np.ndarray,
                       depths: np.ndarray, classes: np.ndarray,
                       tables: RouteTables):
    """The stack as P1 reads it: ``(buffer int32 [W], RecordLayout)``
    from ``stack_trees_host``'s [T, M] arrays, each tree's depth (0 for a
    single leaf), each tree's class and the feature tables.

    A node's record folds in what the plain route reads for it: x = the
    column's bin - the feature's offset; x in [0, span) (span = num_bin
    under EFB, NO_BIN for a feature that owns its column) is the
    feature's bin: a categorical node looks x up in its bitset, a
    numerical one sends x left when x <= threshold, flipped at the
    missing bin (the default bin under missing-zero, the last bin under
    missing-NaN), which the record holds only where its default way
    differs from the threshold's (else NO_BIN); any other x goes where the
    plain route sends it, which is one way for the node (FLAG_LEFT_OUTSIDE):
    under EFB the default bin's way, else that of a negative bin (the i16
    sentinel: right at a categorical node, left at a numerical one).

    Trees are grouped by class (tree order within a class) and cut into
    chunks of at most STAGE_BYTES (records, leaf values, bitsets), a
    chunk of one class; a tree larger than that is a
    chunk of its own, read in place.  A tree whose nodes are all
    numerical on owned columns (below COMPACT_COLUMNS, at most 256 bins)
    takes 8-byte records (KIND_COMPACT: column | has a missing bin << 15
    | threshold << 16 | missing bin << 24, then the children).  Raises
    ValueError on a value a record cannot hold (a column
    past 2^24 - 1; an offset, num_bin, threshold, missing bin or
    categorical node count a tree past 65534; a child outside int16)."""
    T, M = split_feature.shape
    nl = np.asarray(num_leaves, dtype=np.int64)
    nodes = np.maximum(nl - 1, 0)
    valid = np.arange(M)[None, :] < nodes[:, None]
    f = split_feature.astype(np.int64)
    if valid.any():
        top = int(f[valid].max())
        if top >= tables.num_bin.shape[0]:
            raise ValueError(f"a tree splits on feature {top} but the "
                             f"tables have {tables.num_bin.shape[0]}")
    f = np.where(valid, f, 0)
    col = tables.feat_group[f]
    off = tables.feat_offset[f]
    nb = tables.num_bin[f]
    db = tables.default_bin[f]
    dt = decision_type.astype(np.int64)
    is_cat = valid & (dt & 1 > 0)
    dl = (dt & 2) > 0
    mt = (dt >> 2) & 3
    cat_idx = np.cumsum(is_cat, axis=1) - 1
    tb = threshold_bin.astype(np.int64)
    thr = np.where(is_cat, cat_idx, tb)
    miss = np.where(mt == MISSING_ZERO, db,
                    np.where(mt == MISSING_NAN, nb - 1, NO_BIN))
    # a missing bin that goes where the threshold sends it anyway needs
    # no test: the kernel flips the threshold test at the recorded one
    miss = np.where(dl == (miss <= tb), NO_BIN, miss)
    own = off == 0
    span = np.where(own, NO_BIN, nb)
    cat_words = cat_bitset.reshape(T, M, CAT_WORDS).astype(np.int64)
    dw = np.take_along_axis(cat_words, np.minimum(db >> 5, CAT_WORDS - 1)[
        ..., None], axis=2)[..., 0]
    outside = np.where(is_cat, ~own & (((dw >> (db & 31)) & 1) > 0),
                       own | np.where(db == miss, dl, db <= tb))
    flags = is_cat * FLAG_CAT + outside * FLAG_LEFT_OUTSIDE
    lc = left_child.astype(np.int64)
    rc = right_child.astype(np.int64)
    for name, v, lo, hi in (("a column", col, 0, _COLUMN_MAX),
                            ("a feature offset", off, 0, _FIELD_MAX - 1),
                            ("num_bin", nb, 0, _FIELD_MAX - 1),
                            ("a default bin", db, 0, _FIELD_MAX - 1),
                            ("a threshold bin or bitset index", thr, 0,
                             _FIELD_MAX - 1),
                            ("a child", lc, _CHILD_MIN, _CHILD_MAX),
                            ("a child", rc, _CHILD_MIN, _CHILD_MAX)):
        _check_field(name, v[valid], lo, hi)
    kids = (lc & 0xFFFF) | ((rc & 0xFFFF) << 16)
    rec = np.stack([col | (flags << 24), off | (span << 16),
                    thr | (miss << 16), kids], axis=-1)
    rec = rec.astype(np.uint32).view(np.int32)            # [T, M, 4]
    has_miss = miss != NO_BIN
    rec8 = np.stack([col | (has_miss << 15) | ((tb & 0xFF) << 16)
                     | ((miss & 0xFF) << 24), kids], axis=-1)
    rec8 = rec8.astype(np.uint32).view(np.int32)          # [T, M, 2]
    # each tree's kind (csrc/predict.cu): the least record and step its
    # nodes need
    compact = ~(valid & (is_cat | ~own | (col >= COMPACT_COLUMNS)
                         | (nb > 256))).any(axis=1)
    kind = np.where((valid & ~own).any(axis=1), KIND_BUNDLED,
                    np.where(compact, KIND_COMPACT, KIND_CATEGORICAL))
    _check_field("a depth", np.asarray(depths), 0, _FIELD_MAX)
    bitsets = cat_bitset.reshape(T, M, CAT_WORDS).astype(np.uint32).view(
        np.int32)
    classes = np.asarray(classes, dtype=np.int64)
    order = np.argsort(classes, kind="stable")
    n_cat = is_cat.sum(axis=1)
    rec_words = np.where(kind == KIND_COMPACT, 2, 4)
    # (a 16-byte tree may need an 8-byte pad before its records)
    tree_bytes = 4 * rec_words * nodes + 8 * nl + 32 * n_cat + 8

    chunk_trees, cur, used = [], [], 0
    for t in order:
        size = int(tree_bytes[t])
        if cur and (classes[cur[0]] != classes[t]
                    or used + size + 8 > STAGE_BYTES):
            chunk_trees.append(cur)
            cur, used = [], 0
        cur.append(int(t))
        used += size
    if cur:
        chunk_trees.append(cur)
    chunks = np.zeros((len(chunk_trees), CHUNK_WORDS), dtype=np.int64)
    tree_rows = np.zeros((T, TREE_WORDS), dtype=np.int64)
    data, size16, i = [], 0, 0
    for c, members in enumerate(chunk_trees):
        # records in tree order (a 16-byte tree's at 16 bytes, after an
        # 8-byte pad where needed), leaf values, a pad to 16 bytes, bitsets
        parts, starts, node8 = [], [], 0
        for t in members:
            if kind[t] != KIND_COMPACT and node8 % 2:
                parts.append(np.zeros(2, np.int32))
                node8 += 1
            starts.append(node8)
            parts.append((rec8 if kind[t] == KIND_COMPACT else rec)[
                t, :nodes[t]].reshape(-1))
            node8 += int(rec_words[t] * nodes[t]) // 2
        n_leaf = int(sum(nl[t] for t in members))
        bit16 = (node8 + n_leaf + 1) // 2
        leaf8, i0 = node8, i
        for t, start in zip(members, starts):
            tree_rows[i] = (start, leaf8, depths[t] | (kind[t] << 16),
                            bit16)
            leaf8 += int(nl[t])
            bit16 += 2 * int(n_cat[t])
            i += 1
        parts += [leaf_value[t, :nl[t]].astype(np.float64).view(np.int32)
                  for t in members]
        parts.append(np.zeros(2 * ((node8 + n_leaf) % 2), np.int32))
        parts += [bitsets[t][is_cat[t]].reshape(-1) for t in members]
        words = np.concatenate(parts)
        units = len(words) // 4
        staged = units * 16 <= STAGE_BYTES
        chunks[c] = (size16, units, i0, i, classes[members[0]], int(staged),
                     0, 0)
        data.append(words)
        size16 += units
    data = np.concatenate(data) if data else np.zeros(0, np.int32)
    head = np.concatenate([chunks.reshape(-1), tree_rows.reshape(-1)])
    head = np.concatenate([head, np.zeros(-len(head) % 4, np.int64)])
    _check_field("a stack offset", head, -(1 << 31), (1 << 31) - 1)
    buf = np.concatenate([head.astype(np.int32), data])
    layout = RecordLayout(len(chunk_trees), chunks.size, len(head))
    return buf, layout


def route_plan(byte_rows: int, bin_bytes: int) -> tuple:
    """(rows a block, tiled) for P1 over a [byte_rows, S] bin matrix of
    ``bin_bytes`` bytes an element: u8 bins take the most rows
    (BLOCK_ROWS) whose tile of bin rows fits TILE_BUDGET; wider u8
    matrices and i16 bins (their tile halved the blocks an SM and was
    slower) 1024 rows read from device memory a node at a time.  A
    function of the shapes alone."""
    if bin_bytes == 1:
        for rows in BLOCK_ROWS:
            if byte_rows * (rows + TILE_PAD) <= TILE_BUDGET:
                return rows, True
    return BLOCK_ROWS[0], False


def identity_tables(num_features: int, device) -> tuple:
    """(feat_group, feat_offset) of bins with one column a feature."""
    return (torch.arange(num_features, dtype=torch.int32, device=device),
            torch.zeros(num_features, dtype=torch.int32, device=device))


def route_leaves_plain(bins: torch.Tensor, stack, t: int,
                       num_bin: torch.Tensor, default_bin: torch.Tensor,
                       n: int, feat_group: torch.Tensor = None,
                       feat_offset: torch.Tensor = None,
                       packed4: bool = False,
                       wide: bool = False) -> torch.Tensor:
    """Leaf index of each of the first ``n`` rows under tree ``t`` of
    ``stack``: [n] int64 (the JAX route's ``_tree_leaves``, with its
    ``feat_group`` / ``feat_offset`` reconstruction; None: one column a
    feature; ``packed4``: two columns a byte; ``wide``: int16 bins holding
    uint16 bits).  A categorical node sends a bin of 256 or more right,
    as the host walk does."""
    if feat_group is None:
        feat_group, feat_offset = identity_tables(num_bin.shape[0],
                                                  bins.device)
    sf = stack.split_feature[t].long()
    tb = stack.threshold_bin[t]
    dt = stack.decision_type[t]
    lc = stack.left_child[t]
    rc = stack.right_child[t]
    cb = stack.cat_bitset[t]
    rows = torch.arange(n, device=bins.device)
    start = -1 if int(stack.num_leaves[t]) <= 1 else 0
    node = torch.full((n,), start, dtype=torch.int32, device=bins.device)
    for _ in range(stack.max_depth + 1):
        internal = node >= 0
        safe = node.clamp(min=0).long()
        f = sf[safe]
        col = feat_group[f].long()
        if packed4:
            fv = unpack_nibble(bins[col >> 1, rows], col)
        elif wide:
            fv = widen_bins(bins[col, rows])
        else:
            fv = bins[col, rows].to(torch.int32)
        off = feat_offset[f]
        fv = torch.where((off == 0) | ((fv >= off) & (fv < off + num_bin[f])),
                         fv - off, default_bin[f])
        d = dt[safe]
        is_cat = (d & 1) > 0
        mt = (d >> 2) & 3
        dl = (d & 2) > 0
        is_missing = (((mt == MISSING_ZERO) & (fv == default_bin[f]))
                      | ((mt == MISSING_NAN) & (fv == num_bin[f] - 1)))
        num_left = torch.where(is_missing, dl, fv <= tb[safe])
        # a negative bin (an unseen category) goes right
        word = cb[safe, torch.div(fv, 32, rounding_mode="floor")
                  .clamp(0, CAT_WORDS - 1).long()]
        cat_left = ((((word >> torch.remainder(fv, 32)) & 1) > 0)
                    & (fv >= 0) & (fv < 32 * CAT_WORDS))
        go_left = torch.where(is_cat, cat_left, num_left)
        nxt = torch.where(go_left, lc[safe], rc[safe])
        node = torch.where(internal, nxt, node)
    return (~node).clamp(min=0).long()


def route_trees_plain(bins: torch.Tensor, stack, num_bin: torch.Tensor,
                      default_bin: torch.Tensor, out: torch.Tensor,
                      feat_group: torch.Tensor = None,
                      feat_offset: torch.Tensor = None,
                      packed4: bool = False,
                      wide: bool = False) -> torch.Tensor:
    n = out.shape[1]
    for t in range(stack.num_trees):
        leaf = route_leaves_plain(bins, stack, t, num_bin, default_bin, n,
                                  feat_group, feat_offset, packed4, wide)
        k = int(stack.tree_class[t])
        out[k] += stack.leaf_value[t][leaf]
    return out


def route_trees(bins: torch.Tensor, stack, num_bin: torch.Tensor,
                default_bin: torch.Tensor, out: torch.Tensor,
                feat_group: torch.Tensor = None,
                feat_offset: torch.Tensor = None,
                packed4: bool = False, wide: bool = False) -> torch.Tensor:
    """P1: ``out[tree_class[t]][row] += leaf_value[t][leaf_t(row)]`` for
    every tree t of ``stack`` in order and every row < out.shape[1] of the
    column-major ``bins`` [G, S] (u8 or i16; ``packed4``: u8 [ceil(G /
    2), S], two columns a byte; ``wide``: i16 holding uint16 bits, the
    kernel's u16 mode, launched as ``route_trees_u16``), each feature read
    out of its column by
    the [F] tables ``feat_group`` / ``feat_offset`` (None: one column a
    feature, G = F); ``out`` [C, n] float64, updated in place and
    returned.  On the card the kernel reads the stack's node records
    (``TreeStack.records``), which fold in the tables the stack was built
    with: they must be these tables."""
    if out.device.type == "cpu":
        return route_trees_plain(bins, stack, num_bin, default_bin, out,
                                 feat_group, feat_offset, packed4, wide)
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    dev = out.device
    if bins.dtype not in (torch.uint8, torch.int16) or bins.dim() != 2 \
            or not bins.is_contiguous() or bins.device != dev \
            or (packed4 and bins.dtype != torch.uint8) \
            or (wide and bins.dtype != torch.int16):
        raise ValueError(f"bins must be a contiguous [F, S] uint8 or int16 "
                         f"tensor on {dev} (uint8 when packed4, int16 when "
                         f"wide)")
    C, n = out.shape
    if out.dtype != torch.float64 or not out.is_contiguous() \
            or n > bins.shape[1]:
        raise ValueError(f"out must be a contiguous [C, n] float64 tensor "
                         f"with n <= {bins.shape[1]} rows")
    F = num_bin.shape[0]
    for name, t in (("num_bin", num_bin), ("default_bin", default_bin),
                    ("feat_group", feat_group), ("feat_offset", feat_offset)):
        if t is not None and (t.device != dev or t.dtype != torch.int32
                              or tuple(t.shape) != (F,)):
            raise ValueError(f"{name} must be an int32 tensor of shape "
                             f"({F},) on {dev}")
    T = stack.num_trees
    if T and int(stack.classes.max()) >= C:
        raise ValueError(f"a tree of class {int(stack.classes.max())} "
                         f"for {C} score rows")
    if T == 0 or n == 0:
        return out
    records, layout = stack.records(F)
    if records.device != dev:
        raise ValueError(f"the stack's records are on {records.device}, "
                         f"expected {dev}")
    rows, tiled = route_plan(bins.shape[0], bins.element_size())
    base = records.data_ptr()
    rc = kernels.library().lgbt_route_trees(
        bins.data_ptr(), bins.element_size(), bins.shape[0], bins.shape[1],
        n, base, layout.num_chunks,
        base + 4 * layout.trees, base + 4 * layout.data, rows, int(tiled),
        STAGE_BYTES, TILE_BUDGET, ROWS_PER_THREAD, out.data_ptr(),
        int(packed4), int(wide), kernels.stream_ptr(dev))
    kernels.check_launch(kernels.variant("route_trees", packed4, wide=wide),
                         rc)
    return out
