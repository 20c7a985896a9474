"""P1's stack as the kernel reads it, on the CPU: node records.

``TreeStack`` folds each node of its trees with the feature tables of
the bins it will route (column, EFB offset, num_bin, default bin) into one
16-byte record, cut into chunks that a block stages in shared memory
(ops/predict.py ``pack_route_records``).  These tests decode the buffer
by csrc/predict.cu's layout (``decode_route_records``) back to
``stack_trees_host``'s fields and the tables, walk the decoded records
as csrc/predict.cu walks them (each
tree's own number of steps, a 4-bit packed column's nibble, a bin
outside its feature's range under EFB or the -1 sentinel of i16 bins
going the record's one way) and hold the leaves to the plain route's
(``route_leaves_plain``), bit for bit; check that a value a
record cannot hold raises; and that ``route_plan`` picks the tiled or
the direct mode from the shapes alone.  Cases: u8, i16 with the -1
sentinel, 4-bit packed columns, EFB tables, categorical nodes,
single-leaf trees, 255-leaf trees, a chain deeper than a stage's trees,
a tree larger than a stage, and C = 5 with interleaved classes.  The
trees are random (numpy, seeded), so no grower is compiled.
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.models.device_predict import (TreeStack,
                                                      stack_trees_host,
                                                      tree_depth)
from lightgbm_tpu_torch.models.tree import Tree
from lightgbm_tpu_torch.ops import predict as tp
from lightgbm_tpu_torch.ops.histogram import pack_bins_4bit


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this module's tests: the CPU tests
    share the cores with other pytest workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N = 1500


def _random_tree(rng, leaves, num_bin, cat_features=(), chain=False):
    """A tree of ``leaves`` leaves in LightGBM's numbering (split i turns
    a leaf into node i, the leaf on its left and leaf i + 1 on its right):
    random features, thresholds inside each feature's bins, random missing
    types and default directions, categorical bitsets on
    ``cat_features``; ``chain``: each split takes the newest leaf."""
    t = Tree(leaves)
    t.leaf_value = rng.normal(size=max(leaves, 1))
    hang = {0: (-1, 0)}
    for i in range(leaves - 1):
        leaf = i if chain else int(rng.randint(0, i + 1))
        parent, side = hang[leaf]
        if parent >= 0:
            (t.left_child if side == 0 else t.right_child)[parent] = i
        t.left_child[i] = ~leaf
        t.right_child[i] = ~(i + 1)
        hang[leaf], hang[i + 1] = (i, 0), (i, 1)
        f = int(rng.randint(0, len(num_bin)))
        t.split_feature_inner[i] = f
        if f in cat_features:
            t.decision_type[i] = 1
            t.threshold_in_bin[i] = len(t.cat_threshold_inner)
            words = rng.randint(0, 2**32, size=int(rng.randint(1, 9)),
                                dtype=np.uint64).astype(np.uint32)
            t.cat_threshold_inner.append(words)
        else:
            t.decision_type[i] = (int(rng.randint(0, 3)) << 2) | (
                2 * int(rng.randint(0, 2)))
            t.threshold_in_bin[i] = int(rng.randint(0, num_bin[f]))
    return t


def _case(name, seed=0):
    """(trees, classes, bins [P, S] tensor, tables, packed4, C) of a case;
    S > N (rows past N are never routed)."""
    rng = np.random.RandomState(seed)
    F, C, packed4 = 12, 1, False
    num_bin = rng.randint(2, 64, size=F)
    cat = ()
    group = offset = None
    leaves = [15, 1, 31, 7]
    chain = False
    if name in ("categorical", "i16"):
        cat = (3, 7)
        num_bin[list(cat)] = 40
    if name == "leaves_255":
        leaves = [255, 255, 2, 255]
    if name == "chain":
        leaves, chain = [200, 3], True
    if name == "over_a_stage":
        leaves = [3, 1200, 5]
    if name == "c5":
        C, leaves = 5, [7, 31, 1, 15, 9] * 3
    if name == "packed4":
        num_bin = rng.randint(2, 17, size=F)
        packed4 = True
    trees = [_random_tree(rng, L, num_bin, cat, chain) for L in leaves]
    default_bin = np.array([int(rng.randint(0, b)) for b in num_bin])
    if name == "efb":
        # features 4.. share columns 4 and 5 at offsets, 0-3 own theirs
        group = np.array([0, 1, 2, 3] + [4 + (j % 2) for j in range(F - 4)])
        offset = np.zeros(F, dtype=np.int64)
        for g in (4, 5):
            at = 1
            for j in np.nonzero(group == g)[0]:
                offset[j], at = at, at + num_bin[j]
        col_bins = [num_bin[j] for j in range(4)] + [
            int(offset[group == g].max() + num_bin[group == g].max())
            for g in (4, 5)]
    else:
        col_bins = list(num_bin)
    S = N + 37
    bins = np.stack([rng.randint(0, b, size=S) for b in col_bins])
    if name == "i16":
        bins = bins.astype(np.int16)
        bins[:, rng.rand(S) < 0.1] = -1
    else:
        bins = bins.astype(np.uint8)
    if packed4:
        bins = pack_bins_4bit(bins)
    tables = tp.route_tables(num_bin, default_bin, group, offset)
    classes = [i % C for i in range(len(trees))]
    return trees, classes, torch.from_numpy(bins), tables, packed4, C


def decode_route_records(buf: np.ndarray, layout, classes,
                         num_leaves) -> list:
    """The trees of a packed stack (``pack_route_records``' buffer of the
    trees of ``classes`` and ``num_leaves``), in their original order: a
    dict each of the record fields [n] (``column``, ``flags`` (0 in an
    8-byte record), ``feat_offset``, ``span`` (0 and NO_BIN in an 8-byte
    record), ``threshold`` (a categorical node's bitset index), ``miss``
    (NO_BIN where the missing bin goes the threshold's way),
    ``left_child``, ``right_child``), ``cat_bitset`` [n, 8] uint32
    (zero at numerical nodes), ``leaf_value`` [num_leaves], ``steps``,
    its ``kind`` (KIND_*), ``cls`` and whether its chunk is ``staged``."""
    buf = np.asarray(buf, dtype=np.int32)
    order = np.argsort(np.asarray(classes, dtype=np.int64), kind="stable")
    chunks = buf[:layout.trees].reshape(-1, tp.CHUNK_WORDS)[
        :layout.num_chunks]
    trees = buf[layout.trees:layout.trees + len(order) * tp.TREE_WORDS
                ].reshape(-1, tp.TREE_WORDS)
    data = buf[layout.data:]
    out = [None] * len(order)
    for ch in chunks:
        base = 4 * int(ch[0])
        lo, hi = int(ch[2]), int(ch[3])
        for i in range(lo, hi):
            node8, leaf8, steps, bit16 = (int(v) for v in trees[i])
            kind, steps = steps >> 16, steps & 0xFFFF
            L = int(num_leaves[order[i]])
            n = max(L - 1, 0)
            if kind == tp.KIND_COMPACT:
                r8 = data[base + 2 * node8:base + 2 * (node8 + n)].view(
                    np.uint32).reshape(n, 2).astype(np.int64)
                hm = (r8[:, 0] >> 15) & 1
                # as the 16-byte fields: offset 0, span NO_BIN
                r = np.stack([r8[:, 0] & 0x7FFF,
                              np.full(n, tp.NO_BIN << 16),
                              ((r8[:, 0] >> 16) & 0xFF)
                              | (np.where(hm > 0, r8[:, 0] >> 24,
                                          tp.NO_BIN) << 16),
                              r8[:, 1]], axis=1)
            else:
                r = data[base + 2 * node8:base + 2 * node8 + 4 * n].view(
                    np.uint32).reshape(n, 4).astype(np.int64)
            flags = r[:, 0] >> 24
            is_cat = (flags & tp.FLAG_CAT) > 0
            thr = r[:, 2] & 0xFFFF
            bits = np.zeros((n, tp.CAT_WORDS), dtype=np.uint32)
            at = base + 4 * bit16
            bits[is_cat] = data[at:at + tp.CAT_WORDS * int(is_cat.sum())
                                ].view(np.uint32).reshape(
                                    -1, tp.CAT_WORDS)[thr[is_cat]]
            out[order[i]] = dict(
                column=r[:, 0] & 0xFFFFFF, flags=flags,
                feat_offset=r[:, 1] & 0xFFFF, span=r[:, 1] >> 16,
                threshold=thr, miss=r[:, 2] >> 16,
                left_child=(r[:, 3] & 0xFFFF).astype(np.uint16).view(
                    np.int16).astype(np.int64),
                right_child=(r[:, 3] >> 16).astype(np.uint16).view(
                    np.int16).astype(np.int64),
                cat_bitset=bits,
                leaf_value=data[base + 2 * leaf8:base + 2 * (leaf8 + L)]
                .view(np.float64),
                steps=steps, kind=kind, cls=int(ch[4]),
                staged=bool(ch[5]))
    return out


CASES = ["u8", "i16", "packed4", "efb", "categorical", "leaves_255",
         "chain", "over_a_stage", "c5"]


def _walk(bins, dec, n, packed4):
    """csrc/predict.cu's walk over one tree's decoded records (its own
    steps, the step's arithmetic): the leaf of each of the first n
    rows."""
    rows = np.arange(n)
    node = np.full(n, 0 if dec["steps"] > 0 else -1, dtype=np.int64)
    b = bins.numpy().astype(np.int64)
    for _ in range(dec["steps"]):
        safe = np.maximum(node, 0)
        col = dec["column"][safe]
        if packed4:
            byte = b[col >> 1, rows]
            fv = np.where(col & 1, byte >> 4, byte & 15)
        else:
            fv = b[col, rows]
        flags = dec["flags"][safe]
        x = fv - dec["feat_offset"][safe]
        thr = dec["threshold"][safe]
        inside = (x >= 0) & (x < dec["span"][safe])
        word = dec["cat_bitset"][safe, np.clip(x >> 5, 0, 7)]
        cat_left = ((word.astype(np.int64) >> (x & 31)) & 1) > 0
        num_left = (x <= thr) != (x == dec["miss"][safe])
        left = np.where(inside, np.where(flags & tp.FLAG_CAT, cat_left,
                                         num_left),
                        (flags & tp.FLAG_LEFT_OUTSIDE) > 0)
        if dec["kind"] != tp.KIND_BUNDLED:
            # owned columns: the bin as it is, a negative one right at a
            # categorical node
            left = np.where(flags & tp.FLAG_CAT, cat_left & (fv >= 0),
                            (fv <= thr) != (fv == dec["miss"][safe]))
        nxt = np.where(left, dec["left_child"][safe], dec["right_child"][safe])
        node = np.where(node >= 0, nxt, node)
    return np.where(node < 0, ~node, 0)


@pytest.mark.parametrize("name", CASES)
def test_records_decode_to_the_stack_and_route_as_the_plain_version(name):
    """The records decode back to stack_trees_host's fields (each split's
    feature through the tables), the leaf values, each tree's depth and
    class; walking them gives the plain route's leaves, bit for bit; one
    buffer is the stack's only device form until the plain version asks
    for its tensors."""
    trees, classes, bins, tables, packed4, C = _case(name)
    F = tables.num_bin.shape[0]
    stack = TreeStack(trees, classes, F, torch.device("cpu"), tables)
    buf, layout = stack.records(F)
    assert buf.dtype == torch.int32 and buf.dim() == 1
    assert not any(k in vars(stack) for k in ("split_feature", "leaf_value"))
    sf, tb, dt, lc, rc, cb, lv, nl, _ = stack_trees_host(trees, F)
    dec = decode_route_records(buf.numpy(), layout, classes, nl)
    for t, tree in enumerate(trees):
        d, n = dec[t], max(int(nl[t]) - 1, 0)
        f = sf[t, :n]
        assert d["cls"] == classes[t]
        assert d["steps"] == (tree_depth(tree) if n else 0)
        nb, db = tables.num_bin[f], tables.default_bin[f]
        off = tables.feat_offset[f]
        mt = (dt[t, :n] >> 2) & 3
        num = (dt[t, :n] & 1) == 0
        np.testing.assert_array_equal(d["column"], tables.feat_group[f])
        np.testing.assert_array_equal(d["feat_offset"], off)
        np.testing.assert_array_equal(d["span"],
                                      np.where(off == 0, tp.NO_BIN, nb))
        miss = np.where(mt == 1, db, np.where(mt == 2, nb - 1, tp.NO_BIN))
        dl = (dt[t, :n] & 2) > 0
        np.testing.assert_array_equal(
            d["miss"], np.where(dl == (miss <= tb[t, :n]), tp.NO_BIN, miss))
        if d["kind"] != tp.KIND_COMPACT:
            np.testing.assert_array_equal(d["flags"] & tp.FLAG_CAT,
                                          dt[t, :n] & 1)
        np.testing.assert_array_equal(d["threshold"][num], tb[t, :n][num])
        np.testing.assert_array_equal(d["left_child"], lc[t, :n])
        np.testing.assert_array_equal(d["right_child"], rc[t, :n])
        np.testing.assert_array_equal(d["cat_bitset"][~num], cb[t, :n][~num])
        assert d["kind"] == (tp.KIND_BUNDLED if (off != 0).any() else
                             tp.KIND_CATEGORICAL if (~num).any() else
                             tp.KIND_COMPACT)
        np.testing.assert_array_equal(d["leaf_value"], lv[t, :nl[t]])
        want = tp.route_leaves_plain(
            bins, stack, t, torch.from_numpy(tables.num_bin).int(),
            torch.from_numpy(tables.default_bin).int(), N,
            torch.from_numpy(tables.feat_group).int(),
            torch.from_numpy(tables.feat_offset).int(), packed4).numpy()
        np.testing.assert_array_equal(_walk(bins, d, N, packed4), want)
    if name == "over_a_stage":
        assert not dec[1]["staged"] and dec[0]["staged"] and dec[2]["staged"]
    else:
        assert all(d["staged"] for d in dec)
    if name == "i16":
        assert bool((bins[:, :N] == -1).any())
    kinds = {d["kind"] for d in dec}
    if name in ("u8", "i16", "categorical", "efb"):
        assert kinds == {"u8": {tp.KIND_COMPACT},
                         "i16": {tp.KIND_COMPACT, tp.KIND_CATEGORICAL},
                         "categorical": {tp.KIND_COMPACT,
                                         tp.KIND_CATEGORICAL},
                         "efb": {tp.KIND_COMPACT, tp.KIND_BUNDLED}}[name]
    kinds = {d["kind"] for d in dec}
    if name in ("u8", "i16", "categorical", "efb"):
        assert kinds == {"u8": {tp.KIND_COMPACT},
                         "i16": {tp.KIND_COMPACT, tp.KIND_CATEGORICAL},
                         "categorical": {tp.KIND_COMPACT,
                                         tp.KIND_CATEGORICAL},
                         "efb": {tp.KIND_COMPACT, tp.KIND_BUNDLED}}[name]
    if name == "c5":
        # a class's trees, in tree order, are one run of chunks
        assert [d["cls"] for d in dec] == classes


def test_tree_stack_without_tables_cannot_route_on_the_card():
    trees, classes, _, tables, _, _ = _case("u8")
    stack = TreeStack(trees, classes, 12, torch.device("cpu"))
    with pytest.raises(ValueError, match="feature tables"):
        stack.records(12)
    stack = TreeStack(trees, classes, 12, torch.device("cpu"), tables)
    with pytest.raises(ValueError, match="cover 12 features"):
        stack.records(13)


@pytest.mark.parametrize("field", ["column", "num_bin", "default_bin",
                                   "threshold", "child", "feature"])
def test_a_value_the_record_cannot_hold_raises(field):
    """A column past 2^24 - 1 (a 16-bit column would not do: the sparse
    gate's columns pass 65,535), table values or a threshold past 65,535,
    a child outside int16 and a feature past the tables raise."""
    rng = np.random.RandomState(1)
    F = 4
    num_bin = np.full(F, 10)
    tree = _random_tree(rng, 5, num_bin)
    group = np.arange(F)
    if field == "column":
        # past 2^15 a numerical tree takes the 16-byte records
        group = group + 70_000
        buf, layout = tp.pack_route_records(
            *_arrays([tree], F),
            tp.route_tables(num_bin, num_bin // 2, group, np.zeros(F)))
        dec = decode_route_records(buf, layout, [0], [tree.num_leaves])
        assert dec[0]["kind"] == tp.KIND_CATEGORICAL
        np.testing.assert_array_equal(
            dec[0]["column"], group[tree.split_feature_inner[:4]])
        group[:] = 1 << 24
    tables = tp.route_tables(num_bin, num_bin // 2, group, np.zeros(F))
    arrays = list(_arrays([tree], F))
    if field == "num_bin":
        tables.num_bin[:] = 1 << 16
    if field == "default_bin":
        tables.default_bin[:] = 1 << 16
    if field == "threshold":
        arrays[1][0, 0] = 1 << 16
    if field == "child":
        arrays[3][0, 0] = 1 << 15
    if field == "feature":
        arrays[0][0, 0] = F
    with pytest.raises(ValueError, match="cannot hold|the tables have"):
        tp.pack_route_records(*arrays, tables)


def _arrays(trees, F):
    stack = TreeStack(trees, [0] * len(trees), F, torch.device("cpu"))
    h = stack._host
    return (h["split_feature"], h["threshold_bin"], h["decision_type"],
            h["left_child"], h["right_child"], h["cat_bitset"],
            h["leaf_value"], h["num_leaves"], stack._depths, stack.classes)


@pytest.mark.parametrize("rows,bytes_,want", [
    (28, 1, (1024, True)),       # HIGGS, multiclass_cat
    (14, 1, (1024, True)),       # HIGGS at max_bin 15, packed
    (28, 2, (1024, False)),      # i16 predict-time bins: read in place
    (18, 1, (1024, True)),       # Expo's EFB columns
    (136, 1, (512, True)),       # lambdarank
    (600, 1, (128, True)),
    (6500, 1, (1024, False)),    # the 100k-feature sparse gate's columns
    (800, 2, (1024, False)),
])
def test_route_plan_follows_the_shapes(rows, bytes_, want):
    assert tp.route_plan(rows, bytes_) == want
    got_rows, tiled = want
    if tiled:
        assert rows * (got_rows + tp.TILE_PAD) <= tp.TILE_BUDGET
