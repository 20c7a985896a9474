"""The port's file input against the JAX package's, on the CPU.

  * CSV with a header, named label, weight, query and ignored columns and a
    categorical column by name; TSV with ``.weight`` and ``.init`` side
    files; LibSVM with a ``.query`` side file; a valid file binned on the
    training file's bins; ``two_round`` with and without a reference:
    each dataset's bin mappers, bins and metadata = JAX's
    ``load_file_to_dataset``'s, and its model text after three
    iterations JAX's;
  * the native tokenizers and binner (core/native.py) = their Python
    versions (core/parser.py, core/binning.py);
  * ``save_binary`` byte for byte JAX's, each package loading the other's;
  * ``Booster.predict(path)`` = JAX's predict of the parsed file;
  * the ``file_io`` scheme seam; ``add_features_from``;
  * a model trained from a file = the model of the parsed matrix.
"""

import json
import os

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
import split_parity as sp
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.dataset import TpuDataset
from lightgbm_tpu.core.parser import load_file_to_dataset as jax_load
from lightgbm_tpu.core.parser import parse_file_to_matrix as jax_parse
from lightgbm_tpu.models.boosting_factory import \
    create_boosting as jax_boosting
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu_torch.core import binning, native, parser
from lightgbm_tpu_torch.core.dataset import TorchDataset
from lightgbm_tpu_torch.utils import file_io


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    yield from sp.one_torch_thread()


N = 2000


def _table(seed=0, n=N):
    """label, weight, query id, 4 numerical features (one with NaN, one
    zero-heavy), an ignored column and a 6-category column."""
    rng = np.random.RandomState(seed)
    X = np.round(rng.normal(size=(n, 4)), 4)
    X[rng.uniform(size=n) < 0.1, 1] = np.nan
    X[rng.uniform(size=n) < 0.3, 2] = 0.0
    cat = rng.randint(0, 6, size=n).astype(np.float64)
    y = (np.nan_to_num(X[:, 0]) + (cat == 2) + 0.3 * rng.normal(size=n)
         > 0.4).astype(np.float64)
    w = np.round(rng.uniform(0.5, 2.0, size=n), 3)
    q = np.repeat(np.arange(n // 20), 20).astype(np.float64)
    junk = np.round(rng.uniform(size=n), 3)
    return y, w, q, X, junk, cat


def _fmt(v):
    return "" if np.isnan(v) else repr(float(v))


def _write_dense(path, cols, sep, header=None):
    with open(path, "w") as fh:
        if header:
            fh.write(sep.join(header) + "\n")
        for row in zip(*cols):
            fh.write(sep.join(_fmt(v) for v in row) + "\n")


def _write_libsvm(path, y, X):
    with open(path, "w") as fh:
        for label, row in zip(y, X):
            toks = [f"{i}:{float(v)!r}" for i, v in enumerate(row)
                    if v != 0 and not np.isnan(v)]
            fh.write(" ".join([repr(float(label))] + toks) + "\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    y, w, q, X, junk, cat = _table()
    yv, wv, qv, Xv, junkv, catv = _table(seed=1, n=500)
    out = {}
    header = ["lab", "wt", "qid", "a", "b", "c", "d", "junk", "kind"]
    out["csv"] = str(d / "train.csv")
    _write_dense(out["csv"], [y, w, q, *X.T, junk, cat], ",", header)
    out["csv_valid"] = str(d / "valid.csv")
    _write_dense(out["csv_valid"], [yv, wv, qv, *Xv.T, junkv, catv], ",",
                 header)
    out["tsv"] = str(d / "train.tsv")
    _write_dense(out["tsv"], [y, *X.T, cat], "\t")
    np.savetxt(out["tsv"] + ".weight", w)
    np.savetxt(out["tsv"] + ".init", 0.1 * X[:, 0].round(2))
    out["svm"] = str(d / "train.svm")
    _write_libsvm(out["svm"], y, np.nan_to_num(X))
    np.savetxt(out["svm"] + ".query", np.full(N // 40, 40), fmt="%d")
    out["X"], out["y"], out["w"], out["q"] = X, y, w, q
    out["cat"] = cat
    return out


CSV_PARAMS = dict(header=True, label_column="name:lab",
                  weight_column="name:wt", group_column="name:qid",
                  ignore_column="name:junk", categorical_feature="name:kind")
CASES = {
    "csv": ("csv", CSV_PARAMS),
    "csv_two_round": ("csv", dict(CSV_PARAMS, two_round=True)),
    "tsv_side_files": ("tsv", dict(categorical_feature="4")),
    "libsvm_query": ("svm", {}),
}
BASE = dict(objective="binary", max_bin=63, verbosity=-1,
            min_data_in_leaf=10)


def _assert_same_dataset(pds, jds):
    assert pds.num_data == jds.num_data
    assert list(pds.feature_names) == list(jds.feature_names)
    # as JSON: a NaN bound equals a NaN bound there
    assert json.dumps([m.to_dict() for m in pds.bin_mappers]) == json.dumps(
        [m.to_dict() for m in jds.bin_mappers])
    np.testing.assert_array_equal(pds.bins_t, jds.binned.T)
    for field in ("label", "weights", "query_boundaries", "init_score"):
        a, b = getattr(pds.metadata, field), getattr(jds.metadata, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_file_datasets_equal_jax(files, case):
    key, extra = CASES[case]
    params = dict(BASE, **extra)
    pds = lt.Dataset(files[key], params=params).construct()._handle
    jds = jax_load(files[key], JaxConfig(**params))
    _assert_same_dataset(pds, jds)


@pytest.mark.parametrize("case", sorted(CASES))
def test_file_models_equal_jax(files, case):
    """Three iterations from each file: JAX's model text, both packages on
    the onehot path (JAX's CPU default, whose XLA grower compiles in
    seconds where its Pallas kernels in interpret mode take ten)."""
    key, extra = CASES[case]
    params = dict(BASE, num_leaves=15, device_type="cpu",
                  tpu_histogram_backend="onehot", **extra)
    cfg = JaxConfig(**params)
    jds = jax_load(files[key], cfg)
    obj = jax_objective(cfg)
    obj.init(jds.metadata, jds.num_data)
    jgb = jax_boosting(cfg, jds, obj)
    for _ in range(3):
        jgb.train_one_iter()
    jgb._flush_pending()
    bst = lt.Booster(params, lt.Dataset(files[key], params=params))
    for _ in range(3):
        bst.update()
    sp.assert_same_model(jgb, bst)


@pytest.mark.parametrize("two_round", [False, True])
def test_valid_file_on_training_bins_equals_jax(files, two_round):
    params = dict(BASE, **CSV_PARAMS, two_round=two_round)
    train = lt.Dataset(files["csv"], params=params)
    valid = lt.Dataset(files["csv_valid"], params=params, reference=train)
    pv = valid.construct()._handle
    jtrain = jax_load(files["csv"], JaxConfig(**params))
    jv = jax_load(files["csv_valid"], JaxConfig(**params), reference=jtrain)
    assert pv.bin_mappers is train.construct()._handle.bin_mappers
    _assert_same_dataset(pv, jv)


def test_native_tokenizers_equal_python(files, monkeypatch):
    for key, sep in (("csv", ","), ("tsv", "\t")):
        with open(files[key], "rb") as fh:
            data = fh.read()
        if key == "csv":
            data = data.split(b"\n", 1)[1]
        text = data.decode().splitlines()
        got = native.parse_dense_native(data, sep)
        np.testing.assert_array_equal(got, parser._parse_dense(text, sep))
    odd = b"1,NA,,2.5\n\n3,nan,NULL,-1e-3\r\n"
    np.testing.assert_array_equal(
        native.parse_dense_native(odd, ","),
        parser._parse_dense(odd.decode().splitlines(), ","))
    # a ragged row or a bad token is left to the Python reader
    assert native.parse_dense_native(b"1,2\n3\n", ",") is None
    assert native.parse_dense_native(b"1,x\n", ",") is None
    with open(files["svm"], "rb") as fh:
        data = fh.read()
    want = parser._parse_libsvm(data.decode().splitlines())
    np.testing.assert_array_equal(native.parse_libsvm_native(data), want)
    # a piece a thread, the pieces' results joined
    monkeypatch.setattr(parser, "_PARALLEL_BYTES", 256)
    monkeypatch.setattr(parser, "_walk_workers", lambda: 5)
    np.testing.assert_array_equal(parser._libsvm_native(data), want)
    with open(files["tsv"], "rb") as fh:
        tsv = fh.read()
    np.testing.assert_array_equal(
        parser._dense_block(tsv, "\t"),
        parser._parse_dense(tsv.decode().splitlines(), "\t"))


@pytest.mark.parametrize("seed", range(4))
def test_native_binner_equals_python(seed):
    rng = np.random.RandomState(seed)
    for k, max_bin in ((50, 63), (3000, 255), (5000, 1023), (700, 15)):
        vals = np.unique(np.round(rng.normal(size=k) * 10, 3))
        cnts = rng.randint(1, 40, size=len(vals)).astype(np.int64)
        total = int(cnts.sum())
        for mdib in (0, 3):
            assert binning.greedy_find_bin(vals, cnts, max_bin, total,
                                           mdib) == \
                binning.greedy_find_bin_py(vals, cnts, max_bin, total, mdib)
    X = rng.normal(size=(3000, 3))
    X[rng.uniform(size=3000) < 0.1, 1] = np.nan
    for max_bin, dtype in ((63, np.uint8), (1023, np.uint16)):
        ms = [binning.BinMapper().find_bin(X[:, f], 3000, max_bin)
              for f in range(3)]
        for data in (X, X.astype(np.float32)):
            got = native.quantize_rows_native(data, [0, 1, 2], ms, dtype)
            for f in range(3):
                np.testing.assert_array_equal(
                    got[:, f], ms[f].value_to_bin(
                        data[:, f].astype(np.float64)))


@pytest.mark.parametrize("case", ["csv", "wide_bundled"])
def test_save_binary_is_jax_byte_for_byte(files, tmp_path, case):
    """The CSV's dataset (weights, query groups, init scores), and a matrix
    of two-byte bins with an EFB group: the port's .bin = JAX's byte for
    byte, each package loads the other's, and lt.Dataset reads it."""
    if case == "csv":
        params = dict(BASE, **CSV_PARAMS)
        pds = lt.Dataset(files["csv"], params=params).construct()._handle
        jds = jax_load(files["csv"], JaxConfig(**params))
    else:
        X, y = sp.one_hot_data()
        params = dict(BASE, max_bin=511)
        pds = lt.Dataset(X, y, params=params).construct()._handle
        jds = TpuDataset.from_numpy(X, y, config=JaxConfig(**params))
        assert pds.wide and pds.bundle is not None
    pds.metadata.set_init_score(np.linspace(-1, 1, pds.num_data))
    jds.metadata.set_init_score(np.linspace(-1, 1, jds.num_data))
    pbin, jbin = str(tmp_path / "p.bin"), str(tmp_path / "j.bin")
    pds.save_binary(pbin)
    jds.save_binary(jbin)
    with open(pbin, "rb") as a, open(jbin, "rb") as b:
        assert a.read() == b.read()
    _assert_same_dataset(TorchDataset.load_binary(jbin),
                         TpuDataset.load_binary(pbin))
    again = lt.Dataset(jbin).construct()._handle
    _assert_same_dataset(again, jds)


def test_predict_from_file_equals_jax(files, tmp_path):
    """JAX's model read by the port: predict(path) = JAX's predict of its
    own parse of the file, bit for bit (a file with a label column, and
    one of the features alone)."""
    params = dict(BASE, num_leaves=15, device_type="cpu")
    X, y = files["X"], files["y"]
    from lightgbm_tpu import basic as jbasic
    jb = jbasic.Booster({k: v for k, v in params.items()
                         if k != "device_type"}, jbasic.Dataset(X, y))
    for _ in range(3):
        jb.update()
    pb = lt.Booster(model_str=jb.model_to_string())
    path = str(tmp_path / "p.csv")
    _write_dense(path, [y, *X.T], ",")
    feats = str(tmp_path / "f.tsv")
    _write_dense(feats, list(X.T), "\t")
    for f in (path, feats):
        Xp, _ = jax_parse(f, False, X.shape[1])
        want = jb.predict(Xp, raw_score=True)
        np.testing.assert_array_equal(pb.predict(f, raw_score=True), want)


def test_file_io_scheme_seam(files):
    store = {}
    with open(files["csv"], "rb") as fh:
        store["memtest://train.csv"] = fh.read()

    def opener(path, mode="r"):
        import io
        if path not in store:
            raise FileNotFoundError(path)
        data = store[path]
        return io.BytesIO(data) if "b" in mode else io.StringIO(
            data.decode())

    file_io.register_scheme("memtest", opener)
    try:
        params = dict(BASE, **CSV_PARAMS)
        remote = lt.Dataset("memtest://train.csv",
                            params=params).construct()._handle
        local = lt.Dataset(files["csv"], params=params).construct()._handle
        np.testing.assert_array_equal(remote.bins_t, local.bins_t)
        assert not file_io.exists("memtest://missing.csv")
        with pytest.raises(lt.LightGBMError):
            file_io.open_file("nosuchscheme://x")
    finally:
        file_io.unregister_scheme("memtest")


def test_add_features_from_equals_jax():
    X, y = sp.data(seed=6)
    cfg = dict(BASE, max_bin=511, enable_bundle=False)
    a, b = X[:, :3], X[:, 3:]
    pa = lt.Dataset(a, y, params=dict(cfg, max_bin=63)).construct()
    pb_ = lt.Dataset(b, y, params=cfg).construct()
    pa.add_features_from(pb_)
    ja = TpuDataset.from_numpy(a, y, config=JaxConfig(**dict(cfg,
                                                             max_bin=63)))
    jb = TpuDataset.from_numpy(b, y, config=JaxConfig(**cfg))
    ja.add_features_from(jb)
    p = pa._handle
    assert p.bins_t.dtype == np.uint16 and p.wide
    np.testing.assert_array_equal(p.bins_t, ja.binned.T)
    assert p.feature_names == ja.feature_names
    np.testing.assert_array_equal(p.used_feature_indices,
                                  ja.used_feature_indices)


def test_model_from_file_equals_matrix_model(files, tmp_path):
    params = dict(BASE, **CSV_PARAMS, device_type="cpu", num_leaves=15)
    from_file = lt.train(params, lt.Dataset(files["csv"], params=params), 3)
    ds = from_file.train_set._handle
    X = np.concatenate([files["X"], files["cat"][:, None]], axis=1)
    mat = lt.Dataset(X, files["y"], weight=files["w"],
                     group=np.full(N // 20, 20),
                     feature_name=ds.feature_names,
                     categorical_feature=[4])
    from_matrix = lt.train(params, mat, 3)
    np.testing.assert_array_equal(mat._handle.bins_t, ds.bins_t)
    assert from_file.model_to_string() == from_matrix.model_to_string()
    # the binary cache trains the same model
    path = str(tmp_path / "c.bin")
    from_file.train_set.save_binary(path)
    again = lt.train(params, lt.Dataset(path, params=params), 3)
    assert again.model_to_string() == from_file.model_to_string()
    os.remove(path)
