"""The binned training dataset.

Reference: include/LightGBM/dataset.h:283-637 + src/io/dataset_loader.cpp
(sample -> FindBin -> quantize all rows).  The port keeps ONE dense bin
matrix, stored column-major ``[G, N]`` uint8 on the host: each bin column
is a contiguous row, which is the layout the histogram kernels read on the
card.  Exclusive feature bundling (EFB, core/bundle.py) packs features
that are rarely off their default bin together into one column, as the
JAX package does (lightgbm_tpu/core/dataset.py): ``bundle`` holds the
packing (None: every used feature is its own column), and
``feature_infos`` gives each feature its column (``group``) and bin
offset.  A scipy sparse matrix is binned from its per-column nonzeros and
written column by column (``from_scipy``), never densified.  Categorical
columns are named at construction (``categorical_features``) and binned
by category (core/binning.py).  The metadata (core/metadata.py) holds
labels, sample weights, query groups and init scores.  The split
features' per-feature settings, ``monotone_constraints`` and
``feature_penalty`` (feature_contri), are taken from the configuration
the dataset is built with, one value an original feature, as the JAX
dataset takes them (lightgbm_tpu/core/dataset.py:194-202), and follow it
into valid sets and subsets.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..models.tree import PARALLEL_ROWS, _walk_workers
from ..ops.histogram import pack_bins_4bit
from ..utils.log import LightGBMError, check, log_warning
from .binning import BIN_TYPE_CATEGORICAL, BIN_TYPE_NUMERICAL, BinMapper
from .bundle import BundleSpec, build_bundle, quantize_bundled
from .metadata import Metadata


def _per_feature(fn, features, num_rows: int) -> list:
    """[fn(f) for f in features]; past PARALLEL_ROWS rows, one feature a
    thread on the cores (numpy's sorts and searches release the GIL).
    Each feature's result does not depend on the threads."""
    workers = _walk_workers()
    if num_rows < PARALLEL_ROWS or workers == 1 or len(features) <= 1:
        return [fn(f) for f in features]
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(fn, features))


class FeatureInfo:
    """Per-used-feature metadata consumed by the tree learner.  The
    feature's bins are in column ``group`` of the bin matrix, at
    ``offset + bin`` (offset 0: the column is the feature's own);
    ``monotone`` is its constraint (-1, 0, +1) and ``penalty`` its gain
    multiplier (feature_contri)."""

    __slots__ = ("num_bin", "missing_type", "default_bin", "is_cat",
                 "group", "offset", "monotone", "penalty")

    def __init__(self, num_bin, missing_type, default_bin, is_cat=False,
                 group=0, offset=0, monotone=0, penalty=1.0):
        self.num_bin = num_bin
        self.missing_type = missing_type
        self.default_bin = default_bin
        self.is_cat = is_cat
        self.group = group
        self.offset = offset
        self.monotone = monotone
        self.penalty = penalty


class TorchDataset:
    """Binned dataset: column-major uint8 bin matrix + BinMappers +
    Metadata, with its EFB packing (``bundle``)."""

    def __init__(self):
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.bin_mappers: List[BinMapper] = []      # one per original feature
        self.used_feature_indices = np.array([], dtype=np.int32)
        self.bins_t: Optional[np.ndarray] = None     # [G, N] uint8
        self.bundle: Optional[BundleSpec] = None     # None: G = F_used
        self.metadata = Metadata()
        self.feature_names: List[str] = []
        self.max_num_bin: int = 0
        # one value an original feature, or None (all 0 / all 1.0)
        self.monotone_constraints: Optional[List[int]] = None
        self.feature_penalty: Optional[List[float]] = None
        self._device_cache: Dict[Tuple, torch.Tensor] = {}

    @classmethod
    def from_numpy(cls, data: np.ndarray, label: Optional[np.ndarray] = None,
                   config: Optional[Config] = None,
                   feature_names: Optional[List[str]] = None,
                   reference: Optional["TorchDataset"] = None,
                   categorical_features: Sequence[int] = (),
                   weights: Optional[np.ndarray] = None,
                   group: Optional[np.ndarray] = None,
                   init_score: Optional[np.ndarray] = None
                   ) -> "TorchDataset":
        """Build a dataset from a raw [N, F] float matrix
        (DatasetLoader::CostructFromSampleData, dataset_loader.cpp:553).
        ``categorical_features`` are column indices binned by category.
        With ``reference`` its bin mappers and EFB packing are reused, so
        validation data aligns with the training bins
        (Dataset::CreateValid).  ``weights`` [N], ``group`` (query sizes)
        and ``init_score`` [C*N, class-major] go to the metadata."""
        cfg = config or Config(device_type="cpu")
        data = np.asarray(data)
        if data.ndim != 2:
            raise ValueError(
                "data must be 2-dimensional [num_data, num_features]")
        ds = cls._new(data.shape, feature_names, reference)
        if reference is None:
            sample_idx = cls._sample_indices(ds.num_data, cfg)
            sample = np.asarray(data[sample_idx], dtype=np.float64)
            ds._fit_bin_mappers(
                cfg, set(int(c) for c in categorical_features),
                lambda f: np.ascontiguousarray(sample[:, f]),
                len(sample_idx))
            ds._set_feature_settings(cfg)
            mappers = [ds.bin_mappers[f] for f in ds.used_feature_indices]
            ds._build_bundle(cfg, len(sample_idx), lambda j: (
                mappers[j].value_to_bin(sample[:, ds.used_feature_indices[j]])
                != mappers[j].default_bin))

        def member_bins(j):
            f = ds.used_feature_indices[j]
            return None, ds.bin_mappers[f].value_to_bin(
                np.asarray(data[:, f], dtype=np.float64))

        ds._quantize(member_bins)
        ds._set_metadata(label, weights, group, init_score)
        return ds

    @classmethod
    def from_scipy(cls, data, label: Optional[np.ndarray] = None,
                   config: Optional[Config] = None,
                   feature_names: Optional[List[str]] = None,
                   reference: Optional["TorchDataset"] = None,
                   categorical_features: Sequence[int] = (),
                   weights: Optional[np.ndarray] = None,
                   group: Optional[np.ndarray] = None,
                   init_score: Optional[np.ndarray] = None
                   ) -> "TorchDataset":
        """Build a dataset from a scipy sparse matrix without densifying it
        (lightgbm_tpu/core/dataset.py from_scipy :206-296; the reference's
        LGBM_DatasetCreateFromCSR): bins are found from each column's
        sampled nonzeros, the implicit zeros counted through
        ``total_sample_cnt`` (the reference's sparse FindBin convention,
        bin.cpp:210), and the bin matrix is written column by column from
        the nonzeros, an implicit zero at the feature's default bin (the
        bin of 0).  The arguments are from_numpy's."""
        cfg = config or Config(device_type="cpu")
        csr = data.tocsr()
        csc = csr.tocsc()
        ds = cls._new(csr.shape, feature_names, reference)
        if reference is None:
            sample_idx = cls._sample_indices(ds.num_data, cfg)
            S = len(sample_idx)
            smp = csc if S >= ds.num_data else csr[sample_idx].tocsc()

            def nonzeros(f):
                sl = slice(smp.indptr[f], smp.indptr[f + 1])
                return smp.indices[sl], np.asarray(smp.data[sl],
                                                   dtype=np.float64)

            ds._fit_bin_mappers(cfg, set(int(c) for c in categorical_features),
                                lambda f: nonzeros(f)[1], S)
            ds._set_feature_settings(cfg)

            def nonzero_mask(j):
                f = ds.used_feature_indices[j]
                rows, vals = nonzeros(f)
                m = ds.bin_mappers[f]
                mask = np.zeros(S, dtype=bool)
                mask[rows] = m.value_to_bin(vals) != m.default_bin
                return mask

            ds._build_bundle(cfg, S, nonzero_mask)

        def member_bins(j):
            f = ds.used_feature_indices[j]
            sl = slice(csc.indptr[f], csc.indptr[f + 1])
            return csc.indices[sl], ds.bin_mappers[f].value_to_bin(
                np.asarray(csc.data[sl], dtype=np.float64))

        ds._quantize(member_bins)
        ds._set_metadata(label, weights, group, init_score)
        return ds

    @classmethod
    def _new(cls, shape, feature_names, reference) -> "TorchDataset":
        """An empty dataset of ``shape`` rows and columns; with
        ``reference`` it takes its bin mappers, names and packing."""
        n, num_features = shape
        ds = cls()
        ds.num_data = n
        ds.num_total_features = num_features
        ds.feature_names = (list(feature_names) if feature_names
                            else [f"Column_{i}" for i in range(num_features)])
        if reference is not None:
            check(reference.num_total_features == num_features,
                  "validation data has a different number of features")
            ds.bin_mappers = reference.bin_mappers
            ds.used_feature_indices = reference.used_feature_indices
            ds.max_num_bin = reference.max_num_bin
            ds.feature_names = list(reference.feature_names)
            ds.bundle = reference.bundle
            ds.monotone_constraints = reference.monotone_constraints
            ds.feature_penalty = reference.feature_penalty
        return ds

    def _set_feature_settings(self, cfg: Config) -> None:
        """``monotone_constraints`` and ``feature_penalty`` from the
        configuration's lists, which name every original feature."""
        self.set_feature_settings(cfg.monotone_constraints or None,
                                  cfg.feature_contri or None)

    def set_feature_settings(self, monotone=None, penalty=None) -> None:
        """Each original feature's monotone constraint and gain
        multiplier (None: 0 and 1.0 for every feature)."""
        if monotone is not None:
            check(len(monotone) == self.num_total_features,
                  "monotone_constraints length must equal number of "
                  "features")
            self.monotone_constraints = [int(x) for x in monotone]
        if penalty is not None:
            check(len(penalty) == self.num_total_features,
                  "feature_contri length must equal number of features")
            self.feature_penalty = [float(x) for x in penalty]

    def _set_metadata(self, label, weights, group, init_score) -> None:
        md = self.metadata
        md.init(self.num_data)
        if label is not None:
            md.set_label(label)
        if weights is not None:
            md.set_weights(weights)
        if group is not None:
            md.set_query(group)
        if init_score is not None:
            md.set_init_score(init_score)

    @staticmethod
    def _sample_indices(n: int, cfg: Config) -> np.ndarray:
        """The rows of the binning sample (the JAX Dataset's
        _pick_sample)."""
        rng = np.random.RandomState(cfg.data_random_seed)
        sample_cnt = min(n, cfg.bin_construct_sample_cnt)
        return (np.arange(n) if sample_cnt >= n
                else rng.choice(n, sample_cnt, replace=False))

    def _fit_bin_mappers(self, cfg: Config, categorical: set, sample_col,
                         total_sample_cnt: int) -> None:
        """One BinMapper a feature from ``sample_col(f)``, its sampled
        values (for sparse input only the nonzeros: the rest of the
        ``total_sample_cnt`` are zeros)."""
        self.bin_mappers = _per_feature(
            lambda f: BinMapper().find_bin(
                sample_col(f), total_sample_cnt=total_sample_cnt,
                max_bin=cfg.max_bin, min_data_in_bin=cfg.min_data_in_bin,
                min_split_data=cfg.min_data_in_leaf,
                bin_type=(BIN_TYPE_CATEGORICAL if f in categorical
                          else BIN_TYPE_NUMERICAL),
                use_missing=cfg.use_missing,
                zero_as_missing=cfg.zero_as_missing),
            range(self.num_total_features), total_sample_cnt)
        self._set_used_features()

    def _set_used_features(self) -> None:
        used = [f for f, m in enumerate(self.bin_mappers) if not m.is_trivial]
        if not used:
            log_warning("There are no meaningful features, as all feature "
                        "values are constant.")
        self.used_feature_indices = np.asarray(used, dtype=np.int32)
        self.max_num_bin = max((self.bin_mappers[f].num_bin for f in used),
                               default=1)
        # a categorical feature may hold more bins than max_bin (99% mass
        # rule); the port's bins are one byte
        check(self.max_num_bin <= 256,
              f"a feature has {self.max_num_bin} bins; lightgbm_tpu_torch "
              "stores one byte a bin (at most 256 bins)")

    def _used_num_bins(self) -> np.ndarray:
        return np.asarray([self.bin_mappers[f].num_bin
                           for f in self.used_feature_indices],
                          dtype=np.int64)

    def _build_bundle(self, cfg: Config, sample_cnt: int,
                      nonzero_mask) -> None:
        """EFB's packing of the used features from their [S] non-default
        masks on the binning sample, ``nonzero_mask(j)`` (the JAX
        Dataset's _build_bundle; Dataset::Construct ->
        FastFeatureBundling, dataset.cpp:235-241); None when
        ``enable_bundle`` is off or no multi-feature group forms."""
        used = self.used_feature_indices
        if not cfg.enable_bundle or len(used) <= 1:
            return
        self.bundle = build_bundle(
            nonzero_mask, len(used), sample_cnt, self._used_num_bins(),
            np.asarray([self.bin_mappers[f].sparse_rate for f in used]),
            cfg.sparse_threshold, cfg.max_conflict_rate)

    def _layout(self) -> BundleSpec:
        """The packing, or one column a used feature."""
        if self.bundle is not None:
            return self.bundle
        return BundleSpec([[j] for j in range(self.num_used_features)],
                          self._used_num_bins())

    def _quantize(self, member_bins) -> None:
        """The [G, N] bin matrix from ``member_bins(j)``: (rows, bins) of
        used feature j (core/bundle.quantize_bundled), one column a thread
        past PARALLEL_ROWS rows."""
        layout = self._layout()
        defaults = np.asarray([self.bin_mappers[f].default_bin
                               for f in self.used_feature_indices],
                              dtype=np.int64)
        self.bins_t = quantize_bundled(
            member_bins, layout, defaults, self.num_data,
            workers=lambda fn, cols: _per_feature(fn, cols, self.num_data))
        self._device_cache = {}

    @classmethod
    def from_bins(cls, bins_t: np.ndarray, bin_mappers: List[BinMapper],
                  label: Optional[np.ndarray] = None,
                  feature_names: Optional[List[str]] = None,
                  weights: Optional[np.ndarray] = None,
                  group: Optional[np.ndarray] = None,
                  init_score: Optional[np.ndarray] = None,
                  bundle_groups: Optional[List[List[int]]] = None,
                  monotone_constraints: Optional[Sequence[int]] = None,
                  feature_penalty: Optional[Sequence[float]] = None
                  ) -> "TorchDataset":
        """A dataset from an already-binned column-major matrix of the
        non-trivial features of ``bin_mappers``, packed by
        ``bundle_groups`` (lists of used-feature indices, as
        BundleSpec.groups; None: one column a feature), with from_numpy's
        metadata and each original feature's monotone constraint and gain
        multiplier (``set_feature_settings``)."""
        ds = cls()
        ds.bin_mappers = list(bin_mappers)
        ds.num_total_features = len(bin_mappers)
        ds._set_used_features()
        if bundle_groups is not None:
            ds.bundle = BundleSpec(bundle_groups, ds._used_num_bins())
        bins_t = np.ascontiguousarray(bins_t, dtype=np.uint8)
        check(bins_t.shape[0] == ds.num_columns,
              "bin matrix rows != the dataset's bin columns")
        ds.bins_t = bins_t
        ds.num_data = bins_t.shape[1]
        ds.feature_names = (list(feature_names) if feature_names else
                            [f"Column_{i}" for i in range(len(bin_mappers))])
        ds.set_feature_settings(monotone_constraints, feature_penalty)
        ds._set_metadata(label, weights, group, init_score)
        return ds

    # ---------------------------------------------------------------- access
    @property
    def num_used_features(self) -> int:
        return len(self.used_feature_indices)

    @property
    def num_columns(self) -> int:
        """Columns of the bin matrix (EFB groups, or the used features)."""
        return (self.bundle.num_groups if self.bundle is not None
                else self.num_used_features)

    @property
    def max_column_bin(self) -> int:
        """The most bins of any column (the histograms' bin axis)."""
        return (int(self.bundle.group_num_bin.max(initial=1))
                if self.bundle is not None else self.max_num_bin)

    @property
    def column_bins(self) -> np.ndarray:
        """[G] the bins of each column."""
        return self._layout().group_num_bin.astype(np.int64)

    def feature_infos(self) -> List[FeatureInfo]:
        layout = self._layout()
        mono, pen = self.monotone_constraints, self.feature_penalty
        return [FeatureInfo(self.bin_mappers[f].num_bin,
                            self.bin_mappers[f].missing_type,
                            self.bin_mappers[f].default_bin,
                            self.bin_mappers[f].is_categorical,
                            int(layout.feat_group[j]),
                            int(layout.feat_offset[j]),
                            0 if mono is None else mono[f],
                            1.0 if pen is None else pen[f])
                for j, f in enumerate(self.used_feature_indices)]

    @property
    def has_categorical(self) -> bool:
        return any(self.bin_mappers[f].is_categorical
                   for f in self.used_feature_indices)

    def inner_feature_index(self, real_feature: int) -> int:
        """The used-feature index of an original feature, -1 if unused."""
        hits = np.nonzero(self.used_feature_indices == real_feature)[0]
        return int(hits[0]) if len(hits) else -1

    def subset(self, indices: np.ndarray) -> "TorchDataset":
        """The rows ``indices`` (sorted), sharing this dataset's bin
        mappers and packing (Dataset::CopySubset, dataset.cpp:503; the JAX
        Booster's Dataset.subset), with their labels, weights and init
        scores, and their query groups where the rows are whole
        queries."""
        indices = np.asarray(indices, dtype=np.int64)
        sub = TorchDataset()
        sub.num_data = len(indices)
        sub.num_total_features = self.num_total_features
        sub.bin_mappers = self.bin_mappers
        sub.used_feature_indices = self.used_feature_indices
        sub.max_num_bin = self.max_num_bin
        sub.feature_names = self.feature_names
        sub.bundle = self.bundle
        sub.monotone_constraints = self.monotone_constraints
        sub.feature_penalty = self.feature_penalty
        sub.bins_t = np.ascontiguousarray(self.bins_t[:, indices])
        sub.metadata = self.metadata.subset(indices)
        return sub

    def check_align(self, other: "TorchDataset") -> None:
        """Raise unless ``other``'s bins align with this dataset's
        (Dataset::CheckAlign; lightgbm_tpu/core/dataset.py check_align):
        the same bin mappers, or mappers with the same bins, and the same
        column layout (EFB packing)."""
        if other.bin_mappers is not self.bin_mappers:
            same = other.num_total_features == self.num_total_features \
                and all(
                    a.num_bin == b.num_bin
                    and a.is_categorical == b.is_categorical
                    and a.missing_type == b.missing_type
                    and np.array_equal(a.bin_upper_bound, b.bin_upper_bound,
                                       equal_nan=True)
                    and a.bin_2_categorical == b.bin_2_categorical
                    for a, b in zip(self.bin_mappers, other.bin_mappers))
            if not same:
                raise LightGBMError(
                    "Cannot use this dataset: its bin mappers differ from "
                    "the training data's (construct it with the training "
                    "set as reference)")
        sb, ob = self.bundle, other.bundle
        if (sb is None) != (ob is None) or (
                sb is not None and ob is not sb
                and (not np.array_equal(sb.feat_group, ob.feat_group)
                     or not np.array_equal(sb.feat_offset, ob.feat_offset))):
            raise LightGBMError("Cannot use this dataset: its EFB column "
                                "layout differs from the training data's")

    def real_threshold(self, used_feature: int, bin_threshold: int) -> float:
        """Numerical bin threshold -> real-valued threshold
        (Dataset::RealThreshold)."""
        f = int(self.used_feature_indices[used_feature])
        return self.bin_mappers[f].bin_to_value(int(bin_threshold))

    def device_bins(self, row_multiple: int, device: torch.device,
                    packed4: bool = False) -> torch.Tensor:
        """Column-major [G, Npad] uint8 on ``device``, rows padded with
        bin 0 to a multiple of ``row_multiple`` (the grower gives pad rows
        zero weight); ``packed4``: [ceil(G / 2), Npad], two <= 16-bin
        columns a byte, packed on the host (ops/histogram.py
        pack_bins_4bit), byte for byte the JAX package's
        ``host_binned_T(row_multiple, packed4=True)``, so the card never
        holds the unpacked matrix.  Uploaded once per (row_multiple,
        device, packed4)."""
        key = (row_multiple, str(device), bool(packed4))
        t = self._device_cache.get(key)
        if t is None:
            npad = -(-self.num_data // row_multiple) * row_multiple
            host = self.bins_t
            if packed4:
                host = pack_bins_4bit(host)
            t = torch.zeros((host.shape[0], npad), dtype=torch.uint8,
                            device=device)
            t[:, :self.num_data] = torch.from_numpy(host).to(device)
            self._device_cache = {key: t}
        return t
