"""The binned training dataset.

Reference: include/LightGBM/dataset.h:283-637 + src/io/dataset_loader.cpp
(sample -> FindBin -> quantize all rows).  The port keeps ONE dense bin
matrix, stored feature-major ``[F_used, N]`` uint8 on the host: each
feature is a contiguous row, which is the layout the histogram kernels
read on the card.  Every used feature is its own column: exclusive
feature bundling (EFB, core/bundle.py) computes the JAX package's
grouping and raises where a multi-feature group forms, since storing and
expanding a group is not ported yet; on data where none forms (dense
data) the matrix is the unbundled one.  Categorical columns are named at
construction (``categorical_features``) and binned by category
(core/binning.py).  The metadata (core/metadata.py) holds labels, sample
weights, query groups and init scores.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..models.tree import PARALLEL_ROWS, _walk_workers
from ..utils.log import LightGBMError, check, log_warning
from .binning import BIN_TYPE_CATEGORICAL, BIN_TYPE_NUMERICAL, BinMapper
from .bundle import build_bundle
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
    """Per-used-feature metadata consumed by the tree learner."""

    __slots__ = ("num_bin", "missing_type", "default_bin", "is_cat")

    def __init__(self, num_bin, missing_type, default_bin, is_cat=False):
        self.num_bin = num_bin
        self.missing_type = missing_type
        self.default_bin = default_bin
        self.is_cat = is_cat


class TorchDataset:
    """Binned dataset: feature-major uint8 matrix + BinMappers + Metadata."""

    def __init__(self):
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.bin_mappers: List[BinMapper] = []      # one per original feature
        self.used_feature_indices = np.array([], dtype=np.int32)
        self.bins_t: Optional[np.ndarray] = None     # [F_used, N] uint8
        self.metadata = Metadata()
        self.feature_names: List[str] = []
        self.max_num_bin: int = 0
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
        With ``reference`` its bin mappers are reused, so validation data
        aligns with the training bins (Dataset::CreateValid).
        ``weights`` [N], ``group`` (query sizes) and ``init_score`` [C*N,
        class-major] go to the metadata."""
        cfg = config or Config(device_type="cpu")
        data = np.asarray(data)
        if data.ndim != 2:
            raise ValueError(
                "data must be 2-dimensional [num_data, num_features]")
        n, num_features = data.shape
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
        else:
            ds._fit_bin_mappers(data, cfg,
                                set(int(c) for c in categorical_features))
            if cfg.enable_bundle:
                groups = ds.find_bundle(data, cfg)
                if groups is not None:
                    raise NotImplementedError(
                        f"EFB groups {len(ds.used_feature_indices)} features "
                        f"into {len(groups)} bin columns here, but the "
                        "expansion of a group's histogram into its features' "
                        "is not ported to lightgbm_tpu_torch yet; pass "
                        "enable_bundle=False")
        ds._quantize(data)
        ds._set_metadata(label, weights, group, init_score)
        return ds

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

    def _fit_bin_mappers(self, data: np.ndarray, cfg: Config,
                         categorical: set) -> None:
        sample_idx = self._sample_indices(data.shape[0], cfg)
        sample = np.asarray(data[sample_idx], dtype=np.float64)
        self.bin_mappers = _per_feature(
            lambda f: BinMapper().find_bin(
                np.ascontiguousarray(sample[:, f]),
                total_sample_cnt=len(sample_idx), max_bin=cfg.max_bin,
                min_data_in_bin=cfg.min_data_in_bin,
                min_split_data=cfg.min_data_in_leaf,
                bin_type=(BIN_TYPE_CATEGORICAL if f in categorical
                          else BIN_TYPE_NUMERICAL),
                use_missing=cfg.use_missing,
                zero_as_missing=cfg.zero_as_missing),
            range(data.shape[1]), len(sample_idx))
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

    def find_bundle(self, data: np.ndarray, cfg: Config):
        """EFB's grouping of the used features on the binning sample of
        ``data`` (the JAX Dataset's _build_bundle): a list of groups of
        used-feature indices, or None when no multi-feature group
        forms."""
        used = self.used_feature_indices
        if len(used) <= 1:
            return None
        sample_idx = self._sample_indices(data.shape[0], cfg)
        mappers = [self.bin_mappers[f] for f in used]

        def nonzero(j):
            col = np.asarray(data[sample_idx, used[j]], dtype=np.float64)
            return mappers[j].value_to_bin(col) != mappers[j].default_bin

        return build_bundle(
            nonzero, len(used), len(sample_idx),
            np.asarray([m.num_bin for m in mappers], dtype=np.int64),
            np.asarray([m.sparse_rate for m in mappers]),
            cfg.sparse_threshold, cfg.max_conflict_rate)

    def _quantize(self, data: np.ndarray) -> None:
        used = self.used_feature_indices
        out = np.empty((len(used), data.shape[0]), dtype=np.uint8)

        def quantize(j):
            out[j] = self.bin_mappers[used[j]].value_to_bin(
                np.asarray(data[:, used[j]], dtype=np.float64))

        _per_feature(quantize, range(len(used)), data.shape[0])
        self.bins_t = out
        self._device_cache = {}

    @classmethod
    def from_bins(cls, bins_t: np.ndarray, bin_mappers: List[BinMapper],
                  label: Optional[np.ndarray] = None,
                  feature_names: Optional[List[str]] = None,
                  weights: Optional[np.ndarray] = None,
                  group: Optional[np.ndarray] = None,
                  init_score: Optional[np.ndarray] = None
                  ) -> "TorchDataset":
        """A dataset from an already-binned feature-major matrix of the
        non-trivial features of ``bin_mappers``, with from_numpy's
        metadata."""
        ds = cls()
        ds.bin_mappers = list(bin_mappers)
        ds.num_total_features = len(bin_mappers)
        ds._set_used_features()
        bins_t = np.ascontiguousarray(bins_t, dtype=np.uint8)
        check(bins_t.shape[0] == len(ds.used_feature_indices),
              "bin matrix rows != non-trivial features")
        ds.bins_t = bins_t
        ds.num_data = bins_t.shape[1]
        ds.feature_names = (list(feature_names) if feature_names else
                            [f"Column_{i}" for i in range(len(bin_mappers))])
        ds._set_metadata(label, weights, group, init_score)
        return ds

    # ---------------------------------------------------------------- access
    @property
    def num_used_features(self) -> int:
        return len(self.used_feature_indices)

    def feature_infos(self) -> List[FeatureInfo]:
        return [FeatureInfo(self.bin_mappers[f].num_bin,
                            self.bin_mappers[f].missing_type,
                            self.bin_mappers[f].default_bin,
                            self.bin_mappers[f].is_categorical)
                for f in self.used_feature_indices]

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
        mappers (Dataset::CopySubset, dataset.cpp:503; the JAX Booster's
        Dataset.subset), with their labels, weights and init scores, and
        their query groups where the rows are whole queries."""
        indices = np.asarray(indices, dtype=np.int64)
        sub = TorchDataset()
        sub.num_data = len(indices)
        sub.num_total_features = self.num_total_features
        sub.bin_mappers = self.bin_mappers
        sub.used_feature_indices = self.used_feature_indices
        sub.max_num_bin = self.max_num_bin
        sub.feature_names = self.feature_names
        sub.bins_t = np.ascontiguousarray(self.bins_t[:, indices])
        sub.metadata = self.metadata.subset(indices)
        return sub

    def check_align(self, other: "TorchDataset") -> None:
        """Raise unless ``other``'s bins align with this dataset's
        (Dataset::CheckAlign; lightgbm_tpu/core/dataset.py check_align):
        the same bin mappers, or mappers with the same bins."""
        if other.bin_mappers is self.bin_mappers:
            return
        same = other.num_total_features == self.num_total_features and all(
            a.num_bin == b.num_bin and a.is_categorical == b.is_categorical
            and a.missing_type == b.missing_type
            and np.array_equal(a.bin_upper_bound, b.bin_upper_bound,
                               equal_nan=True)
            and a.bin_2_categorical == b.bin_2_categorical
            for a, b in zip(self.bin_mappers, other.bin_mappers))
        if not same:
            raise LightGBMError(
                "Cannot use this dataset: its bin mappers differ from the "
                "training data's (construct it with the training set as "
                "reference)")

    def real_threshold(self, used_feature: int, bin_threshold: int) -> float:
        """Numerical bin threshold -> real-valued threshold
        (Dataset::RealThreshold)."""
        f = int(self.used_feature_indices[used_feature])
        return self.bin_mappers[f].bin_to_value(int(bin_threshold))

    def device_bins(self, row_multiple: int,
                    device: torch.device) -> torch.Tensor:
        """Feature-major [F, Npad] uint8 on ``device``, rows padded with
        bin 0 to a multiple of ``row_multiple`` (the grower gives pad rows
        zero weight).  Uploaded once per (row_multiple, device)."""
        key = (row_multiple, str(device))
        t = self._device_cache.get(key)
        if t is None:
            npad = -(-self.num_data // row_multiple) * row_multiple
            t = torch.zeros((self.num_used_features, npad),
                            dtype=torch.uint8, device=device)
            t[:, :self.num_data] = torch.from_numpy(self.bins_t).to(device)
            self._device_cache = {key: t}
        return t
