"""GBDT: the boosting loop.

Counterpart of the core of lightgbm_tpu/models/gbdt.py (reference
src/boosting/gbdt.cpp: boost-from-average :420, TrainOneIter :450).  One
iteration grows C trees (C = num_class for multiclass softmax, else 1):
gradients [C, N] on the device; for C > 1 the C class roots' histograms
in one K5 launch (``histogram_all``, as the JAX loop does, gbdt.py:
1116-1154); then per class one tree grown from its root by the segment
grower or, with ``tpu_tree_impl=frontier``, the frontier grower, the
class's training score updated through the score kernel (K4), the tree
finalized on the host.  Trees are kept class by class within
each iteration (tree i is class i % C).  The training score starts from
the train set's ``init_score`` where it has one (and then is not boosted
from the average), a valid set's from its own; an objective with leaf
renewal (L1, quantile, MAPE) refits a tree's leaves between its growth
and its score update.  Subsampling follows the JAX package's streams
(lightgbm_tpu/models/gbdt.py:732-734, :971-1015, :1627-1640): after the
gradients, a bag of rows from a numpy RandomState(bagging_seed) every
``bagging_freq`` iterations, copied into the ``member`` channel every
kernel reads; then per class tree a feature mask from
RandomState(feature_fraction_seed) and, where by-node masks or GOSS need
it, the threefry key split from PRNGKey(seed) once a tree
(utils/random.py).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_METRIC, Config
from ..core.dataset import TorchDataset
from ..metric import create_metric
from ..ops.histogram import (check_packed_acc_bits, class_scales,
                             frontier_width, histogram_all, pack_channel_sets)
from ..ops.predict import route_trees
from ..ops.score import score_gather_add
from ..ops.split import FeatureMeta, SplitParams
from ..utils import random
from ..utils.log import LightGBMError, log_warning
from .device_predict import TreeStack, bin_rows, dataset_tables
from .grower import GrowerParams
from .grower_frontier import FrontierGrower
from .grower_fused import FusedGrower
from .grower_seg import SegmentGrower
from .tree import Tree

# Row block of the segment grower when tpu_row_chunk is 0: the
# granularity of confinement windows.  The card's kernels have no block
# shape of their own, so a block only needs to be large enough that
# windows stay few blocks long.
DEFAULT_BLOCK_ROWS = 8192


def resolve_device(config: Config) -> torch.device:
    """``device_type`` -> torch.device.  "cuda" without a card raises:
    the card path never falls back to the CPU."""
    if config.device_type == "cuda":
        if not torch.cuda.is_available():
            raise LightGBMError(
                "device_type='cuda' but torch.cuda.is_available() is False; "
                "pass device_type='cpu' to train on the CPU")
        return torch.device("cuda")
    return torch.device("cpu")


def _round_up_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def block_rows(config: Config, num_data: int) -> int:
    """Row block of the segment grower: ``tpu_row_chunk``, or
    DEFAULT_BLOCK_ROWS capped at the row count rounded up to a power of
    two."""
    if config.tpu_row_chunk > 0:
        return config.tpu_row_chunk
    return min(DEFAULT_BLOCK_ROWS, _round_up_pow2(max(num_data, 1)))


def _auto_frontier_k(config: Config, num_columns: int, num_bins: int) -> int:
    """Frontier width K (lightgbm_tpu/models/gbdt.py:109-124): an explicit
    tpu_frontier_width wins; else frontier_width's K, capped at
    ceil(num_leaves / 16) so that small trees stay near strict best-first.
    ``num_columns`` is the bin matrix's column count (EFB groups, or the
    used features) and ``num_bins`` its histograms' bin axis."""
    if config.tpu_frontier_width > 0:
        return config.tpu_frontier_width
    return min(frontier_width(num_columns, num_bins),
               max(1, -(-max(2, config.num_leaves) // 16)))


def build_forced_plan(dataset: TorchDataset, filename: str,
                      num_leaves: int) -> tuple:
    """``forcedsplits_filename``'s JSON -> the breadth-first plan of
    (leaf, used feature, threshold bin) splits (ForceSplits,
    serial_tree_learner.cpp:642; lightgbm_tpu/models/gbdt.py
    _build_forced_plan :131-176): a node's left child keeps its leaf id,
    its right child takes the next one; a split on an unused feature is
    skipped with its subtree; at most num_leaves - 1 splits."""
    import json
    from collections import deque
    with open(filename) as fh:
        root = json.load(fh)
    plan = []
    q = deque([(root, 0)])
    while q and len(plan) < num_leaves - 1:
        node, leaf = q.popleft()
        if not isinstance(node, dict) or "feature" not in node:
            continue
        real_f = int(node["feature"])
        inner = dataset.inner_feature_index(real_f)
        if inner < 0:
            log_warning(f"forced split on unused feature {real_f}; skipped")
            continue
        t_bin = int(np.asarray(dataset.bin_mappers[real_f].value_to_bin(
            np.asarray([float(node["threshold"])], dtype=np.float64)))[0])
        step = len(plan)
        plan.append((int(leaf), int(inner), t_bin))
        if isinstance(node.get("left"), dict):
            q.append((node["left"], leaf))
        if isinstance(node.get("right"), dict):
            q.append((node["right"], step + 1))
    return tuple(plan)


def resolve_tree_impl(config: Config, forced_plan: tuple) -> str:
    """The grower ``tpu_tree_impl`` gets (lightgbm_tpu/models/gbdt.py
    :637-648): "fused" when named, or when a forced plan or CEGB-lazy
    needs it (with the JAX package's warning where segment or frontier was
    named); else "frontier" when named, and the segment grower for
    "auto"."""
    impl = config.tpu_tree_impl
    if impl == "fused" or forced_plan or config.cegb_penalty_feature_lazy:
        if impl in ("segment", "frontier"):
            log_warning(f"tpu_tree_impl={impl} requires the pallas "
                        "histogram backend (and no forced splits / "
                        "CEGB-lazy); using the fused grower")
        return "fused"
    return "frontier" if impl == "frontier" else "segment"


def build_feature_meta(dataset: TorchDataset, device: torch.device,
                       config: Optional[Config] = None,
                       used_in_split: Optional[np.ndarray] = None
                       ) -> FeatureMeta:
    """The growers' FeatureMeta of ``dataset`` on ``device``; the split
    features' fields where they are used (lightgbm_tpu/models/gbdt.py
    build_feature_meta :178-211): the monotone constraints where one is
    set, the gain multipliers where one is not 1, and with ``config``'s
    CEGB feature costs their [F] arrays (indexed by original feature; a
    shorter list leaves 0) and ``cegb_used0``, the features
    ``used_in_split``."""
    infos = dataset.feature_infos()

    def col(name, dtype=torch.int32):
        return torch.tensor([getattr(i, name) for i in infos], dtype=dtype,
                            device=device)

    def per_feature(vals):
        out = np.zeros(len(infos), dtype=np.float64)
        for j, real in enumerate(dataset.used_feature_indices):
            if int(real) < len(vals):
                out[j] = float(vals[int(real)])
        return torch.tensor(out, dtype=torch.float32, device=device)

    is_cat = None
    if dataset.has_categorical:
        is_cat = torch.tensor([bool(i.is_cat) for i in infos],
                              dtype=torch.bool, device=device)
    feat_group = feat_offset = gather_idx = None
    if dataset.bundle is not None:
        # the [F, Bf] gather map from the flattened [G * Bg] group
        # histogram, at the grower's bin axes (lightgbm_tpu/models/gbdt.py
        # :185-200)
        Bg = _round_up_pow2(max(dataset.max_column_bin, 2))
        Bf = _round_up_pow2(max(dataset.max_num_bin, 2))
        gi = np.full((len(infos), Bf), -1, dtype=np.int64)
        for j, info in enumerate(infos):
            gi[j, :info.num_bin] = (info.group * Bg + info.offset
                                    + np.arange(info.num_bin))
        feat_group, feat_offset = col("group"), col("offset")
        gather_idx = torch.from_numpy(gi).to(device)
    monotone = penalty = coupled = lazy = used0 = None
    if any(i.monotone != 0 for i in infos):
        monotone = col("monotone")
    if any(i.penalty != 1.0 for i in infos):
        penalty = col("penalty", torch.float32)
    if config is not None and (config.cegb_penalty_feature_coupled
                               or config.cegb_penalty_feature_lazy):
        coupled = per_feature(config.cegb_penalty_feature_coupled)
        lazy = per_feature(config.cegb_penalty_feature_lazy)
        used0 = torch.tensor(np.zeros(len(infos)) if used_in_split is None
                             else used_in_split, dtype=torch.float32,
                             device=device)
    return FeatureMeta(num_bin=col("num_bin"),
                       missing_type=col("missing_type"),
                       default_bin=col("default_bin"), is_cat=is_cat,
                       feat_group=feat_group, feat_offset=feat_offset,
                       gather_idx=gather_idx, monotone=monotone,
                       penalty=penalty, cegb_coupled=coupled,
                       cegb_lazy=lazy, cegb_used0=used0)


class TreeEnsemble:
    """A model as prediction sees it: the trees (tree i is class i % C),
    the boost-from-average init scores, the objective's link (None: raw
    scores), and whether a prediction averages its iterations' trees
    (``average_output``: a random forest).  GBDT trains one;
    serialization.LoadedBoosting is one read from a model text."""

    average_output = False
    # the route of the last predict: "device" (P1) or "host" (the walk)
    last_predict_route: Optional[str] = None
    config: Config
    models: List[Tree]
    num_tree_per_iteration: int
    init_scores: List[float]
    objective: Optional[object]
    feature_names: List[str]
    max_feature_idx: int
    iter_: int

    def current_iteration(self) -> int:
        return self.iter_

    def _end_iteration(self, num_iteration: int, start: int = 0) -> int:
        """The iteration after the last one of ``num_iteration`` counted
        from ``start`` (<= 0: every one)."""
        if num_iteration <= 0:
            return self.iter_
        return min(start + num_iteration, self.iter_)

    def _layout(self, score: np.ndarray) -> np.ndarray:
        """[C, N] -> the objective's score layout: [N] when C == 1."""
        return score[0] if self.num_tree_per_iteration == 1 else score

    def predict(self, X: np.ndarray, num_iteration: int = -1,
                raw_score: bool = False, pred_leaf: bool = False,
                start_iteration: int = 0,
                config: Optional[Config] = None) -> np.ndarray:
        """Raw scores or the objective's output ([N] or [N, C]) of a raw
        feature matrix over ``num_iteration`` iterations from
        ``start_iteration``, or with ``pred_leaf`` each row's leaf index in
        each of those trees ([N, trees]) (lightgbm_tpu/models/gbdt.py
        predict :2210-2238).  ``config`` (default the model's) gives the
        prediction parameters: under ``predict_device`` the stacked-tree
        route (P1, ``_device_raw_predict``) where ``_device_route_ok``,
        else the host walk of every tree (``_raw_predict``, with
        ``pred_early_stop``); both give the same bits.  The route taken
        is ``last_predict_route`` ("device" or "host"); ``pred_leaf`` is
        a host walk."""
        config = config or self.config
        # feature-major: a tree node reads one contiguous column
        X = np.asfortranarray(X, dtype=np.float64)
        C = self.num_tree_per_iteration
        start = min(max(start_iteration, 0), self.iter_)
        end = self._end_iteration(num_iteration, start)
        trees = range(start * C, end * C)
        if pred_leaf:
            self.last_predict_route = "host"
            leaves = np.zeros((X.shape[0], len(trees)), dtype=np.int32)
            for j, i in enumerate(trees):
                leaves[:, j] = self.models[i].apply_raw(X)
            return leaves
        if self._device_route_ok(config):
            self.last_predict_route = "device"
            raw = self._device_raw_predict(X, trees)
        else:
            self.last_predict_route = "host"
            raw = self._raw_predict(X, start, end, config)
        if self.average_output:
            # lightgbm_tpu/models/gbdt.py:2231-2234
            raw = raw / max(len(trees) // C, 1)
        raw = self._layout(raw)
        if raw_score or self.objective is None:
            return raw.T
        return self.objective.convert_output(raw).T

    def _init_raw(self, n: int) -> np.ndarray:
        """[C, n] f64: each class's boost-from-average score, added to 0.0
        as the walks start."""
        raw = np.zeros((self.num_tree_per_iteration, n), dtype=np.float64)
        for k in range(self.num_tree_per_iteration):
            raw[k] += self.init_scores[k]
        return raw

    def _early_stop(self, config: Config) -> bool:
        """Whether prediction stops rows early (``pred_early_stop``): only
        for binary, cross-entropy and multiclass models, as the reference
        instantiates it (lightgbm_tpu/models/gbdt.py:2090-2093)."""
        C = self.num_tree_per_iteration
        kind_ok = C > 1 or getattr(self.objective, "name", "") in (
            "binary", "cross_entropy", "xentropy")
        return (bool(config.pred_early_stop)
                and config.pred_early_stop_freq > 0 and kind_ok)

    def _raw_predict(self, X: np.ndarray, start: int, end: int,
                     config: Config) -> np.ndarray:
        """[C, N] f64 raw scores of iterations [start, end) by the host
        walk; with ``pred_early_stop`` a row stops after every
        ``pred_early_stop_freq`` iterations once its margin (binary: 2 |raw|,
        multiclass: top1 - top2) exceeds ``pred_early_stop_margin``
        (prediction_early_stop.cpp; lightgbm_tpu/models/gbdt.py:
        2080-2115)."""
        C = self.num_tree_per_iteration
        raw = self._init_raw(X.shape[0])
        if not self._early_stop(config):
            for i in range(start * C, end * C):
                raw[i % C] += self.models[i].predict_raw(X)
            return raw
        freq = config.pred_early_stop_freq
        thr = float(config.pred_early_stop_margin)
        active = np.ones(X.shape[0], dtype=bool)
        for it in range(start, end):
            if not active.any():
                break
            Xa = X[active]
            for k in range(C):
                raw[k, active] += self.models[it * C + k].predict_raw(Xa)
            if (it + 1 - start) % freq == 0:
                sub = raw[:, active]
                if C == 1:
                    margin = 2.0 * np.abs(sub[0])
                else:
                    top2 = np.partition(sub, C - 2, axis=0)
                    margin = top2[-1] - top2[-2]
                idx = np.nonzero(active)[0]
                active[idx[margin > thr]] = False
        return raw

    def _device_route_ok(self, config: Config) -> bool:
        """A model with no bound training set (a loaded one) has no bin
        mappers to bin rows by: the host walk."""
        return False

    def feature_importance(self, importance_type: str = "split",
                           iteration: int = -1) -> np.ndarray:
        """Split counts ("split") or summed split gains ("gain") per
        original feature (gbdt.h FeatureImportance)."""
        if importance_type not in ("split", "gain"):
            raise LightGBMError(f"importance_type must be 'split' or "
                                f"'gain', got {importance_type!r}")
        out = np.zeros(self.max_feature_idx + 1, dtype=np.float64)
        for tree in self.models[:self._end_iteration(iteration)
                                * self.num_tree_per_iteration]:
            for i in range(tree.num_leaves - 1):
                f = int(tree.split_feature[i])
                if importance_type == "split":
                    out[f] += 1
                else:
                    out[f] += max(float(tree.split_gain[i]), 0.0)
        return out


class GBDT(TreeEnsemble):
    """``fused_route`` picks the segment grower's kernels (K3, or K2 + K1
    when False; None: K3, and K2 + K1 under ``packed_acc``, as the JAX
    growers choose without LIGHTGBM_TPU_FUSED_PACKED); ``frontier_tier``
    the frontier grower's (None, "off", "k1" or "fusedk": FrontierGrower),
    and is given only with ``tpu_tree_impl=frontier``; ``packed4`` the
    training bins' layout (None: two columns a byte exactly when the bin
    axis is at most 16, as the JAX package picks it,
    lightgbm_tpu/models/gbdt.py:547-565; False: one column a byte; True:
    packed, which needs <= 16 bins).  ``packed_acc`` feeds the histogram
    kernels the packed-accumulator stream, quantized once a tree at
    ``packed_acc_bits`` (in [2, 15]; JAX's LIGHTGBM_TPU_PACKED_ACC=force
    and LIGHTGBM_TPU_PACKED_BITS, read there and never here): no
    self-check, no fallback.  Multiclass roots keep K5's fixed-point
    channels, as in JAX.  ``objective`` None (objective "none") trains on
    the gradients the caller hands ``train_one_iter``."""

    def __init__(self, config: Config, train_set: TorchDataset, objective,
                 fused_route: Optional[bool] = None, frontier_tier=None,
                 packed4: Optional[bool] = None, packed_acc: bool = False,
                 packed_acc_bits: int = 8):
        self.config = config
        self.device = resolve_device(config)
        self.objective = objective
        self.num_tree_per_iteration = (
            objective.num_tree_per_iteration if objective is not None
            else max(1, config.num_class))
        if config.tpu_tree_impl != "frontier" and frontier_tier is not None:
            raise LightGBMError("frontier_tier is given, but "
                                "tpu_tree_impl is not 'frontier'")
        self.packed_acc = bool(packed_acc)
        self.packed_acc_bits = check_packed_acc_bits(packed_acc_bits)
        self._fused_route = (not self.packed_acc if fused_route is None
                             else bool(fused_route))
        self._frontier_tier = frontier_tier
        self._packed4 = packed4
        self.shrinkage_rate = config.learning_rate
        self.models: List[Tree] = []
        self.iter_ = 0
        self.iter_seconds: List[float] = []   # wall time of each iteration
        self.renew_seconds: List[float] = []  # each tree's leaf renewal
        self.init_scores = [0.0] * self.num_tree_per_iteration
        self.valid_sets: List[Tuple[str, TorchDataset]] = []
        # raw scores of each valid set, [N] (C = 1) or [C, N]
        self.valid_scores: List[np.ndarray] = []
        self.train_set: Optional[TorchDataset] = None
        self.reset_train_data(train_set)
        self.setup_metrics()

    def reset_train_data(self, train_set: TorchDataset) -> None:
        """Train on ``train_set`` from here on (GBDT::ResetTrainingData;
        lightgbm_tpu/models/gbdt.py reset_train_data :464-741): its bins
        must align with the current training set's.  The device state,
        the grower and the sampling streams start anew; the training score
        is the current model's replay on the new rows (``_replay_scores``)
        once a tree exists, else the rows' init scores."""
        if self.train_set is not None and train_set is not self.train_set:
            self.train_set.check_align(train_set)
        config = self.config
        self.train_set = train_set
        self.num_data = train_set.num_data
        self.feature_names = list(train_set.feature_names)
        self.max_feature_idx = train_set.num_total_features - 1
        if self.objective is not None:
            self.objective.init(train_set.metadata, self.num_data,
                                self.device)
        # the features the model has split on (CEGB's coupled cost), from
        # the first tree on these rows (lightgbm_tpu/models/gbdt.py:478)
        self._cegb_used = np.zeros(train_set.num_used_features)
        self.fmeta = build_feature_meta(train_set, self.device, config,
                                        self._cegb_used)
        # P1's feature tables on the host: the training set's column
        # layout (its device bins and valid sets'), one column a feature
        # (predict-time bins)
        self.route_tables = dataset_tables(train_set)
        # the kernels' bin axis: the widest column (an EFB group's bins)
        self.num_bins = _round_up_pow2(max(train_set.max_column_bin, 2))
        # 4-bit packing: two columns a byte where the bin axis is <= 16
        self.packed4 = (self.num_bins <= 16 if self._packed4 is None
                        else bool(self._packed4))
        if self.packed4 and self.num_bins > 16:
            raise LightGBMError(f"packed4 needs a bin axis of at most 16, "
                                f"this dataset's is {self.num_bins}")
        rb = block_rows(config, self.num_data)
        self.bins = train_set.device_bins(rb, self.device, self.packed4)
        npad = self.bins.shape[1]
        # the rows in the bag (1) or out of it (0); pad rows 0.  Updated in
        # place by _bagging
        self.member = torch.zeros(npad, dtype=torch.float32,
                                  device=self.device)
        self.member[:self.num_data] = 1.0
        self._bag_rng = np.random.RandomState(config.bagging_seed)
        self._feat_rng = np.random.RandomState(config.feature_fraction_seed)
        # the threefry key, on the host (a key is two words; the draws
        # from it run on the device)
        self._key = random.prng_key(config.seed)
        self._masked = (config.feature_fraction < 1.0
                        or config.feature_fraction_bynode < 1.0)
        forced_plan = ()
        if config.forcedsplits_filename:
            forced_plan = build_forced_plan(train_set,
                                            config.forcedsplits_filename,
                                            config.num_leaves)
        self.tree_impl = resolve_tree_impl(config, forced_plan)
        params = GrowerParams(
            num_leaves=config.num_leaves, max_depth=config.max_depth,
            feature_fraction_bynode=config.feature_fraction_bynode,
            split=SplitParams(
                lambda_l1=config.lambda_l1, lambda_l2=config.lambda_l2,
                max_delta_step=config.max_delta_step,
                min_data_in_leaf=float(config.min_data_in_leaf),
                min_sum_hessian_in_leaf=config.min_sum_hessian_in_leaf,
                min_gain_to_split=config.min_gain_to_split,
                cat_smooth=config.cat_smooth, cat_l2=config.cat_l2,
                max_cat_threshold=config.max_cat_threshold,
                max_cat_to_onehot=config.max_cat_to_onehot,
                min_data_per_group=config.min_data_per_group,
                has_cat=train_set.has_categorical),
            packed4=self.packed4, num_columns=train_set.num_columns,
            packed_acc=self.packed_acc,
            packed_acc_bits=self.packed_acc_bits,
            use_monotone=self.fmeta.monotone is not None,
            cegb_tradeoff=float(config.cegb_tradeoff),
            cegb_penalty_split=float(config.cegb_penalty_split),
            use_cegb_coupled=bool(config.cegb_penalty_feature_coupled),
            use_cegb_lazy=bool(config.cegb_penalty_feature_lazy),
            forced_plan=forced_plan)
        if self.tree_impl == "fused":
            self.grower = FusedGrower(self.num_bins, params, rb)
        elif self.tree_impl == "frontier":
            self.grower = FrontierGrower(
                self.num_bins, params, rb,
                _auto_frontier_k(config, train_set.num_columns,
                                 self.num_bins),
                config.tpu_frontier_gain_ratio, tier=self._frontier_tier)
        else:
            self.grower = SegmentGrower(self.num_bins, params, rb,
                                        fused_route=self._fused_route)
        score = (torch.from_numpy(self._replay_scores(train_set))
                 if self.iter_ > 0 else self._initial_score(train_set))
        self.train_score = score.to(torch.float32).to(self.device)
        # a stopped model may find splits again on new rows; a replayed
        # score holds the boost-from-average already
        self._stop = False
        self._boosted_from_average = self.iter_ > 0

    def reset_config(self, config: Config) -> None:
        """Train on from ``config`` (the C API's ResetParameter): its
        learning rate and metrics from the next iteration on."""
        self.config = config
        self.shrinkage_rate = config.learning_rate
        self.setup_metrics()

    def _metrics_for(self, dataset: TorchDataset) -> list:
        ms = [create_metric(m, self.config) for m in self.metric_names]
        for m in ms:
            m.init(dataset.metadata, dataset.num_data)
        return ms

    def setup_metrics(self) -> None:
        """The metrics of ``config.metric`` (else the objective's own),
        bound to the training set and to each valid set
        (lightgbm_tpu/models/gbdt.py setup_metrics)."""
        config = self.config
        self.metric_names = config.metric or (
            [DEFAULT_METRIC[config.objective]]
            if config.objective in DEFAULT_METRIC else [])
        self.train_metrics = self._metrics_for(self.train_set)
        self.valid_metrics = [self._metrics_for(vset)
                              for _, vset in self.valid_sets]

    def _initial_score(self, dataset: TorchDataset) -> torch.Tensor:
        """[C, N] f64: the dataset's init scores (class-major), else
        zeros (lightgbm_tpu/models/gbdt.py:725-731, :936-939)."""
        C = self.num_tree_per_iteration
        init = dataset.metadata.init_score
        if init is None:
            return torch.zeros((C, dataset.num_data), dtype=torch.float64)
        init = np.asarray(init, dtype=np.float64)
        if init.size != C * dataset.num_data:
            raise LightGBMError(
                f"init_score has {init.size} values, expected "
                f"{C} x {dataset.num_data}")
        return torch.from_numpy(init.reshape(C, dataset.num_data).copy())

    # ------------------------------------------------------------ walks
    def _walks_on_card(self) -> bool:
        """Whether the training loop's tree walks (valid scores, replay,
        rollback, DART's drops, init_model's seeding) run as P1 over the
        device bins (a card booster) or as the host walk over the host
        bins (a CPU booster).  Both give the same bits."""
        return self.device.type == "cuda"

    def _card_walk(self, dataset: TorchDataset, trees: List[Tree],
                   classes: List[int], out: torch.Tensor,
                   bins: Optional[torch.Tensor] = None) -> torch.Tensor:
        """P1: ``out[classes[i]] += trees[i]``'s leaf values over
        ``bins``, in place; ``out`` [C, N] float64 on the card.  By
        default ``bins`` are ``dataset``'s device bins (the training set's
        padded matrix, or the set's own [G, N] copy, uploaded once), in
        the training set's column layout (its EFB tables); given ``bins``
        are predict-time bins of raw rows, one column a feature.  The
        training set's bins are read as they are held, packed or not; a
        valid set's keep one column a byte."""
        if not trees:
            return out
        tables = (None, None)
        packed4 = False
        host_tables = self.route_tables[1]
        if bins is None:
            packed4 = self.packed4 and dataset is self.train_set
            bins = (self.bins if dataset is self.train_set
                    else dataset.device_bins(1, self.device))
            tables = (self.fmeta.feat_group, self.fmeta.feat_offset)
            host_tables = self.route_tables[0]
        stack = TreeStack(trees, classes, dataset.num_used_features,
                          self.device, host_tables)
        return route_trees(bins, stack, self.fmeta.num_bin,
                           self.fmeta.default_bin, out, *tables,
                           packed4=packed4)

    def _card_delta(self, dataset: TorchDataset, trees: List[Tree],
                    classes: List[int]) -> torch.Tensor:
        """[C, N] float64 on the card: each class's sum of its ``trees``'
        leaf values from -0.0, which adds nothing to any value (x + -0.0
        is x, bit for bit): the host walk's ``tree.predict_binned`` where
        a class has one tree, -0.0 where it has none."""
        out = torch.full((self.num_tree_per_iteration, dataset.num_data),
                         -0.0, dtype=torch.float64, device=self.device)
        return self._card_walk(dataset, trees, classes, out)

    def _replay_scores(self, dataset: TorchDataset) -> np.ndarray:
        """[C, N] f64 raw scores of the current model on ``dataset``: its
        init scores, every tree walked over its binned rows, then the
        boost-from-average scores (lightgbm_tpu/models/gbdt.py
        _replay_model_scores; gbdt.cpp AddValidDataset)."""
        C = self.num_tree_per_iteration
        score = self._initial_score(dataset).numpy()
        trees = self.models[:self.iter_ * C]
        if self._walks_on_card():
            score = self._card_walk(
                dataset, trees, [i % C for i in range(len(trees))],
                torch.from_numpy(score).to(self.device)).cpu().numpy()
        else:
            infos = dataset.feature_infos()
            for i, tree in enumerate(trees):
                score[i % C] += tree.predict_binned(dataset.bins_t, infos)
        for k in range(C):
            score[k] += self.init_scores[k]
        return score

    def add_valid(self, name: str, dataset: TorchDataset) -> None:
        """A valid set, scored by the trees grown so far."""
        self.valid_sets.append((name, dataset))
        self.valid_scores.append(self._layout(self._replay_scores(dataset)))
        self.valid_metrics.append(self._metrics_for(dataset))

    # ---------------------------------------------------------- predict
    def _device_route_ok(self, config: Config) -> bool:
        """Whether predict takes the stacked-tree route (P1) instead of the
        host walk (lightgbm_tpu/models/gbdt.py _device_route_ok
        :2124-2154): ``predict_device`` "on", or "auto" on a card booster;
        a training set with bin mappers and used features; every tree
        bin-aligned, and routing binned rows as the raw walk routes them
        (``Tree.bins_exact``: not so for a seeded tree grown on other
        rows); and no per-row early stop (a host-only loop)."""
        pd = config.predict_device
        if pd == "off" or (pd == "auto" and self.device.type != "cuda"):
            return False
        ds = self.train_set
        if ds is None or not ds.bin_mappers or ds.num_used_features == 0:
            return False
        if self._early_stop(config):
            return False
        return all(t.bins_exact for t in self.models)

    def _device_raw_predict(self, X: np.ndarray, trees: range) -> np.ndarray:
        """[C, N] f64 raw scores of ``trees`` on the booster's device:
        the rows binned on the host (``bin_rows``, unseen categories -1),
        uploaded as i16, routed and summed by P1 from the boost-from-
        average scores in the host walk's order, then fetched
        (lightgbm_tpu/models/gbdt.py _device_raw_predict :2156-2208)."""
        C = self.num_tree_per_iteration
        dev = self.device
        bins = torch.from_numpy(bin_rows(self.train_set, X)).to(dev)
        out = torch.from_numpy(self._init_raw(X.shape[0])).to(dev)
        route_trees(bins, TreeStack([self.models[i] for i in trees],
                                    [i % C for i in trees],
                                    self.train_set.num_used_features, dev,
                                    self.route_tables[1]),
                    self.fmeta.num_bin, self.fmeta.default_bin, out)
        return out.cpu().numpy()

    # -------------------------------------------------------------- train
    def _boost_from_average(self) -> None:
        if self._boosted_from_average:
            return
        self._boosted_from_average = True
        if (self.objective is None or not self.config.boost_from_average
                or self.train_set.metadata.init_score is not None):
            return
        C = self.num_tree_per_iteration
        for k in range(C):
            init = self.objective.boost_from_score(k)
            if abs(init) > 1e-15:
                self.init_scores[k] = init
                self.train_score[k] += init
                for vs in self.valid_scores:
                    vs.reshape(C, -1)[k] += init

    def _gradients(self):
        """[C, Npad] gradients and hessians; pad rows are 0."""
        C = self.num_tree_per_iteration
        if C == 1:
            grad, hess = self.objective.get_gradients(self.train_score[0])
            grad, hess = grad[None], hess[None]
        else:
            grad, hess = self.objective.get_gradients(self.train_score)
        pad = self.bins.shape[1] - self.num_data
        if pad:
            grad = torch.nn.functional.pad(grad, (0, pad))
            hess = torch.nn.functional.pad(hess, (0, pad))
        return grad, hess

    def _given_gradients(self, grad: np.ndarray, hess: np.ndarray):
        """A caller's gradients (host arrays of C x N, class-major) in
        ``_gradients``' layout: [C, Npad] on the device, pad rows 0."""
        C = self.num_tree_per_iteration
        pad = self.bins.shape[1] - self.num_data

        def upload(a):
            t = torch.from_numpy(np.ascontiguousarray(
                np.asarray(a, dtype=np.float32).reshape(C, self.num_data)))
            return torch.nn.functional.pad(t.to(self.device), (0, pad))

        return upload(grad), upload(hess)

    # ------------------------------------------------------------ sampling
    # GOSS folds its row key from the key stream, so it splits the key
    # each tree even without by-node masks
    _draws_keys = False

    def _set_bag(self, mask: torch.Tensor) -> None:
        """The bag ([num_data], 1 in, 0 out) into ``member``'s rows, in
        place; pad rows stay 0."""
        self.member[:self.num_data].copy_(mask)

    def _bagging(self, iter_idx: int, grad: torch.Tensor,
                 hess: torch.Tensor):
        """A new bag every ``bagging_freq`` iterations, balanced over
        label > 0 when pos_/neg_bagging_fraction < 1 (gbdt.cpp:186-240,
        lightgbm_tpu/models/gbdt.py:971-1002); the draw is the JAX
        package's numpy one, so the same seed draws the same rows.
        Returns (grad, hess); GOSS overrides it and rescales them."""
        cfg = self.config
        need = (cfg.bagging_freq > 0
                and (cfg.bagging_fraction < 1.0
                     or cfg.pos_bagging_fraction < 1.0
                     or cfg.neg_bagging_fraction < 1.0))
        if not need or iter_idx % cfg.bagging_freq != 0:
            return grad, hess
        n = self.num_data
        mask = np.zeros(n, dtype=np.float32)
        if cfg.pos_bagging_fraction < 1.0 or cfg.neg_bagging_fraction < 1.0:
            lab = np.asarray(self.train_set.metadata.label)
            pos = np.nonzero(lab > 0)[0]
            neg = np.nonzero(lab <= 0)[0]
            kp = int(len(pos) * cfg.pos_bagging_fraction)
            kn = int(len(neg) * cfg.neg_bagging_fraction)
            if kp > 0:
                mask[self._bag_rng.choice(pos, kp, replace=False)] = 1.0
            if kn > 0:
                mask[self._bag_rng.choice(neg, kn, replace=False)] = 1.0
        else:
            k = int(n * cfg.bagging_fraction)
            mask[self._bag_rng.choice(n, k, replace=False)] = 1.0
        self._set_bag(torch.from_numpy(mask).to(self.device))
        return grad, hess

    def _tree_feature_mask(self) -> Optional[torch.Tensor]:
        """A tree's feature mask ([F] float32 on the device; None without
        feature fraction): max(1, int(F x feature_fraction)) features drawn
        from the numpy stream (GetUsedFeatures,
        serial_tree_learner.cpp:273-321; lightgbm_tpu/models/gbdt.py:
        1004-1015), all of them when only the by-node fraction is set."""
        if not self._masked:
            return None
        F = self.train_set.num_used_features
        frac = self.config.feature_fraction
        if frac >= 1.0:
            mask = np.ones(F, dtype=np.float32)
        else:
            mask = np.zeros(F, dtype=np.float32)
            mask[self._feat_rng.choice(F, max(1, int(F * frac)),
                                       replace=False)] = 1.0
        return torch.from_numpy(mask).to(self.device)

    def _tree_key(self) -> Optional[torch.Tensor]:
        """The next tree's threefry key (key, sub = split(key)), where a
        draw uses the key stream; else None."""
        if not (self._draws_keys
                or self.config.feature_fraction_bynode < 1.0):
            return None
        self._key, sub = random.split(self._key)
        return sub

    def train_one_iter(self, grad: Optional[np.ndarray] = None,
                       hess: Optional[np.ndarray] = None) -> bool:
        """One boosting iteration, C trees, from the objective's gradients
        or the given ones; True when training should stop (no tree could
        split, LGBM_BoosterUpdateOneIter semantics)."""
        if self._stop:
            return True
        C = self.num_tree_per_iteration
        if self.train_set.num_used_features == 0:
            # every feature is trivial: a constant model (gbdt.cpp:543-551)
            self.models.extend(Tree(1) for _ in range(C))
            self.iter_ += 1
            self._stop = True
            return True
        t0 = time.perf_counter()
        self._boost_from_average()
        if grad is not None and hess is not None:
            grad, hess = self._given_gradients(grad, hess)
        elif self.objective is None:
            raise LightGBMError("No objective and no custom gradients")
        else:
            grad, hess = self._gradients()
        grad, hess = self._bagging(self.iter_, grad, hess)
        roots = [None] * C
        if C > 1 and self.tree_impl != "fused":
            # every class tree's root histogram in one K5 launch; each
            # class's packed channels and fixed-point scales go on to its
            # tree's kernels, so the root and the splits share one scale
            w8C = pack_channel_sets(grad, hess, self.member)
            scales = class_scales(w8C)
            hists = histogram_all(self.bins, w8C, self.num_bins, scales,
                                  self.packed4)
            roots = [(w8C[8 * k:8 * k + 8], scales[k], hists[k])
                     for k in range(C)]
        trees = []
        for k in range(C):
            fmask = self._tree_feature_mask()
            key = self._tree_key()
            arrays, leaf_id = self.grower.grow(
                self.bins, grad[k], hess[k], self.member, self.fmeta,
                root=roots[k], feature_mask=fmask, key=key)
            if arrays.num_leaves <= 1:
                trees.append(Tree(1))
                continue
            row = self.train_score[k]
            if self.objective is not None \
                    and self.objective.is_renew_tree_output:
                tree, table = self._renewed_tree(arrays, leaf_id, row)
            else:
                tree = Tree.from_grown(arrays, self.train_set,
                                       self.shrinkage_rate)
                table = np.float32(self.shrinkage_rate) * arrays.leaf_value
            score_gather_add(row, leaf_id[:self.num_data],
                             torch.from_numpy(table).to(self.device),
                             out=row)
            trees.append(tree)
        if all(t.num_leaves <= 1 for t in trees):
            log_warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            self._stop = True
            return True
        self._add_valid_trees(trees)
        self.models.extend(trees)
        self._note_trees(trees)
        self.iter_ += 1
        self._sync()
        self.iter_seconds.append(time.perf_counter() - t0)
        return False

    def _note_trees(self, trees: List[Tree]) -> None:
        """Mark the features the iteration's trees split on, which the
        next tree's CEGB coupled cost waives (is_feature_used_in_split_,
        serial_tree_learner.h:169; lightgbm_tpu/models/gbdt.py _note_trees
        :1433-1448).  Written into ``fmeta.cegb_used0`` in place: the
        segment grower copies it into its graphs' state a tree."""
        if self.fmeta.cegb_used0 is None or \
                not self.config.cegb_penalty_feature_coupled:
            return
        changed = False
        for t in trees:
            for f in np.unique(t.split_feature_inner[:t.num_leaves - 1]):
                if not self._cegb_used[f]:
                    self._cegb_used[f] = 1.0
                    changed = True
        if changed:
            self.fmeta.cegb_used0.copy_(torch.from_numpy(
                self._cegb_used.astype(np.float32)))

    def _sync(self) -> None:
        """Wait for the device's queued work (a wall clock's end)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _renewed_tree(self, arrays, leaf_id: torch.Tensor,
                      score: torch.Tensor):
        """A grown tree whose leaves the objective refits from its rows'
        residuals against ``score`` (the class's training score before
        this tree), then the learning rate, and its f32 leaf table for the
        score update (lightgbm_tpu/models/gbdt.py:1698-1713)."""
        t0 = time.perf_counter()
        tree = Tree.from_arrays(arrays, self.train_set)
        tree.leaf_value = np.array(self.objective.renew_tree_output(
            tree.leaf_value, leaf_id[:self.num_data], score),
            dtype=np.float64)[:tree.num_leaves]
        tree.apply_shrinkage(self.shrinkage_rate)
        self.renew_seconds.append(time.perf_counter() - t0)
        return tree, tree.leaf_value.astype(np.float32)

    def _add_valid_trees(self, trees: List[Tree]) -> None:
        """Each valid set's f64 scores += the iteration's trees that split
        (tree k is class k): one walk a set, host or card (one fetched
        delta a set)."""
        C = self.num_tree_per_iteration
        grown = [k for k, t in enumerate(trees) if t.num_leaves > 1]
        if not grown:
            return
        infos = self.train_set.feature_infos()
        for (_, vset), vscore in zip(self.valid_sets, self.valid_scores):
            v2 = vscore.reshape(C, -1)
            if self._walks_on_card():
                v2 += self._card_delta(vset, [trees[k] for k in grown],
                                       grown).cpu().numpy()
                continue
            for k in grown:
                v2[k] += trees[k].predict_binned(vset.bins_t, infos)

    def rollback_one_iter(self) -> None:
        """Remove the last iteration's trees and their scores
        (gbdt.cpp:553-576, lightgbm_tpu/models/gbdt.py:2050-2068): each
        tree that split walked over the training bins, its f32 delta
        subtracted from the device training score, its f64 delta from the
        valid scores."""
        if self.iter_ <= 0:
            return
        C = self.num_tree_per_iteration
        trees = self.models[-C:]
        del self.models[-C:]
        self.iter_ -= 1
        grown = [k for k, t in enumerate(trees) if t.num_leaves > 1]
        if self._walks_on_card() and grown:
            picked = [trees[k] for k in grown]
            delta = self._card_delta(self.train_set, picked, grown)
            for k in grown:
                self.train_score[k] -= delta[k].to(torch.float32)
            for (_, vset), vscore in zip(self.valid_sets, self.valid_scores):
                delta = self._card_delta(vset, picked, grown).cpu().numpy()
                for k in grown:
                    vscore.reshape(C, -1)[k] -= delta[k]
            return
        infos = self.train_set.feature_infos()
        for k in reversed(grown):
            tree = trees[k]
            delta = tree.predict_binned(self.train_set.bins_t, infos)
            self.train_score[k] -= torch.from_numpy(
                delta.astype(np.float32)).to(self.device)
            for (_, vset), vscore in zip(self.valid_sets, self.valid_scores):
                vscore.reshape(C, -1)[k] -= tree.predict_binned(vset.bins_t,
                                                                infos)

    # --------------------------------------------------------------- eval
    def _eval_score(self, score: np.ndarray, metrics
                    ) -> List[Tuple[str, float, bool]]:
        """(name, value, higher_better) of each metric; a ranking metric
        gives one "name@k" a position (lightgbm_tpu/models/gbdt.py
        _eval_score)."""
        out = []
        for m in metrics:
            if hasattr(m, "eval_multi"):
                out.extend((f"{m.name}@{k}", float(v), m.higher_better)
                           for k, v in zip(m.eval_at, m.eval_multi(
                               score, self.objective)))
            else:
                out.append((m.name, float(m.eval(score, self.objective)),
                            m.higher_better))
        return out

    def eval_train(self) -> List[Tuple[str, float, bool]]:
        score = self._layout(
            self.train_score.cpu().numpy().astype(np.float64))
        return self._eval_score(score, self.train_metrics)

    def eval_valid(self, i: int) -> List[Tuple[str, float, bool]]:
        """The metrics of valid set ``i``."""
        return self._eval_score(self.valid_scores[i], self.valid_metrics[i])
