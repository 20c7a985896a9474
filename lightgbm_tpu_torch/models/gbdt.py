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
from ..ops.histogram import (class_scales, frontier_width, histogram_all,
                             pack_channel_sets)
from ..ops.score import score_gather_add
from ..ops.split import FeatureMeta, SplitParams
from ..utils import random
from ..utils.log import LightGBMError, log_warning
from .grower import GrowerParams
from .grower_frontier import FrontierGrower
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
    ``num_columns`` is the bin matrix's row count (the port has no EFB)."""
    if config.tpu_frontier_width > 0:
        return config.tpu_frontier_width
    return min(frontier_width(num_columns, num_bins),
               max(1, -(-max(2, config.num_leaves) // 16)))


def build_feature_meta(dataset: TorchDataset,
                       device: torch.device) -> FeatureMeta:
    infos = dataset.feature_infos()

    def col(name):
        return torch.tensor([getattr(i, name) for i in infos],
                            dtype=torch.int32, device=device)

    is_cat = None
    if dataset.has_categorical:
        is_cat = torch.tensor([bool(i.is_cat) for i in infos],
                              dtype=torch.bool, device=device)
    return FeatureMeta(num_bin=col("num_bin"),
                       missing_type=col("missing_type"),
                       default_bin=col("default_bin"), is_cat=is_cat)


class TreeEnsemble:
    """A model as prediction sees it: the trees (tree i is class i % C),
    the boost-from-average init scores, the objective's link (None: raw
    scores), and whether a prediction averages its iterations' trees
    (``average_output``: a random forest).  GBDT trains one;
    serialization.LoadedBoosting is one read from a model text."""

    average_output = False
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
                start_iteration: int = 0) -> np.ndarray:
        """Raw scores or the objective's output ([N] or [N, C]) of a raw
        feature matrix over ``num_iteration`` iterations from
        ``start_iteration``, or with ``pred_leaf`` each row's leaf index in
        each of those trees ([N, trees]).  A host walk of every tree
        (lightgbm_tpu/models/gbdt.py _raw_predict, predict)."""
        # feature-major: a tree node reads one contiguous column
        X = np.asfortranarray(X, dtype=np.float64)
        C = self.num_tree_per_iteration
        start = min(max(start_iteration, 0), self.iter_)
        trees = range(start * C, self._end_iteration(num_iteration,
                                                     start) * C)
        if pred_leaf:
            leaves = np.zeros((X.shape[0], len(trees)), dtype=np.int32)
            for j, i in enumerate(trees):
                leaves[:, j] = self.models[i].apply_raw(X)
            return leaves
        raw = np.zeros((C, X.shape[0]), dtype=np.float64)
        for k in range(C):
            raw[k] += self.init_scores[k]
        for i in trees:
            raw[i % C] += self.models[i].predict_raw(X)
        if self.average_output:
            # lightgbm_tpu/models/gbdt.py:2231-2234
            raw = raw / max(len(trees) // C, 1)
        raw = self._layout(raw)
        if raw_score or self.objective is None:
            return raw.T
        return self.objective.convert_output(raw).T

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
    when False); ``frontier_tier`` the frontier grower's (None, "off",
    "k1" or "fusedk": FrontierGrower), and is given only with
    ``tpu_tree_impl=frontier``.  ``objective`` None (objective "none")
    trains on the gradients the caller hands ``train_one_iter``."""

    def __init__(self, config: Config, train_set: TorchDataset, objective,
                 fused_route: bool = True, frontier_tier=None):
        self.config = config
        self.device = resolve_device(config)
        self.objective = objective
        self.num_tree_per_iteration = (
            objective.num_tree_per_iteration if objective is not None
            else max(1, config.num_class))
        self.train_set = train_set
        self.num_data = train_set.num_data
        self.feature_names = list(train_set.feature_names)
        self.max_feature_idx = train_set.num_total_features - 1
        self.shrinkage_rate = config.learning_rate
        self.models: List[Tree] = []
        self.iter_ = 0
        self.iter_seconds: List[float] = []   # wall time of each iteration
        self.renew_seconds: List[float] = []  # each tree's leaf renewal
        self.init_scores = [0.0] * self.num_tree_per_iteration
        self._boosted_from_average = False
        self._stop = False
        if objective is not None:
            objective.init(train_set.metadata, self.num_data, self.device)

        self.fmeta = build_feature_meta(train_set, self.device)
        self.num_bins = _round_up_pow2(max(train_set.max_num_bin, 2))
        rb = block_rows(config, self.num_data)
        self.bins = train_set.device_bins(rb, self.device)
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
                has_cat=train_set.has_categorical))
        if config.tpu_tree_impl == "frontier":
            self.grower = FrontierGrower(
                self.num_bins, params, rb,
                _auto_frontier_k(config, self.bins.shape[0], self.num_bins),
                config.tpu_frontier_gain_ratio, tier=frontier_tier)
        elif frontier_tier is not None:
            raise LightGBMError("frontier_tier is given, but "
                                "tpu_tree_impl is not 'frontier'")
        else:
            self.grower = SegmentGrower(self.num_bins, params, rb,
                                        fused_route=fused_route)
        self.train_score = self._initial_score(train_set).to(
            torch.float32).to(self.device)
        self.valid_sets: List[Tuple[str, TorchDataset]] = []
        # raw scores of each valid set, [N] (C = 1) or [C, N]
        self.valid_scores: List[np.ndarray] = []
        names = config.metric or (
            [DEFAULT_METRIC[config.objective]]
            if config.objective in DEFAULT_METRIC else [])
        self.metric_names = names
        self.train_metrics = [create_metric(m, config) for m in names]
        for m in self.train_metrics:
            m.init(train_set.metadata, self.num_data)
        self.valid_metrics = []

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

    def _replay_scores(self, dataset: TorchDataset) -> np.ndarray:
        """[C, N] f64 raw scores of the current model on ``dataset``: its
        init scores, every tree walked over its binned rows, then the
        boost-from-average scores (lightgbm_tpu/models/gbdt.py
        _replay_model_scores; gbdt.cpp AddValidDataset)."""
        C = self.num_tree_per_iteration
        score = self._initial_score(dataset).numpy()
        infos = dataset.feature_infos()
        for i, tree in enumerate(self.models[:self.iter_ * C]):
            score[i % C] += tree.predict_binned(dataset.bins_t, infos)
        for k in range(C):
            score[k] += self.init_scores[k]
        return score

    def add_valid(self, name: str, dataset: TorchDataset) -> None:
        """A valid set, scored by the trees grown so far."""
        self.valid_sets.append((name, dataset))
        self.valid_scores.append(self._layout(self._replay_scores(dataset)))
        ms = [create_metric(m, self.config) for m in self.metric_names]
        for m in ms:
            m.init(dataset.metadata, dataset.num_data)
        self.valid_metrics.append(ms)

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
        if C > 1:
            # every class tree's root histogram in one K5 launch; each
            # class's packed channels and fixed-point scales go on to its
            # tree's kernels, so the root and the splits share one scale
            w8C = pack_channel_sets(grad, hess, self.member)
            scales = class_scales(w8C)
            hists = histogram_all(self.bins, w8C, self.num_bins, scales)
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
        infos = self.train_set.feature_infos()
        for (_, vset), vscore in zip(self.valid_sets, self.valid_scores):
            v2 = vscore.reshape(C, -1)
            for k, tree in enumerate(trees):
                if tree.num_leaves > 1:
                    v2[k] += tree.predict_binned(vset.bins_t, infos)
        self.models.extend(trees)
        self.iter_ += 1
        self._sync()
        self.iter_seconds.append(time.perf_counter() - t0)
        return False

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

    def rollback_one_iter(self) -> None:
        """Remove the last iteration's trees and their scores
        (gbdt.cpp:553-576, lightgbm_tpu/models/gbdt.py:2050-2068): each
        tree walked over the host bins, its f32 delta subtracted from the
        device training score, its f64 delta from the valid scores."""
        if self.iter_ <= 0:
            return
        C = self.num_tree_per_iteration
        infos = self.train_set.feature_infos()
        for k in reversed(range(C)):
            tree = self.models.pop()
            if tree.num_leaves <= 1:
                continue
            delta = tree.predict_binned(self.train_set.bins_t, infos)
            self.train_score[k] -= torch.from_numpy(
                delta.astype(np.float32)).to(self.device)
            for (_, vset), vscore in zip(self.valid_sets, self.valid_scores):
                vscore.reshape(C, -1)[k] -= tree.predict_binned(vset.bins_t,
                                                                infos)
        self.iter_ -= 1

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
