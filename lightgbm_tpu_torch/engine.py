"""Training loop: train() and cv().

Counterpart of lightgbm_tpu/engine.py (train :62, CVBooster :315,
_make_n_folds :330, _agg_cv_result :370, cv :383), after the reference
python package's engine.py: a driver around Booster.update that
evaluates the valid sets after every iteration and hands the results to
the callbacks (printing, recording, early stopping).  The training set
passed as a valid set is evaluated from the training score under the
name "training".  One iteration a step: the JAX package's chunked
boosting and in-scan evaluation, its health stream and profiler window
are not ported, nor cv's ``fpreproc``.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset
from .config import resolve_alias
from .core.dataset import TorchDataset
from .models.serialization import load_trees_into


def _resolve_num_boost_round(params: Dict, num_boost_round: int) -> int:
    for k in list(params):
        if resolve_alias(k) == "num_iterations":
            num_boost_round = int(params.pop(k))
    return num_boost_round


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj: Optional[Callable] = None, feval: Optional[Callable] = None,
          init_model: Optional[Union[str, Booster]] = None,
          feature_name: str = "auto", categorical_feature: str = "auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval: Union[bool, int] = True,
          keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None) -> Booster:
    """Boost ``num_boost_round`` iterations, or until the early stop.
    ``init_model`` (a Booster or a model file) is continued: its trees
    come first and seed the scores.  The returned Booster always keeps
    its training state, as the JAX package's does
    (``keep_training_booster`` changes nothing).  ``best_iteration`` is
    the early stop's best iteration, else the last one."""
    params = dict(params or {})
    num_boost_round = _resolve_num_boost_round(params, num_boost_round)
    if fobj is not None:
        params["objective"] = "none"
    first_metric_only = bool(params.get("first_metric_only", False))

    if isinstance(init_model, str):
        init_booster = Booster(model_file=init_model)
    elif isinstance(init_model, Booster):
        init_booster = init_model
    else:
        init_booster = None

    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature

    booster = Booster(params=params, train_set=train_set)
    if init_booster is not None:
        # the raw rows when there are any (a binned TorchDataset has none)
        raw = (None if isinstance(train_set.data, TorchDataset)
               else train_set.data)
        if raw is not None:
            # a scipy matrix stays sparse: the seeding densifies it only
            # for a walk of the raw rows
            if not hasattr(raw, "tocsr") or hasattr(raw, "values"):
                raw = np.asarray(raw, dtype=np.float64)
                if raw.ndim == 1:
                    raw = raw[:, None]
            if train_set.used_indices is not None:
                raw = raw[train_set.used_indices]
        load_trees_into(booster.gbdt, init_booster.gbdt, raw_data=raw)
    train_in_valid = False
    if valid_sets:
        valid_names = valid_names or [f"valid_{i}"
                                      for i in range(len(valid_sets))]
        for vs, name in zip(valid_sets, valid_names):
            if vs is train_set:
                # evaluated from the training score (reference
                # engine.py:141-147)
                train_in_valid = True
                continue
            booster.add_valid(vs, name)
    callbacks = list(callbacks or [])
    if verbose_eval is True:
        callbacks.append(callback_mod.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval > 0:
        callbacks.append(callback_mod.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        callbacks.append(callback_mod.early_stopping(
            early_stopping_rounds, first_metric_only,
            verbose=bool(verbose_eval)))
    if evals_result is not None:
        callbacks.append(callback_mod.record_evaluation(evals_result))
    callbacks_before = sorted(
        (cb for cb in callbacks if getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))
    callbacks_after = sorted(
        (cb for cb in callbacks
         if not getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))

    for i in range(num_boost_round):
        for cb in callbacks_before:
            cb(callback_mod.CallbackEnv(
                model=booster, params=params, iteration=i,
                begin_iteration=0, end_iteration=num_boost_round,
                evaluation_result_list=None))
        should_stop = booster.update(fobj=fobj)
        evaluation_result_list = []
        if train_in_valid:
            evaluation_result_list.extend(booster.eval_train(feval))
        evaluation_result_list.extend(booster.eval_valid(feval))
        try:
            for cb in callbacks_after:
                cb(callback_mod.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=evaluation_result_list))
        except callback_mod.EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            for item in e.best_score:
                booster.best_score.setdefault(item[0], {})[item[1]] = item[2]
            break
        if should_stop:
            break
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration()
    return booster


class CVBooster:
    """The fold boosters of cv(return_cvbooster=True); a method call is
    made on each, its results listed."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler_function


def _make_n_folds(full_data: Dataset, nfold: int, seed: int,
                  stratified: bool, shuffle: bool):
    """(train rows, test rows) of each fold, the JAX package's for the
    same seed: whole queries dealt to the folds in turn (shuffled) where
    the data has query groups; else stratified by label (every nfold-th
    row of the label order), else a (shuffled) split in order."""
    num_data = full_data.num_data()
    rng = np.random.RandomState(seed)
    group = full_data.get_group()
    if group is not None:
        gidx = np.arange(len(group))
        if shuffle:
            rng.shuffle(gidx)
        bounds = np.concatenate([[0], np.cumsum(group)]).astype(np.int64)
        for f in range(nfold):
            test_rows = np.sort(np.concatenate(
                [np.arange(bounds[g], bounds[g + 1])
                 for g in gidx[f::nfold]] or [np.zeros(0, np.int64)]))
            train = np.ones(num_data, dtype=bool)
            train[test_rows] = False
            yield np.flatnonzero(train), test_rows
        return
    label = full_data.get_label()
    if stratified and label is not None:
        order = np.argsort(label, kind="stable")
        folds = [order[f::nfold] for f in range(nfold)]
    else:
        idx = np.arange(num_data)
        if shuffle:
            rng.shuffle(idx)
        folds = np.array_split(idx, nfold)
    for f in range(nfold):
        test_rows = np.sort(folds[f])
        # np.setdiff1d(np.arange(num_data), test_rows), without its sort
        train = np.ones(num_data, dtype=bool)
        train[test_rows] = False
        yield np.flatnonzero(train), test_rows


def _agg_cv_result(raw_results):
    """The folds' results -> [("cv_agg", "<set> <metric>", mean,
    higher_better, stdv)]."""
    cvmap = collections.OrderedDict()
    metric_type = {}
    for one_result in raw_results:
        for one_line in one_result:
            key = f"{one_line[0]} {one_line[1]}"
            metric_type[key] = one_line[3]
            cvmap.setdefault(key, [])
            cvmap[key].append(one_line[2])
    return [("cv_agg", k, float(np.mean(v)), metric_type[k],
             float(np.std(v))) for k, v in cvmap.items()]


def cv(params: Dict, train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, feature_name: str = "auto",
       categorical_feature: str = "auto",
       early_stopping_rounds: Optional[int] = None, verbose_eval=None,
       show_stdv: bool = True, seed: int = 0, callbacks=None,
       eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, List[float]]:
    """Cross-validation: one booster a fold, all updated in turns each
    iteration; {"<set> <metric>-mean": [...], "-stdv": [...]} over the
    folds, cut at the early stop's best iteration.  ``folds`` is a list
    of (train rows, test rows) or has a ``split`` method; by default
    ``nfold`` folds (stratified for binary and multiclass).  As in the
    JAX package, ``init_model``, ``feature_name`` and
    ``categorical_feature`` are accepted and not used."""
    params = dict(params or {})
    num_boost_round = _resolve_num_boost_round(params, num_boost_round)
    if metrics:
        params["metric"] = metrics
    if fobj is not None:
        params["objective"] = "none"
    obj_name = str(params.get("objective", "")).lower()
    if stratified and obj_name not in ("binary", "multiclass",
                                       "multiclassova"):
        stratified = False

    train_set.construct()
    if folds is None:
        folds = list(_make_n_folds(train_set, nfold, seed, stratified,
                                   shuffle))
    elif hasattr(folds, "split"):
        folds = list(folds.split(np.zeros(train_set.num_data()),
                                 train_set.get_label()))

    cvbooster = CVBooster()
    for train_rows, test_rows in folds:
        b = Booster(params=params, train_set=train_set.subset(train_rows))
        b.add_valid(train_set.subset(test_rows), "valid")
        cvbooster.append(b)

    callbacks = list(callbacks or [])
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        callbacks.append(callback_mod.early_stopping(
            early_stopping_rounds, verbose=False))
    if verbose_eval is True:
        callbacks.append(callback_mod.print_evaluation(show_stdv=show_stdv))
    elif isinstance(verbose_eval, int) and verbose_eval:
        callbacks.append(callback_mod.print_evaluation(verbose_eval,
                                                       show_stdv))
    callbacks.sort(key=lambda cb: getattr(cb, "order", 0))

    results = collections.defaultdict(list)
    for i in range(num_boost_round):
        for b in cvbooster.boosters:
            b.update(fobj=fobj)
        raw = []
        for b in cvbooster.boosters:
            one = []
            if eval_train_metric:
                one.extend(b.eval_train(feval))
            one.extend(b.eval_valid(feval))
            raw.append(one)
        agg = _agg_cv_result(raw)
        for _, key, mean, _, std in agg:
            results[key + "-mean"].append(mean)
            results[key + "-stdv"].append(std)
        try:
            for cb in callbacks:
                cb(callback_mod.CallbackEnv(
                    model=cvbooster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=agg))
        except callback_mod.EarlyStopException as e:
            cvbooster.best_iteration = e.best_iteration + 1
            for k in list(results):
                results[k] = results[k][:cvbooster.best_iteration]
            break
    if return_cvbooster:
        results["cvbooster"] = cvbooster
    return dict(results)
