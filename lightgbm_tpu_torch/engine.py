"""Training entry point.

Counterpart of lightgbm_tpu/engine.py (train :62) without callbacks: the
loop boosts, evaluates the metrics after every iteration and records
them in ``evals_result``.  The training set passed as a valid set is
evaluated from the training score under the name "training".
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .basic import Booster, Dataset
from .config import resolve_alias
from .utils.log import log_info


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          evals_result: Optional[Dict] = None) -> Booster:
    params = dict(params or {})
    for k in list(params):
        if resolve_alias(k) == "num_iterations":
            num_boost_round = int(params.pop(k))
    booster = Booster(params=params, train_set=train_set)
    train_in_valid = False
    valid_names = valid_names or [f"valid_{i}"
                                  for i in range(len(valid_sets or []))]
    for vs, name in zip(valid_sets or [], valid_names):
        if vs is train_set:
            train_in_valid = True
            continue
        booster.add_valid(vs, name)
    if evals_result is not None:
        evals_result.clear()
    for i in range(num_boost_round):
        stop = booster.update()
        results = []
        if train_in_valid:
            results += [("training", m, v)
                        for m, v, _ in booster.eval_train()]
        results += [(d, m, v) for d, m, v, _ in booster.eval_valid()]
        if evals_result is not None:
            for d, m, v in results:
                evals_result.setdefault(d, {}).setdefault(m, []).append(v)
        if results:
            log_info(f"[{i + 1}]\t" + "\t".join(
                f"{d}'s {m}: {v:g}" for d, m, v in results))
        if stop:
            break
    return booster
