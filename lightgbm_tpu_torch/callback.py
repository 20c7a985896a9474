"""Training callbacks: lightgbm_tpu/callback.py, as it is.

Reference: python-package/lightgbm/callback.py — print_evaluation (:55),
record_evaluation (:80), reset_parameter (:107), early_stopping (:154).
The callback env protocol (CallbackEnv namedtuple) matches the reference so
user callbacks port unchanged.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List

from .utils.log import log_info, log_warning


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _format_eval_result(value, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    last_seen = [-1]

    def _callback(env: CallbackEnv) -> None:
        if period <= 0 or not env.evaluation_result_list:
            return
        # fire when a period boundary was crossed since the previous call:
        # identical to (iteration + 1) % period == 0 under per-iteration
        # stepping, and never skips a boundary under chunked stepping,
        # where env.iteration advances several rounds at a time
        crossed = ((env.iteration + 1) // period
                   > (last_seen[0] + 1) // period)
        last_seen[0] = env.iteration
        if crossed:
            result = "\t".join(
                _format_eval_result(x, show_stdv)
                for x in env.evaluation_result_list)
            log_info(f"[{env.iteration + 1}]\t{result}")
    _callback.order = 10
    return _callback


log_evaluation = print_evaluation  # modern alias


def record_evaluation(eval_result: Dict) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")
    eval_result.clear()

    def _init(env: CallbackEnv) -> None:
        for item in env.evaluation_result_list:
            data_name, eval_name = item[0], item[1]
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for item in env.evaluation_result_list:
            data_name, eval_name, result = item[0], item[1], item[2]
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])
            eval_result[data_name][eval_name].append(result)
    _callback.order = 20
    return _callback


def reset_parameter(**kwargs) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        new_parameters = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        f"Length of list {key!r} has to equal "
                        "num_boost_round")
                new_param = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_param = value(env.iteration - env.begin_iteration)
            else:
                raise ValueError("Only list and callable values are "
                                 "supported as a mapping from boosting round "
                                 "index to new parameter value")
            if new_param != env.params.get(key, None):
                new_parameters[key] = new_param
        if new_parameters:
            env.model.reset_parameter(new_parameters)
            env.params.update(new_parameters)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    best_score: List = []
    best_iter: List = []
    best_score_list: List = []
    cmp_op: List = []
    enabled: List = [True]
    first_metric: List = [""]

    def _init(env: CallbackEnv) -> None:
        enabled[0] = not any(
            env.params.get(alias, "") == "dart"
            for alias in ("boosting", "boosting_type", "boost"))
        if not enabled[0]:
            log_warning("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric "
                "is required for evaluation")
        if verbose:
            log_info(f"Training until validation scores don't improve for "
                     f"{stopping_rounds} rounds")
        first_metric[0] = env.evaluation_result_list[0][1].split(" ")[-1]
        for eval_ret in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if eval_ret[3]:  # higher is better
                best_score.append(float("-inf"))
                cmp_op.append(lambda x, y: x > y)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda x, y: x < y)

    def _final_iteration_check(env, eval_name_splitted, i) -> None:
        if env.iteration == env.end_iteration - 1:
            if verbose:
                log_info("Did not meet early stopping. Best iteration is:\n"
                         f"[{best_iter[i] + 1}]\t"
                         + "\t".join(_format_eval_result(x)
                                     for x in best_score_list[i]))
            raise EarlyStopException(best_iter[i], best_score_list[i])

    def _callback(env: CallbackEnv) -> None:
        if not best_score:
            _init(env)
        if not enabled[0]:
            return
        for i, eval_ret in enumerate(env.evaluation_result_list):
            score = eval_ret[2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            eval_name_splitted = eval_ret[1].split(" ")
            if first_metric_only and first_metric[0] != eval_name_splitted[-1]:
                continue
            if eval_ret[0] == "training":
                continue
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    log_info("Early stopping, best iteration is:\n"
                             f"[{best_iter[i] + 1}]\t"
                             + "\t".join(_format_eval_result(x)
                                         for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
            _final_iteration_check(env, eval_name_splitted, i)
    _callback.order = 30
    return _callback
