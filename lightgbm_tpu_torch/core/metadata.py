"""Per-dataset metadata: labels, weights, query boundaries, init scores.

Counterpart of lightgbm_tpu/core/metadata.py; reference
include/LightGBM/dataset.h:41-250 (`Metadata`) and src/io/metadata.cpp
(query boundaries from group sizes, query weights as the average member
weight).  Host numpy: the objectives and metrics take what they need to
the device at their ``init``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.log import check, log_fatal


class Metadata:
    def __init__(self, num_data: int = 0):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None             # [N] f32
        self.weights: Optional[np.ndarray] = None           # [N] f32
        self.query_boundaries: Optional[np.ndarray] = None  # [Q+1] i32
        self.query_weights: Optional[np.ndarray] = None     # [Q] f32
        self.init_score: Optional[np.ndarray] = None        # [C*N] f64

    def init(self, num_data: int) -> None:
        self.num_data = num_data
        if self.label is None:
            self.label = np.zeros(num_data, dtype=np.float32)

    def set_label(self, label: np.ndarray) -> None:
        label = np.ascontiguousarray(label, dtype=np.float32).ravel()
        check(len(label) == self.num_data,
              f"Length of label ({len(label)}) != num_data ({self.num_data})")
        self.label = label

    def set_weights(self, weights: Optional[np.ndarray]) -> None:
        if weights is None:
            self.weights = None
            self.query_weights = None
            return
        weights = np.ascontiguousarray(weights, dtype=np.float32).ravel()
        check(len(weights) == self.num_data,
              f"Length of weights ({len(weights)}) != num_data "
              f"({self.num_data})")
        self.weights = weights
        self._update_query_weights()

    def set_query(self, query: Optional[np.ndarray]) -> None:
        """Query boundaries from per-query group sizes (LightGBM's group
        field)."""
        if query is None:
            self.query_boundaries = None
            self.query_weights = None
            return
        query = np.ascontiguousarray(query, dtype=np.int64).ravel()
        boundaries = np.concatenate([[0], np.cumsum(query)]).astype(np.int32)
        check(int(boundaries[-1]) == self.num_data,
              f"Sum of query counts ({int(boundaries[-1])}) != num_data "
              f"({self.num_data})")
        self.query_boundaries = boundaries
        self._update_query_weights()

    def set_query_from_ids(self, qids: np.ndarray) -> None:
        """Query boundaries from a per-row query-id column: a query is a
        run of equal ids."""
        qids = np.asarray(qids).ravel()
        change = np.nonzero(np.diff(qids))[0] + 1
        self.query_boundaries = np.concatenate(
            [[0], change, [len(qids)]]).astype(np.int32)
        self._update_query_weights()

    def _update_query_weights(self) -> None:
        """The average member weight of each query."""
        if self.weights is None or self.query_boundaries is None:
            self.query_weights = None
            return
        b = self.query_boundaries
        sums = np.add.reduceat(self.weights, b[:-1])
        cnts = np.diff(b)
        self.query_weights = (sums / np.maximum(cnts, 1)).astype(np.float32)

    def set_init_score(self, init_score: Optional[np.ndarray]) -> None:
        if init_score is None:
            self.init_score = None
            return
        init_score = np.ascontiguousarray(init_score,
                                          dtype=np.float64).ravel()
        if len(init_score) % max(self.num_data, 1) != 0:
            log_fatal(f"Initial score size {len(init_score)} is not a "
                      f"multiple of num_data {self.num_data}")
        self.init_score = init_score

    @property
    def num_queries(self) -> int:
        if self.query_boundaries is None:
            return 0
        return len(self.query_boundaries) - 1

    def subset(self, indices: np.ndarray) -> "Metadata":
        """The rows ``indices`` (sorted): labels, weights, init scores,
        and the query boundaries when the rows are whole queries (as cv's
        folds of a grouped dataset take them; the reference's
        Metadata::Init(fullset, used_indices))."""
        out = Metadata(len(indices))
        if self.label is not None:
            out.label = self.label[indices]
        if self.weights is not None:
            out.weights = self.weights[indices]
        if self.init_score is not None:
            nc = len(self.init_score) // self.num_data
            out.init_score = np.concatenate(
                [self.init_score[c * self.num_data + indices]
                 for c in range(nc)])
        if self.query_boundaries is not None:
            out.query_boundaries = self._subset_queries(indices)
            out._update_query_weights()
        return out

    def _subset_queries(self, indices: np.ndarray) -> Optional[np.ndarray]:
        """Boundaries of the queries ``indices`` covers, or None when it
        cuts a query."""
        b = self.query_boundaries
        q = np.searchsorted(b, indices, side="right") - 1
        qs, cnt = np.unique(q, return_counts=True)
        sizes = np.diff(b)[qs]
        if not np.array_equal(cnt, sizes):
            return None
        return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
