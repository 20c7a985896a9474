"""Per-dataset metadata: labels.

Reference: include/LightGBM/dataset.h:41-250 (`Metadata`).  The port's
slice trains unweighted binary models, so the metadata holds the label
only; weights, query boundaries and init scores are not supported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.log import check


class Metadata:
    def __init__(self, num_data: int = 0):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None          # [N] f32

    def init(self, num_data: int) -> None:
        self.num_data = num_data
        if self.label is None:
            self.label = np.zeros(num_data, dtype=np.float32)

    def set_label(self, label: np.ndarray) -> None:
        label = np.ascontiguousarray(label, dtype=np.float32).ravel()
        check(len(label) == self.num_data,
              f"Length of label ({len(label)}) != num_data ({self.num_data})")
        self.label = label
