"""State carried across from the JAX package, as numpy.

Two hand-overs, so the port can be held to the JAX package on identical
inputs:

  * ``dataset_from_arrays``: a binned dataset (the row-major ``binned``
    matrix of the used features, each BinMapper in its ``to_dict()``
    form, the labels) -> a port Dataset over the same bins;
  * ``trees_from_arrays``: trained trees, each given as its numpy fields
    (``vars(tree)``) -> port Trees.

Only numerical, unbundled state converts; anything else raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .basic import Dataset
from .core.binning import BinMapper
from .core.dataset import TorchDataset
from .models.tree import Tree


def dataset_from_arrays(binned: np.ndarray, bin_mappers: Sequence[Dict],
                        label: Optional[np.ndarray] = None,
                        feature_names: Optional[List[str]] = None
                        ) -> Dataset:
    mappers = []
    for d in bin_mappers:
        if int(d.get("bin_type", 0)) != 0:
            raise NotImplementedError("categorical features do not convert")
        m = BinMapper.from_bounds(d["bin_upper_bound"], d["missing_type"],
                                  d["default_bin"], d["min_val"],
                                  d["max_val"])
        m.is_trivial = bool(d["is_trivial"])
        mappers.append(m)
    ds = TorchDataset.from_bins(np.asarray(binned).T, mappers, label,
                                feature_names)
    return Dataset(ds)


_TREE_FIELDS = ("split_feature_inner", "split_feature", "threshold_in_bin",
                "threshold", "decision_type", "left_child", "right_child",
                "split_gain", "internal_value", "internal_weight",
                "internal_count", "leaf_value", "leaf_weight", "leaf_count",
                "leaf_parent", "leaf_depth")


def trees_from_arrays(fields: Sequence[Dict]) -> List[Tree]:
    out = []
    for f in fields:
        if int(f.get("num_cat", 0)) > 0:
            raise NotImplementedError("categorical splits do not convert")
        t = Tree(int(f["num_leaves"]))
        t.shrinkage = float(f.get("shrinkage", 1.0))
        for name in _TREE_FIELDS:
            setattr(t, name, np.array(f[name], dtype=getattr(t, name).dtype))
        out.append(t)
    return out
