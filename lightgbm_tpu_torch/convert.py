"""State carried across from the JAX package, as numpy.

Two hand-overs, so the port can be held to the JAX package on identical
inputs:

  * ``dataset_from_arrays``: a binned dataset (the row-major ``binned``
    matrix of its columns, each BinMapper in its ``to_dict()`` form, the
    labels, the metadata: weights, query group sizes, init scores, and
    the EFB groups of a bundled one, ``bundle.groups``, and its
    ``monotone_constraints`` and ``feature_penalty``) -> a port Dataset
    over the same bins;
  * ``trees_from_arrays``: trained trees, each given as its numpy fields
    (``vars(tree)``) -> port Trees.

Numerical and categorical features convert, bundled (EFB) or not.
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
                        feature_names: Optional[List[str]] = None,
                        weights: Optional[np.ndarray] = None,
                        group: Optional[np.ndarray] = None,
                        init_score: Optional[np.ndarray] = None,
                        bundle_groups: Optional[List[List[int]]] = None,
                        monotone_constraints: Optional[Sequence[int]] = None,
                        feature_penalty: Optional[Sequence[float]] = None
                        ) -> Dataset:
    mappers = [BinMapper.from_dict(d) for d in bin_mappers]
    ds = TorchDataset.from_bins(np.asarray(binned).T, mappers, label,
                                feature_names, weights=weights, group=group,
                                init_score=init_score,
                                bundle_groups=bundle_groups,
                                monotone_constraints=monotone_constraints,
                                feature_penalty=feature_penalty)
    return Dataset(ds)


_TREE_FIELDS = ("split_feature_inner", "split_feature", "threshold_in_bin",
                "threshold", "decision_type", "left_child", "right_child",
                "split_gain", "internal_value", "internal_weight",
                "internal_count", "leaf_value", "leaf_weight", "leaf_count",
                "leaf_parent", "leaf_depth")


def trees_from_arrays(fields: Sequence[Dict]) -> List[Tree]:
    out = []
    for f in fields:
        t = Tree(int(f["num_leaves"]))
        t.shrinkage = float(f.get("shrinkage", 1.0))
        for name in _TREE_FIELDS:
            setattr(t, name, np.array(f[name], dtype=getattr(t, name).dtype))
        t.num_cat = int(f.get("num_cat", 0))
        if t.num_cat:
            t.cat_boundaries = [int(x) for x in f["cat_boundaries"]]
            t.cat_boundaries_inner = [int(x)
                                      for x in f["cat_boundaries_inner"]]
            t.cat_threshold = [np.array(w, dtype=np.uint32)
                               for w in f["cat_threshold"]]
            t.cat_threshold_inner = [np.array(w, dtype=np.uint32)
                                     for w in f["cat_threshold_inner"]]
        out.append(t)
    return out
