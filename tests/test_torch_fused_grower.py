"""The port's fused grower (models/grower_fused.py) against the JAX
package's (make_grow_tree), on the CPU.

  * a forced plan of three levels, reached as JAX reaches it (``auto``
    with ``forcedsplits_filename``), on plain, EFB-bundled and 4-bit
    columns, with monotone constraints, and CEGB-lazy: each grows JAX's
    trees split for split with one model text (tests/split_parity.py
    check_fused_case), the plan's splits head every tree;
  * K5 once for the root and once a split (the grower's count).

Every split feature at once, the boosting modes, the packed accumulator
and the dispatch are test_torch_fused_modes.py's.
"""

import pytest

import split_parity as sp


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    yield from sp.one_torch_thread()


@pytest.fixture(autouse=True)
def _no_jax_env(monkeypatch):
    """The JAX package's kernel-choice variables unset: its defaults."""
    for k in ("LIGHTGBM_TPU_PACKED_ACC", "LIGHTGBM_TPU_PACKED_BITS"):
        monkeypatch.delenv(k, raising=False)


CASES = ["forced", "forced_4bit", "forced_efb", "lazy"]


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    return sp.plan_files(tmp_path_factory.mktemp("plans"))


@pytest.mark.parametrize("case", CASES)
def test_fused_trees_match_jax(plans, case):
    sp.check_fused_case(case, plans)
