"""``repro_torch/tree.py``: ``tree_map`` rebuilds NamedTuples field by field
(an ``AdamWState``, the port's ``KVCache`` and recurrent states), and
leaves are named by dotted paths, the checkpoint manager's keys."""
from typing import Any, NamedTuple

import torch

from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWState
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path, tree_paths
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


class _State(NamedTuple):
    step: torch.Tensor
    m: Any


def test_tree_map_rebuilds_namedtuples():
    s = _State(torch.tensor(3), {"w": torch.ones(2, 2)})
    got = tree_map(lambda x: x * 2, s)
    assert isinstance(got, _State)
    assert int(got.step) == 6 and torch.equal(got.m["w"], torch.full((2, 2), 2.0))
    st = AdamWState(torch.tensor(1), {"a": torch.ones(3)}, {"a": torch.zeros(3)})
    got = tree_map(lambda x, y: x + y, st, st)
    assert isinstance(got, AdamWState) and torch.equal(got.m["a"], torch.full((3,), 2.0))


def test_tree_map_over_kv_cache_keeps_host_length():
    cfg = get_config("qwen3-14b-smoke")
    c = A.init_kv_cache(cfg, 2, 8, 1, torch.int8, "cpu")._replace(length=5)
    got = tree_map(lambda x: x.clone(), c)
    assert isinstance(got, A.KVCache) and got.length == 5
    assert got.k.shape == c.k.shape and got.k.data_ptr() != c.k.data_ptr()
    cache = lm.init_cache(cfg, 2, 8)
    moved = tree_map(lambda x: x.clone(), cache)
    assert moved["pos"] == 0 and all(isinstance(e, A.KVCache) for e in moved["blocks"].values())
    assert len(tree_leaves(moved)) == len(tree_leaves(cache))


def test_paths_name_leaves_by_keys_fields_and_indices():
    tree = {"opt": AdamWState(torch.tensor(0), {"blocks": [{"w": torch.ones(1)}]}, {}),
            "b": None}
    assert list(tree_paths(tree)) == ["opt.step", "opt.m.blocks.0.w"]
    got = tree_map_with_path(lambda p, x: x + len(p), tree)
    assert isinstance(got["opt"], AdamWState) and got["b"] is None
    assert float(got["opt"].m["blocks"][0]["w"]) == 1 + len("opt.m.blocks.0.w")
