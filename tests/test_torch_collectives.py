"""The collectives of the port's multi-device paths, counted.

The JAX package audits the partitioned HLO of its sharded programs
(``tests/test_collectives.py``): no collective in the march, the frame's
assembly, one tuple all-reduce per fused step. The port's collectives all
go through ``bsdmg_tpu_torch/parallel/collectives.py``, which counts them
by kind; a 2x2 ``dp x sp`` world of four gloo ranks on the CPU, spawned
once for the module (``tests/torch_parallel_ranks.py::collectives_rank``),
counts each path:

* one ``all_gather`` per sharded frame (K1, row two-phase, block
  retirement, the grid route), RGB in one buffer;
* one ``all_reduce`` per training step, both steps (loss and gradients in
  one buffer);
* none to deal the field, refine or extract, nor to shard the rays;
* two in the final triangle gather (counts, then triangles), two in
  ``ShardedField.gather()``, so two in ``generate_mesh_sharded``.
"""

import pytest

import torch_parallel_ranks as ranks
from bsdmg_tpu_torch.parallel.launch import spawn

NONE = {"all_gather": 0, "all_reduce": 0}
GATHER = {"all_gather": 1, "all_reduce": 0}
REDUCE = {"all_gather": 0, "all_reduce": 1}
TWO_GATHERS = {"all_gather": 2, "all_reduce": 0}

EXPECTED = {
    **{f"frame two_phase={m}": GATHER for m in ranks.MODES},
    "grid frame": GATHER,
    "shard_rays": NONE,
    "train_step_fused": REDUCE,
    "train_step": REDUCE,
    "distribute_field": NONE,
    "refine_field_sharded": NONE,
    "extract_sharded": NONE,
    "gather_triangles": TWO_GATHERS,
    "ShardedField.gather": TWO_GATHERS,
    "generate_mesh_sharded": TWO_GATHERS,
}


@pytest.fixture(scope="module")
def counts():
    return spawn(ranks.collectives_rank, 4, (2, 2), device="cpu", timeout=240.0)


def test_every_path_is_counted(counts):
    for rank in counts:
        assert set(rank) == set(EXPECTED)


@pytest.mark.parametrize("path", sorted(EXPECTED))
def test_collectives_per_path(counts, path):
    for rank in counts:
        assert rank[path] == EXPECTED[path], (path, rank[path])
