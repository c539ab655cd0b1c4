"""Distribution on one device (port of ``amgx_tpu/distributed/``): the
row partition and its halo maps (:mod:`.partition`), sharded ELL packs
with the halo exchange and the distributed SpMV (:mod:`.matrix`), and
the coarse-level agglomeration planner (:mod:`.agglomerate`).  A mesh
holds its P shards on one device (:func:`make_mesh`); several cards are
ROADMAP item 8c of the port."""
from . import agglomerate, partition
from .agglomerate import (AgglomPlan, build_agglomeration, plan_for,
                          plan_submesh, redistribute_blocks)
from .matrix import (DeviceMesh, ShardedMatrix, dist_spmv, embed_padded,
                     exchange_halo, make_mesh, pad_map, shard_matrix,
                     shard_matrix_from_blocks, shard_vector, unshard_vector)
from .partition import (Partition, build_partition,
                        partition_offsets_from_vector)

__all__ = ["ShardedMatrix", "DeviceMesh", "shard_matrix",
           "shard_matrix_from_blocks", "exchange_halo", "dist_spmv",
           "shard_vector", "unshard_vector", "make_mesh", "embed_padded",
           "pad_map", "Partition", "build_partition",
           "partition_offsets_from_vector", "AgglomPlan",
           "build_agglomeration", "plan_for", "plan_submesh",
           "redistribute_blocks", "partition", "agglomerate"]
