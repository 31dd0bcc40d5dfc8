"""Multi-GPU training (port of ``raw_ngp_tpu/parallel/``): ray-batch data
parallelism (:mod:`raw_ngp_torch.parallel.mesh`) and channel-sharded
tensor parallelism of the hash table (:mod:`raw_ngp_torch.parallel.tp`)
over ``torch.distributed``, one process a rank."""

from raw_ngp_torch.parallel.mesh import (Mesh, make_mesh,
                                         make_parallel_eval_render,
                                         make_parallel_train_step, replicate)
from raw_ngp_torch.parallel.tp import (gather_table, make_tp_mesh,
                                       make_tp_train_step, place_state_tp,
                                       shard_of)
