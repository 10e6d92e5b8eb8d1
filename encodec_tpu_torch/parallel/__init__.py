"""The parallel paths on `torch.distributed` (port of `encodec_tpu/parallel`).

One process per GPU (`torchrun --nproc_per_node=N`), NCCL on the card,
gloo on the CPU; meshes are `DeviceMesh`es with JAX's axis names.

- `mesh`: process-group setup, meshes, `shard_batch` (`initialize_multihost`,
  `make_mesh`, `make_mesh_2d`, `make_hybrid_mesh`, `batch_sharding`,
  `replicated`, `shard_batch`, `local_device`);
- `comm`: the collectives (new: JAX's live inside `shard_map`), and
  `DataParallel`, the batch reductions of the training steps on a mesh
  (`train.make_train_steps(mesh=)`);
- `tp`: the codebook-sharded RVQ search (`nearest_codebook_tp`,
  `rvq_encode_tp`);
- `sp`: the sequence-parallel SEANet encode and decode (`seanet_encode_sp`,
  `encode_sp`, `seanet_decode_sp`, `decode_sp`), and the differentiable
  sharded trunks of the data×seq training step (`seanet_encode_seq`,
  `seanet_decode_seq`, `check_seq_parallel`);
- `pp`: the pipelined LM (`stack_lm_layers`, `shard_stacked_layers`,
  `lm_forward_batch_pp`, `make_lm_pp_train_step`).
"""

from .mesh import (  # noqa: F401
    BatchSharding,
    batch_sharding,
    initialize_multihost,
    local_device,
    make_hybrid_mesh,
    make_mesh,
    make_mesh_2d,
    replicated,
    shard_batch,
)
from .pp import (  # noqa: F401
    lm_forward_batch_pp,
    make_lm_pp_train_step,
    shard_stacked_layers,
    stack_lm_layers,
)
from .sp import (  # noqa: F401
    check_seq_parallel,
    decode_sp,
    encode_sp,
    seanet_decode_seq,
    seanet_decode_sp,
    seanet_encode_seq,
    seanet_encode_sp,
)
from .tp import nearest_codebook_tp, rvq_encode_tp  # noqa: F401
