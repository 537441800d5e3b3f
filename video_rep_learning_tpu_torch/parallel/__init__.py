"""Data parallelism: one process per card over `torch.distributed`.

Counterpart of `video_rep_learning_tpu/parallel/` (`mesh.py`,
`collectives.py`), in the reference's own layout (`train.py:259-286`): each
rank holds a replica of the model on its card (`cuda:(rank % cards)`),
loads TRAIN.BATCH_SIZE clips of its own shard (the loaders shard by rank),
and `DistributedDataParallel` averages the gradients. What the JAX package
gets from one global batch on a mesh, the port gets from collectives:
BatchNorm statistics over the global batch (`models/layers.py`,
`convert_sync_batchnorm`), the SCL and TCC losses per rank averaged by
DDP (their global branches gather the embeddings), classification's masked
mean over the global batch's count (`algos/classification.py`), and the FineGym
harness's gathered file lists and summed counters (`collectives.py`).

The JAX package's `parallel/sharding.py::dp_kernel_call` has no
counterpart: it exists because GSPMD replicates a Mosaic custom call over
the mesh, while here each rank already launches its kernels on its own
shard. Its tensor and sequence parallelism (PARALLEL.TENSOR_PARALLELISM
> 1) raise (`mesh.check_parallel_config`).
"""

from .collectives import (all_gather_object, all_gather_with_grad,  # noqa: F401
                          all_reduce_sum, all_reduce_tensor, synchronize)
from .mesh import (check_parallel_config, init_distributed, is_root_proc,  # noqa: F401
                   process_group, world)
