"""Stream sharding over devices and processes (counterpart of
mp3tpu.parallel): mesh.py splits the stream axis over the devices of one
process, distributed.py covers the three places where processes talk
(start-up, the final gather, the metric reduction) on torch.distributed."""
from .distributed import (allreduce_metric, gather_to_host0,  # noqa: F401
                          init_distributed, rank_slice, reduce_shards,
                          shutdown_distributed)
from .mesh import (StreamMesh, StreamSharding, make_stream_mesh,  # noqa: F401
                   shard_batch, sharded_decode_step, stream_sharding, unshard)
