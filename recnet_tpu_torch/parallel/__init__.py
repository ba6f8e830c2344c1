from recnet_tpu_torch.parallel.mesh import (
    make_mesh, batch_sharding, replicated, state_shardings, shard_state)
from recnet_tpu_torch.parallel.distributed import (
    initialize, is_primary, is_multihost, put_global)
