"""Runtime services of the port, as in ``repro.runtime``: gradient
compression with error feedback (``compression``), straggler detection
(``straggler``), parameter, batch and cache placement on a process grid
(``sharding``) and resharding a training state onto another grid
(``elastic``)."""

from .compression import (  # noqa: F401
    CompressedAllReduce,
    bf16_compress,
    bf16_decompress,
    int8_compress,
    int8_decompress,
)
from .straggler import StragglerMonitor  # noqa: F401
from .elastic import reshard_state  # noqa: F401
from .sharding import (  # noqa: F401
    apply_sharding_rules,
    batch_sharding,
    cache_sharding,
    gather_tensor,
    param_sharding_rules,
    shard_model,
    shard_tensor,
    spec_for,
)
