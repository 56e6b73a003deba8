from quadrupedwholebodycontroller.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_batch,
)
from quadrupedwholebodycontroller.parallel.sweep import (  # noqa: F401
    sharded_sweep_step,
    sweep_metrics,
)
from quadrupedwholebodycontroller.parallel.flagship import (  # noqa: F401
    sharded_wbc_step,
)
