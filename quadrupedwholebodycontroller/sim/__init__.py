from quadrupedwholebodycontroller.sim.world import (  # noqa: F401
    SimParams,
    SimState,
    init_sim_state,
    observe,
    sim_control_period,
)
from quadrupedwholebodycontroller.sim.rollout import (  # noqa: F401
    closed_loop_rollout,
)
