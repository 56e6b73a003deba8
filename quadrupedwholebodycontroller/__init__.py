"""quadrupedwholebodycontroller — a batched, accelerator-native whole-body-control framework.

A ground-up JAX / XLA re-design of the capabilities of the reference
ROS1/C++ stack (Mavagnale/QuadrupedWholeBodyController): centroidal-dynamics
whole-body control of a quadruped (ANYmal-D), with

  * a batched, differentiable floating-base rigid-body dynamics engine
    (replaces iDynTree — reference src/whole_body_controller.cpp:26-38),
  * a batched dense QP solver with warm start (replaces qpOASES —
    reference src/whole_body_controller.cpp:517-541),
  * an on-device gait/reference generator (replaces the motion_planner node —
    reference src/motion_planner.cpp),
  * an on-device physics rollout (replaces Gazebo for closed-loop scenarios),
  * scenario data-parallelism via vmap and multi-chip sharding via
    jax.sharding / shard_map (replaces the ROS pub/sub process graph).

The whole 400 Hz control cycle — state intake, centroidal dynamics, QP,
torque mapping — is one jitted function of (state, reference, carry), vmapped
over a scenario batch and sharded over a device mesh.
"""

__version__ = "0.1.0"

from quadrupedwholebodycontroller.config import (  # noqa: F401
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
