"""Packaged ANYmal-D model (the reference robot, urdf/anymal.urdf).

The JSON spec is generated offline by tools/extract_model.py from the
reference URDF: 13 movable bodies (base + 4x hip/thigh/shank), 12 revolute
joints in the reference controller's model order LH,LF,RF,RH x HAA,HFE,KFE
(reference src/whole_body_controller.cpp:234,81), 4 foot frames stacked
LH,LF,RF,RH (reference src/whole_body_controller.cpp:327-341).
Total mass 51.63574 kg (the XML-visible URDF mass — what iDynTree's
getTotalMass returns; commented-out payload links are excluded).
"""
from __future__ import annotations

import functools
import os

import jax.numpy as jnp

from quadrupedwholebodycontroller.models.robot_model import RobotModel

_DATA = os.path.join(os.path.dirname(__file__), "data", "anymal_d.json")

# Hard-coded initial joint configuration, reference src/whole_body_controller.cpp:81
# (model order LH, LF, RF, RH x HAA, HFE, KFE).
INITIAL_JOINT_POS = (
    0.0, -0.4, 0.8,
    0.0, 0.4, -0.8,
    0.0, 0.4, -0.8,
    0.0, -0.4, 0.8,
)
# Initial base height, reference src/whole_body_controller.cpp:82
INITIAL_BASE_HEIGHT = 0.60


@functools.lru_cache(maxsize=None)
def _cached(dtype_name: str) -> RobotModel:
    return RobotModel.from_json(_DATA, dtype=jnp.dtype(dtype_name))


def anymal_d_model(dtype=jnp.float32) -> RobotModel:
    return _cached(jnp.dtype(dtype).name)
