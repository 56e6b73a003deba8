"""RobotModel — the static lumped rigid-body tree as arrays.

Replaces the iDynTree Model/KinDynComputations model object (reference
src/whole_body_controller.cpp:26-40).  Loaded once at trace time; every
field is either a static Python tuple (tree topology) or a jnp array
(numeric parameters), so the model can be closed over by jitted functions
or passed as a pytree argument.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RobotModel:
    # -- static metadata (aux_data) --
    name: str = dataclasses.field(metadata=dict(static=True))
    joint_names: Tuple[str, ...] = dataclasses.field(metadata=dict(static=True))
    frame_names: Tuple[str, ...] = dataclasses.field(metadata=dict(static=True))
    parent: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    frame_body: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))

    # -- numeric parameters (children) --
    joint_R: jax.Array    # (nj, 3, 3) joint frame rotation in parent body frame
    joint_p: jax.Array    # (nj, 3)    joint frame origin in parent body frame
    joint_axis: jax.Array  # (nj, 3)   rotation axis in joint frame
    mass: jax.Array       # (nb,)
    com: jax.Array        # (nb, 3)    body CoM in body frame
    inertia: jax.Array    # (nb, 3, 3) inertia about body CoM, body frame
    frame_R: jax.Array    # (nf, 3, 3) frame rotation in owning body frame
    frame_p: jax.Array    # (nf, 3)
    joint_lower: jax.Array   # (nj,)
    joint_upper: jax.Array   # (nj,)
    joint_effort: jax.Array  # (nj,)
    joint_velocity: jax.Array  # (nj,)

    @property
    def num_bodies(self) -> int:
        return len(self.parent)

    @property
    def num_joints(self) -> int:
        return len(self.joint_names)

    @property
    def nv(self) -> int:
        """Floating-base velocity dimension: 6 + num_joints."""
        return 6 + self.num_joints

    @property
    def total_mass(self):
        return jnp.sum(self.mass)

    def ancestor_joint_mask(self) -> np.ndarray:
        """(nb, nj) float mask: body b moves with joint j (static numpy)."""
        nb, nj = self.num_bodies, self.num_joints
        mask = np.zeros((nb, nj))
        for b in range(1, nb):
            mask[b] = mask[self.parent[b]].copy()
            mask[b, b - 1] = 1.0  # body b is the child of joint b-1
        return mask

    def astype(self, dtype) -> "RobotModel":
        return jax.tree.map(lambda x: x.astype(dtype), self)

    @classmethod
    def from_spec(cls, spec: dict, dtype=jnp.float32) -> "RobotModel":
        bodies = spec["bodies"]
        nb = len(bodies)
        parent = tuple(b["parent"] for b in bodies)
        for i in range(1, nb):
            if parent[i] >= i:
                raise ValueError("bodies must be topologically ordered")
        joints = [b["joint"] for b in bodies[1:]]

        def arr(x):
            return jnp.asarray(np.array(x), dtype=dtype)

        def lim(key, default):
            return arr([j["limit"].get(key, default) for j in joints])

        frames = spec.get("frames", [])
        return cls(
            name=spec.get("name", "robot"),
            joint_names=tuple(j["name"] for j in joints),
            frame_names=tuple(f["name"] for f in frames),
            parent=parent,
            frame_body=tuple(f["body"] for f in frames),
            joint_R=arr([j["R"] for j in joints]),
            joint_p=arr([j["p"] for j in joints]),
            joint_axis=arr([j["axis"] for j in joints]),
            mass=arr([b["mass"] for b in bodies]),
            com=arr([b["com"] for b in bodies]),
            inertia=arr([b["inertia"] for b in bodies]),
            frame_R=arr([f["R"] for f in frames]) if frames else jnp.zeros((0, 3, 3), dtype),
            frame_p=arr([f["p"] for f in frames]) if frames else jnp.zeros((0, 3), dtype),
            joint_lower=lim("lower", -np.inf),
            joint_upper=lim("upper", np.inf),
            joint_effort=lim("effort", np.inf),
            joint_velocity=lim("velocity", np.inf),
        )

    @classmethod
    def from_json(cls, path: str, dtype=jnp.float32) -> "RobotModel":
        with open(path) as f:
            return cls.from_spec(json.load(f), dtype=dtype)

    @classmethod
    def from_urdf(cls, path: str, joint_order, frame_names, dtype=jnp.float32) -> "RobotModel":
        from quadrupedwholebodycontroller.models.urdf import parse_urdf

        return cls.from_spec(parse_urdf(path, joint_order, frame_names), dtype=dtype)
