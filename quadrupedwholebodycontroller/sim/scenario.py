"""Scenario perturbations for robustness sweeps (BASELINE.json config 5:

payload mass, friction coefficient, push disturbances — thousands of
parallel scenarios).

All perturbations are traced values, so a batch of scenarios vmaps/shards
like any other data.  The payload modifies the *simulated* robot only; the
controller keeps the nominal model (model-mismatch robustness, the realistic
condition)."""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from quadrupedwholebodycontroller.models.robot_model import RobotModel
from quadrupedwholebodycontroller.ops import spatial


class Scenario(NamedTuple):
    """Per-scenario world perturbation."""

    sim_friction: jax.Array    # () ground friction coefficient
    payload_mass: jax.Array    # () kg added rigidly to the base
    payload_com: jax.Array     # (3,) payload location in the base frame
    push_wrench: jax.Array     # (T, 6) external base wrench per control step

    @classmethod
    def nominal(cls, T: int, friction: float = 1.0, dtype=jnp.float32) -> "Scenario":
        return cls(
            sim_friction=jnp.asarray(friction, dtype),
            payload_mass=jnp.zeros((), dtype),
            payload_com=jnp.zeros(3, dtype),
            push_wrench=jnp.zeros((T, 6), dtype),
        )

    @classmethod
    def random_batch(cls, key, B: int, T: int, dtype=jnp.float32,
                     friction_range=(0.5, 1.2), payload_range=(0.0, 10.0),
                     push_force: float = 60.0, push_steps: int = 40) -> "Scenario":
        """The sweep distribution: friction x payload x one lateral push."""
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        friction = jax.random.uniform(k1, (B,), dtype, *friction_range)
        payload = jax.random.uniform(k2, (B,), dtype, *payload_range)
        com = jnp.stack(
            [
                jax.random.uniform(k3, (B,), dtype, -0.15, 0.15),
                jnp.zeros((B,), dtype),
                jnp.full((B,), 0.1, dtype),
            ],
            axis=1,
        )
        # one push window of push_steps at a random onset, random direction
        onset = jax.random.randint(k4, (B,), T // 4, max(T // 4 + 1, T - push_steps))
        theta = jax.random.uniform(k5, (B,), dtype, 0.0, 2 * jnp.pi)
        t_idx = jnp.arange(T)[None, :]
        window = (
            (t_idx >= onset[:, None]) & (t_idx < onset[:, None] + push_steps)
        ).astype(dtype)
        fx = push_force * jnp.cos(theta)[:, None] * window
        fy = push_force * jnp.sin(theta)[:, None] * window
        push = jnp.zeros((B, T, 6), dtype)
        push = push.at[:, :, 0].set(fx).at[:, :, 1].set(fy)
        return cls(
            sim_friction=friction, payload_mass=payload,
            payload_com=com, push_wrench=push,
        )


def apply_payload(model: RobotModel, payload_mass, payload_com) -> RobotModel:
    """A rigid point payload lumped into the base body (traced, vmappable)."""
    m0 = model.mass[0]
    c0 = model.com[0]
    m = m0 + payload_mass
    c = (m0 * c0 + payload_mass * payload_com) / m
    d0 = c0 - c
    dp = payload_com - c
    S0 = spatial.skew(d0)
    Sp = spatial.skew(dp)
    I_new = model.inertia[0] - m0 * (S0 @ S0) - payload_mass * (Sp @ Sp)
    return RobotModel(
        name=model.name,
        joint_names=model.joint_names,
        frame_names=model.frame_names,
        parent=model.parent,
        frame_body=model.frame_body,
        joint_R=model.joint_R,
        joint_p=model.joint_p,
        joint_axis=model.joint_axis,
        mass=model.mass.at[0].set(m),
        com=model.com.at[0].set(c),
        inertia=model.inertia.at[0].set(I_new),
        frame_R=model.frame_R,
        frame_p=model.frame_p,
        joint_lower=model.joint_lower,
        joint_upper=model.joint_upper,
        joint_effort=model.joint_effort,
        joint_velocity=model.joint_velocity,
    )
