import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadrupedwholebodycontroller.config import PlannerParams
from quadrupedwholebodycontroller.planner import gait


@pytest.fixture(scope="module")
def pp():
    return PlannerParams()


def run_ticks(pp, n, cmd, state=None):
    state = state or gait.init_planner_state(pp, dtype=jnp.float64)
    cmd = jnp.asarray(cmd, jnp.float64)
    step = jax.jit(lambda s: gait.planner_step(pp, s, cmd))
    refs, pubs = [], []
    for _ in range(n):
        state, ref, pub = step(state)
        refs.append(jax.tree.map(np.asarray, ref))
        pubs.append(bool(pub))
    return state, refs, pubs


def test_quintic_boundary_conditions():
    import quadrupedwholebodycontroller.planner.gait as g

    T = 0.8
    vi, vf = 0.0, 0.4
    c = g._quintic(T, vi, vf, jnp.float64)
    s0, sd0, sdd0 = g._quintic_eval(c, jnp.asarray(0.0))
    sT, sdT, sddT = g._quintic_eval(c, jnp.asarray(T))
    assert np.isclose(float(s0), 0.0) and np.isclose(float(sT), 1.0)
    assert np.isclose(float(sd0), vi) and np.isclose(float(sdT), vf)
    assert np.isclose(float(sdd0), 0.0, atol=1e-12)
    assert np.isclose(float(sddT), 0.0, atol=1e-10)


def test_bezier_endpoints_and_peak():
    import quadrupedwholebodycontroller.planner.gait as g

    pi = jnp.array([0.0, 0.0, 0.0])
    pf = jnp.array([0.1, 0.0, 0.0])
    h = 0.1
    p0, _, _ = g._bezier(jnp.asarray(0.0), pi, pf, h)
    p1, _, _ = g._bezier(jnp.asarray(1.0), pi, pf, h)
    pm, _, _ = g._bezier(jnp.asarray(0.5), pi, pf, h)
    assert np.allclose(np.asarray(p0), np.asarray(pi), atol=1e-15)
    assert np.allclose(np.asarray(p1), np.asarray(pf), atol=1e-15)
    assert np.isclose(float(pm[2]), 0.75 * h)  # peak of 3 s (1-s) h at s=1/2


def test_stand_still(pp):
    _, refs, pubs = run_ticks(pp, 10, [0.0, 0.0, 0.0])
    assert all(pubs)
    for r in refs:
        assert np.allclose(r.contacts, 1.0)
        assert np.allclose(r.com_pose, [0, 0, pp.body_height, 0, 0, 0])


def test_walk_contact_schedule(pp):
    """One full cycle: 20 publishes per phase with the correct single swing

    leg (LH, RH, LF, RF), one silent tick between phases, two at cycle end."""
    n = 90
    _, refs, pubs = run_ticks(pp, n, [0.5, 0.0, 0.0])
    # publishes: phases are runs of 20 identical contact masks
    expected_masks = [
        (0, 1, 1, 1),  # LH swings
        (1, 1, 1, 0),  # RH swings
        (1, 0, 1, 1),  # LF swings
        (1, 1, 0, 1),  # RF swings
    ]
    i = 0
    for phase in range(4):
        for k in range(20):
            assert pubs[i], (phase, k, i)
            assert tuple(refs[i].contacts.astype(int)) == expected_masks[phase], (phase, k)
            i += 1
        # silent transition tick
        assert not pubs[i]
        i += 1
    # one extra silent tick at cycle end (the outer-loop sleep)
    assert not pubs[i]
    i += 1
    # next cycle starts publishing phase 0 again
    assert pubs[i]
    assert tuple(refs[i].contacts.astype(int)) == expected_masks[0]


def test_walk_swing_trajectory(pp):
    """LH swing during phase 0: starts at the initial stance point, returns

    to ground contact (z ~ 0) at phase end, peaks near 0.75 * h."""
    _, refs, pubs = run_ticks(pp, 21, [0.5, 0.0, 0.0])
    lh = np.stack([r.swing_pos[:3] for r in refs[:20]])
    assert np.allclose(lh[0], [-pp.x_offset, pp.y_offset, 0.0], atol=1e-9)
    assert lh[:, 2].max() == pytest.approx(0.75 * pp.height_control_point, rel=0.05)
    assert abs(lh[-1, 2]) < 0.01
    # forward displacement close to one step (quintic not fully at 1 at t=0.19)
    assert 0.03 < lh[-1, 0] - lh[0, 0] <= pp.step_length * 0.5 + 1e-6


def test_body_moves_second_cycle(pp):
    """The body path lags the feet by one cycle (pf_body only advances at

    cycle end — reference cpp:360-361)."""
    n_cycle = 85
    _, refs, pubs = run_ticks(pp, 2 * n_cycle, [1.0, 0.0, 0.0])
    poses = np.stack([r.com_pose for r in refs])
    # first cycle: body x stays 0
    assert np.allclose(poses[:n_cycle, 0], 0.0, atol=1e-12)
    # second cycle: body x advances
    assert poses[-1, 0] > 0.05


def test_yaw_integration(pp):
    _, refs, pubs = run_ticks(pp, 25, [0.0, 0.0, 0.3])
    yaws = [r.com_pose[5] for r, p in zip(refs, pubs) if p]
    # yaw advances 0.3 * dt per published tick, first publish at yaw 0
    assert np.isclose(yaws[0], 0.0)
    assert np.isclose(yaws[10] - yaws[9], 0.3 * pp.dt)


def test_stop_resumes_standing(pp):
    """After a cycle completes with zero command, the planner holds the last

    pose with all feet in stance (reference cpp:369-372)."""
    # one full cycle = 85 ticks (80 publishes + 4 phase ticks + 1 outer tick)
    state, refs, _ = run_ticks(pp, 85, [0.4, 0.0, 0.0])
    state, refs2, pubs2 = run_ticks(pp, 5, [0.0, 0.0, 0.0], state=state)
    for r, p in zip(refs2, pubs2):
        if p:
            assert np.allclose(r.contacts, 1.0)


def test_vmappable(pp):
    """Batched planners with different commands advance independently."""
    state = gait.init_planner_state(pp, dtype=jnp.float64)
    bstate = jax.tree.map(lambda x: jnp.stack([x, x]), state)
    cmds = jnp.asarray([[0.5, 0, 0], [0.0, 0, 0]], jnp.float64)
    step = jax.jit(jax.vmap(lambda s, c: gait.planner_step(pp, s, c)))
    for _ in range(5):
        bstate, ref, pub = step(bstate, cmds)
    assert int(bstate.mode[0]) == gait.WALKING
    assert int(bstate.mode[1]) == gait.IDLE
