"""Config loading: reference-format YAML files port verbatim."""
import os

from quadrupedwholebodycontroller.config import load_yaml_params

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def test_load_controller_yaml():
    out = load_yaml_params(os.path.join(CONFIGS, "params_controller.yaml"))
    cp = out["controller"]
    assert cp.loop_rate == 400.0
    assert cp.kp == 6000.0
    assert cp.kp_z == 10000.0
    assert cp.max_torque == 80.0
    assert cp.slack_weight == 1000.0
    assert tuple(cp.initial_reference_pose) == (0.0, 0.0, 0.50, 0.0, 0.0, 0.0)


def test_load_planner_yaml():
    out = load_yaml_params(os.path.join(CONFIGS, "params_planner.yaml"))
    pp = out["planner"]
    assert pp.step_length == 0.1
    assert pp.cycle_duration == 0.8
    assert pp.body_final_velocity == 0.4
