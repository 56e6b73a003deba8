from quadrupedwholebodycontroller.models.robot_model import RobotModel  # noqa: F401
from quadrupedwholebodycontroller.models.anymal import anymal_d_model  # noqa: F401
