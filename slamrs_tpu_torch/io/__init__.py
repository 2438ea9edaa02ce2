"""Host input and output: the robot's wire protocol and Neato lidar codec,
the robot link, the virtual robot (a model of the robot's firmware) and
keyboard teleop."""

from slamrs_tpu_torch.io import message, neato  # noqa: F401
