"""Host input and output: keyboard teleop (the robot I/O is the next slice)."""
