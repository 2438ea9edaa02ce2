"""The device time, in microseconds per scan frame, of the operations
``ekf_launches_per_frame`` counts (every device operation of the profiled
window but the simulator kernel, in a cell whose worlds run EKF landmark
SLAM alone); nothing where the profile holds no such operation."""

from h100bench.harness import kernel_time


def read(record):
    t = record.get("trace")
    if not t or not t.get("frames"):
        return None
    (n, s), (sim_n, sim_s) = (kernel_time(t, ""),
                              kernel_time(t, "sim_frame_kernel"))
    if n == sim_n:
        return None
    return (s - sim_s) / t["frames"] * 1e6
