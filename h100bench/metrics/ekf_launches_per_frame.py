"""Device operations in the profiled window per scan frame other than the
simulator kernel (``sim_frame_kernel``), in a cell whose worlds run EKF
landmark SLAM alone: the landmark sensor, the EKF's prediction and its
sequential corrections, and the frame's few input and output copies;
nothing where the profile holds no such operation."""

from h100bench.harness import kernel_time


def read(record):
    t = record.get("trace")
    if not t or not t.get("frames"):
        return None
    launches = kernel_time(t, "")[0] - kernel_time(t, "sim_frame_kernel")[0]
    if launches == 0:
        return None
    return launches / t["frames"]
