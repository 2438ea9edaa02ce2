from slamrs_tpu_torch.utils.perf import PerfStats  # noqa: F401
