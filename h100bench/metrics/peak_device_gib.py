"""``torch.cuda.max_memory_allocated()`` over set-up and window, in GiB
(the peak statistics are reset when the run starts)."""


def read(record):
    peak = record.get("peak_bytes")
    return None if peak is None else peak / 2 ** 30
