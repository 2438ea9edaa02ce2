"""Set-up: seconds from the process's start to the window's first tick
(import, the kernel library's load or build, the cell's state and
draws, the warm-up that captures every graph the cell replays)."""


def read(record):
    return record.get("setup_s")
