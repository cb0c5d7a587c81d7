"""setup_s: seconds from the process's start to the first timed epoch
(imports, the kernels' load or build, the log, the layout, the first
epochs)."""


def read(m: dict):
    return m["setup_s"]
