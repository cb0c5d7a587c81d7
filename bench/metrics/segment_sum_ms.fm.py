"""segment_sum_ms.fm: device time of the kernels that
``aten::index_add_`` launched (the field layers' segment sums), in ms an epoch."""
from bench.harness.profile import op_ms_per_step


def read(m: dict):
    return op_ms_per_step(m, "aten::index_add_") if m["model"] == "fm" else None
