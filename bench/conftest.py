"""Set-up for the benchmark's CPU tests: the toy sizes of the
configurations that ``tools/toy.py`` does not list (its ``SMOKE`` has mf
and fm), so that a toy checkout holds every cell of ``BENCHMARK.json``."""
from bench.tools import toy

toy.SMOKE.setdefault("tucker", dict(n_ctx=40, n_buckets=6, n_items=30, k1=3, k2=2, k3=4))
