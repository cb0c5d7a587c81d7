"""Set-up for every test run from the root: the toy sizes of the
configurations that ``bench/tools/toy.py``'s ``SMOKE`` does not list, so
that a toy checkout holds every cell of ``BENCHMARK.json`` (``bench/conftest.py``
adds Tucker's). MFSI runs on FM's smoke sizes and fields."""
from bench.tools import toy

toy.SMOKE.setdefault("mfsi", dict(toy.SMOKE["fm"]))
