"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

One run is one cell of ``BENCHMARK.json`` run once::

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

  configs/<config>.json    a model configuration as it is run
  traffic/<mix>.json       the parameters the one generator
                           (``harness/traffic.py``) reads
  workloads/<cell>.json    a cell's driver, epochs and the limits of its
                           correctness checks
  drivers/<kind>.py        a driver (one run of a cell)
  models/<model>.py        the program under test, by the config's model
  reference/<model>.py     the plain reference of the same model
  metrics/<metric>.py      the reader of one metric
  costs/                   FLOP and byte counts from shapes, device peaks

Nothing here imports ``jax`` or the JAX package ``repro``; only
``models/`` imports the port.
"""
