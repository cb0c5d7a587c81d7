"""Plain PyTorch references of the models the benchmark runs.

They import nothing of the port, of ``jax`` or of the JAX package, and
take only what the benchmark made (the raw log, the designs' raw field
ids, the initial factors): Lemma 1's rescaling, the residuals and every
layout they need are worked out here again. Each is the flat,
column-by-column iCD of the paper (Algorithm 2 for MF, §5.2.2 for FM) in
a chosen arithmetic (``common.Arith``): float64 for the reference,
float32 with TF32 matrix products for the control.
"""
