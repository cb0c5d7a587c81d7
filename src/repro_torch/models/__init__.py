"""Sharding-hint DSL (``models/hints.py``, port of ``repro.models``):
constraint annotations usable by any model code. The paper's own
k-separable models are ``repro_torch.core.models``.
"""
