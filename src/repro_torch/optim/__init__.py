"""Optimizers (port of ``repro.optim``; no optax, no ``torch.optim``).

Functional design: ``opt.init(params) -> state``,
``opt.update(grads, state, params) -> (updates, state)``; apply with
``apply_updates``. AdamW, Adafactor, SGD+momentum, LR schedules,
global-norm clipping and the mixed-precision wrapper. The int8
error-feedback gradient compressor of the reference's data-parallel
all-reduce (``optim/compression``) waits for slice 7, with the
distribution layer it serves.
"""

from repro_torch.optim.base import OptimizerDef, apply_updates, global_norm
from repro_torch.optim.sgd import sgd
from repro_torch.optim.adam import adamw
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.schedules import constant, cosine_decay, linear_warmup_cosine
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.mixed import mixed_precision

__all__ = [
    "OptimizerDef", "apply_updates", "global_norm",
    "sgd", "adamw", "adafactor",
    "constant", "cosine_decay", "linear_warmup_cosine",
    "clip_by_global_norm", "mixed_precision",
]
