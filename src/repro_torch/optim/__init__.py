"""Optimizers (port of ``repro.optim``; no optax, no ``torch.optim``).

Functional design: ``opt.init(params) -> state``,
``opt.update(grads, state, params) -> (updates, state)``; apply with
``apply_updates``. AdamW, Adafactor, SGD+momentum, LR schedules,
global-norm clipping, the mixed-precision wrapper, and the int8
error-feedback compressor of the data-parallel all-reduce
(``optim/compression``, over ``torch.distributed``).
"""

from repro_torch.optim.base import OptimizerDef, apply_updates, global_norm
from repro_torch.optim.sgd import sgd
from repro_torch.optim.adam import adamw
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.schedules import constant, cosine_decay, linear_warmup_cosine
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.mixed import mixed_precision
from repro_torch.optim.compression import int8_compress, int8_decompress, ef_compress_update

__all__ = [
    "OptimizerDef", "apply_updates", "global_norm",
    "sgd", "adamw", "adafactor",
    "constant", "cosine_decay", "linear_warmup_cosine",
    "clip_by_global_norm", "mixed_precision",
    "int8_compress", "int8_decompress", "ef_compress_update",
]
