"""The paper's own iCD-FM (§6: A+P+H features over the YouTube-like set;
port of ``repro.configs.icd_fm``).

Context features: user id (200k) + age (8) + country (64) + gender (3) +
device (16) + previous video (68k) + watch history (bag over 68k).
Item features: video id (68k).
"""
import dataclasses

from repro_torch.configs.base import ICDConfig

CONFIG = ICDConfig(
    name="icd-fm",
    model="fm",
    n_ctx=200_000,
    n_items=68_000,
    k=128,
    alpha0=1.0,
    l2=0.1,
    p_ctx=200_000 + 8 + 64 + 3 + 16 + 68_000 + 68_000,
    p_item=68_000,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, n_ctx=50, n_items=30, k=6, p_ctx=50 + 4 + 3 + 30 + 30, p_item=30
)
