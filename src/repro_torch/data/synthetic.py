"""Synthetic implicit-feedback generator mirroring the paper's §6 dataset
(port of ``repro.data.synthetic``: the same seeded numpy, so the same
arrays from the same seed).

The paper evaluates on a private YouTube subset (200k users, 68k videos,
side attributes: age / country / gender / device, watch sequences). We
generate a statistically matched stand-in:

  * latent taste vectors per user drawn from ATTRIBUTE-dependent cluster
    means (so attribute-based FM can genuinely generalize to cold users —
    the mechanism behind Figure 7);
  * item popularity ~ Zipf (implicit-feedback datasets are power-law);
  * watch sequences with Markov drift (so the previously-watched video `P`
    and history `H` features carry signal — §6.2.2/6.2.3);
  * timestamps for the global-cutoff Instant protocol.

Everything is seeded numpy on the host. The generator forms the dense
(n_items, n_items) item-similarity matrix and loops over users in Python,
so it serves small catalogues only: at icd-mf's 68,000 items that matrix
alone is 37 GB of float64 (a limit of the reference it mirrors).
``chip_smoke.py`` builds its own seeded full-width log instead.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticImplicitDataset:
    n_users: int
    n_items: int
    # per-user attributes
    age: np.ndarray        # (U,) bucket ids
    country: np.ndarray
    gender: np.ndarray
    device: np.ndarray
    n_age: int
    n_country: int
    n_gender: int
    n_device: int
    # interactions, time-ordered per user
    events: np.ndarray     # (nnz, 3): user, item, t (global integer time)

    def user_histories(self) -> List[np.ndarray]:
        hist = [[] for _ in range(self.n_users)]
        for u, i, _ in self.events:
            hist[u].append(i)
        return [np.asarray(h, np.int64) for h in hist]


def make_implicit_dataset(
    n_users: int = 2000,
    n_items: int = 800,
    k_latent: int = 8,
    events_per_user: Tuple[int, int] = (5, 30),
    n_age: int = 8,
    n_country: int = 16,
    n_gender: int = 3,
    n_device: int = 8,
    attr_strength: float = 0.7,
    markov_strength: float = 0.5,
    pop_strength: float = 1.5,
    taste_strength: float = 1.0,
    seed: int = 0,
) -> SyntheticImplicitDataset:
    rng = np.random.default_rng(seed)

    age = rng.integers(0, n_age, n_users)
    country = rng.integers(0, n_country, n_users)
    gender = rng.integers(0, n_gender, n_users)
    device = rng.integers(0, n_device, n_users)

    # attribute cluster means in latent space
    m_age = rng.normal(size=(n_age, k_latent))
    m_country = rng.normal(size=(n_country, k_latent))
    m_gender = rng.normal(size=(n_gender, k_latent))
    user_lat = (
        attr_strength * (m_age[age] + m_country[country] + m_gender[gender]) / 3
        + (1 - attr_strength) * rng.normal(size=(n_users, k_latent))
    )
    item_lat = rng.normal(size=(n_items, k_latent))
    pop = 1.0 / np.arange(1, n_items + 1) ** 1.1  # Zipf popularity
    pop = pop[rng.permutation(n_items)]

    # Markov drift: similar items tend to follow each other
    sim = item_lat @ item_lat.T
    events = []
    t = 0
    for u in range(n_users):
        n_ev = rng.integers(*events_per_user)
        base = taste_strength * (user_lat[u] @ item_lat.T) + np.log(pop) * pop_strength
        prev = None
        for _ in range(n_ev):
            logit = base.copy()
            if prev is not None and markov_strength > 0:
                logit = logit + markov_strength * sim[prev]
            logit = logit - logit.max()
            p = np.exp(logit)
            p /= p.sum()
            item = rng.choice(n_items, p=p)
            events.append((u, item, t))
            prev = item
            t += 1
    ev = np.asarray(events, np.int64)
    # global shuffle of time to interleave users, then re-sort by time
    ev[:, 2] = rng.permutation(len(ev))
    ev = ev[np.argsort(ev[:, 2])]
    return SyntheticImplicitDataset(
        n_users=n_users, n_items=n_items,
        age=age, country=country, gender=gender, device=device,
        n_age=n_age, n_country=n_country, n_gender=n_gender, n_device=n_device,
        events=ev,
    )
