"""Data loading: host-sharded batch iterators and the MovieLens-class loader
(port of ``repro.data.loader``).

Sharded iterators: each host yields only its slice of the global batch
(slice index = :func:`repro_torch.runtime.hosts.process_index`, the rank
when ``torch.distributed`` is initialised). In one process the iterators
yield the full batch, same code path.

MovieLens-class loading: :func:`load_movielens` reads a ``u.data``-style
ratings file (``user item value timestamp`` per line) from an explicit path
or the cache directory, falling back to a DETERMINISTIC synthetic event log
(written through the same cache file, so the parse path is always the one
exercised; the same seed writes the same bytes as the reference, whose
generator :mod:`repro_torch.data.synthetic` mirrors array for array).
:func:`frequency_interactions` collapses the event log into unique
``(user, item)`` cells with Hu-et-al. frequency confidence — the source of
the per-interaction ``weights=`` vectors of the training paths.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.implicit import confidence_weights, frequency_confidence
from repro_torch.runtime import hosts
from repro_torch.sparse.interactions import Interactions, build_interactions


def _host_slice(global_batch: int) -> slice:
    """This host's contiguous slice of a ``global_batch``-sized batch.

    Balanced split: host ``i`` takes ``[i·n//H, (i+1)·n//H)``, so the union
    over hosts covers every element even when ``H`` does not divide ``n``.
    """
    n_hosts = hosts.process_count()
    i = hosts.process_index()
    lo = (i * global_batch) // n_hosts
    hi = ((i + 1) * global_batch) // n_hosts
    return slice(lo, hi)


def interaction_stream(
    ds, *, batch_events: int = 1024, start: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Time-ordered replay of a
    :class:`~repro_torch.data.synthetic.SyntheticImplicitDataset` (or any
    object with an ``events`` (n, 3) array of ``user, item, t``): yields
    the event log in arrival order, ``batch_events`` at a time — the
    traffic source of the continual-learning loop.

    The iterator is FINITE (a log replay, not a sampler) and the final
    partial batch is yielded. Each host takes its contiguous slice of every
    batch; in one process that is the full batch.
    """
    events = np.asarray(ds.events)
    for lo in range(int(start), len(events), int(batch_events)):
        chunk = events[lo : lo + batch_events]
        sl = _host_slice(len(chunk))
        part = chunk[sl] if hosts.process_count() > 1 else chunk
        yield {
            "ctx": part[:, 0].astype(np.int32),
            "item": part[:, 1].astype(np.int32),
            "t": part[:, 2].astype(np.int64),
        }


def sharded_batches(
    make_batch, global_batch: int, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Generic host-sharded iterator: make_batch(rng, n) → dict of arrays."""
    rng = np.random.default_rng(seed + hosts.process_index())
    sl = _host_slice(global_batch)
    n = sl.stop - sl.start
    while True:
        yield make_batch(rng, n)


# ---------------------------------------------------- MovieLens-class -------

@dataclasses.dataclass(frozen=True)
class ImplicitLog:
    """Raw per-event implicit log, before :class:`Interactions`.

    ``value`` is the event's count increment (1 for a plain view; a rating
    parsed from a MovieLens file plays the same role — a frequency proxy
    for the confidence derivation).
    """

    user: np.ndarray    # (n_events,) int64
    item: np.ndarray    # (n_events,) int64
    value: np.ndarray   # (n_events,) float32
    t: np.ndarray       # (n_events,) int64 timestamps
    n_users: int
    n_items: int

    @property
    def n_events(self) -> int:
        return int(self.user.shape[0])


def _cache_path(cache_dir: Optional[str]) -> str:
    base = cache_dir or os.environ.get("REPRO_DATA_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "repro-data"
    )
    return os.path.join(base, "ml-synth.data")


def _parse_ratings(path: str) -> ImplicitLog:
    """Parse ``user item value timestamp`` lines (tab/space separated —
    the ml-100k ``u.data`` layout). Ids are remapped to dense 0-based."""
    raw = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if raw.shape[1] < 3:
        raise ValueError(f"{path}: expected ≥3 columns (user item value [t])")
    user_raw = raw[:, 0].astype(np.int64)
    item_raw = raw[:, 1].astype(np.int64)
    users, user = np.unique(user_raw, return_inverse=True)
    items, item = np.unique(item_raw, return_inverse=True)
    t = (raw[:, 3] if raw.shape[1] > 3 else np.arange(len(raw))).astype(np.int64)
    return ImplicitLog(
        user=user.astype(np.int64), item=item.astype(np.int64),
        value=raw[:, 2].astype(np.float32), t=t,
        n_users=int(len(users)), n_items=int(len(items)),
    )


def load_movielens(
    path: Optional[str] = None,
    *,
    cache_dir: Optional[str] = None,
    n_users: int = 400,
    n_items: int = 300,
    events_per_user: Tuple[int, int] = (4, 16),
    seed: int = 0,
) -> ImplicitLog:
    """Load a MovieLens-class ratings log.

    Resolution order:
      1. explicit ``path`` (must exist) — a real ``u.data``-style file;
      2. the cache file under ``cache_dir`` / ``$REPRO_DATA_DIR`` /
         ``~/.cache/repro-data`` if a previous call wrote it;
      3. deterministic synthetic fallback (seeded
         :func:`~repro_torch.data.synthetic.make_implicit_dataset`), written
         through the cache file in the same format — so every load goes
         through :func:`_parse_ratings` and later calls hit the cache.
    """
    if path is not None:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return _parse_ratings(path)
    cached = _cache_path(cache_dir)
    if not os.path.exists(cached):
        from repro_torch.data.synthetic import make_implicit_dataset

        ds = make_implicit_dataset(
            n_users=n_users, n_items=n_items,
            events_per_user=events_per_user, seed=seed,
        )
        os.makedirs(os.path.dirname(cached), exist_ok=True)
        ev = np.asarray(ds.events)
        table = np.column_stack(
            [ev[:, 0], ev[:, 1], np.ones(len(ev), np.int64), ev[:, 2]]
        )
        tmp = cached + ".tmp"
        np.savetxt(tmp, table, fmt="%d", delimiter="\t")
        os.replace(tmp, cached)
    return _parse_ratings(cached)


def split_by_time(
    log: ImplicitLog, holdout_fraction: float = 0.2
) -> Tuple[ImplicitLog, ImplicitLog]:
    """Global-time-cutoff split (the paper's Instant protocol shape): the
    last ``holdout_fraction`` of events by timestamp become the test log.
    Vocabulary sizes are shared so ids stay aligned across the split."""
    if not 0.0 < holdout_fraction < 1.0:
        raise ValueError("holdout_fraction must be in (0, 1)")
    order = np.argsort(log.t, kind="stable")
    n_test = max(1, int(round(log.n_events * holdout_fraction)))
    tr, te = order[: log.n_events - n_test], order[log.n_events - n_test:]

    def take(idx):
        return ImplicitLog(
            user=log.user[idx], item=log.item[idx], value=log.value[idx],
            t=log.t[idx], n_users=log.n_users, n_items=log.n_items,
        )

    return take(tr), take(te)


def frequency_interactions(
    log: ImplicitLog,
    *,
    alpha0: float = 0.5,
    base_alpha: float = 2.0,
    beta: float = 1.0,
    mode: str = "log",
    eps: float = 1.0,
    device=None,
) -> Tuple[Interactions, torch.Tensor, np.ndarray]:
    """Collapse an event log into unique ``(user, item)`` cells with
    Hu-et-al. frequency confidence, on ``device`` (the GPU unless the
    caller names the CPU).

    Returns ``(data, weights, counts)``:

    ``data``
        :class:`Interactions` over the deduped cells with UNIFORM
        confidence ``base_alpha`` (y=1) — the baseline objective.
    ``weights``
        (nnz,) float32 tensor on ``data``'s device: per-interaction
        confidence weights α_raw/``base_alpha`` in ``data``'s ctx-major
        order (cells are built pre-sorted, so the alignment is exact) —
        feed as ``weights=`` / ``Dataset.confidence`` to train the
        frequency-confidence objective.
    ``counts``
        (nnz,) float32 numpy array: summed event values per cell (the α
        derivation input).
    """
    key = log.user * log.n_items + log.item
    uniq, inv = np.unique(key, return_inverse=True)
    counts = np.zeros(len(uniq), np.float64)
    np.add.at(counts, inv, log.value.astype(np.float64))
    user_u, item_u = uniq // log.n_items, uniq % log.n_items
    # np.unique returns keys sorted ⇒ (user-major, item within) — exactly
    # the ctx-major layout build_interactions sorts to, so weights align.
    data = build_interactions(
        user_u, item_u,
        np.ones(len(uniq), np.float64),
        np.full(len(uniq), float(base_alpha)),
        log.n_users, log.n_items, alpha0=alpha0, device=device,
    )
    alpha_raw = frequency_confidence(counts, beta=beta, mode=mode, eps=eps)
    weights = confidence_weights(alpha_raw, base=float(base_alpha))
    return data, weights.to(data.device), counts.astype(np.float32)
