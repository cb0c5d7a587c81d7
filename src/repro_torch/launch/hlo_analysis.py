"""Roofline terms of one rank's step (port of
``repro.launch.hlo_analysis``).

The reference reads a compiled XLA module: ``cost_analysis()`` for
per-device FLOPs and bytes, and the HLO text for collective traffic. The
port compiles nothing, so :func:`roofline_from_trace` runs the step once
on ``meta`` tensors (shapes without data; no device allocates anything)
inside a world of torch's ``fake`` backend (``runtime.collectives``):

  flops       ``torch.utils.flop_counter.FlopCounterMode``: the matrix
              product family only (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
              convolutions, attention); elementwise work, segment sums and
              ``mv`` count nothing.
  bytes       :class:`ByteCounter`: each op's tensor inputs and outputs,
              op by op, views and collectives left out. Nothing is fused,
              so it is an upper bound where XLA's count comes after fusion.
  collective  ``collectives.read_bytes()``, each wrapper's payload, on the
              reference's wire model below. A port collective's tensor
              already holds every peer's slice, so all-to-all is 1 ×.

Wire-cost model per op (ring algorithms, per-device bytes), as the
reference's:
  all-reduce       2 × payload        (reduce-scatter + all-gather phases)
  all-gather       1 × result bytes
  reduce-scatter   1 × operand bytes
  all-to-all       1 × payload
  collective-permute 1 × payload

Roofline terms (one NVIDIA H100 SXM, NVIDIA's data sheet):
  compute    = device_flops / PEAK_FLOPS   67 TFLOP/s fp32 outside the tensor
               cores (the parity paths run without TF32)
  memory     = device_bytes / HBM_BW       3.35 TB/s HBM3
  collective = device_collective_bytes / LINK_BW   NVLink 4, 450 GB/s each
               way (the data sheet's 900 GB/s counts both directions)

The HLO text helpers (:func:`collective_bytes`, :func:`_shape_bytes`,
:func:`_group_size`) are copies of the reference's, kept for reading an
XLA dump beside the port's numbers; they give the reference's results.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 67e12        # fp32 per card, outside the tensor cores
HBM_BW = 3.35e12          # bytes/s per card
LINK_BW = 450e9           # bytes/s per card and direction, NVLink 4

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")
_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# the port's collective wrappers (runtime.collectives) by the reference's
# op names, with the wire multiple of each payload
_PORT_COLLECTIVES = {"all_reduce": ("all-reduce", 2.0),
                     "all_gather": ("all-gather", 1.0),
                     "all_to_all": ("all-to-all", 1.0)}

FLOPS_COUNTED = ("torch.utils.flop_counter.FlopCounterMode: the matrix "
                 "product family only (mm, addmm, bmm, baddbmm, convolution, "
                 "attention); elementwise ops, segment sums and mv count 0")
BYTES_COUNTED = ("every op's tensor inputs and outputs, op by op, on meta "
                 "tensors (views, empty allocations and collectives left "
                 "out): unfused, an upper bound where XLA's count comes "
                 "after fusion")
COLLECTIVES_COUNTED = ("runtime.collectives payload bytes: all-reduce 2 x "
                       "the tensor, all-gather 1 x the result, all-to-all 1 x "
                       "the tensor (it holds every peer's slice)")


def _shape_bytes(dtype: str, dims: str) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Per-collective-kind wire bytes (per device) from an SPMD HLO dump."""
    out = {k: 0.0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        stripped = line.strip()
        head = stripped.split("metadata=")[0]
        # op instructions look like: %x = f32[...] all-reduce(%y), ...
        kind = None
        for k in _COLLECTIVES:
            if f" {k}(" in head or f" {k}-start(" in head:
                kind = k
                break
        if kind is None:
            continue
        shapes = _SHAPE_RE.findall(head)
        if not shapes:
            continue
        payload = max(_shape_bytes(dt, dims) for dt, dims in shapes)
        mult = 2.0 if kind == "all-reduce" else 1.0
        if kind == "all-to-all":
            # HLO prints the per-peer SLICE shape; per-device wire bytes are
            # slice × group size (the op exchanges one slice with every peer)
            mult = float(_group_size(stripped))
        out[kind] += mult * payload
        counts[kind] += 1
    out["_counts"] = counts
    return out


def _group_size(line: str) -> int:
    """Replica group size from 'replica_groups={{0,1,..}},..' or
    'replica_groups=[G,N]<=[...]' (G groups of N)."""
    m = re.search(r"replica_groups=\[\d+,(\d+)\]", line)
    if m:
        return int(m.group(1))
    m = re.search(r"replica_groups=\{\{([0-9, ]+)\}", line)
    if m:
        return m.group(1).count(",") + 1
    return 1


@dataclasses.dataclass
class Roofline:
    flops: float              # per device
    bytes_accessed: float     # per device
    coll_bytes: float         # per device (wire model above)
    coll_breakdown: Dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def fraction_of_roofline(self) -> float:
        """How much of the bound time is the compute term — 1.0 means pure
        compute-bound (ideal); lower means memory/collective dominate."""
        return self.compute_s / max(self.bound_s, 1e-30)

    def to_dict(self):
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes_per_device": self.coll_bytes,
            "collective_breakdown": self.coll_breakdown,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "roofline_fraction": self.fraction_of_roofline(),
        }


def normalize_cost_analysis(ca) -> Dict[str, float]:
    """``Compiled.cost_analysis()`` returns a dict on current jax but a
    one-dict-per-computation list on older releases; normalize to a dict."""
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    return ca or {}


def tensors_of(tree) -> List[torch.Tensor]:
    """Every tensor in a tree of tuples, lists, dicts, NamedTuples and
    dataclasses (a ``ShardedMF``), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors_of(x)]
    return []


def _nbytes(tree) -> int:
    return sum(t.nbytes for t in tensors_of(tree))


_NO_TRAFFIC = ("empty", "new_empty", "empty_like", "empty_strided")


class ByteCounter(TorchDispatchMode):
    """Sums, op by op, the bytes of each op's tensor inputs and outputs:
    each input read once and each output written once, nothing fused.
    Views (which move nothing), allocations of uninitialised memory and
    the collectives' own ops (their traffic is the collective term) count
    nothing. ``log`` keeps one ``(op, bytes)`` entry an op."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.log: List[Tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.namespace in ("c10d", "_c10d_functional")
                or func.__name__.split(".")[0] in _NO_TRAFFIC):
            n = _nbytes((args, kwargs or {})) + _nbytes(out)
            self.bytes += n
            self.log.append((str(func), n))
        return out


def roofline(flops: float, bytes_accessed: float,
             payload: Dict[str, int], counts: Dict[str, int]) -> Roofline:
    """The roofline of a step from its counts: ``payload`` and ``counts``
    by the port's collective names (``collectives.read_bytes()`` /
    ``read_counts()``), put on the wire model as the reference's op kinds."""
    breakdown = {name: mult * payload[fn]
                 for fn, (name, mult) in _PORT_COLLECTIVES.items()}
    total = sum(breakdown.values())
    return Roofline(
        flops=float(flops),
        bytes_accessed=float(bytes_accessed),
        coll_bytes=total,
        coll_breakdown={**breakdown, "counts": {
            name: counts[fn] for fn, (name, _) in _PORT_COLLECTIVES.items()}},
        compute_s=flops / PEAK_FLOPS,
        memory_s=bytes_accessed / HBM_BW,
        collective_s=total / LINK_BW,
    )


@dataclasses.dataclass
class StepTrace:
    """One traced run of a step: its outputs (meta tensors), the counts
    behind its :class:`Roofline`, and the byte counter's op log."""

    outputs: Any
    flops: float
    bytes_accessed: float
    counts: Dict[str, int]     # collective calls by wrapper name
    payload: Dict[str, int]    # collective payload bytes by wrapper name
    op_log: List[Tuple[str, int]]
    trace_s: float

    @property
    def roofline(self) -> Roofline:
        return roofline(self.flops, self.bytes_accessed, self.payload,
                        self.counts)


def trace_step(step_fn: Callable, args) -> StepTrace:
    """Run ``step_fn(*args)`` once under the FLOP and byte counters, with
    the collective counts reset first. ``args`` are meta tensors, and the
    caller's world a fake one (``collectives.fake_world``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.runtime import collectives

    # the FLOP counter's first product imports what it needs (≈ 2 s): one
    # product of its own first, so that trace_s is the step's
    with FlopCounterMode(display=False):
        torch.empty((1, 1), device="meta") @ torch.empty((1, 1), device="meta")
    collectives.reset_counts()
    counter = ByteCounter()
    with FlopCounterMode(display=False) as flops, counter:
        t0 = time.perf_counter()
        out = step_fn(*args)
        trace_s = time.perf_counter() - t0
    return StepTrace(outputs=out, flops=float(flops.get_total_flops()),
                     bytes_accessed=float(counter.bytes),
                     counts=collectives.read_counts(),
                     payload=collectives.read_bytes(), op_log=counter.log,
                     trace_s=trace_s)


def roofline_from_trace(step_fn: Callable, args) -> Roofline:
    """The port's ``roofline_from_compiled``: the step traced once on its
    arguments (:func:`trace_step`)."""
    return trace_step(step_fn, args).roofline


NO_TEMP_ESTIMATE = ("meta tensors carry no allocator: no temp or peak "
                    "estimate exists without running the step on a device")


def memory_stats(args, outputs) -> Dict[str, Any]:
    """Argument and output bytes of a traced step. Temporaries and the
    peak are not known on meta tensors: null, with the reason."""
    return {
        "argument_bytes": float(_nbytes(args)),
        "output_bytes": float(_nbytes(outputs)),
        "temp_bytes": None,
        "alias_bytes": None,
        "peak_hbm_estimate": None,
        "not_estimated": NO_TEMP_ESTIMATE,
    }
