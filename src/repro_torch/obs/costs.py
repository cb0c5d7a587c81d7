"""Kernel cost accounting at the dispatch sites (port of
``repro.obs.costs``, rebased on the Hopper kernel's own traffic).

The mesh records one cost per ``topk_score`` dispatch into the metrics
registry: device-memory bytes and FLOPs from the shapes in hand, and the
shared memory of one kernel block. The counts are analytic, computed on
the host; no kernel is instrumented.

Counters (label ``kernel``):

  ``kernel_calls_total``       dispatches
  ``kernel_hbm_bytes_total``   device-memory bytes the kernel moves
  ``kernel_flops_total``       FLOPs
  ``kernel_smem_bytes``        (gauge) shared memory of one pass-1 block
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import vmem
from repro_torch.obs.metrics import resolve_registry


def topk_score_cost(b: int, n_rows: int, d: int, k: int, *,
                    excl_l: int = 0) -> Dict[str, float]:
    """Cost of ONE ``topk_score`` kernel call over ``n_rows`` fp32 ψ rows.

    Bytes: the ψ shard read once per 16-row φ block (pass 1 stages ψ per
    φ block), φ read once, the (B, k) scores and ids written, and the
    exclude-id lists read. The (chunks, B, k_pad) candidate keys that pass
    1 writes and pass 2 reads back are left out. FLOPs: the score
    product's ``2·B·n_rows·D``."""
    row_blocks = -(-b // vmem.TOPK_ROW_BLOCK)
    hbm = (4.0 * row_blocks * n_rows * d + 4.0 * b * d + 8.0 * b * k
           + 4.0 * b * excl_l)
    try:
        chunk = vmem.topk_block_items(vmem.topk_k_pad(k), n_items=n_rows)
        smem = float(vmem.topk_smem_bytes(chunk))
    except vmem.VmemBudgetError:  # k the kernel does not take (CPU only)
        smem = float(vmem.SMEM_STATIC_BYTES)
    return {"hbm_bytes": hbm, "flops": 2.0 * b * n_rows * d,
            "smem_bytes": smem}


class KernelCostRecorder:
    """Registry-bound recorder; resolve once, record per dispatch.

    Children are cached per kernel label, so a dispatch costs a dict hit
    and three float adds. With ``NULL_REGISTRY`` every record is a no-op."""

    def __init__(self, registry=None):
        reg = resolve_registry(registry)
        self._calls = reg.counter(
            "kernel_calls_total", "kernel dispatches", labels=("kernel",))
        self._hbm = reg.counter(
            "kernel_hbm_bytes_total",
            "device-memory bytes the kernel moves (obs/costs.py model)",
            labels=("kernel",))
        self._flops = reg.counter(
            "kernel_flops_total", "analytic FLOPs", labels=("kernel",))
        self._smem = reg.gauge(
            "kernel_smem_bytes",
            "last dispatch's shared memory per kernel block",
            labels=("kernel",))
        self._children: Dict[str, tuple] = {}

    def _resolve(self, kernel: str):
        ch = self._children.get(kernel)
        if ch is None:
            ch = (
                self._calls.labels(kernel=kernel),
                self._hbm.labels(kernel=kernel),
                self._flops.labels(kernel=kernel),
                self._smem.labels(kernel=kernel),
            )
            self._children[kernel] = ch
        return ch

    def record(self, kernel: str, cost: Dict[str, float],
               calls: int = 1) -> None:
        calls_c, hbm_c, flops_c, smem_g = self._resolve(kernel)
        calls_c.inc(calls)
        hbm_c.inc(cost["hbm_bytes"])
        flops_c.inc(cost["flops"])
        smem_g.set(cost.get("smem_bytes", 0.0))

    def record_topk(self, b: int, n_rows: int, d: int, k: int, *,
                    kernel: str = "topk_score", excl_l: int = 0) -> None:
        self.record(kernel, topk_score_cost(b, n_rows, d, k, excl_l=excl_l))
