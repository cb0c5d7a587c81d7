"""PyTorch + CUDA port of the ``repro`` iCD package, for one NVIDIA H100.

The JAX package (``repro``) is the reference; this package mirrors its
layout path for path (``repro_torch/serve/mesh.py`` ports
``repro/serve/mesh.py``) and imports neither JAX nor any ``repro`` module.
Every Pallas TPU kernel becomes a hand-written Hopper kernel under
``kernels/*/csrc``; on a CPU tensor each kernel wrapper runs its plain
PyTorch version instead. Importing this package never needs ``nvcc`` or a
GPU: kernels are compiled at their first CUDA launch.

Ported so far:

  * slice 1, the serving path: configs for icd-mf, the fused score + top-K
    kernel, MF's serving functions, the obs spine, the straggler watchdog,
    and the serve tier (cluster, versioned table, fault-tolerant mesh,
    micro-batcher) under ``python -m repro_torch.launch.serve``;
  * slice 2, iCD-MF training: interactions and segment ops, the Lemma 1/2
    objective, the sweep machinery, the segment-sum ``mf`` epoch and the
    kernel-fused ``mf_padded`` epoch over the Gram and block-sweep
    kernels, the retrieval engine, streaming ranking evaluation, the
    training metrics callback, and the quickstart twin
    (``python -m repro_torch.examples.quickstart``).
"""
