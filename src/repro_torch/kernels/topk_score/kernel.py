"""Build and bind the hand-written CUDA top-K kernel (``csrc/topk_score.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``. The build runs at the
first launch, never at import, into ``build/repro_torch/`` at the root of
the checkout (listed in ``.gitignore``). The library's name carries a hash
of the source and of the flags, so an edited source or a changed tile size
rebuilds, and a finished build is moved into place in one rename, so two
processes building at once cannot load a half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import vmem

SOURCE = Path(__file__).resolve().parent / "csrc" / "topk_score.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"

_lib = None
build_log = ""  # nvcc's -Xptxas -v report (registers, shared memory, spills)


def _flags() -> list:
    defines = {
        "TOPK_ROWS": vmem.TOPK_ROW_BLOCK,
        "TOPK_DSLAB": vmem.TOPK_D_SLAB,
        "TOPK_MAX_CHUNK": vmem.TOPK_MAX_CHUNK,
        "TOPK_MERGE_SLOTS": vmem.TOPK_MERGE_SLOTS,
        "TOPK_MERGE_THREADS": vmem.TOPK_MERGE_THREADS,
    }
    return [
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        *(f"-D{k}={v}" for k, v in defines.items()),
    ]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found: the topk_score CUDA kernel is built at its first "
            "launch and needs the CUDA toolkit (PATH or CUDA_HOME)")
    return str(path)


def build() -> Path:
    """Compile the kernel library if this source and these flags have not
    been built yet; returns its path."""
    global build_log
    flags = _flags()
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode())
    out = BUILD_DIR / f"libtopk_score_{tag.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *flags, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {SOURCE.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    build_log = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_score_f32.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i,
                                       p, p, p, p, p]
        lib.topk_score_f32.restype = i
        lib.topk_score_error_string.argtypes = [i]
        lib.topk_score_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(phi: torch.Tensor, psi: torch.Tensor, exclude_ids, k: int,
           k_pad: int, chunk: int, id_offset: int, n_valid: int,
           scores: torch.Tensor, ids: torch.Tensor,
           cand: torch.Tensor, cand2: torch.Tensor) -> None:
    """Enqueue both passes on the current stream. ``cand`` holds
    (chunks, B, k_pad) candidate keys and ``cand2`` (⌈chunks/16⌉, B,
    k_pad), the merge levels' other buffer. The caller has checked every
    shape, dtype, device and contiguity (``ops.topk_score``)."""
    lib = _load()
    b, d = phi.shape
    n_rows = psi.shape[0]
    n_excl = 0 if exclude_ids is None else exclude_ids.shape[1]
    excl_ptr = None if n_excl == 0 else exclude_ids.data_ptr()
    # the launches go to the current device, which is φ's only for the
    # call: the caller's current device is left as it was
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        rc = lib.topk_score_f32(
            phi.data_ptr(), psi.data_ptr() if n_rows else None, excl_ptr,
            b, n_rows, d, n_excl, id_offset, n_valid, k, k_pad, chunk,
            cand.data_ptr() if cand.numel() else None, cand2.data_ptr(),
            scores.data_ptr(), ids.data_ptr(), stream,
        )
    if rc != 0:
        msg = lib.topk_score_error_string(rc).decode()
        raise RuntimeError(f"topk_score kernel launch failed: {msg} ({rc})")
