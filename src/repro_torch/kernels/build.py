"""Build and load the hand-written CUDA kernels (``kernels/*/csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``. A build runs at the
kernel's first launch, never at import, into ``build/repro_torch/`` at the
root of the checkout (listed in ``.gitignore``). A library's name carries
a hash of the source and of the flags, so an edited source or a changed
tile size rebuilds, and a finished build is moved into place in one
rename, so two processes building at once cannot load a half-written
file. :func:`build_all` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built at their first "
            "launch and need the CUDA toolkit (PATH or CUDA_HOME)")
    return str(path)


class CudaLibrary:
    """One kernel source and its compile-time defines. :meth:`load` builds
    it if needed and returns the ``ctypes.CDLL`` with ``bind`` applied
    (the function that sets each entry point's argtypes and restype);
    the source exports ``<name>_error_string`` for :meth:`check`."""

    def __init__(self, name: str, source: Path, defines=None, bind=None):
        self.name = name
        self.source = Path(source)
        self.defines = dict(defines or {})
        self.bind = bind
        self.build_log = ""  # nvcc's -Xptxas -v report of the last build
        self._lib = None

    def flags(self) -> list:
        return [*ARCH_FLAGS, *(f"-D{k}={v}" for k, v in self.defines.items())]

    def path(self) -> Path:
        tag = hashlib.sha256(self.source.read_bytes()
                             + " ".join(self.flags()).encode())
        return BUILD_DIR / f"lib{self.name}_{tag.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the library if this source and these flags have not
        been built yet; returns its path."""
        out = self.path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *self.flags(), "-o", str(tmp), str(self.source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {self.source.name} (exit "
                f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        self.build_log = proc.stdout + proc.stderr
        os.replace(tmp, out)
        return out

    def load(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            if self.bind is not None:
                self.bind(lib)
            self._lib = lib
        return self._lib

    def check(self, rc: int, what: str) -> None:
        """Raise if an entry point returned a CUDA error code; every
        source exports ``<name>_error_string`` to decode it."""
        if rc != 0:
            msg = getattr(self.load(), f"{self.name}_error_string")(rc)
            raise RuntimeError(
                f"{what} kernel launch failed: {msg.decode()} ({rc})")


def build_all(libraries) -> list:
    """Build every library at once, one ``nvcc`` each; returns their
    paths in order. The first failure raises."""
    libraries = list(libraries)
    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        return list(pool.map(lambda lib: lib.build(), libraries))
