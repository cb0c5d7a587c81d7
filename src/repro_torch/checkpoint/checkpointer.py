"""Fault-tolerant checkpointing (port of
``repro.checkpoint.checkpointer``, with its on-disk layout).

  * **Atomicity** — writes go to ``step_N.tmp/`` and are renamed to
    ``step_N/`` only after the manifest fsyncs; a crash mid-write can never
    corrupt the latest valid checkpoint.
  * **Manifest** — JSON with step, per-leaf key path, dtype, shape and a
    sha256 of each ``leaf_i.npy``; restore validates before use.
  * **Async** — ``save(...)`` copies the state to host memory at once
    (device→host, synchronous, so later steps cannot change the snapshot)
    and writes the files on a thread; ``wait()`` joins.
  * **Retention** — keep the newest ``keep`` checkpoints, delete older ones
    after a successful save.

The layout is the reference's, leaf paths included (``.w`` for a
NamedTuple field, ``['w']`` for a dict key, ``[0]`` for a sequence index,
joined by ``/``; ``repro_torch.optim.base.tree_flatten_with_path``), so a
checkpoint written by either package restores in the other. A restored
leaf keeps the file's dtype and goes to the device of the target's leaf
(the CPU for a non-tensor target leaf).

Sharded state (the reference's elastic path, on ``torch.distributed``):

  * ``save`` takes DTensor leaves. Every rank of their mesh calls it:
    each leaf is gathered whole with ``full_tensor()`` (a collective),
    only the rank with ``hosts.process_index() == 0`` writes, and a
    barrier over the mesh after the write keeps every rank from
    returning, and so from restoring, before the files exist. Such a
    save blocks.
  * ``restore(..., shardings=)`` places each leaf with
    ``distribute_tensor`` on its ``launch.sharding.NamedSharding`` (a
    tree of the target's structure; ``None`` leaves a leaf unsharded).
    Every rank reads the same files and keeps its own slice, so restoring
    needs no collective, and a checkpoint saved on one mesh restores onto
    any other (``runtime.elastic``).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.optim.base import tree_flatten_up_to, tree_flatten_with_path
from repro_torch.runtime import collectives, hosts


def _to_host(x) -> np.ndarray:
    """A leaf as a host array of its own (a CPU tensor is copied too, so
    later in-place updates cannot reach the writer thread); bfloat16,
    which numpy lacks, as its raw 2-byte words (the manifest keeps the
    dtype name)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.dtype("V2"))
        return x.numpy()
    return np.asarray(x)


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        words = np.array(arr, order="C").view(np.int16)
        return torch.from_numpy(words).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _dtensor_meshes(leaves) -> list:
    """The distinct meshes of the DTensor leaves. Each must hold process 0,
    which writes, and this rank, which takes part in the gather."""
    meshes = []
    for x in leaves:
        mesh = x.device_mesh if _is_dtensor(x) else None
        if mesh is None or mesh in meshes:
            continue
        if 0 not in mesh.mesh.flatten().tolist():
            raise ValueError("process 0 writes a sharded checkpoint; a "
                             "DTensor leaf's mesh must hold it")
        if mesh.get_coordinate() is None:
            raise ValueError("this rank is outside the mesh of a DTensor "
                             "leaf; only the mesh's ranks save it")
        meshes.append(mesh)
    return meshes


def _distributed(t: torch.Tensor, sh) -> torch.Tensor:
    """The whole leaf ``t`` (the same on every rank) as a DTensor on
    ``sh``: each rank keeps its own slice, with no collective."""
    from torch.distributed.tensor import distribute_tensor

    device = "cuda" if sh.mesh.device_type == "cuda" else "cpu"
    return distribute_tensor(t.to(device), sh.mesh, sh.placements,
                             src_data_rank=None)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save ----
    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        """Snapshot ``state`` (device→host now) and write asynchronously;
        with DTensor leaves, gather them, write on process 0 and wait at
        a barrier over their mesh."""
        paths, leaves, _ = tree_flatten_with_path(state)
        meshes = _dtensor_meshes(leaves)
        if meshes:
            leaves = [x.full_tensor() if _is_dtensor(x) else x for x in leaves]
            if hosts.process_index() != 0:
                for mesh in meshes:
                    collectives.mesh_barrier(mesh)
                return
            blocking = True
        host_leaves = [_to_host(x) for x in leaves]  # snapshot
        dtypes = [str(x.dtype).removeprefix("torch.")
                  if isinstance(x, torch.Tensor) else str(h.dtype)
                  for x, h in zip(leaves, host_leaves)]
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, paths, host_leaves, dtypes),
            daemon=True)
        self._thread.start()
        if blocking:
            self.wait()
        for mesh in meshes:
            collectives.mesh_barrier(mesh)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, paths, host_leaves, dtypes) -> None:
        final = os.path.join(self.directory, f"step_{step:010d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (path, arr, dtype) in enumerate(zip(paths, host_leaves, dtypes)):
            fname = f"leaf_{i:05d}.npy"
            fpath = os.path.join(tmp, fname)
            np.save(fpath, arr)
            with open(fpath, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            manifest["leaves"].append(
                {"path": path, "file": fname, "dtype": dtype,
                 "shape": list(arr.shape), "sha256": digest}
            )
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True
            )

    # ---------------------------------------------------------- restore ----
    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any, shardings: Any = None) -> Any:
        """Restore into the structure of ``target``, each leaf on the
        device of ``target``'s leaf, or, with ``shardings``, distributed
        on its sharding."""
        from repro_torch.launch.sharding import NamedSharding

        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        paths, leaves, unflatten = tree_flatten_with_path(target)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        if set(paths) != set(by_path):
            missing = set(paths) ^ set(by_path)
            raise ValueError(f"checkpoint structure mismatch: {sorted(missing)[:5]}")

        if shardings is None:
            shard_leaves = [None] * len(leaves)
        else:
            try:
                shard_leaves = tree_flatten_up_to(target, shardings)
            except ValueError:
                raise ValueError("shardings= must be a tree of the target's "
                                 "structure") from None
            for path, sh in zip(paths, shard_leaves):
                if sh is not None and not isinstance(sh, NamedSharding):
                    raise TypeError(
                        f"{path}: shardings= takes launch.sharding."
                        f"NamedSharding leaves, got {type(sh).__name__}")
        out = []
        for path, ref_leaf, sh in zip(paths, leaves, shard_leaves):
            entry = by_path[path]
            fpath = os.path.join(d, entry["file"])
            with open(fpath, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            if digest != entry["sha256"]:
                raise IOError(f"checksum mismatch in {fpath}")
            arr = np.load(fpath)
            shape = tuple(getattr(ref_leaf, "shape", np.shape(ref_leaf)))
            if tuple(arr.shape) != shape:
                raise ValueError(f"{path}: shape {arr.shape} != target {shape}")
            if sh is not None:
                out.append(_distributed(_from_host(arr, entry["dtype"], "cpu"), sh))
                continue
            device = (ref_leaf.device if isinstance(ref_leaf, torch.Tensor)
                      else "cpu")
            out.append(_from_host(arr, entry["dtype"], device))
        return unflatten(out)

    def restore_latest(self, target: Any, shardings: Any = None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target, shardings)
