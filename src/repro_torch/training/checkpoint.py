"""Training checkpoints: atomic, checksummed, keep-k, async.

Port of the reference package's ``training/checkpoint.py``, in its layout,
so either package restores what the other saved:
``<dir>/step_<N>/arrays.npz`` (the flat ``/``-joined keys of
``durable_io.flatten_tree``) + ``manifest.json`` (step, keys, time and the
sha256 of ``arrays.npz``). Every file is written and synced before the tmp
directory is renamed into place and the parent directory fsynced, so a
crash mid-save never corrupts the latest checkpoint. ``restore`` verifies
the checksum and rebuilds the template's structure with every tensor on
its template leaf's device.

At a full-size model the checksum costs as much as the write: ``save``
writes the npz straight to its file and reads it back through sha256 on a
worker thread while the file is synced; ``restore`` hashes the bytes on a
worker thread while ``np.load`` parses them, and returns nothing before
the digest is checked (hashlib releases the GIL on large buffers).

``restore(..., shardings=)`` restores onto a device mesh, as the
reference does: each leaf is read whole and placed on its ``Sharding``
(``distributed/sharding.py``), each rank keeping its own slice, so a
checkpoint saved on any mesh (or none) restores onto any other. A sharded
tree saves as whole tensors (``durable_io.leaf_array`` gathers a DTensor),
so the files are the same whichever mesh wrote them.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from repro_torch.core.durable_io import (CorruptFileError, flatten_tree,
                                         fsync_dir, fsync_path, host_tree,
                                         leaf_array, sha256_bytes,
                                         unflatten_like)
from repro_torch.distributed.sharding import place_tree

_CHUNK = 64 << 20


def _write_fsynced(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    buf = memoryview(bytearray(_CHUNK))
    with open(path, "rb", buffering=0) as f:
        while True:
            n = f.readinto(buf)
            if not n:
                return h.hexdigest()
            h.update(buf[:n])


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         extra: Optional[dict] = None) -> str:
    """Atomic synchronous save of ``tree`` (nested dicts of tensors or
    arrays) as step ``step``; prunes to the newest ``keep`` steps (0 keeps
    all). Returns the checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = {k: leaf_array(v) for k, v in flatten_tree(tree).items()}
    arrays = os.path.join(tmp, "arrays.npz")
    np.savez(arrays, **flat)
    with ThreadPoolExecutor(1) as pool:       # hash while the file syncs
        digest = pool.submit(_sha256_file, arrays)
        fsync_path(arrays)
        checksum = digest.result()
    manifest = {"step": step, "keys": sorted(flat), "time": time.time(),
                "checksums": {"arrays.npz": checksum}}
    if extra:
        manifest.update(extra)
    _write_fsynced(os.path.join(tmp, "manifest.json"),
                   json.dumps(manifest).encode())
    fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    fsync_dir(ckpt_dir)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, target_tree, step: Optional[int] = None,
            shardings=None):
    """Restore step ``step`` (default: the newest) into the structure of
    ``target_tree``: each leaf takes its template leaf's dtype and device
    (``durable_io.unflatten_like``) and, with ``shardings`` (a matching
    tree of ``Sharding``), its placements on that mesh. Returns (tree,
    step); raises ``CorruptFileError`` when ``arrays.npz`` fails its
    checksum."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "arrays.npz"), "rb") as f:
        arrays = f.read()
    expect = None
    manifest_path = os.path.join(path, "manifest.json")
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
        expect = manifest.get("checksums", {}).get("arrays.npz")
    with ThreadPoolExecutor(1) as pool:       # hash while np.load parses
        digest = pool.submit(sha256_bytes, arrays) if expect else None
        try:
            with np.load(io.BytesIO(arrays)) as z:
                flat = {k: z[k] for k in z.files}
        except Exception:
            if digest is None or digest.result() == expect:
                raise
            flat = None
        if digest is not None and digest.result() != expect:
            raise CorruptFileError(
                f"{path}/arrays.npz sha256 mismatch — checkpoint is "
                "corrupt; restore an earlier step")
    tree = unflatten_like(target_tree, flat)
    if shardings is not None:
        tree = place_tree(tree, shardings)
    return tree, step


class AsyncCheckpointer:
    """Off-critical-path saves: snapshot to the host on the caller's
    thread, write in a worker thread. One in-flight save at a time (a newer
    request supersedes a queued one)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._lock = threading.Lock()
        self._pending: Optional[tuple] = None
        self._thread: Optional[threading.Thread] = None
        self.saved_steps: List[int] = []

    def save(self, step: int, tree, extra: Optional[dict] = None) -> None:
        snapshot = host_tree(tree)
        with self._lock:
            self._pending = (step, snapshot, extra)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._drain,
                                                daemon=True)
                self._thread.start()

    def _drain(self) -> None:
        while True:
            with self._lock:
                if self._pending is None:
                    return
                step, tree, extra = self._pending
                self._pending = None
            save(self.ckpt_dir, step, tree, keep=self.keep, extra=extra)
            self.saved_steps.append(step)

    def wait(self) -> None:
        t = self._thread
        if t is not None:
            t.join()
