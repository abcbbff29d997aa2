"""Durable files and tree digests for every on-disk artifact of the port.

Port of the reference package's ``core/durable_io.py``. The deployment
artifact (``serving.convert``), the search checkpoints
(``core.checkpointing``) and the training checkpoints
(``training.checkpoint``) write through it. The file format and the digest
are the reference's, so either package reads what the other wrote:

- ``atomic_write_bytes``: tmp file + data sync + ``os.replace`` + parent
  directory fsync. A crash at any point leaves the previous file intact
  or the new one complete; a torn tmp file is swept by the next save;
- ``write_checksummed``/``read_checksummed``: a one-line header
  (``REPRO-CKPT1 <sha256> <length>``) in front of the payload, verified on
  read (``CorruptFileError`` on any mismatch), so callers fall back to the
  previous good generation instead of loading garbage;
- ``flatten_tree``/``unflatten_like``/``tree_digest`` over nested dicts
  (and lists or tuples) of tensors or numpy arrays, with ``/``-joined keys.
  ``tree_digest`` equals the reference's for the same tree.

Fault-injection hook: ``REPRO_CKPT_CRASH_AFTER_TMP=K`` makes the K-th
``write_checksummed`` call of the process SIGKILL it after the tmp file is
written and before the rename: the torn write that the kill-and-resume
tests recover from.
"""
from __future__ import annotations

import hashlib
import os
import signal
from typing import Any, Dict

import numpy as np

SEP = "/"

_MAGIC = b"REPRO-CKPT1"

# countdown of the torn-write fault hook, read from the environment at the
# first write so that a child process can arm it per run
_crash_countdown = None


class CorruptFileError(RuntimeError):
    """A durable file failed its integrity check (torn write, truncation,
    bit rot). Callers fall back to the previous good copy."""


def sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


_fdatasync = getattr(os, "fdatasync", os.fsync)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Durable atomic file replacement: write ``path``'s new content to a
    tmp file, sync it, rename over ``path``, fsync the directory."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        _fdatasync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))


def _maybe_crash_after_tmp() -> None:
    """Torn-write fault hook (see the module docstring): SIGKILL with the
    tmp file on disk and the rename never issued."""
    global _crash_countdown
    if _crash_countdown is None:
        _crash_countdown = int(os.environ.get("REPRO_CKPT_CRASH_AFTER_TMP",
                                              0) or 0)
    if _crash_countdown <= 0:
        return
    _crash_countdown -= 1
    if _crash_countdown == 0:
        os.kill(os.getpid(), signal.SIGKILL)


def write_checksummed(path: str, payload: bytes, *,
                      sync: bool = True) -> None:
    """Atomically write ``header + payload``; the header carries the
    payload's sha256 and length. ``sync=False`` skips the data and directory
    syncs, deferring power-loss durability to a later
    ``fsync_path``/``fsync_dir`` (one seal per search). Atomicity and the
    checksum are unaffected, and process death never needs a sync: the
    page cache survives it."""
    header = b"%s %s %d\n" % (_MAGIC, sha256_bytes(payload).encode(),
                              len(payload))
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o666)
    try:
        view = memoryview(header + payload)
        while view:
            view = view[os.write(fd, view):]
        if sync:
            _fdatasync(fd)
    finally:
        os.close(fd)
    _maybe_crash_after_tmp()
    os.replace(tmp, path)
    if sync:
        fsync_dir(os.path.dirname(path))


def fsync_path(path: str) -> None:
    """Flush an already-written file's data to stable storage (the seal
    half of ``write_checksummed(..., sync=False)``)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        _fdatasync(fd)
    finally:
        os.close(fd)


def read_checksummed(path: str) -> bytes:
    """Read and verify a ``write_checksummed`` file; raises
    ``CorruptFileError`` on truncation, digest mismatch or a mangled
    header."""
    with open(path, "rb") as f:
        header = f.readline()
        payload = f.read()
    parts = header.split()
    if len(parts) != 3 or parts[0] != _MAGIC:
        raise CorruptFileError(f"{path}: bad header {header[:64]!r}")
    try:
        expect_len = int(parts[2])
    except ValueError:
        raise CorruptFileError(f"{path}: non-integer length in header")
    if len(payload) != expect_len:
        raise CorruptFileError(f"{path}: truncated payload "
                               f"({len(payload)} of {expect_len} bytes)")
    if sha256_bytes(payload) != parts[1].decode():
        raise CorruptFileError(f"{path}: sha256 mismatch")
    return payload


def sweep_tmp_files(directory: str) -> int:
    """Delete leftover ``*.tmp-<pid>`` files of crashed writers; returns
    the count removed. Safe concurrently: live writers use their own pid."""
    removed = 0
    if not os.path.isdir(directory):
        return removed
    for name in os.listdir(directory):
        if ".tmp-" in name:
            try:
                os.remove(os.path.join(directory, name))
                removed += 1
            except FileNotFoundError:
                pass   # another sweeper got it first; nothing to clean
    return removed


# ------------------------------------------------------- tree <-> flat

def flatten_tree(tree) -> Dict[str, Any]:
    """Flatten nested dicts / lists / tuples to {joined-path: leaf} with
    ``/``-joined keys, in the reference's order (dict keys sorted, as
    ``jax.tree_util`` flattens them; ``None`` is an empty subtree)."""
    flat: Dict[str, Any] = {}
    _flatten_into(flat, tree, [])
    return flat


def _flatten_into(flat, node, path) -> None:
    # module level, not a closure: a recursive closure is a reference cycle
    # that would hold ``flat`` (tensors on the card) until the garbage
    # collector runs
    if node is None:
        return
    if isinstance(node, dict):
        items = [(k, node[k]) for k in sorted(node)]
    elif isinstance(node, (list, tuple)):
        items = list(enumerate(node))
    else:
        flat[SEP.join(path)] = node
        return
    for k, v in items:
        _flatten_into(flat, v, path + [str(k)])


def _map_like(template, fn, path=()):
    """``template``'s nested dicts / lists / tuples with each leaf replaced
    by ``fn(path, leaf)``; ``None`` stays an empty subtree."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _map_like(v, fn, path + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_map_like(v, fn, path + (str(i),))
                              for i, v in enumerate(template))
    return fn(path, template)


def _leaf_like(leaf, arr: np.ndarray):
    """``arr`` in the form of the template ``leaf``: a tensor with its dtype
    on its device, or (a numpy leaf) the array itself. Void arrays (how
    ``np.savez`` and the frame container store bfloat16) are re-viewed with
    the leaf's dtype."""
    if not hasattr(leaf, "detach"):                  # a numpy template leaf
        if arr.dtype.kind == "V":
            arr = arr.view(np.dtype(leaf.dtype))
        return arr
    import torch
    if arr.dtype.kind == "V":                        # raw bf16 bytes
        t = torch.from_numpy(np.ascontiguousarray(arr).view(
            np.dtype(f"i{arr.dtype.itemsize}")).copy()).view(leaf.dtype)
    else:
        t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    return t.to(device=leaf.device, dtype=leaf.dtype)


def unflatten_like(template, flat: Dict[str, np.ndarray]):
    """Rebuild ``template``'s nested structure from a ``flatten_tree``-keyed
    dict of host arrays. Where a template leaf is a tensor the rebuilt leaf
    is a tensor with that leaf's dtype on that leaf's device."""
    def rebuild(path, leaf):
        return _leaf_like(leaf, np.asarray(flat[SEP.join(path)]))
    return _map_like(template, rebuild)


def leaf_array(leaf) -> np.ndarray:
    """A leaf (tensor, array or scalar) as a host numpy array; bf16 tensors
    become ``ml_dtypes.bfloat16`` arrays, as a JAX bf16 array does. A
    DTensor is gathered whole first (a collective: every rank calls it)."""
    if hasattr(leaf, "detach"):                      # a torch tensor
        from repro_torch.models.common import tensor_to_numpy
        if hasattr(leaf, "full_tensor"):
            leaf = leaf.full_tensor()
        return tensor_to_numpy(leaf)
    return np.asarray(leaf)


def host_tree(tree):
    """``tree`` with every leaf copied to a host numpy array
    (``leaf_array``), the structure kept: a snapshot that a writer thread
    can read while the device goes on."""
    return _map_like(tree, lambda path, leaf: leaf_array(leaf))


def tree_digest(tree) -> str:
    """Content digest of a tree: sha256 over the sorted flat keys plus each
    leaf's dtype, shape and bytes. Equal to the reference's ``tree_digest``
    for the same content, whichever package holds it."""
    h = hashlib.sha256()
    flat = {k: leaf_array(v) for k, v in flatten_tree(tree).items()}
    for key in sorted(flat):
        arr = flat[key]
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()
