"""Durable files and tree digests for the deployment artifact.

Port of the parts of the reference package's ``core/durable_io.py`` that
the artifact's writer and reader use; the file format and the digest are
the same, so either package reads what the other wrote:

- ``atomic_write_bytes``: tmp file + data sync + ``os.replace`` + parent
  directory fsync;
- ``write_checksummed``/``read_checksummed``: a one-line header
  (``REPRO-CKPT1 <sha256> <length>``) in front of the payload, verified on
  read (``CorruptFileError`` on any mismatch);
- ``flatten_tree``/``tree_digest`` over nested dicts (and lists or tuples)
  of tensors or numpy arrays, with ``/``-joined keys. ``tree_digest``
  equals the reference's for the same tree.

Checkpointing (the reference's torn-write fault hook, ``unflatten_like``,
``sweep_tmp_files``) waits for ROADMAP.md queue 1, item 7.
"""
from __future__ import annotations

import hashlib
import os
from typing import Any, Dict

import numpy as np

SEP = "/"

_MAGIC = b"REPRO-CKPT1"


class CorruptFileError(RuntimeError):
    """A durable file failed its integrity check (torn write, truncation,
    bit rot)."""


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


def write_checksummed(path: str, payload: bytes, *,
                      sync: bool = True) -> None:
    """Atomically write ``header + payload``; the header carries the
    payload's sha256 and length. ``sync=False`` skips the data and directory
    syncs (atomicity and the checksum are unaffected)."""
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
    os.replace(tmp, path)
    if sync:
        fsync_dir(os.path.dirname(path))


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


# ------------------------------------------------------- tree <-> flat

def flatten_tree(tree) -> Dict[str, Any]:
    """Flatten nested dicts / lists / tuples to {joined-path: leaf} with
    ``/``-joined keys, in the reference's order (dict keys sorted, as
    ``jax.tree_util`` flattens them; ``None`` is an empty subtree)."""
    flat: Dict[str, Any] = {}

    def walk(node, path):
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
            walk(v, path + [str(k)])

    walk(tree, [])
    return flat


def leaf_array(leaf) -> np.ndarray:
    """A leaf (tensor, array or scalar) as a host numpy array; bf16 tensors
    become ``ml_dtypes.bfloat16`` arrays, as a JAX bf16 array does."""
    if hasattr(leaf, "detach"):                      # a torch tensor
        from repro_torch.models.common import tensor_to_numpy
        return tensor_to_numpy(leaf)
    return np.asarray(leaf)


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
