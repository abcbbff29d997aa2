"""Crash-safe search state: the on-disk ``SearchStore`` and the
capture/restore plumbing behind ``SearchSession.run(checkpoint_dir=...,
resume=True)``.

Port of the reference package's ``core/checkpointing.py``. The bytes on
disk are the reference's (the frame container, ``KEY.json`` and
``SETTINGS.json``, the hashed directory names, the generation file names
and the checksummed header), so a store written by either package loads
in the other for the same parameters. Beacon parameters are copied to the
host on the search's thread (``capture_state``): the saver's writer
thread never touches a device tensor. Loaded beacon parameters land on
the device of the template's leaves (the target's params).

What makes exact resume possible
--------------------------------
The GA's SeedSequence invariant (see ``nsga2.NSGA2``): generation ``gen``
always draws its variation RNG from spawned child ``1 + gen`` of the
master ``SeedSequence(seed)`` — a pure function of (seed, spawn index).
Resuming therefore re-spawns the SAME child streams without replaying any
draws; together with the serialized population/history/memo (and, for
beacon searches, the retrained parameters plus the retrain-stream
fast-forward ``skip_retrains``) the resumed run's final Pareto front is
bit-identical to the uninterrupted one. Nothing here is approximate:
fronts compare with ``==``.

Store layout
------------
::

    <root>/<key-hash>/               one search identity
        KEY.json                       the content address (informational)
        <settings-hash>/               one run configuration
            SETTINGS.json
            gen_00000.ckpt             state after the initial population
            gen_00003.ckpt             state after generation 3, ...

The key is content-addressed: (target fingerprint, platform name + SRAM,
menu, seed), where the fingerprint hashes the target's layer names, menu
and full parameter tree — resuming against a different model or platform
is structurally impossible (``CheckpointMismatchError``), not a silent
wrong answer. Run settings (generations/pop/initial/objectives/beacon
config) hash into a sub-directory so different runs of one search
identity never overwrite each other.

Each ``gen_*.ckpt`` file is one atomic, checksummed blob
(``durable_io.write_checksummed``): a flat framed container holding the
population / history / memo / beacon-parameter arrays plus an embedded
JSON manifest (counters, beacon allocs + digests, quarantine log,
running front).
``load_latest`` walks generations newest-first and skips corrupt or torn
files — a crash mid-checkpoint-write costs at most one checkpoint, never
the run.
"""
from __future__ import annotations

import itertools
import json
import os
import queue
import struct
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import durable_io
from repro_torch.core.nsga2 import Individual

Alloc = Dict[str, Tuple[int, int]]

_FORMAT_VERSION = 1


class CheckpointMismatchError(RuntimeError):
    """A checkpoint exists but belongs to a different search identity or
    run configuration — resuming from it would be silently wrong."""


# ------------------------------------------------------------------ keys

def target_fingerprint(target) -> str:
    """Content fingerprint of a ``SearchTarget``: layer names, menu, and
    the full parameter tree. Two processes that trained the same model the
    same way agree; any drift in the model makes old checkpoints
    unloadable (by design)."""
    h = durable_io.sha256_bytes(json.dumps(
        {"layer_names": list(target.layer_names),
         "menu": [int(b) for b in target.menu]},
        sort_keys=True).encode())
    return durable_io.sha256_bytes(
        (h + durable_io.tree_digest(target.params)).encode())[:32]


def search_key(target, hardware, seed: int,
               sram_bytes: Optional[int] = None) -> dict:
    """The store key (content address) of one search identity:
    (target fingerprint, platform, menu, seed). ``sram_bytes`` overrides
    the platform's bound (the session's ``sram_override``); platforms
    without an SRAM constraint key as null."""
    if sram_bytes is None:
        sram_bytes = hardware.sram_bytes
    return {"fingerprint": target_fingerprint(target),
            "platform": hardware.name,
            "sram_bytes": int(sram_bytes) if sram_bytes is not None else None,
            "menu": [int(b) for b in target.menu],
            "seed": int(seed)}


def _canonical(obj: dict) -> str:
    return json.dumps(obj, sort_keys=True)


def _hash12(obj: dict) -> str:
    return durable_io.sha256_bytes(_canonical(obj).encode())[:12]


# ----------------------------------------------------------------- state

@dataclass
class SearchState:
    """Full NSGA-II + problem + beacon state after ``next_gen`` completed
    generations (0 = initial population evaluated, nothing varied yet)."""
    next_gen: int
    population: List[Individual]
    history: List[Individual]
    n_cache_hits: int
    memo: Dict[tuple, float]
    memo_hits: int
    n_error_evals: int
    quarantine_log: List[dict] = field(default_factory=list)
    n_quarantined: int = 0
    beacon_allocs: List[Alloc] = field(default_factory=list)
    beacon_params: List[Any] = field(default_factory=list)
    beacon_digests: List[str] = field(default_factory=list)
    n_retrains: int = 0
    front_idx: List[int] = field(default_factory=list)

    def ga_resume(self) -> dict:
        """The ``NSGA2.run(resume=...)`` dict."""
        return {"next_gen": self.next_gen, "population": self.population,
                "history": self.history, "n_cache_hits": self.n_cache_hits}


def capture_state(ga_state: dict, problem, beacon_search=None,
                  hist_cache: Optional[list] = None,
                  beacon_cache: Optional[list] = None) -> SearchState:
    """Snapshot everything a resume needs from the GA callback state dict
    ({next_gen, population, history, n_cache_hits}), the problem's memo
    and counters, and (when present) the beacon search's retrained
    parameters. Mutable scalars (rank/crowding, counters) are copied
    eagerly; genome/objective ARRAYS are shared, not copied — once an
    individual is evaluated the GA never writes them again (crossover
    and mutation build new child arrays), so a concurrent serializer can
    read them safely.

    ``hist_cache`` (a list owned by the caller, passed back on every
    capture of the same run) makes the history snapshot incremental:
    history is append-only and entries are immutable once evaluated, so
    only the new suffix is wrapped and the cache keeps the snapshot rows
    for everything before it. ``beacon_cache`` does the same for beacons:
    it holds a (host copy, digest) pair per beacon (beacons are
    append-only and their params immutable once retrained — copying and
    hashing every param tree on every save is the kind of O(whole search)
    cost the incremental path exists to avoid). The copy to the host is
    made here, on the caller's thread: the state's ``beacon_params`` are
    numpy trees, so a writer thread that serializes the state never reads
    a device tensor."""
    pop = [Individual(i.genome, np.asarray(i.objectives, float),
                      float(i.violation), int(i.rank), float(i.crowding))
           for i in ga_state["population"]]
    src_hist = ga_state["history"]
    if hist_cache is None:
        hist_cache = []
    elif len(hist_cache) > len(src_hist):
        hist_cache.clear()
    hist_cache.extend(
        Individual(i.genome, np.asarray(i.objectives, float),
                   float(i.violation))
        for i in src_hist[len(hist_cache):])
    hist = list(hist_cache)
    front_idx = [i for i, ind in enumerate(pop)
                 if ind.rank == 0 and ind.violation == 0.0]
    state = SearchState(
        next_gen=int(ga_state["next_gen"]), population=pop, history=hist,
        n_cache_hits=int(ga_state["n_cache_hits"]),
        memo=dict(problem.error_memo),
        memo_hits=int(problem.memo_hits),
        n_error_evals=int(problem.n_error_evals),
        quarantine_log=[dict(r) for r in problem.quarantine_log],
        n_quarantined=int(problem.n_quarantined),
        front_idx=front_idx)
    if beacon_search is not None:
        beacons = list(beacon_search.beacons)
        state.beacon_allocs = [dict(b.alloc) for b in beacons]
        if beacon_cache is None:
            beacon_cache = []
        elif len(beacon_cache) > len(beacons):
            beacon_cache.clear()
        for b in beacons[len(beacon_cache):]:
            host = durable_io.host_tree(b.params)
            beacon_cache.append((host, durable_io.tree_digest(host)))
        state.beacon_params = [host for host, _ in beacon_cache]
        state.beacon_digests = [digest for _, digest in beacon_cache]
        state.n_retrains = int(beacon_search.n_retrains)
    return state


def restore_into(state: SearchState, problem, beacon_search=None) -> None:
    """Re-hydrate a problem (memo + counters + quarantine records) and,
    when present, a beacon search (retrained params + retrain count) from
    a loaded state. The memo restore is parity-critical for beacon
    searches: memo hits skip Algorithm-1 routing entirely, so a missing
    entry would re-route a candidate, trigger an extra retrain, and
    diverge the data stream."""
    problem.error_memo.update(state.memo)
    problem.memo_hits = state.memo_hits
    problem.n_error_evals = state.n_error_evals
    problem.quarantine_log[:] = [dict(r) for r in state.quarantine_log]
    problem.n_quarantined = state.n_quarantined
    for rec in state.quarantine_log:
        key = tuple((n, tuple(p)) for n, p in rec["alloc"].items())
        problem._quarantined_keys.add(key)
    if beacon_search is not None:
        from repro_torch.core.beacon import Beacon
        beacon_search.beacons[:] = [
            Beacon(dict(a), p)
            for a, p in zip(state.beacon_allocs, state.beacon_params)]
        beacon_search.n_retrains = state.n_retrains


# --------------------------------------------------------- serialization

def _alloc_to_json(alloc: Alloc) -> list:
    return [[n, [int(alloc[n][0]), int(alloc[n][1])]] for n in alloc]


def _alloc_from_json(items: list) -> Alloc:
    return {n: (int(p[0]), int(p[1])) for n, p in items}


def _memo_from_arrays(name_seqs: list, z) -> Dict[tuple, float]:
    memo: Dict[tuple, float] = {}
    for g, names in enumerate(name_seqs):
        bits = z[f"memo{g}/bits"]
        vals = z[f"memo{g}/vals"]
        for row, v in zip(bits.tolist(), vals.tolist()):
            memo[tuple((n, (int(p[0]), int(p[1])))
                       for n, p in zip(names, row))] = float(v)
    return memo


# A flat framed container instead of ``np.savez``: the zipfile machinery
# cost ~1 ms per checkpoint — comparable to an entire generation's save
# budget at compact shapes — and none of its features (compression,
# random access from disk) matter for a blob that is always read whole
# and checksummed by durable_io anyway.
_PACK_MAGIC = b"RPKT1\n"

# frame = (dtype_str, shape, raw bytes); dtype strings carry endianness
_I8 = np.dtype(np.int64).str
_F8 = np.dtype(np.float64).str
Frame = Tuple[str, Sequence[int], bytes]

# scalar packers for the encoder's hot path — bit-identical to the
# corresponding little-endian numpy int64/float64 bytes, without a numpy
# array allocation per value (the encoder runs on the saver thread; its
# CPU is stolen 1:1 from the search on a small box)
_SQ = struct.Struct("<q")
_SD = struct.Struct("<d")


def _array_frame(arr) -> Frame:
    arr = np.ascontiguousarray(arr)
    return arr.dtype.str, arr.shape, arr.tobytes()


def _pack_frames(frames: Dict[str, Frame]) -> bytes:
    index, chunks, off = {}, [], 0
    for name, (dt, shape, raw) in frames.items():
        index[name] = [dt, list(shape), off, len(raw)]
        chunks.append(raw)
        off += len(raw)
    head = json.dumps(index).encode()
    return b"".join([_PACK_MAGIC, len(head).to_bytes(8, "little"), head]
                    + chunks)


class _Frames:
    """Read side of ``_pack_arrays`` with the same access shape as an
    ``np.load`` handle (``.files`` + ``[name]``); malformed payloads
    raise ``ValueError``, which deserialization maps to
    ``CorruptFileError``."""

    def __init__(self, payload: bytes):
        m = len(_PACK_MAGIC)
        if payload[:m] != _PACK_MAGIC:
            raise ValueError("bad checkpoint container magic")
        n = int.from_bytes(payload[m:m + 8], "little")
        if n <= 0 or m + 8 + n > len(payload):
            raise ValueError("truncated checkpoint container index")
        self._index = json.loads(payload[m + 8:m + 8 + n].decode())
        self._data = payload[m + 8 + n:]

    @property
    def files(self) -> List[str]:
        return list(self._index)

    def __getitem__(self, name: str) -> np.ndarray:
        dt, shape, off, nbytes = self._index[name]
        raw = self._data[off:off + nbytes]
        if len(raw) != nbytes:
            raise ValueError(f"truncated frame {name!r}")
        return np.frombuffer(raw, dtype=np.dtype(dt)).reshape(shape).copy()


def _inds_to_arrays(inds: List[Individual], prefix: str) -> Dict[str, Any]:
    if not inds:
        return {f"{prefix}/genomes": np.zeros((0, 0), np.int64),
                f"{prefix}/objectives": np.zeros((0, 0), np.float64),
                f"{prefix}/violations": np.zeros((0,), np.float64),
                f"{prefix}/rank": np.zeros((0,), np.int64),
                f"{prefix}/crowding": np.zeros((0,), np.float64)}
    return {f"{prefix}/genomes":
                np.stack([np.asarray(i.genome, np.int64) for i in inds]),
            f"{prefix}/objectives":
                np.stack([np.asarray(i.objectives, np.float64)
                          for i in inds]),
            f"{prefix}/violations":
                np.asarray([i.violation for i in inds], np.float64),
            f"{prefix}/rank":
                np.asarray([i.rank for i in inds], np.int64),
            f"{prefix}/crowding":
                np.asarray([i.crowding for i in inds], np.float64)}


def _inds_bytes(inds: List[Individual]) -> Dict[str, bytes]:
    """Raw little-endian bytes of each per-individual field — the same
    bytes ``_inds_to_arrays`` + ``tobytes`` would produce, built with one
    pass and no intermediate stacked arrays."""
    bg, bo, bv = bytearray(), bytearray(), bytearray()
    br, bc = bytearray(), bytearray()
    for i in inds:
        bg += np.asarray(i.genome, np.int64).tobytes()
        bo += np.asarray(i.objectives, np.float64).tobytes()
        bv += _SD.pack(i.violation)
        br += _SQ.pack(i.rank)
        bc += _SD.pack(i.crowding)
    return {"genomes": bytes(bg), "objectives": bytes(bo),
            "violations": bytes(bv), "rank": bytes(br),
            "crowding": bytes(bc)}


def _inds_frames(inds: List[Individual], prefix: str) -> Dict[str, Frame]:
    if not inds:
        return {k: _array_frame(v)
                for k, v in _inds_to_arrays(inds, prefix).items()}
    raw = _inds_bytes(inds)
    n = len(inds)
    L = len(inds[0].genome)
    m = len(np.asarray(inds[0].objectives))
    return {f"{prefix}/genomes": (_I8, (n, L), raw["genomes"]),
            f"{prefix}/objectives": (_F8, (n, m), raw["objectives"]),
            f"{prefix}/violations": (_F8, (n,), raw["violations"]),
            f"{prefix}/rank": (_I8, (n,), raw["rank"]),
            f"{prefix}/crowding": (_F8, (n,), raw["crowding"])}


def _inds_from_arrays(z, prefix: str) -> List[Individual]:
    genomes = z[f"{prefix}/genomes"]
    objs = z[f"{prefix}/objectives"]
    viols = z[f"{prefix}/violations"]
    ranks = z[f"{prefix}/rank"]
    crowds = z[f"{prefix}/crowding"]
    return [Individual(np.asarray(genomes[i], int),
                       np.asarray(objs[i], float),
                       float(viols[i]), int(ranks[i]), float(crowds[i]))
            for i in range(genomes.shape[0])]


class CheckpointEncoder:
    """Incremental serialization: within one run, history, memo entries
    and beacons are append-only across successive checkpoints (history
    individuals and memo values are never mutated once recorded), so the
    encoder caches their packed bytes and packs only the suffix that is
    new since the previous ``encode``. This keeps the per-generation
    checkpoint cost O(new work), not O(whole search so far) — the
    difference between a bounded <5% steady-state overhead and a cost
    that grows every generation. A fresh encoder (what ``serialize_state``
    uses) produces byte-identical output to an incrementally-warmed one;
    a state that does not extend the cached prefix resets the cache and
    re-packs fully."""

    def __init__(self, key: dict, settings: dict):
        self.key, self.settings = key, settings
        self._hist_n = 0
        self._hist: Dict[str, bytearray] = {}
        self._memo_n = 0
        self._memo_groups: List[dict] = []
        self._memo_index: Dict[tuple, dict] = {}
        self._beacons: List[Dict[str, Frame]] = []

    # ---- history (append-only individuals) ----
    def _hist_frames(self, hist: List[Individual]) -> Dict[str, Frame]:
        if not hist:
            return {k: _array_frame(v)
                    for k, v in _inds_to_arrays([], "hist").items()}
        if len(hist) < self._hist_n:
            self._hist_n, self._hist = 0, {}
        new = hist[self._hist_n:]
        if new:
            for k, raw in _inds_bytes(new).items():
                self._hist.setdefault(k, bytearray()).extend(raw)
            self._hist_n = len(hist)
        n, L = len(hist), len(hist[0].genome)
        m = len(np.asarray(hist[0].objectives))
        return {"hist/genomes": (_I8, (n, L), bytes(self._hist["genomes"])),
                "hist/objectives":
                    (_F8, (n, m), bytes(self._hist["objectives"])),
                "hist/violations":
                    (_F8, (n,), bytes(self._hist["violations"])),
                "hist/rank": (_I8, (n,), bytes(self._hist["rank"])),
                "hist/crowding": (_F8, (n,), bytes(self._hist["crowding"]))}

    # ---- memo (insert-only dict; grouped by layer-name sequence) ----
    def _memo_frames(self, memo: Dict[tuple, float]
                     ) -> Tuple[Dict[str, Frame], list]:
        if len(memo) < self._memo_n:
            self._memo_n, self._memo_groups, self._memo_index = 0, [], {}
        for mkey, v in itertools.islice(memo.items(), self._memo_n, None):
            names = tuple(n for n, _ in mkey)
            grp = self._memo_index.get(names)
            if grp is None:
                grp = {"names": names, "n": 0,
                       "bits": bytearray(), "vals": bytearray(),
                       "pack": struct.Struct("<%dq" % (2 * len(names)))}
                self._memo_index[names] = grp
                self._memo_groups.append(grp)
            grp["bits"] += grp["pack"].pack(
                *(b for _, pair in mkey for b in pair))
            grp["vals"] += _SD.pack(v)
            grp["n"] += 1
        self._memo_n = len(memo)
        frames: Dict[str, Frame] = {}
        for g, grp in enumerate(self._memo_groups):
            frames[f"memo{g}/bits"] = (
                _I8, (grp["n"], len(grp["names"]), 2), bytes(grp["bits"]))
            frames[f"memo{g}/vals"] = (_F8, (grp["n"],), bytes(grp["vals"]))
        return frames, [list(grp["names"]) for grp in self._memo_groups]

    # ---- beacons (append-only; params immutable once retrained) ----
    def _beacon_frames(self, state: SearchState) -> Dict[str, Frame]:
        if len(state.beacon_params) < len(self._beacons):
            self._beacons = []
        while len(self._beacons) < len(state.beacon_params):
            b = len(self._beacons)
            flat = durable_io.flatten_tree(state.beacon_params[b])
            self._beacons.append({
                f"beacon{b}/{k}":
                    _array_frame(durable_io.leaf_array(leaf))
                for k, leaf in flat.items()})
        frames: Dict[str, Frame] = {}
        for d in self._beacons:
            frames.update(d)
        return frames

    def encode(self, state: SearchState) -> bytes:
        frames = _inds_frames(state.population, "pop")
        frames.update(self._hist_frames(state.history))
        frames.update(self._beacon_frames(state))
        memo_frames, memo_names = self._memo_frames(state.memo)
        frames.update(memo_frames)
        manifest = {
            "version": _FORMAT_VERSION,
            "key": self.key,
            "settings": self.settings,
            "next_gen": state.next_gen,
            "n_cache_hits": state.n_cache_hits,
            "memo_names": memo_names,
            "memo_hits": state.memo_hits,
            "n_error_evals": state.n_error_evals,
            "quarantine_log": state.quarantine_log,
            "n_quarantined": state.n_quarantined,
            "beacon_allocs": [_alloc_to_json(a)
                              for a in state.beacon_allocs],
            "beacon_digests": list(state.beacon_digests),
            "n_retrains": state.n_retrains,
            "front_idx": [int(i) for i in state.front_idx],
        }
        frames["manifest"] = _array_frame(
            np.frombuffer(json.dumps(manifest).encode(), np.uint8))
        return _pack_frames(frames)


def serialize_state(state: SearchState, key: dict, settings: dict) -> bytes:
    """One framed blob: population/history/memo/beacon arrays + an
    embedded JSON manifest (everything non-array, including the store key
    and run settings a loader validates against). Equivalent to a fresh
    ``CheckpointEncoder`` — repeated saves of a growing search should
    reuse one encoder for the incremental fast path."""
    return CheckpointEncoder(key, settings).encode(state)


def deserialize_state(payload: bytes,
                      params_template=None) -> Tuple[SearchState, dict]:
    """Inverse of ``serialize_state``. ``params_template`` (the target's
    base parameter tree) rebuilds each beacon's retrained parameters —
    retraining preserves the tree structure, so the base tree is the
    template; each leaf lands on the device of its template leaf. Returns
    (state, manifest); any malformed content raises
    ``durable_io.CorruptFileError`` so loaders can fall back."""
    try:
        z = _Frames(payload)
        manifest = json.loads(bytes(z["manifest"].tobytes()).decode())
        if manifest.get("version") != _FORMAT_VERSION:
            raise durable_io.CorruptFileError(
                f"unsupported checkpoint version "
                f"{manifest.get('version')!r}")
        pop = _inds_from_arrays(z, "pop")
        hist = _inds_from_arrays(z, "hist")
        memo = _memo_from_arrays(manifest["memo_names"], z)
        beacon_params = []
        for b in range(len(manifest["beacon_allocs"])):
            flat = {k[len(f"beacon{b}/"):]: z[k] for k in z.files
                    if k.startswith(f"beacon{b}/")}
            if params_template is None:
                raise CheckpointMismatchError(
                    "checkpoint contains beacon parameters but no "
                    "params_template was given to rebuild them")
            beacon_params.append(
                durable_io.unflatten_like(params_template, flat))
    except (KeyError, ValueError, OSError, json.JSONDecodeError) as exc:
        raise durable_io.CorruptFileError(
            f"malformed checkpoint payload: {type(exc).__name__}: {exc}")
    # verify the beacon parameter digests: a resumed beacon MUST evaluate
    # bit-identically to the one that was retrained in the dead process
    for b, (params, digest) in enumerate(zip(beacon_params,
                                             manifest["beacon_digests"])):
        got = durable_io.tree_digest(params)
        if got != digest:
            raise durable_io.CorruptFileError(
                f"beacon {b} parameter digest mismatch "
                f"({got[:12]} != {digest[:12]})")
    state = SearchState(
        next_gen=int(manifest["next_gen"]), population=pop, history=hist,
        n_cache_hits=int(manifest["n_cache_hits"]),
        memo=memo,
        memo_hits=int(manifest["memo_hits"]),
        n_error_evals=int(manifest["n_error_evals"]),
        quarantine_log=list(manifest["quarantine_log"]),
        n_quarantined=int(manifest["n_quarantined"]),
        beacon_allocs=[_alloc_from_json(a)
                       for a in manifest["beacon_allocs"]],
        beacon_params=beacon_params,
        beacon_digests=list(manifest["beacon_digests"]),
        n_retrains=int(manifest["n_retrains"]),
        front_idx=[int(i) for i in manifest["front_idx"]])
    return state, manifest


# ----------------------------------------------------------------- store

class AsyncSaver:
    """Overlap checkpoint persistence with the next generation's compute:
    ``save`` captures the state incrementally (an eager copy of only the
    new history suffix — the live search can keep mutating) and hands it
    to one persistent background writer thread that encodes (also
    incrementally, via a run-scoped ``CheckpointEncoder``) and durably
    writes it. Saves stay strictly ordered (single FIFO worker; the
    bounded queue applies back-pressure if the disk falls behind) and
    each file is still the same atomic + checksummed blob; the fsyncs
    that defend against power loss are deferred to one ``seal`` at close
    (see ``SearchStore.seal`` — process death never needed them, and a
    torn unsynced tail after power loss is detected by checksum and
    skipped). A crash loses at most the in-flight checkpoint, which
    ``load_latest``'s newest-loadable walk already tolerates. ``close``
    drains the queue, seals the store and re-raises any writer error;
    ``abort`` drains but swallows it (for paths already unwinding an
    exception)."""

    def __init__(self, store: "SearchStore", key: dict, settings: dict):
        self._store, self._key, self._settings = store, key, settings
        self._encoder = CheckpointEncoder(key, settings)
        self._hist_cache: list = []
        self._beacon_cache: list = []
        self._q: "queue.Queue[Optional[SearchState]]" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        # the checkpoint machinery's own cost, measured in-process:
        # foreground_s is wall time stolen from the search thread,
        # worker_cpu_s is CPU the writer thread burned (an upper bound on
        # steal when every core is busy), drain_s is the close() wait.
        # Far more precise than differencing two noisy end-to-end runs.
        self.stats = {"foreground_s": 0.0, "worker_cpu_s": 0.0,
                      "drain_s": 0.0, "n_saves": 0}
        self._thread = threading.Thread(
            target=self._worker, name="repro-ckpt-writer", daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            state = self._q.get()
            if state is None:
                self._q.task_done()
                return
            t0 = time.thread_time()
            try:
                if self._err is None:
                    self._store.save(self._key, self._settings, state,
                                     encoder=self._encoder, sync=False)
            except BaseException as exc:
                self._err = exc           # re-raised on the next save/close
            self.stats["worker_cpu_s"] += time.thread_time() - t0
            self._q.task_done()

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def save(self, ga_state: dict, problem, beacon_search=None) -> None:
        self._raise_pending()
        t0 = time.perf_counter()
        self._q.put(capture_state(ga_state, problem, beacon_search,
                                  hist_cache=self._hist_cache,
                                  beacon_cache=self._beacon_cache))
        self.stats["foreground_s"] += time.perf_counter() - t0
        self.stats["n_saves"] += 1

    def _drain(self) -> None:
        t0 = time.perf_counter()
        if self._thread.is_alive():
            self._q.put(None)
            self._q.join()
            self._thread.join()
        self._store.seal(self._key, self._settings)
        self.stats["drain_s"] += time.perf_counter() - t0

    def close(self) -> None:
        self._drain()
        self._raise_pending()

    def abort(self) -> None:
        self._drain()
        self._err = None


class SearchStore:
    """Content-addressed, crash-safe store of search checkpoints (layout
    in the module docstring). ``keep=0`` keeps every generation;
    ``keep=k`` prunes to the newest k after each save."""

    _FMT = "gen_{:05d}.ckpt"

    def __init__(self, root: str, keep: int = 0):
        self.root = root
        self.keep = keep
        # directories already created/swept/stamped by THIS store — the
        # per-save filesystem churn (makedirs, tmp sweep, KEY/SETTINGS
        # stamps) only needs to happen once per (key, settings) dir
        self._prepared: set = set()
        # per-dir newest deferred-sync checkpoint, data-synced by seal()
        self._unsealed: Dict[str, Optional[str]] = {}
        # (key, settings) -> dir, by object identity: a run saves with
        # the same dict objects every generation, and re-hashing them per
        # save is pure waste. Holding the refs keeps the ids stable.
        self._dirs: Dict[Tuple[int, int], Tuple[dict, dict, str]] = {}

    def dir_for(self, key: dict, settings: dict) -> str:
        ck = (id(key), id(settings))
        hit = self._dirs.get(ck)
        if hit is not None and hit[0] is key and hit[1] is settings:
            return hit[2]
        d = os.path.join(self.root, _hash12(key), _hash12(settings))
        self._dirs[ck] = (key, settings, d)
        return d

    def _gen_files(self, d: str) -> List[Tuple[int, str]]:
        if not os.path.isdir(d):
            return []
        out = []
        for name in os.listdir(d):
            if name.startswith("gen_") and name.endswith(".ckpt"):
                out.append((int(name[4:-5]), os.path.join(d, name)))
        return sorted(out)

    def generations(self, key: dict, settings: dict) -> List[int]:
        return [g for g, _ in self._gen_files(self.dir_for(key, settings))]

    def save(self, key: dict, settings: dict, state: SearchState,
             encoder: Optional[CheckpointEncoder] = None,
             sync: bool = True) -> str:
        """Durably persist one generation. ``encoder`` (a run-scoped
        ``CheckpointEncoder``) enables the incremental fast path for
        repeated saves of a growing search; omitted, the state is encoded
        from scratch (same bytes). ``sync=False`` defers power-loss
        durability to a later ``seal`` (see
        ``durable_io.write_checksummed`` — atomicity, checksums and
        process-death safety are unaffected)."""
        d = self.dir_for(key, settings)
        if d not in self._prepared:
            os.makedirs(d, exist_ok=True)
            durable_io.sweep_tmp_files(d)  # dead writers' torn tmp files
            key_file = os.path.join(self.root, _hash12(key), "KEY.json")
            if not os.path.exists(key_file):
                durable_io.atomic_write_bytes(
                    key_file, (_canonical(key) + "\n").encode())
            settings_file = os.path.join(d, "SETTINGS.json")
            if not os.path.exists(settings_file):
                durable_io.atomic_write_bytes(
                    settings_file, (_canonical(settings) + "\n").encode())
            self._prepared.add(d)
        path = os.path.join(d, self._FMT.format(state.next_gen))
        payload = (encoder.encode(state) if encoder is not None
                   else serialize_state(state, key, settings))
        durable_io.write_checksummed(path, payload, sync=sync)
        self._unsealed[d] = None if sync else path
        if self.keep:
            for g, p in self._gen_files(d)[:-self.keep]:
                os.remove(p)
        return path

    def seal(self, key: dict, settings: dict) -> None:
        """Make the newest deferred-sync checkpoint power-loss durable:
        data-sync the last ``save(..., sync=False)`` file, then commit
        every deferred directory entry in one journal flush. Earlier
        unsynced generations reach stable storage with normal kernel
        writeback; a power cut before that costs recent generations,
        never correctness — ``load_latest`` falls back past any torn
        tail to the newest intact file."""
        d = self.dir_for(key, settings)
        last = self._unsealed.get(d)
        if last is not None and os.path.exists(last):
            durable_io.fsync_path(last)
        if os.path.isdir(d):
            durable_io.fsync_dir(d)
        self._unsealed[d] = None

    def load_latest(self, key: dict, settings: dict,
                    params_template=None) -> Optional[SearchState]:
        """Newest loadable state, walking generations newest-first and
        skipping (with a warning) corrupt or torn files. Returns None when
        nothing loadable exists. A loadable checkpoint whose key or
        settings disagree raises ``CheckpointMismatchError`` — that is a
        caller bug, not corruption, and must not be silently skipped."""
        d = self.dir_for(key, settings)
        durable_io.sweep_tmp_files(d)
        for g, path in reversed(self._gen_files(d)):
            try:
                payload = durable_io.read_checksummed(path)
                state, manifest = deserialize_state(payload, params_template)
            except durable_io.CorruptFileError as exc:
                warnings.warn(f"skipping corrupt checkpoint {path}: {exc}",
                              RuntimeWarning, stacklevel=2)
                continue
            if _canonical(manifest["key"]) != _canonical(key):
                raise CheckpointMismatchError(
                    f"{path} belongs to a different search identity")
            if _canonical(manifest["settings"]) != _canonical(settings):
                raise CheckpointMismatchError(
                    f"{path} was written under different run settings")
            return state
        return None

    def discard_after(self, key: dict, settings: dict, gen: int) -> int:
        """Delete checkpoints newer than ``gen`` (test/demo helper for
        simulating an interruption at a chosen generation)."""
        removed = 0
        for g, path in self._gen_files(self.dir_for(key, settings)):
            if g > gen:
                os.remove(path)
                removed += 1
        return removed
