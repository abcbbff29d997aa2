"""Continuous batching over the population axis.

Port of the reference package's ``serving/batcher.py``. Every live request
owns one LANE of a population dispatch, and each serving step runs
``models.sru.forward_decode_step`` once on the whole mixed-allocation
batch: lane *i*'s qp row (and so its menu index in the packed-bank MxV
kernel) is request *i*'s allocation. Admitting a request with a new
allocation changes a gather index, not the number of dispatches; the
packed banks are shared and read-only.

Shapes: the lane axis is padded to the next power-of-two bucket (pad lanes
replicate a live lane's qp row; every op is lane-independent, so they cannot
perturb live lanes, and their outputs are dropped). The time axis is never
padded, because the Bi-SRU's backward recurrence reads future frames:
lanes are grouped per step by their next-chunk length, full chunks in the
one main dispatch and each distinct ragged tail length in a same-step extra
dispatch.

``SerialGroupBatcher`` is the counterfactual: the same engine and step
cadence, but one dispatch per allocation group, as a server with one model
per operating point must do.

The reference's ``ServingEngine.step_jaxpr`` (its jaxpr lane-independence
proof) has no counterpart; the port's tests flip one lane's allocation and
check that no other lane's logits move.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import sru
from repro_torch.serving.artifact import DeploymentArtifact
from repro_torch.serving.metrics import RequestRecord, ServingLog, StepRecord
from repro_torch.serving.router import RouteDecision, Router


@dataclass
class Request:
    """One inference request: ``feats`` (n_frames, input_dim) float32."""
    rid: int
    slo: str
    feats: np.ndarray


@dataclass
class _Flight:
    """A request in a lane: cursor into its frames + collected logits."""
    req: Request
    alloc: int
    rec: RequestRecord
    cursor: int = 0
    chunks: List[np.ndarray] = field(default_factory=list)

    def remaining(self) -> int:
        return self.req.feats.shape[0] - self.cursor

    def next_len(self, chunk: int) -> int:
        return min(chunk, self.remaining())


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(dev)


class ServingEngine:
    """Owns the loaded artifact's device state and the step.

    The packed banks and the (bias-only) serving params move to ``device``
    once; ``step`` runs one ``forward_decode_step`` dispatch. ``use_kernel``
    (default: True on a card) picks the kernel lane (``bank_qmm_pop`` and
    ``sru_scan_pop``) or the plain PyTorch lane.
    """

    def __init__(self, artifact: DeploymentArtifact, *, device="cuda",
                 use_kernel: Optional[bool] = None):
        self.artifact = artifact
        self.cfg = artifact.cfg
        self.device = resolve_device(device)
        self.use_kernel = use_kernel
        self.banks = _to_device(artifact.banks, self.device)
        self.params = _to_device(artifact.serving_params(), self.device)

    def step(self, feats: np.ndarray, qp: np.ndarray) -> np.ndarray:
        """feats (P, T, m) + qp (P, L, 6) -> logits (P, T, n_outputs) on the
        host; returns when the device result is ready (the batcher times
        this span as the step's compute latency)."""
        out = sru.forward_decode_step(
            self.params, self.cfg,
            torch.from_numpy(np.asarray(feats, np.float32)).to(self.device),
            torch.from_numpy(np.asarray(qp, np.float32)).to(self.device),
            banks=self.banks, use_kernel=self.use_kernel)
        return out.cpu().numpy()


def bucket_for(n: int, buckets: List[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class ContinuousBatcher:
    """FIFO admission + per-step retire/admit over ``max_lanes`` lanes."""

    def __init__(self, engine: ServingEngine, router: Router, *,
                 max_lanes: int = 8, chunk: int = 16,
                 log: Optional[ServingLog] = None, collect: bool = False,
                 clock: Callable[[], float] = time.perf_counter):
        if max_lanes < 1:
            raise ValueError("need at least one lane")
        self.engine = engine
        self.router = router
        self.max_lanes = int(max_lanes)
        self.chunk = int(chunk)
        self.log = log if log is not None else ServingLog()
        self.collect = bool(collect)
        self.clock = clock
        self.queue: deque = deque()      # routed _Flight, awaiting a lane
        self.lanes: List[_Flight] = []   # in flight
        self.results: Dict[int, np.ndarray] = {}
        self._step_no = 0
        # power-of-two lane buckets: steady-state full batches keep one shape
        self.buckets = [1]
        while self.buckets[-1] < self.max_lanes:
            self.buckets.append(min(self.buckets[-1] * 2, self.max_lanes))

    # -- admission -------------------------------------------------------
    def submit(self, req: Request) -> RouteDecision:
        """Route + enqueue one request (or shed it at the door)."""
        decision = self.router.route(req.slo, queue_depth=len(self.queue))
        rec = self.log.add_request(RequestRecord(
            rid=req.rid, slo=req.slo, alloc=decision.alloc,
            t_enqueue=self.clock(), shed=decision.shed,
            degraded=decision.degraded, fallback=decision.fallback))
        if not decision.shed:
            self.queue.append(_Flight(req=req, alloc=decision.alloc,
                                      rec=rec))
        return decision

    def _admit(self):
        while self.queue and len(self.lanes) < self.max_lanes:
            self.lanes.append(self.queue.popleft())

    # -- the step loop ---------------------------------------------------
    def _dispatch_groups(self) -> List[List[_Flight]]:
        """Partition live lanes into same-shape dispatches: the full-chunk
        group plus one group per distinct ragged tail length."""
        by_len: Dict[int, List[_Flight]] = {}
        for fl in self.lanes:
            by_len.setdefault(fl.next_len(self.chunk), []).append(fl)
        return [by_len[t] for t in sorted(by_len, reverse=True)]

    def _dispatch(self, group: List[_Flight], t: int) -> Tuple[float, int]:
        """Run one padded dispatch for ``group`` (all next-chunk length
        ``t``); returns (compute span in seconds, lane bucket used)."""
        m = self.engine.cfg.input_dim
        bucket = bucket_for(len(group), self.buckets)
        feats = np.zeros((bucket, t, m), np.float32)
        # pad lanes replicate lane 0's qp row: a real allocation row, so
        # the bank index stays in range; their logits are dropped
        lanes_alloc = [fl.alloc for fl in group]
        lanes_alloc += [lanes_alloc[0]] * (bucket - len(group))
        qp = self.engine.artifact.qp_rows(lanes_alloc)
        for i, fl in enumerate(group):
            feats[i] = fl.req.feats[fl.cursor:fl.cursor + t]
        t0 = self.clock()
        for fl in group:
            if fl.rec.t_start is None:
                fl.rec.t_start = t0
        logits = self.engine.step(feats, qp)
        span = self.clock() - t0
        for i, fl in enumerate(group):
            if self.collect:
                fl.chunks.append(logits[i])
            fl.cursor += t
            fl.rec.tokens += t
        return span, bucket

    def step(self) -> int:
        """One serving step: admit -> dispatch live lanes -> retire. Logs
        one StepRecord whose ``n_dispatches`` counts the dispatches it took.
        Returns the number of live lanes computed."""
        self._admit()
        if not self.lanes:
            return 0
        self._step_no += 1
        tokens, span, max_bucket, n_disp = 0, 0.0, 0, 0
        for group in self._dispatch_groups():
            t = group[0].next_len(self.chunk)
            s, bucket = self._dispatch(group, t)
            span += s
            tokens += t * len(group)
            max_bucket = max(max_bucket, bucket)
            n_disp += 1
        self.log.add_step(StepRecord(
            step=self._step_no, n_lanes=len(self.lanes), bucket=max_bucket,
            tokens=tokens, compute_s=span, n_dispatches=n_disp))
        done = self.clock()
        still = []
        for fl in self.lanes:
            if fl.remaining() == 0:
                fl.rec.t_done = done
                if self.collect:
                    self.results[fl.req.rid] = np.concatenate(fl.chunks)
            else:
                still.append(fl)
        n = len(self.lanes)
        self.lanes = still
        return n

    def run_until_idle(self, max_steps: int = 100000) -> ServingLog:
        """Drain the queue and all lanes; returns the log."""
        steps = 0
        while self.queue or self.lanes:
            if self.step() == 0 and not self.queue:
                break
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"batcher did not drain in {max_steps} "
                                   f"steps")
        return self.log


class SerialGroupBatcher(ContinuousBatcher):
    """Per-allocation-group serving baseline (same engine): identical
    admission, lanes, chunking and retirement, but one dispatch per
    allocation present in each step."""

    def _dispatch_groups(self) -> List[List[_Flight]]:
        by_key: Dict[tuple, List[_Flight]] = {}
        for fl in self.lanes:
            key = (fl.next_len(self.chunk), fl.alloc)
            by_key.setdefault(key, []).append(fl)
        return [by_key[k] for k in sorted(by_key, reverse=True)]
