"""Batched candidate evaluation for the MOHAQ search (the GA's hot loop).

Port of the reference package's ``core/batched_eval.py``, on one device (no
mesh). ``PopulationEvaluator`` owns the pipeline against any
``SearchTarget``'s population forward: ``BatchedSRUEvaluator`` binds it to
``models.sru.forward_population``, and the xLSTM target
(``core/xlstm_target.py``) to its own ``forward_population``.

- Every menu precision is a dynamic (scale, lo, hi) triple, so a whole
  population stacks into one (P, L, 6) grid array (``stack_qps``, or numpy
  indexing into the target's menu tables) and one forward scores it.
- Populations pad up to fixed buckets (1 … 64, then multiples of 64) by
  repeating the last candidate; padding lanes are sliced off.
- Equal-shaped validation subsets fold into the batch axis, so a
  generation is ONE forward that reduces on the device to per-(candidate,
  subset) integer error counts. The host takes the float64 percentage and
  the max over subsets, as the scalar path does.
- Quantized-weight banks are built once per parameter set and cached by
  its identity, optionally for a bounded number of sets
  (``extend_banks`` specializes fresh f32 banks to the folded fold: the
  SRU input-layer u-bank).
- Fault hooks (``faults``) inject dispatch failures and poisoned lanes;
  transient failures retry with backoff. A device loss has no mesh to
  shrink here and raises.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import faults as fault_policies
from repro_torch.core import quantization as Q

Alloc = Dict[str, Tuple[int, int]]

# population-size buckets; sizes above the largest round up to a multiple
_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def bucket_size(p: int) -> int:
    """Smallest bucket holding a population of ``p`` candidates."""
    for b in _BUCKETS:
        if p <= b:
            return b
    top = _BUCKETS[-1]
    return ((p + top - 1) // top) * top


def stack_qps(qp_list: Sequence[Dict[str, tuple]],
              layer_names: Sequence[str]) -> np.ndarray:
    """Stack per-candidate qp dicts ({name: 6 floats}, from
    ``sru.quant_triples_for``) into a (P, L, 6) float32 array in
    ``layer_names`` order."""
    arr = np.empty((len(qp_list), len(layer_names), 6), np.float32)
    for p, qp in enumerate(qp_list):
        for i, name in enumerate(layer_names):
            arr[p, i, :] = qp[name]
    return arr


class PopulationEvaluator:
    """Model-agnostic population scorer.

    ``forward_pop(params, feats, qp_stack, banks)`` -> logits
    (P, B, T, n_out), lanes independent in P. ``make_qp``: Alloc ->
    {layer: 6-float grid}. Error convention: per candidate, the MAX
    frame-error % over the validation subsets (paper §4.2).

    ``make_banks``/``make_packed_banks`` build banks per parameter set
    (``bank_format`` picks "f32" or "packed"; the packed format skips the
    ``extend_banks`` hook, which needs f32 stacks). ``qp_tables``:
    (L, |menu|, 3) weight/activation triple tables, from which the banked
    pipeline assembles qp stacks by numpy indexing. ``bank_cache_size``
    bounds the parameter sets whose banks stay cached (the least recently
    used go first); None keeps every set.
    """

    def __init__(self, layer_names, val_subsets,
                 make_qp: Callable[[Alloc], dict],
                 forward_pop: Callable,
                 make_banks: Optional[Callable] = None,
                 use_banks: Optional[bool] = None,
                 qp_tables=None,
                 extend_banks: Optional[Callable] = None,
                 bank_format: str = "f32",
                 make_packed_banks: Optional[Callable] = None,
                 bank_cache_size: Optional[int] = None):
        self.layer_names = list(layer_names)
        self.val_subsets = val_subsets
        self.make_qp = make_qp
        self._forward_pop = forward_pop
        self._qp_tables = qp_tables
        # the forwards recover bank rows with Q.menu_index_from_hi, which
        # assumes the full Q.SUPPORTED_BITS menu order
        self._menu_code = {b: k for k, b in enumerate(Q.SUPPORTED_BITS)}
        if bank_format not in ("f32", "packed"):
            raise ValueError(f"unknown bank_format {bank_format!r} "
                             "(want 'f32' or 'packed')")
        if use_banks is None:
            use_banks = (make_packed_banks if bank_format == "packed"
                         else make_banks) is not None
        if use_banks and bank_format == "packed" \
                and make_packed_banks is None:
            raise ValueError("bank_format='packed' requires "
                             "make_packed_banks")
        if bank_format == "packed" and not use_banks:
            raise ValueError("bank_format='packed' requires use_banks=True "
                             "(the packed lane IS a bank lane)")
        if use_banks and bank_format == "f32" and make_banks is None:
            raise ValueError("use_banks=True requires make_banks")
        self.use_banks = use_banks
        self.bank_format = bank_format
        self._make_banks = make_banks
        self._make_packed_banks = make_packed_banks
        self._extend_banks = extend_banks
        # banks keyed by parameter-set identity; the params ref is kept so
        # a collected object's id can never alias a live cache entry
        self._banks: Dict[int, tuple] = {}
        self._bank_cache_size = bank_cache_size
        self.device = val_subsets[0][0].device
        shapes = {tuple(f.shape) for f, _ in val_subsets}
        self._folded = len(shapes) == 1 and len(val_subsets) > 1
        if self._folded:
            self._feats_all = torch.cat([f for f, _ in val_subsets], dim=0)
            self._labels_all = torch.cat([l for _, l in val_subsets], dim=0)
            self._n_subsets = len(val_subsets)
            self._subset_frames = int(val_subsets[0][1].numel())
        # graceful-degradation knobs (see repro_torch.core.faults)
        self.faults = None
        self.max_retries = 3
        self.retry_backoff_s = 0.005
        self.fault_log: List[dict] = []

    @torch.no_grad()
    def _batch_err(self, params, banks, feats, labels, qp_stack):
        """The per-generation dispatch: population forward, then the
        frame-error reduction to integer counts on the device — (P, S) when
        the subsets are folded, else (P,)."""
        logits = self._forward_pop(params, feats, qp_stack, banks)
        wrong = torch.argmax(logits, dim=-1) != labels[None]   # (P, B*, T)
        if self._folded:
            p, _, t = wrong.shape
            return wrong.reshape(p, self._n_subsets, -1, t).sum(dim=(2, 3))
        return wrong.sum(dim=(1, 2))

    def _banks_for(self, params):
        """Banks for a parameter set, built on first use (see class doc)."""
        if not self.use_banks:
            return None
        key = id(params)
        if key in self._banks:
            self._banks[key] = self._banks.pop(key)   # most recently used
        else:
            if self._bank_cache_size is not None:
                while len(self._banks) >= max(self._bank_cache_size, 1):
                    del self._banks[next(iter(self._banks))]
            if self.bank_format == "packed":
                banks = self._make_packed_banks(params)
            else:
                banks = self._make_banks(params)
                if self._folded and self._extend_banks is not None:
                    banks = self._extend_banks(banks, self._feats_all)
            self._banks[key] = (params, banks)
        return self._banks[key][1]

    def _stack(self, allocs: Sequence[Alloc]) -> torch.Tensor:
        if self.use_banks and self._qp_tables is not None:
            # menu indexing: gather the per-layer triple rows directly
            w_t, a_t = self._qp_tables
            code = self._menu_code
            wc = np.asarray([[code[a[nm][0]] for nm in self.layer_names]
                             for a in allocs])
            ac = np.asarray([[code[a[nm][1]] for nm in self.layer_names]
                             for a in allocs])
            li = np.arange(len(self.layer_names))[None]
            stack = np.concatenate([w_t[li, wc], a_t[li, ac]], -1)
        else:
            stack = stack_qps([self.make_qp(a) for a in allocs],
                              self.layer_names)
        pad = bucket_size(len(allocs)) - len(allocs)
        if pad:
            stack = np.concatenate([stack, np.repeat(stack[-1:], pad, 0)])
        return torch.from_numpy(
            np.ascontiguousarray(stack, np.float32)).to(self.device)

    def _dispatch(self, params, banks, feats, labels, stack):
        """The single dispatch, with the fault-injection hook in front."""
        if self.faults is not None:
            self.faults.on_dispatch(self)
        return self._batch_err(params, banks, feats, labels, stack)

    def _errors_once(self, allocs: Sequence[Alloc], params) -> np.ndarray:
        """One attempt at scoring a generation; returns the (P,) float
        max-over-subsets error array (real lanes only, padding sliced)."""
        stack = self._stack(allocs)
        banks = self._banks_for(params)
        p = len(allocs)
        if self._folded:
            wrong = self._dispatch(params, banks, self._feats_all,
                                   self._labels_all, stack).cpu().numpy()
            errs = 100.0 * wrong[:p].astype(np.int64) / self._subset_frames
            errs = np.max(errs, axis=1)
        else:
            per_subset = []
            for feats, labels in self.val_subsets:
                wrong = self._dispatch(params, banks, feats, labels,
                                       stack).cpu().numpy()
                per_subset.append(100.0 * wrong[:p].astype(np.int64)
                                  / int(labels.numel()))
            errs = np.max(np.stack(per_subset), axis=0)
        if self.faults is not None:
            errs = self.faults.on_result(self, errs)
        return errs

    def errors(self, allocs: Sequence[Alloc], params) -> List[float]:
        """Max-over-subsets error % for each allocation (order-preserving).

        Transient dispatch failures (``faults.TRANSIENT_DISPATCH_ERRORS``)
        are retried up to ``max_retries`` times with exponential backoff; a
        retry re-runs the identical forward. A ``DeviceLossError`` cannot
        be survived on one device and raises."""
        if not allocs:
            return []
        attempt = 0
        while True:
            try:
                return self._errors_once(allocs, params).tolist()
            except fault_policies.DeviceLossError as loss:
                raise RuntimeError(
                    "device loss injected on a single-device evaluator "
                    "(no mesh to shrink)") from loss
            except fault_policies.TRANSIENT_DISPATCH_ERRORS as exc:
                attempt += 1
                if attempt > self.max_retries:
                    raise
                delay = self.retry_backoff_s * (2 ** (attempt - 1))
                self.fault_log.append({
                    "event": "retry", "attempt": attempt,
                    "delay_s": delay,
                    "error": f"{type(exc).__name__}: {exc}"})
                time.sleep(delay)


class BatchedSRUEvaluator(PopulationEvaluator):
    """SRU binding of ``PopulationEvaluator``: ``models.sru
    .forward_population`` plus the input-layer u-bank hook, wired whenever
    menu tables are given and the L0 highway is inactive.

    ``use_kernel`` (default: True on a CUDA device) picks the kernel lane
    of the forward; the u-bank is built by the same lane's MxV."""

    def __init__(self, cfg, val_subsets, make_qp: Callable[[Alloc], dict],
                 use_kernel: Optional[bool] = None,
                 make_banks: Optional[Callable] = None,
                 use_banks: Optional[bool] = None,
                 qp_tables=None,
                 bank_format: str = "f32",
                 make_packed_banks: Optional[Callable] = None):
        from repro_torch.models import sru

        self.cfg = cfg
        if use_kernel is None:
            use_kernel = val_subsets[0][0].device.type == "cuda"
        self.use_kernel = use_kernel

        def forward_pop(params, feats, qp_stack, banks):
            return sru.forward_population(params, cfg, feats, qp_stack,
                                          banks=banks, use_kernel=use_kernel)

        extend = None
        if qp_tables is not None and cfg.input_dim != cfg.hidden:
            def extend(banks, feats):
                return sru.extend_banks_u0(banks, cfg, feats,
                                           qp_tables[1][0],
                                           use_kernel=use_kernel)

        super().__init__(list(cfg.layer_names()), val_subsets, make_qp,
                         forward_pop, make_banks=make_banks,
                         use_banks=use_banks, qp_tables=qp_tables,
                         extend_banks=extend, bank_format=bank_format,
                         make_packed_banks=make_packed_banks)
