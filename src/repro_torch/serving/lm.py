"""Serve a decoder-only LM (dense, MoE, VLM or hybrid) with a quantized
output head: greedy prefill and decode whose LM head runs through the
``quant_matmul`` kernel.

Port of the first half of the reference's ``examples/serve_quantized.py``.
The head is packed once (``kernels.ops.pack_for_kernel``: per-column scales,
codes packed along K) and every prefill and decode step calls
``kernels.ops.quant_matmul`` on the final hidden state through
``transformer``'s ``head_fn`` hook, so on a card each head run launches the
kernel once per step.

    python -m repro_torch.serving.lm [--device cuda] [--full]

serves stablelm-1.6b's reduced config (``--full``: full width) with seeded
random weights, reports whether the int8 head's greedy tokens equal the
dense head's, and exits 1 unless they hold on margins
(``RecordingHead.on_margins``: the int8 head's error within its rounding
bound, tokens parting only where the dense margin is within its reach).

On a mesh (params placed on ``transformer.lm_axes``, under
``distributed/sharding.py::axis_rules``) the head is split over
"vocab" -> "model": ``quant_head`` packs each rank's own column shard
(per-column scales, so a shard's packing is the slice of the whole
head's), every head run launches ``quant_matmul`` on the rank's local
hidden state and shard, and the logits come back as a DTensor split over
the vocabulary. ``greedy_tokens`` takes their argmax on the shards (the
first maximal index, as ``torch.argmax``) with two all-reduces of (B, T)
rows, so the logits are never gathered.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core.quantization import INT_RANGES, mmse_clip
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.roofline.counter import fill_trips, trips


@torch.no_grad()
def decode_loop(params, cfg, tokens, gen: int, head_fn=None):
    """Greedy prefill + ``gen`` decode steps; the output head is ``head_fn``
    (dense when None). Returns the generated (B, gen) tokens. Under a
    roofline counter more than four decode steps fold to four, the third
    counted ``gen - 3`` times (``roofline/counter.py::trips``)."""
    logits, cache = tfm.prefill(params, cfg, tokens,
                                max_len=tokens.shape[1] + gen,
                                head_fn=head_fn)
    out = []
    for _ in trips(gen):
        nxt = greedy_tokens(logits[:, -1])[:, None]
        out.append(nxt)
        logits, cache = tfm.decode_step(params, cfg, cache, nxt,
                                        head_fn=head_fn)
    return torch.cat(fill_trips(out, gen), dim=1)


def greedy_tokens(logits):
    """``argmax`` over the last dim (the first maximal index). On a DTensor
    split over its last dim each rank takes its shard's argmax, and the
    maximum and then the least global index holding it are all-reduced
    over the splitting mesh dims; the result is a DTensor of the other
    dims' placements."""
    if not sh.split_over(logits, -1):
        return torch.argmax(logits, dim=-1)
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh, last = logits.device_mesh, logits.ndim - 1
    _, off = compute_local_shape_and_global_offset(
        logits.shape, mesh, logits.placements)
    local = logits.to_local()
    idx = torch.argmax(local, dim=-1)
    val = torch.gather(local, -1, idx[..., None])[..., 0]
    dims = [i for i, p in enumerate(logits.placements)
            if isinstance(p, Shard) and p.dim == last]
    best = val
    for i in dims:
        best = funcol.all_reduce(best, "max", (mesh, i))
    cand = torch.where(val == best, idx + off[last],
                       torch.full_like(idx, logits.shape[-1]))
    for i in dims:
        cand = funcol.all_reduce(cand, "min", (mesh, i))
    pl = [Replicate() if i in dims else p
          for i, p in enumerate(logits.placements)]
    return sh.from_local(cand, mesh, pl, logits.shape[:-1])


@dataclass
class QuantHead:
    """A packed output head: ``head(hidden (..., D)) -> logits (..., V)``
    f32, one ``quant_matmul`` per call."""
    packed: torch.Tensor           # (ceil(D * bits / 8), V) int8
    scales: torch.Tensor           # (V,) f32
    bits: int

    def __call__(self, hidden):
        h2 = hidden.reshape(-1, hidden.shape[-1]).to(torch.float32)
        y = kops.quant_matmul(h2.contiguous(), self.packed, self.scales,
                              self.bits)
        return y.reshape(hidden.shape[:-1] + (self.packed.shape[1],))

    @property
    def nbytes(self) -> int:
        return (self.packed.numel() * self.packed.element_size()
                + self.scales.numel() * self.scales.element_size())


@dataclass
class ShardedQuantHead:
    """An output head split over the vocabulary: ``local`` is this rank's
    ``QuantHead`` of its column shard, and a call returns the logits as a
    DTensor of the head's placements (``placements``: the head weight's,
    its vocab dim split) over ``mesh``."""
    local: QuantHead
    mesh: object
    placements: tuple
    vocab: int

    def __call__(self, hidden):
        from torch.distributed.tensor import Replicate, Shard
        # the hidden state whole along D; its batch split kept
        hpl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in hidden.placements]
        h = hidden.redistribute(self.mesh, hpl)
        y = self.local(h.to_local())
        last = hidden.ndim - 1
        pl = [Shard(last) if isinstance(w, Shard) and w.dim == 1 else p
              for p, w in zip(hpl, self.placements)]
        return sh.from_local(y, self.mesh, pl,
                             hidden.shape[:-1] + (self.vocab,))


# The largest change of a router gate that one bf16 step in its norm's
# input makes: on the reduced jamba-1.5-large-398b with the reference's
# weights, every MoE router fed the float32 residual sum and the same sum
# rounded to bf16 (``tests/test_torch_hybrid.py::
# test_gate_delta_is_one_bf16_step`` measures it and holds this bound).
# Two rounding paths to the same step (prefill against forward, the
# card against the CPU) can pick other experts only where the top-k gate
# margin is below it.
GATE_DELTA = 2.4e-3


def head_error_bound(weight, bits: int, hidden, dense):
    """A bound, set by the quantization rule before the head runs, on
    ``|quant_j - dense_j|`` for every logit of the head ``weight`` (D, V)
    packed at ``bits`` with its clip at max |w| (``int8_head``: each
    column's scale ``s_j = max_k |w_kj| / hi``, no code clipped), on the
    f32 ``hidden`` (rows, D) whose dense logits are ``dense`` (rows, V):
    the weight rounding, half a step a weight, ``s_j / 2 * sum_k |h_k|``;
    the dense logit's bf16 rounding, ``2^-8 |dense_j|`` (half an ulp is at
    most 2^-9 of the exact value); the f32 sums over D terms of both
    heads, ``D 2^-22 max_k |w_kj| sum_k |h_k|``. A head whose scales,
    clip or codes are wrong errs past it. Returns (rows, V) f32."""
    w = weight.to(torch.float32)
    absmax = w.abs().amax(0)
    hi = INT_RANGES[bits][1]
    per_l1 = absmax / hi / 2 + w.shape[0] * 2.0 ** -22 * absmax
    l1 = hidden.to(torch.float32).abs().sum(-1, keepdim=True)
    return per_l1[None, :] * l1 + 2.0 ** -8 * dense.to(torch.float32).abs()


def head_margins(dense, quant, bound):
    """Per row of (rows, V) logits of the dense head and of a quantized
    head on the same hidden state, with ``bound`` (``head_error_bound``):
    (the dense head's top-2 margin; ``reach``, the most the pick's margin
    can move within the bound, ``bound[top1] + max_{j != top1}
    bound[j]``; the head's largest error as a share of its bound, ``max_j
    |quant_j - dense_j| / bound_j``). The quantized head can pick another
    token only where margin <= reach, as long as the share is <= 1."""
    d = dense.reshape(-1, dense.shape[-1]).to(torch.float32)
    e = (quant.reshape(d.shape).to(torch.float32) - d).abs()
    b = bound.reshape(d.shape)
    top = torch.topk(d, 2, dim=-1)
    margin = top.values[:, 0] - top.values[:, 1]
    at_top = b.gather(-1, top.indices[:, :1])[:, 0]
    others = b.scatter(-1, top.indices[:, :1], float("-inf"))
    return margin, at_top + others.max(-1).values, (e / b).max(-1).values


class RecordingHead:
    """``head`` as the path calls it, keeping each call's hidden state (f32,
    (rows, D)) and output ((rows, V)) and running nothing else, so a timed
    decode through it times the head alone; ``on_margins`` holds the run
    to the dense head afterwards."""

    def __init__(self, head):
        self.head, self.runs = head, []

    def __call__(self, hidden):
        y = self.head(hidden)
        self.runs.append((hidden.reshape(-1, hidden.shape[-1]).to(
            torch.float32), y.reshape(-1, y.shape[-1])))
        return y

    def on_margins(self, weight, dense_fn, dense_tokens, quant_tokens
                   ) -> dict:
        """``agreement_on_margins`` of this run's greedy ``quant_tokens``
        against the dense head's ``dense_tokens``: each recorded call's
        dense logits (``dense_fn`` on its hidden state, (rows, 1, D)) with
        ``head_error_bound`` of ``weight`` (D, V) at the head's bits."""
        cols = [[], [], []]
        for h, y in self.runs:
            d = dense_fn(h[:, None]).reshape(y.shape)
            bound = head_error_bound(weight, self.head.bits, h, d)
            for col, v in zip(cols, head_margins(d, y, bound)):
                col.append(v)
        return agreement_on_margins(dense_tokens, quant_tokens,
                                    *(torch.stack(c, 1) for c in cols))


def agreement_on_margins(dense_tokens, quant_tokens, margin, reach, share
                         ) -> dict:
    """Greedy tokens of the dense head and of a quantized head, (B, n), held
    on margins: ``margin``, ``reach`` and ``share`` (B, >= n) are
    ``head_margins`` of the quantized run's head calls, which see the
    dense run's hidden states up to the first position where a token
    differs. The head's error must stay within its bound at every call
    (share <= 1; a head with wrong scales, clip or codes fails here). The
    tokens must agree at every position before the first where some row's
    dense top-2 margin is within the bound's reach (a tie the head may
    break either way), and the first differing token must lie at such a
    row and position. Later positions are reported (``agreement_after``),
    not bounded: after a tie the two greedy continuations part
    legitimately."""
    n = dense_tokens.shape[1]
    worst = float(share.max())
    margin, reach = margin[:, :n].cpu(), reach[:, :n].cpu()
    differ = (dense_tokens != quant_tokens).cpu()
    tie = margin <= reach
    cols = torch.nonzero(differ.any(0)).flatten().tolist()
    ties = torch.nonzero(tie.any(0)).flatten().tolist()
    out = {"positions": n, "max_error_share": worst,
           "first_tie": ties[0] if ties else None,
           "first_differing": cols[0] if cols else None,
           "ok": worst <= 1.0,
           "min_margin_before": float(margin.min()) if n else None}
    if cols:
        p = cols[0]
        rows = torch.nonzero(differ[:, p]).flatten().tolist()
        out.update(
            rows=rows, margin=[float(margin[b, p]) for b in rows],
            reach=[float(reach[b, p]) for b in rows],
            ok=out["ok"] and all(bool(tie[b, p]) for b in rows),
            min_margin_before=float(margin[:, :p].min()) if p else None,
            agreement_after=float((~differ[:, p + 1:]).float().mean())
            if p + 1 < n else None)
    return out


class RouterLog:
    """Inside ``with log:``, each ``moe_ffn`` call's router picks: its
    top-k experts a token (sorted, (B, T, k)) and the margin between its
    k-th and (k+1)-th gate, how far a gate must move to change the pick
    ((B, T)), in call order (``calls``)."""

    def __init__(self):
        self.calls = []
        self._observing = None

    def _record(self, gates, top_k: int):
        top = torch.topk(gates, top_k + 1, dim=-1)
        self.calls.append((top.indices[..., :top_k].sort(-1).values,
                           top.values[..., top_k - 1] - top.values[..., top_k]))

    def __enter__(self):
        self._observing = cm.observe_routers(self._record)
        self._observing.__enter__()
        return self

    def __exit__(self, *exc):
        return self._observing.__exit__(*exc)


def step_routing(forward: RouterLog, steps, spans):
    """For each prefill or decode step (``steps``: its ``RouterLog``, whose
    last position is ``stop - 1``; ``spans``: the positions (start, stop)
    of the forward to compare): whether any router picked other experts
    than the forward's there, and the smallest top-k gate margin of the
    forward's routers there. Returns (flipped, margin) lists."""
    flipped, margin = [], []
    for log, (a, b) in zip(steps, spans):
        if len(log.calls) != len(forward.calls):
            raise ValueError(f"{len(log.calls)} router calls in a step, "
                             f"{len(forward.calls)} in the forward")
        flipped.append(any(
            bool((picks[:, picks.shape[1] - (b - a):] != fp[:, a:b]).any())
            for (picks, _), (fp, _) in zip(log.calls, forward.calls)))
        margin.append(min(float(fm[:, a:b].min()) for _, fm in forward.calls))
    return flipped, margin


def decode_on_margins(step_err, step_margin, flipped, atol: float,
                      delta: float = GATE_DELTA, min_bounded: int = 9
                      ) -> dict:
    """Prefill + teacher-forced decode against ``forward``, held on router
    margins. Per step (the prefill's last position first, then each
    decode step): ``step_err`` its largest logit difference,
    ``step_margin`` the smallest top-k gate margin of the forward's
    routers at its position and ``flipped`` whether its routers picked
    other experts than the forward's there (``step_routing``). Every step
    before the first that routed otherwise must lie within ``atol``, and
    that step's margin must be below ``delta``: only a near tie may route
    otherwise. That bounds at least every step before the first margin
    below ``delta`` (``first_below_delta``, reported), and also the near
    ties that flipped nothing. Later steps are reported: a router that
    picks other experts moves the logits by far more than rounding. ``ok``
    also needs ``min(min_bounded, steps)`` steps bounded: the prefill and
    the first 8 decode steps."""
    err = [float(e) for e in step_err]
    margin = [float(m) for m in step_margin]
    below = [i for i, m in enumerate(margin) if m < delta]
    flips = [i for i, f in enumerate(flipped) if f]
    first = flips[0] if flips else len(err)
    out = {"atol": atol, "delta": delta, "steps": len(err),
           "first_below_delta": below[0] if below else None,
           "first_routing_flip": flips[0] if flips else None,
           "bounded_steps": first,
           "max_abs_err": max(err[:first]) if first else None,
           "margin_there": margin[first] if flips else None,
           "err_after": err[first:], "err_by_step": err,
           "margin_by_step": margin}
    out["ok"] = ((not flips or margin[first] < delta)
                 and first >= min(min_bounded, len(err))
                 and all(e <= atol for e in err[:first]))
    return out


def quant_head(params, cfg, bits: int, clip: Optional[float] = None):
    """Pack the LM head at ``bits`` with clip ``clip`` (default: the MMSE
    clip of the whole head, a 64-step host search; a caller with a large
    head may pass a clip found on a sample). A head that is a DTensor
    gives a ``ShardedQuantHead``: each rank packs its own column shard."""
    w = tfm.logits_head_weight(params, cfg)
    if clip is None:
        clip = mmse_clip(sh.full(w).to(torch.float32), bits)
    if not sh.is_dtensor(w):
        packed, scales = kops.pack_for_kernel(w.to(torch.float32), bits, clip)
        return QuantHead(packed, scales, bits)
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(p if isinstance(p, Shard) and p.dim == 1 else Replicate()
               for p in w.placements)
    w = w.redistribute(w.device_mesh, pl)
    packed, scales = kops.pack_for_kernel(w.to_local().to(torch.float32),
                                          bits, clip)
    return ShardedQuantHead(QuantHead(packed, scales, bits), w.device_mesh,
                            pl, w.shape[1])


def int8_head(params, cfg) -> QuantHead:
    """The int8 head the reference serves through: clip at max |w|, so each
    column's scale is its own range (argmax-lossless on its test heads)."""
    w = tfm.logits_head_weight(params, cfg)
    return quant_head(params, cfg, 8, float(sh.full(torch.max(torch.abs(w)))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="full-width stablelm-1.6b (about 3.3 GB of bf16)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("stablelm-1.6b")
    cfg = cfg if args.full else cfg.reduced()
    params = tfm.init_lm(0, cfg, dev)
    head = int8_head(params, cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt),
                           generator=g, device=dev)
    t0 = time.perf_counter()
    dense = decode_loop(params, cfg, tokens, args.gen)
    t_dense = time.perf_counter() - t0
    rec = RecordingHead(head)
    t0 = time.perf_counter()
    quant = decode_loop(params, cfg, tokens, args.gen, head_fn=rec)
    t_quant = time.perf_counter() - t0
    held = rec.on_margins(tfm.logits_head_weight(params, cfg),
                          lambda h: tfm.logits_head(params, cfg, h),
                          dense, quant)
    print(f"{cfg.name} on {dev}: dense head {t_dense:.2f}s, int8 head "
          f"{t_quant:.2f}s ({kops.quant_matmul.launches} quant_matmul "
          f"launches); int8 head {head.nbytes / 1e6:.1f} MB; tokens equal: "
          f"{bool(torch.equal(dense, quant))}; held on margins: {held}")
    return 0 if held["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
