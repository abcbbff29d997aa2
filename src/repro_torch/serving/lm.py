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
random weights, and reports whether the int8 head's greedy tokens equal the
dense head's.

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
from repro_torch.core.quantization import mmse_clip
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ops as kops
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
    t0 = time.perf_counter()
    quant = decode_loop(params, cfg, tokens, args.gen, head_fn=head)
    t_quant = time.perf_counter() - t0
    print(f"{cfg.name} on {dev}: dense head {t_dense:.2f}s, int8 head "
          f"{t_quant:.2f}s ({kops.quant_matmul.launches} quant_matmul "
          f"launches); int8 head {head.nbytes / 1e6:.1f} MB; tokens equal: "
          f"{bool(torch.equal(dense, quant))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
