"""int8 error-feedback gradient compression: the paper's quantization idea
applied to the gradient that a data-parallel reduction would move.

Port of the reference package's ``training/grad_compress.py``. Each
gradient leaf, plus the error carried from the last step, is quantized to
int8 against its own max-abs; what the codes miss is carried to the next
step (error feedback, Karimireddy et al. 2019). The codes are exactly
representable, so a reduction of them could move a quarter of the float32
bytes. On one device there is no reduction: the trainer round-trips the
gradient through the codes, as the reference does between the loss and the
optimizer. Bitwise equal to the reference's jitted trainer on the CPU: the
scale is divided, never multiplied by a reciprocal, ``torch.round`` rounds
half to even, and the error buffer ``g - q * scale`` is rounded once, as
XLA computes it there (it contracts the product and the difference into
one fused multiply-add; op by op, the reference rounds the product first,
which can move the buffer by one float32 step).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.training.optimizer import tree_leaves, tree_unflatten


def quantize_leaf(g, ebuf):
    """-> (int8 codes, float32 scale, new error buffer)."""
    g = g.to(torch.float32) + ebuf
    amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / torch.tensor(
        127.0, dtype=torch.float32, device=g.device)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    # q * scale is exact in float64 (8 + 24 significant bits), and so is its
    # difference from g (|g - q * scale| <= scale / 2 + one float32 step of
    # g): one rounding to float32, a fused multiply-add's result
    err = (g.to(torch.float64) - q.to(torch.float64) * scale.to(
        torch.float64)).to(torch.float32)
    return q, scale, err


def dequantize_leaf(q, scale):
    return q.to(torch.float32) * scale


def init_error_state(params):
    return tree_unflatten(params, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in tree_leaves(params)])


def compress_grads(grads, error_state) -> Tuple[Any, Any]:
    """Round-trip every gradient leaf through int8 with error feedback.
    Returns (dequantized gradients, new error state)."""
    qs = [quantize_leaf(g, e) for g, e in zip(tree_leaves(grads),
                                              tree_leaves(error_state))]
    return (tree_unflatten(grads, [dequantize_leaf(q, s) for q, s, _ in qs]),
            tree_unflatten(grads, [e for _, _, e in qs]))
