"""The flash-style branch of the port's ``gqa_attention`` (sequences past
``dense_max``: q-chunks and kv-chunks with an online softmax) against the
reference's branch, forced at small sizes by a small ``dense_max``,
``chunk_q`` and ``chunk_k``, and against the port's own dense path.

Tolerance: atol 0.02 on the bf16 outputs, the port's bound for its
attention primitives (``tests/test_torch_lm.py``). The reference runs
jitted, one compile a case (op by op its nested ``lax.scan``s compile at
every call)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as RC
from repro_torch.models import common as TC

R_ATTN = jax.jit(RC.gqa_attention, static_argnames=(
    "q_offset", "kv_valid", "chunk_q", "chunk_k", "causal", "dense_max"))
H, KV, D = 4, 2, 16
SMALL = dict(chunk_q=4, chunk_k=8, dense_max=8)

# (Tq, Tk, causal, q_offset, kv_valid)
CASES = {
    "causal_chunk_multiples": (16, 16, True, 0, None),
    "causal_padded": (19, 19, True, 0, None),
    "bidirectional_padded": (13, 21, False, 0, None),
    "offset_and_valid": (12, 24, True, 5, 20),
    "offset_valid_padded": (9, 21, True, 11, 19),
    "bidirectional_valid": (9, 17, False, 0, 15),
}


def _np(t):
    return t.to(torch.float32).numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _bf16_pair(seed, shape):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, TC.tensor_from_numpy(np.asarray(j), "cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_flash_branch_matches_reference_and_dense(case):
    Tq, Tk, causal, q_offset, kv_valid = CASES[case]
    qj, qt = _bf16_pair(1, (2, Tq, H, D))
    kj, kt = _bf16_pair(2, (2, Tk, KV, D))
    vj, vt = _bf16_pair(3, (2, Tk, KV, D))
    kw = dict(q_offset=q_offset, kv_valid=kv_valid, causal=causal)
    got = TC.gqa_attention(qt, kt, vt, **kw, **SMALL)
    assert got.dtype == torch.bfloat16 and got.shape == (2, Tq, H, D)
    want = R_ATTN(qj, kj, vj, **kw, **SMALL)
    np.testing.assert_allclose(_np(got), _np(want), atol=0.02)
    dense = TC.gqa_attention(qt, kt, vt, **kw)
    np.testing.assert_allclose(_np(got), _np(dense), atol=0.02)


def test_flash_branch_is_taken_past_dense_max(monkeypatch):
    """Past ``DENSE_ATTN_MAX`` (and past a chunk either way) the branch is
    the flash one; within a chunk each way, dense whatever the length."""
    calls = []
    flash = TC._flash_attention
    monkeypatch.setattr(TC, "_flash_attention",
                        lambda *a: calls.append(a[0].shape) or flash(*a))
    q = torch.zeros((1, 9, 2, 4), dtype=torch.bfloat16)
    TC.gqa_attention(q, q, q, **SMALL)
    assert calls == [(1, 9, 2, 1, 4)]
    TC.gqa_attention(q, q, q, chunk_q=9, chunk_k=9, dense_max=8)
    TC.gqa_attention(q, q, q, **{**SMALL, "dense_max": 9})
    assert len(calls) == 1
