"""Deterministic synthetic data: the TIMIT stand-in for the SRU model and
the bigram token task of the xLSTM.

Port of the reference package's ``data/synthetic.py``. Every batch is a
pure function of (seed, step, host): it comes from a numpy generator seeded
with ``SeedSequence([seed, step, host])``.

- ``speech_batch``: FBANK-like feature sequences with per-frame phone-state
  labels from a fixed random "teacher" network. The teacher uses
  ``np.random.default_rng(task.seed)`` in both packages, so its weights
  are identical.
- ``lm_batch``: tokens with a planted bigram rule, ``next = (5 * prev +
  noise) % vocab``, ``noise`` uniform over ``n_noise`` values.

The reference draws features, first tokens and noise with ``jax.random``
(threefry), this module with numpy's PCG64, so the arrays differ. Tests
that compare the packages feed the reference's arrays to both instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


def _rng(seed: int, step: int, host: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step, host]))


# ------------------------------------------------------------------ LM

def lm_batch(vocab: int, batch: int, seq: int, *, seed: int = 0,
             step: int = 0, host: int = 0, n_noise: int = 7,
             device="cuda") -> Dict[str, torch.Tensor]:
    """Bigram-structured tokens: next token = (5 * prev + noise) % vocab.
    ``n_noise`` is the number of equiprobable noise values; the top-1
    error floor is 1 - 1/n_noise. Returns {"tokens": (batch, seq),
    "labels": (batch, seq)} int64 on ``device``; ``labels`` is the tokens
    shifted left by one, with -1 (ignored) in the last column."""
    dev = resolve_device(device)
    rng = _rng(seed, step, host)
    tokens = np.empty((batch, seq), np.int64)
    tokens[:, 0] = rng.integers(0, vocab, batch)
    noise = rng.integers(0, n_noise, (batch, seq))
    for t in range(1, seq):
        tokens[:, t] = (tokens[:, t - 1] * 5 + noise[:, t - 1]) % vocab
    labels = np.concatenate([tokens[:, 1:], np.full((batch, 1), -1)], axis=1)
    return {"tokens": torch.from_numpy(tokens).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}


def lm_batches(vocab: int, batch: int, seq: int, *, seed: int = 0,
               start_step: int = 0, host: int = 0, n_noise: int = 7,
               device="cuda") -> Iterator[Dict]:
    step = start_step
    while True:
        yield lm_batch(vocab, batch, seq, seed=seed, step=step, host=host,
                       n_noise=n_noise, device=device)
        step += 1


# ------------------------------------------------------------------ speech

@dataclasses.dataclass(frozen=True)
class SpeechTask:
    """Fixed random teacher mapping feature windows to phone states."""
    input_dim: int = 23
    n_states: int = 1904
    hidden: int = 64
    seed: int = 1234

    def teacher(self):
        rng = np.random.default_rng(self.seed)
        w1 = rng.normal(0, 1.0, (self.input_dim * 3, self.hidden)).astype(np.float32)
        w2 = rng.normal(0, 1.0, (self.hidden, self.n_states)).astype(np.float32)
        return w1, w2


def speech_batch(task: SpeechTask, batch: int, seq: int, *, seed: int = 0,
                 step: int = 0, host: int = 0,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """Smooth random feature tracks; labels from the teacher over a 3-frame
    context window. Returns {"feats": (batch, seq, input_dim) f32,
    "labels": (batch, seq) int64} on ``device``."""
    dev = resolve_device(device)
    rng = _rng(seed, step, host)
    raw = rng.standard_normal((batch, seq + 4, task.input_dim),
                              dtype=np.float32)
    # smooth over time (speech-like correlations)
    feats = ((raw[:, :-4] + raw[:, 1:-3] + raw[:, 2:-2] + raw[:, 3:-1]
              + raw[:, 4:]) / np.float32(np.sqrt(5.0))).astype(np.float32)
    ctx = np.concatenate(
        [feats, np.roll(feats, 1, axis=1), np.roll(feats, -1, axis=1)],
        axis=-1)
    w1, w2 = task.teacher()
    labels = np.argmax(np.tanh(ctx @ w1) @ w2, axis=-1)
    return {"feats": torch.from_numpy(feats).to(dev),
            "labels": torch.from_numpy(labels.astype(np.int64)).to(dev)}


def speech_batches(task: SpeechTask, batch: int, seq: int, *, seed: int = 0,
                   start_step: int = 0, host: int = 0,
                   device="cuda") -> Iterator[Dict]:
    step = start_step
    while True:
        yield speech_batch(task, batch, seq, seed=seed, step=step, host=host,
                           device=device)
        step += 1


def speech_eval_sets(task: SpeechTask, *, n_val: int = 8, n_test: int = 8,
                     batch: int = 4, seq: int = 64, device="cuda"):
    """Fixed validation / test sets. The validation set is split into 4
    subsets; MOHAQ scores a candidate by the MAX error over subsets."""
    val = [speech_batch(task, batch, seq, seed=77, step=i, device=device)
           for i in range(n_val)]
    test = [speech_batch(task, batch, seq, seed=88, step=1000 + i,
                         device=device)
            for i in range(n_test)]
    subsets = [val[i::4] for i in range(4)]
    return subsets, test
