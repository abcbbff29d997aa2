"""Faults planted underneath the timed path, to see the output check fail:

- ``half``: the evaluator counts the errors of every other sequence of each
  subset and doubles them (half of the batch left out, the mean taken over
  the rest);
- ``answer``: one lane's error, as the evaluator returns it, moved by 5
  points (an answer altered where it is produced);
- ``state``: the recurrence never carries its state (the SRU's scan starts
  every step from c = 0; the sLSTM's cell state is zeroed every step): a
  step that returns its state unchanged.

There is no exchange between chips to leave out: every cell uses one.
"""
from __future__ import annotations

import contextlib

FAULTS = ("half", "answer", "state")


@contextlib.contextmanager
def planted(name: str):
    import torch

    from repro_torch.core import batched_eval as BE
    undo = []

    def patch(owner, attr, value):
        undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "half":
        def half(self, params, banks, feats, labels, qp_stack):
            logits = self._forward_pop(params, feats, qp_stack, banks)
            wrong = torch.argmax(logits, dim=-1) != labels[None]
            p, _, t = wrong.shape
            w = wrong.reshape(p, self._n_subsets, -1, t)
            return 2 * w[:, :, ::2].sum(dim=(2, 3))
        patch(BE.PopulationEvaluator, "_batch_err", half)
    elif name == "answer":
        errors = BE.PopulationEvaluator.errors

        def altered(self, allocs, params):
            errs = errors(self, allocs, params)
            return [e + 5.0 if i == len(errs) // 2 else e
                    for i, e in enumerate(errs)]
        patch(BE.PopulationEvaluator, "errors", altered)
    elif name == "state":
        from repro_torch.kernels import ops, ref
        from repro_torch.models import xlstm

        def scan(uw, uf, ur, v_f, v_r, b_f, b_r):
            f = torch.sigmoid(uf + b_f)
            r = torch.sigmoid(ur + b_r)
            c = (1.0 - f) * uw
            return r * c, r, c[:, :, -1]
        patch(ref, "sru_scan_pop_ref", scan)
        patch(ops, "sru_scan_pop", scan)
        cell = xlstm._slstm_cell

        def cell_fn(p, cfg, pre, state, rec=None):
            new = cell(p, cfg, pre, state, rec)
            return {k: torch.zeros_like(v) if k == "c" else v
                    for k, v in new.items()}
        patch(xlstm, "_slstm_cell", cell_fn)
    else:
        raise ValueError(f"unknown fault {name!r} (one of {FAULTS})")
    try:
        yield
    finally:
        for owner, attr, value in reversed(undo):
            setattr(owner, attr, value)
