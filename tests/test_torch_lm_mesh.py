"""Tensor parallelism of the port's LM on a (1, n) ("data", "model") mesh
of n gloo CPU ranks (``torch.multiprocessing.spawn``, a ``file://``
store under ``tmp_path``), the reduced stablelm-1.6b on the port's seeded
params, against the port unsharded in this process:

- every rank decodes teacher-forced by the unsharded run's tokens, its
  own picks taken by ``lm.greedy_tokens`` on the vocab shards, and then
  free-running through ``lm.decode_loop``;
- n = 1 (model degree 1): the picks, the free-running tokens and every
  head run's logits, and ``launch/train.py --model-parallel 1``'s losses,
  equal the unsharded port's bit for bit;
- n = 2: each rank packs and runs its own 128 of the 256 head columns
  (its packing bitwise the slice of the whole head's), decode logits
  within atol 0.15 of the unsharded port (``test_torch_lm.py``'s bound)
  and the picks equal its tokens wherever the top-2 margin is above 0.3;
  free-running, while a batch row's picks are the unsharded port's its
  logits are within 0.15 of the unsharded port's (a fault that builds up
  over steps in the split cache shows there), and a pick parts from its
  tokens only at a margin <= 0.3; training
  losses within rel 2e-3 of the unsharded trainer's
  (``test_torch_train_step.py``'s bound for the LM step);
- both: a run resumed onto the mesh from the uninterrupted run's step-2
  checkpoint gives its steps 3 and 4 bit for bit, and the ranks agree."""
import json

import pytest
import torch
import torch.multiprocessing as mp

from _torch_lm_mesh_ranks import ARCH, TRAIN, decode, rank_main
from repro_torch.configs import get_config
from repro_torch.launch import train as TL
from repro_torch.models import transformer as tfm
from repro_torch.serving import lm


@pytest.fixture(scope="module")
def unsharded():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = get_config(ARCH).reduced()
    params = tfm.init_lm(0, cfg, "cpu")
    tokens, runs = decode(params, cfg, lm.int8_head(params, cfg))
    losses = _plain_losses(cfg, 4)
    torch.set_num_threads(n)
    return tokens, runs, losses


def _plain_losses(cfg, steps):
    """The trainer's losses with no mesh: its step function and data."""
    from repro_torch.data import synthetic
    from repro_torch.models.registry import get_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts
    args = TL.parse_args(TRAIN + ["--steps", str(steps)])
    model = get_model(cfg, "cpu")
    ocfg = opt.AdamWConfig(lr=args.lr, schedule=args.schedule,
                           warmup_steps=max(args.steps // 20, 1),
                           total_steps=args.steps)
    state, step = ts.init_train_state(model, 0), ts.make_train_step(model,
                                                                     ocfg)
    data = synthetic.lm_batches(cfg.vocab_size, args.batch, args.seq,
                                device="cpu")
    out = []
    for _ in range(steps):
        state, m = step(state, next(data))
        out.append(float(m["loss"]))
    return out


@pytest.mark.parametrize("world", [1, 2])
def test_model_parallel_decode_and_training(world, unsharded, tmp_path):
    tokens, runs, losses = unsharded
    (tmp_path / "forced.json").write_text(json.dumps(tokens.tolist()))
    mp.spawn(rank_main, args=(world, str(tmp_path / "store"),
                              str(tmp_path)), nprocs=world, join=True)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(world)]
    for r, got in enumerate(ranks):
        assert got["local_columns"] == 256 // world
        assert got["local_packing_is_the_slice"], r
        assert got["resumed"] == got["losses"][2:], r
        assert got == ranks[0] or r == 0
    got = ranks[0]
    logits = [torch.tensor(x) for x in got["logits"]]
    if world == 1:
        assert got["tokens"] == tokens.tolist()
        assert got["free_tokens"] == tokens.tolist()
        assert all(torch.equal(torch.tensor(a), b)
                   for a, b in zip(got["free_logits"], runs))
        assert all(torch.equal(a, b) for a, b in zip(logits, runs))
        assert got["losses"] == losses
        return
    assert len(logits) == len(runs) == 5
    for a, b in zip(logits, runs):
        assert float((a - b).abs().max()) <= 0.15
    margins = []
    for step, b in enumerate(runs[:-1]):
        top2 = torch.topk(b[:, -1], 2, dim=-1).values
        margins.append(top2[:, 0] - top2[:, 1])
        same = torch.tensor(got["tokens"])[:, step] == tokens[:, step]
        assert bool(same[margins[-1] > 0.3].all()), step
    free, want = got["free_tokens"], tokens.tolist()
    on_track = 0
    for step, (a, b) in enumerate(zip(got["free_logits"], runs)):
        for row in range(len(want)):
            if free[row][:step] != want[row][:step]:
                continue
            on_track += 1
            assert float((torch.tensor(a)[row] - b[row]).abs().max()) \
                <= 0.15, (step, row)
            if step < len(margins) and free[row][step] != want[row][step]:
                assert float(margins[step][row]) <= 0.3, (step, row)
    assert on_track > len(want)       # past the prefill's head run
    for a, b in zip(got["losses"], losses):
        assert abs(a - b) <= 2e-3 * abs(b)
