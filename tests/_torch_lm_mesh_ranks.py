"""The rank program of ``test_torch_lm_mesh.py``: one gloo rank of a
(1, world) ("data", "model") mesh on the CPU, running the reduced
stablelm-1.6b's int8-head decode on params placed on ``lm_axes``
(teacher-forced by the unsharded run's tokens, ``work/forced.json``, and
free-running), and ``launch/train.py --model-parallel world`` (an
uninterrupted run of 4 steps, then a run resumed from its step-2
checkpoint, copied alone into a fresh directory). It imports only
``repro_torch`` (a spawned rank re-imports the module that holds its
function)."""
import json
import os
import shutil

ARCH = "stablelm-1.6b"
PROMPT, GEN, BATCH = 8, 4, 2
TRAIN = ["--arch", ARCH, "--reduced", "--batch", "4", "--seq", "16",
         "--device", "cpu", "--log-every", "1", "--ckpt-every", "2"]


def decode(params, cfg, head_fn, forced=None):
    """The greedy decode of ``serving/lm.py`` with every head run's logits
    recorded (whole, as plain tensors). With ``forced`` (B, GEN) tokens,
    each step reads the forced token (teacher forcing) and the picks of
    ``lm.greedy_tokens`` are returned beside the logits."""
    import torch

    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import lm

    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=g)
    runs = []

    def rec(hidden):
        y = head_fn(hidden)
        runs.append(sh.full(y))
        return y
    if forced is None:
        out = lm.decode_loop(params, cfg, tokens, GEN, head_fn=rec)
        return sh.full(out), runs
    logits, cache = tfm.prefill(params, cfg, tokens, max_len=PROMPT + GEN,
                                head_fn=rec)
    picks = []
    for i in range(GEN):
        picks.append(sh.full(lm.greedy_tokens(logits[:, -1])))
        logits, cache = tfm.decode_step(params, cfg, cache,
                                        forced[:, i:i + 1], head_fn=rec)
    return torch.stack(picks, dim=1), runs


def rank_main(rank, world, store, work):
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import train as TL
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import lm

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        cfg = get_config(ARCH).reduced()
        params = tfm.init_lm(0, cfg, "cpu")
        mesh = make_mesh_for(world, world, device_type="cpu")
        with sh.axis_rules(mesh):
            placed = sh.place_tree(params, sh.tree_shardings(
                mesh, tfm.lm_axes(cfg), params))
            head = lm.int8_head(placed, cfg)
            with open(os.path.join(work, "forced.json")) as f:
                forced = torch.tensor(json.load(f))
            tokens, runs = decode(placed, cfg, head, forced)
            free, free_runs = decode(placed, cfg, head)
            whole = lm.int8_head(params, cfg)
            cols = head.local.packed.shape[1]
            lo = rank * cols
            out = {"tokens": tokens.tolist(), "free_tokens": free.tolist(),
                   "free_logits": [r.tolist() for r in free_runs],
                   "logits": [r.tolist() for r in runs],
                   "local_columns": cols,
                   "local_packing_is_the_slice": bool(
                       torch.equal(head.local.packed,
                                   whole.packed[:, lo:lo + cols])
                       and torch.equal(head.local.scales,
                                       whole.scales[lo:lo + cols]))}

        def train(steps, ckpt):
            return TL.run(TL.parse_args(TRAIN + [
                "--steps", str(steps), "--model-parallel", str(world),
                "--ckpt-dir", os.path.join(work, ckpt)]))
        out["losses"] = train(4, "whole")
        if rank == 0:
            shutil.copytree(os.path.join(work, "whole", "step_00000002"),
                            os.path.join(work, "cut", "step_00000002"))
        dist.barrier()
        out["resumed"] = train(4, "cut")
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
