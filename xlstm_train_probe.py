"""Train xlstm-350m at full width and depth on the card under one or more
recipes, printing the loss and the validation error as training goes.

The recipes are the knobs of ``repro_torch.core.xlstm_target.
train_small_xlstm`` (steps, batch, seq, lr, schedule, tf32); the
validation error is the search target's baseline metric (the max over 4
subsets of 4 x 64 next-token frames, full precision, TF32 off). Each
recipe starts from the same seeded initial weights and token stream. One
JSON line per checkpoint and one per recipe; the first recipe also times
steps with TF32 off, against the same steps with it on.

    python3 xlstm_train_probe.py                      # the default sweep
    python3 xlstm_train_probe.py '{"lr": 2e-3, "steps": 300}' ...

Needs one CUDA card; exits 2 without one.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

DEFAULT = dict(steps=600, batch=4096, seq=3, lr=2e-3, schedule="constant",
               tf32=True)
SWEEP = [dict(lr=2e-3), dict(lr=4e-3), dict(lr=1e-3)]
EVERY = 60
TIMED_STEPS = 6


def val_error(params, cfg, val):
    import torch
    from repro_torch.core import xlstm_target as XT
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            return max(100.0 * float((XT.forward_plain(params, cfg, t)
                                      .argmax(-1) != lab).sum()) / lab.numel()
                       for t, lab in val)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def step_ms(model, params, ocfg, batches, tf32):
    """Median ms of ``TIMED_STEPS`` AdamW steps from ``params`` (the
    result is thrown away)."""
    import statistics
    import torch
    from repro_torch.training import optimizer as opt
    torch.backends.cuda.matmul.allow_tf32 = tf32
    ost = opt.init_opt_state(params)
    p, times = params, []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        p, ost, loss = opt.adamw_step(ocfg, model.loss, p, ost, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    torch.backends.cuda.matmul.allow_tf32 = False
    return statistics.median(times[1:])


def run(recipe, cfg, val, timed: bool):
    import numpy as np
    import torch
    from repro_torch.core import xlstm_target as XT
    from repro_torch.data import synthetic
    from repro_torch.models import registry
    from repro_torch.training import optimizer as opt
    r = {**DEFAULT, **recipe}
    model = registry.get_model(cfg, "cuda")
    params = model.init(0)
    ocfg = opt.AdamWConfig(lr=r["lr"], schedule=r["schedule"],
                           warmup_steps=10, total_steps=r["steps"],
                           weight_decay=0.0)
    data = synthetic.lm_batches(cfg.vocab_size, r["batch"], r["seq"],
                                seed=11, n_noise=XT.N_NOISE, device="cuda")
    out = {"recipe": r}
    if timed:
        batches = [next(synthetic.lm_batches(
            cfg.vocab_size, r["batch"], r["seq"], seed=12, start_step=i,
            n_noise=XT.N_NOISE, device="cuda")) for i in range(TIMED_STEPS)]
        out["step_ms_fp32"] = step_ms(model, params, ocfg, batches, False)
        out["step_ms_tf32"] = step_ms(model, params, ocfg, batches, True)
    torch.cuda.reset_peak_memory_stats()
    ost = opt.init_opt_state(params)
    curve, t0 = [], time.perf_counter()
    for i in range(r["steps"]):
        torch.backends.cuda.matmul.allow_tf32 = r["tf32"]
        params, ost, loss = opt.adamw_step(ocfg, model.loss, params, ost,
                                           next(data))
        torch.backends.cuda.matmul.allow_tf32 = False
        if (i + 1) % EVERY == 0 or i + 1 == r["steps"]:
            point = {"step": i + 1, "loss": float(loss),
                     "val_error": val_error(params, cfg, val),
                     "s": time.perf_counter() - t0}
            curve.append(point)
            print(json.dumps(point), flush=True)
            if not np.isfinite(point["loss"]):
                break
    out.update(curve=curve, train_s=time.perf_counter() - t0,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    print(json.dumps(out), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is present", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core import xlstm_target as XT
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config("xlstm-350m")
    val, _ = XT._eval_sets(cfg, 4, 64, device="cuda")
    recipes = [json.loads(a) for a in sys.argv[1:]] or SWEEP
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__}), flush=True)
    for i, recipe in enumerate(recipes):
        run(recipe, cfg, val, timed=i == 0)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
