"""End-to-end run on the PyTorch port: train the paper's SRU speech
architecture on the synthetic TIMIT stand-in, with checkpoint/restart,
then post-training quantize and report the error/compression trade-off.

The counterpart of ``examples/train_sru_speech.py``, on ``repro_torch``
alone (no JAX).

Run: PYTHONPATH=src python examples/torch_train_sru_speech.py [--steps 400]
     [--device cpu]
"""
import argparse
import os
import tempfile

import torch

from repro_torch.core import sru_experiment as X
from repro_torch.core.quantization import compression_ratio
from repro_torch.models.sru import LAYER_NAMES
from repro_torch.training import checkpoint as ckpt


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    trained = X.train_small_sru(steps=args.steps, verbose=True,
                                device=args.device)
    print(f"baseline val {trained.baseline_val_error:.1f}% "
          f"test {trained.baseline_test_error:.1f}%")

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "sru_speech_ckpt")
    path = ckpt.save(ckpt_dir, args.steps, trained.params, keep=2)
    print(f"checkpointed to {path}")
    restored, step = ckpt.restore(ckpt_dir, trained.params)
    same = all(bool(torch.equal(a, b)) for a, b in
               zip(_leaves(trained.params), _leaves(restored)))
    print(f"restore roundtrip at step {step}: exact={same}")

    print("\npost-training quantization sweep (weights/activations):")
    paper_cfg = X.PAPER_CFG
    sweep = {}
    for wb, ab in ((8, 16), (4, 16), (4, 8), (2, 16), (2, 8)):
        alloc = {n: (wb, ab) for n in LAYER_NAMES}
        err = trained.val_error(alloc)
        # compression computed on the PAPER-scale model (exact arithmetic)
        cr = compression_ratio(paper_cfg.layer_weight_counts(),
                               {n: wb for n in LAYER_NAMES})
        sweep[(wb, ab)] = (err, cr)
        print(f"  W{wb:2d}/A{ab:2d}: val {err:5.1f}% "
              f"({err-trained.baseline_val_error:+5.1f} pp)  "
              f"paper-model compression {cr:4.1f}x")
    return {"restored_exact": same, "step": step, "sweep": sweep,
            "baseline_val_error": trained.baseline_val_error}


if __name__ == "__main__":
    main()
