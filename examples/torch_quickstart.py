"""Quickstart on the PyTorch port: the MOHAQ pipeline in a few minutes.

1. Build the paper's SRU-TIMIT model config and confirm the exact Table 4
   numbers.
2. Post-training-quantize a small trained SRU speech model (MMSE clipping,
   calibrated activation ranges) at a few bit-widths.
3. Score paper-published Pareto solutions with the SiLago hardware model:
   compression, speedup and energy come out at the paper's values.

The counterpart of ``examples/quickstart.py``, on ``repro_torch`` alone (no
JAX). On a CUDA card the population evaluation runs the port's kernels.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core import sru_experiment as X
from repro_torch.core.hardware import SILAGO
from repro_torch.core.mohaq import MOHAQProblem
from repro_torch.models.sru import LAYER_NAMES


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("== 1. paper model breakdown (Table 4) ==")
    paper = get_config("sru_timit")
    counts = paper.layer_weight_counts()
    for name, c in counts.items():
        print(f"  {name:4s} MACs/frame = weights = {c}")
    print(f"  total {sum(counts.values())} (paper: 5549500)")

    print("\n== 2. post-training quantization of a trained SRU ==")
    trained = X.train_small_sru(steps=150, device=args.device)
    print(f"  baseline val error {trained.baseline_val_error:.1f}%")
    ptq = {}
    for bits in (8, 4, 2):
        alloc = {n: (bits, 16) for n in LAYER_NAMES}
        err = trained.val_error(alloc)
        ptq[bits] = err
        print(f"  all-{bits}-bit weights: val error {err:.1f}% "
              f"({err - trained.baseline_val_error:+.1f} pp)")

    print("\n== 3. hardware objectives for a paper solution ==")
    macs = paper.layer_weight_counts()
    prob = MOHAQProblem(list(LAYER_NAMES), macs, macs,
                        paper.vector_weight_count(), SILAGO,
                        lambda a: 0.0, 16.2, fixed_ops=88000 + 10704)
    s7 = {n: (4, 4) for n in LAYER_NAMES}     # paper Table 6 S7
    hw = prob.hardware_objectives(s7)
    print(f"  SiLago all-4-bit: speedup {hw['speedup']:.1f}x "
          f"(paper 3.9x), energy {hw['energy']*1e6:.1f}uJ (paper 2.6uJ), "
          f"compression {hw['compression']:.1f}x (paper 8x)")
    return {"table4": counts, "baseline_val_error":
            trained.baseline_val_error, "ptq": ptq, "s7": hw}


if __name__ == "__main__":
    main()
