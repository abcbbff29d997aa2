"""A second witness on the xLSTM's calibration: the activation ranges of the
program's calibration forward, of the float32 reference's own forward and of
the same reference with every product summed in float64, one model a seed;
and how often the full-precision argmax of each agrees with the float32
reference's (the fold's labels).

    python3 bench/witness.py --seeds 20240507 1 2 [--small]

One JSON line a model: each layer's ranges and the three gaps between them,
and the agreements. ``--small`` runs a four-block model on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    import run
    run._environment()
    import torch

    import discovery
    import refquant as RQ
    from repro_torch.core import xlstm_target as XT

    class Float64Sums(RQ.Precision):
        def mm(self, a, b):
            return torch.matmul(a.double(), b.double()).float()

    mod = discovery.config_module("xlstm_350m")
    spec = dict(discovery.config_spec("xlstm_350m"))
    dev = torch.device("cpu")
    if args.small:
        spec.update(n_layers=4, d_model=32, vocab_size=64, tokens=8,
                    sequences_per_subset=2)
    else:
        dev = torch.device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = mod.port_config(spec)
    B = spec["sequences_per_subset"]
    for seed in args.seeds:
        params = mod.make_params(spec, seed, dev)
        tokens = mod.make_tokens(spec, seed, dev)
        cal = [tokens[s * B:(s + 1) * B] for s in range(spec["val_subsets"])]
        with torch.no_grad():
            prog = XT.calibrate(params, cfg, cal)
            f32, f64 = RQ.Precision("f32"), Float64Sums("f32")
            own = mod.ref_ranges(spec, params, cal, f32)[0]
            own64 = mod.ref_ranges(spec, params, cal, f64)[0]
            labels = mod.ref_forward(spec, params, tokens, None,
                                     f32)[0].argmax(-1)
            top64 = mod.ref_forward(spec, params, tokens, None,
                                    f64)[0].argmax(-1)
            plain = XT.forward_plain(params, cfg, tokens).argmax(-1)
        layers = {k: {"program": prog[k], "f32": own[k], "f64": own64[k],
                      "program_f32": RQ.rel_gap(prog[k], own[k]),
                      "f32_f64": RQ.rel_gap(own[k], own64[k]),
                      "program_f64": RQ.rel_gap(prog[k], own64[k])}
                  for k in mod.layer_names(spec)}
        print(json.dumps({
            "model_seed": seed,
            "widest": {g: max(v[g] for v in layers.values())
                       for g in ("program_f32", "f32_f64", "program_f64")},
            "argmax_f64_agrees": float((top64 == labels).float().mean()),
            "argmax_program_agrees": float((plain == labels).float().mean()),
            "layers": layers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
