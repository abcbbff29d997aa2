"""Serve a small LM with MOHAQ-quantized weights on the PyTorch port: the
LM head on the ``quant_matmul`` CUDA kernel through prefill and batched
decode; then serve a whole population of quantization allocations in one
dispatch from a packed deployment artifact.

int4 and int8 weights are packed along K in int8 containers and
dequantized in the kernel. The population-serving half goes through
``repro_torch.serving``: a trained search model and its chosen allocations
are frozen into a packed artifact (int codes + scales + manifest, >= 4x
smaller than the f32 banks), an SLO router picks each request's operating
point off the stored front, and the continuous batcher serves the whole
mixed-allocation batch in one ``forward_decode_step`` dispatch a step
(``bank_qmm_pop`` and ``sru_scan_pop`` on a card).

The counterpart of ``examples/serve_quantized.py``, on ``repro_torch``
alone (no JAX). On the CPU every kernel call runs its plain PyTorch
version.

Run: PYTHONPATH=src python examples/torch_serve_quantized.py [--device cpu]
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import serving as S
from repro_torch.configs import get_config
from repro_torch.core import sru_experiment as X
from repro_torch.core.quantization import mmse_clip
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import sru
from repro_torch.models import transformer as tfm
from repro_torch.serving.lm import QuantHead, RecordingHead, decode_loop


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("stablelm-1.6b").reduced()
    params = tfm.init_lm(0, cfg, dev)

    # --- quantize the LM head: int4 for memory, int8 for lossless serving ---
    w = tfm.logits_head_weight(params, cfg).to(torch.float32)   # (D, V)
    clip4 = mmse_clip(w, 4)
    packed4, scales4 = kops.pack_for_kernel(w, 4, clip4)
    orig_bytes = w.numel() * 2                         # bf16 deployment
    q_bytes = packed4.numel() + scales4.numel() * 4
    print(f"lm_head: {tuple(w.shape)} bf16 {orig_bytes/1e3:.0f}kB -> int4 "
          f"{q_bytes/1e3:.0f}kB ({orig_bytes/q_bytes:.1f}x smaller)")
    # int8 keeps the greedy picks wherever the dense head's top-2 margin is
    # beyond the reach of its rounding bound (int4 flips near-tie logits
    # on a 256-way random-init vocab: the error/hardware trade the MOHAQ
    # search navigates); serve through int8, report int4 noise below
    packed8, scales8 = kops.pack_for_kernel(
        w, 8, float(torch.max(torch.abs(w))))
    quant_head = QuantHead(packed8, scales8, 8)

    # --- serve: prefill a prompt, decode 8 tokens greedily, both heads ---
    B, prompt_len, gen = 2, 16, 8
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, prompt_len), generator=g,
                           device=dev)
    t0 = time.time()
    dense_tokens = decode_loop(params, cfg, tokens, gen)
    t_dense = time.time() - t0
    # the int8 head keeps each call's hidden state and logits; afterwards
    # the dense head on the same hidden states gives the top-2 margins and
    # a bound on the int8 head's logit error set by its rounding: the
    # error must stay within it, and the tokens must agree until a margin
    # is within the bound's reach (a tie the int8 head may break the other
    # way) and may part only at such a position
    rec = RecordingHead(quant_head)
    launches = kops.quant_matmul.launches
    t0 = time.time()
    quant_tokens = decode_loop(params, cfg, tokens, gen, head_fn=rec)
    t_quant = time.time() - t0
    launches = kops.quant_matmul.launches - launches
    match = bool(torch.equal(dense_tokens, quant_tokens))
    held = rec.on_margins(w, lambda h: tfm.logits_head(params, cfg, h),
                          dense_tokens, quant_tokens)
    print(f"dense head  {t_dense:.1f}s tokens {dense_tokens.tolist()}")
    print(f"int8 head   {t_quant:.1f}s tokens {quant_tokens.tolist()} "
          f"({launches} quant_matmul launches)")
    print(f"generated tokens match dense head: {match}")
    print(f"int8 head's largest logit error: {held['max_error_share']:.4f} "
          f"of its rounding bound")
    if held["first_differing"] is not None:
        print(f"first differing position {held['first_differing']} (rows "
              f"{held['rows']}): dense top-2 margin {held['margin']} within "
              f"the bound's reach {held['reach']}; later positions agree "
              f"{held['agreement_after']}")
    assert held["ok"], f"int8 head erred past its rounding bound or parted " \
        f"from the dense head outside the bound's reach: {held}"

    # --- check the kernel path against the dense head on random hiddens ---
    x = torch.randn((B, cfg.d_model), generator=g, device=dev)
    dense_logits = x @ w
    kern_logits = kops.quant_matmul(x, packed4, scales4, 4)
    err = float(torch.max(torch.abs(dense_logits - kern_logits)))
    rel = err / float(torch.max(torch.abs(dense_logits)))
    print(f"int4 kernel vs dense head: max abs err {err:.3f} (rel {rel:.3f}) "
          f"- int4 quantization noise, as expected")

    # --- Pareto-front-as-a-service from the packed artifact ---------------
    # The search's population axis doubles as the serving request axis:
    # lane i's menu index is request i's allocation, so adding an operating
    # point never adds a dispatch.
    trained = X.train_small_sru(steps=8, device=dev)
    names = list(trained.layer_names)
    presets = [{n: (b, 8) for n in names} for b in (2, 4, 8, 16)]
    objectives = [{"error": 12.0}, {"error": 7.0}, {"error": 3.0},
                  {"error": 1.0}]              # front-row stand-ins
    with tempfile.TemporaryDirectory() as d:
        manifest = S.pack_deployment(trained, presets, d,
                                     objectives=objectives)
        art = S.DeploymentArtifact.load(d)
    by = manifest["bytes"]
    print(f"packed artifact: {art.n_allocs} allocations, weight banks "
          f"{by['packed_weight_banks']/1e3:.0f}kB "
          f"({by['ratio']:.2f}x smaller than f32 banks)")
    router = S.Router(art)
    for c in router.classes:
        dec = router.route(c.name)
        row = art.objectives[dec.alloc]
        print(f"  SLO {c.name:>8s} -> allocation {dec.alloc} "
              f"(error {row['error']:.0f}%, {row['cost_bits']:.1f} mean "
              f"weight bits)")
    bat = S.ContinuousBatcher(S.ServingEngine(art, device=dev), router,
                              max_lanes=4, chunk=16, collect=True)
    rng = np.random.default_rng(0)
    dim = art.cfg.input_dim
    reqs = [S.Request(rid=i, slo=("premium", "standard", "economy")[i % 3],
                      feats=rng.normal(size=(32, dim)).astype(np.float32))
            for i in range(6)]
    for r in reqs:
        bat.submit(r)
    log = bat.run_until_idle()
    for r in reqs:                             # served == scalar, bitwise
        qp = trained.qp_for(presets[log.requests[r.rid].alloc])
        feats = torch.from_numpy(r.feats).to(dev)
        ref = torch.cat([
            sru.forward(trained.params, trained.cfg, feats[s:s + 16][None],
                        qp=qp)[0] for s in range(0, 32, 16)])
        assert np.array_equal(bat.results[r.rid], ref.cpu().numpy()), r.rid
    s = log.summary()
    print(f"served {s['n_completed']} requests over 3 SLO classes in "
          f"{s['n_dispatches']} dispatches ({s['n_steps']} steps, "
          f"{s['tokens_per_s']:.0f} frames/s) — logits bitwise == the "
          f"scalar forward(qp=) path")
    return {"tokens_match": match, "held_on_margins": held,
            "int4_rel_err": rel,
            "served": s, "quant_matmul_launches": launches}


if __name__ == "__main__":
    main()
