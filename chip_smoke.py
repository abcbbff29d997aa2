#!/usr/bin/env python3
"""Drive the PyTorch port of MOHAQ on one CUDA card and check it.

    python3 chip_smoke.py            # all phases; needs one CUDA device

Phases, each printing JSON lines:

1. setup: build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, all at once, then one link; each command's seconds and
   their sum, what one source after another would take, are printed),
   print every bank-kernel instantiation's registers, spill bytes and
   shared memory and every scan and ``quant_matmul`` instantiation's
   registers and spill bytes (from ``build.log``'s ptxas lines), the blocks
   an SM holds of ``quant_matmul``'s launches (the runtime's occupancy
   calculator; the LM head's grid must be one resident wave), the card and
   its power limit;
2. kernels: each kernel against its plain PyTorch version on seeded inputs
   at the search path's full-width shapes, at the serving path's (8 lanes
   of a 16-frame chunk, and 4 lanes of a 7-frame ragged tail) and at a
   ragged shape (scan: 1e-5; MxVs and ``quant_matmul``: rtol 1e-4 / atol
   1e-3; the packed MxV bitwise equal to the f32 MxV on the dequantized
   bank); at FC every bank-GEMM tile configuration, forced, bitwise equal
   to every other; at every scan shape ``sru_scan`` bitwise equal to lane
   0 of ``sru_scan_pop``;
3. search path: the inference-only MOHAQ search on the paper's model
   (``configs/sru_timit.py``, full width, synthetic speech), trained first
   on the card by ``train_small_sru`` (400 AdamW steps of 8 x 48 frames
   from seeded random weights; the loss every 50 steps, the median step,
   the training seconds and the baseline errors are printed, and the
   phase fails on a non-finite loss, on a last-50-step mean loss not below
   the first 50's, or on a 100 % baseline val error). The trained params
   are saved by ``training.checkpoint.save`` and restored into a fresh
   template on the card (the phase fails unless ``tree_digest`` and
   ``target_fingerprint`` are equal). Then: calibrate, build
   banks, ``SearchSession(target, "silago", ("error", "speedup",
   "energy")).run(generations=2, pop=10, initial=40)``, score the front in
   the packed deployment format and on the test set. Every kernel's launch
   count over that run must be > 0. Then, on generation 0's allocations,
   the kernel lane against the plain lane and the f32 bank format against
   the packed one (argmax agreement >= 99.9 %, |delta error| <= 0.1 pp);
4. beacon_search: the paper's experiment 3 on the trained target:
   ``SearchSession(target, "bitfusion", ("error", "speedup"),
   sram_override=...)`` inference-only and then with ``beacons=True,
   retrain_steps=60`` (Algorithm 1: binary-connect retraining on the card,
   every beacon's candidates scored through the kernels), checkpointed
   into a ``SearchStore`` (its ``checkpoint_stats`` and bytes printed): the
   uninterrupted run of phase 5. Printed: each
   beacon's allocation, retrain seconds and own-allocation error under the
   base and the beacon's params, both fronts, the best speedup within 2, 4
   and 8 pp, the launches and peak memory. Fails when no beacon was
   retrained, when ``sru_scan_pop``, ``bank_mxv_pop`` or ``sru_scan`` did
   not launch, or on a non-finite result; then the lanes and bank formats
   are compared as in phase 3 on the first beacon's params;
5. resume: two child processes (``python3 chip_smoke.py --resume-child
   SPEC``), each restoring the trained params from phase 3's training
   checkpoint and building the target on the card, run phase 4's beacon
   search into a fresh store. The first kills itself with SIGKILL right
   after ``SearchStore.save`` commits generation K (the first generation
   whose checkpoint in phase 4's store holds a retrain); the second
   resumes its store. Fails unless the first died by SIGKILL with a
   retrain on disk, the resumed run equals phase 4's in ``front_key()``,
   ``n_evals``, ``n_retrains`` and every beacon's digest, and it ran only
   the retrains the store did not hold. Then ``front_from_store`` on phase
   4's store must give that run's front, and ``pack_deployment`` /
   ``load_deployment`` round-trip it with equal ``tree_digest``. Printed:
   retrains restored and run after the kill, each child's seconds, the
   resumed search's seconds beside the uninterrupted run's;
6. lm_serve: stablelm-1.6b at full width (seeded random weights drawn on
   the card), batch 4, a 128-token prompt and 32 greedy tokens through
   ``serving/lm.py`` with the int8 head on ``quant_matmul``. At every step
   the plain head runs on the same hidden state; a differing argmax is
   allowed only where the plain top-2 margin is <= 1e-3. Reported: int8
   vs dense bf16 head token agreement, prefill s, decode ms/token, peak
   memory. ``quant_matmul`` must launch once per head run (33);
7. front_serve: the paper's SRU (the search path's trained target) packed for 4
   presets (weights 2/4/8/16 bits, activations 8) by
   ``serving.pack_deployment``, loaded, routed over 3 SLO classes and
   served by ``ContinuousBatcher(max_lanes=8, chunk=16)`` on 12 requests of
   64-160 frames. ``bank_qmm_pop`` and ``sru_scan_pop`` must launch in
   this phase. Checks: served logits against the scalar ``forward(qp=)``
   per chunk (rtol 1e-4 / atol 1e-3; both run the bank GEMM on the card,
   so this one is not independent of the kernels), and the same traffic
   served on the plain PyTorch lane (``ServingEngine(use_kernel=False)``:
   cuBLAS and the plain scan): argmax agreement >= 99.9 %, and logits
   within the tolerance except in lanes where a rounding tie before an
   activation grid fell the other way (``compare_by_ties``). The same tie
   test holds the scalar forward with its MxVs on ``torch.matmul`` against
   the scalar forward as it runs. Reported: the share of chunks bitwise
   equal, frames/s, continuous vs serial dispatches;
8. xlstm_search: the xLSTM search target at full xlstm-350m width and
   depth (``configs/xlstm_350m.py``: 24 layers, d_model 1024, 25
   searchable layers, 353.6 M searchable weights, 5.66 GB of f32 banks),
   trained on the card by ``train_small_xlstm`` (200 steps of 512 x 17
   tokens of the bigram task; the phase fails on a non-finite loss or one
   that does not fall), validated on 4 subsets of 4 x 64 tokens; the
   inference-only search (bitfusion, (error, speedup), 2 generations of 10
   with 40 in generation 0, an SRAM that holds any allocation) with every
   quantized MxV on ``bank_mxv_pop`` (which must launch); on generation
   0's candidates the kernel lane against the plain lane
   (``compare_xlstm_lanes``: every layer's MxV on the path's inputs within
   rtol 1e-4 / atol 1e-3, each lane's first divergence, argmax flips only
   below the lane's logit gap, a lane flip that moves no other lane); then
   the beacon search, with one retrain at full width where the search
   retrains none. Printed: the training curve, the generation sizes and
   seconds, ``n_evals``, fronts, retrain seconds, each beacon's error
   under the base and its own params, and peak memory;
9. moe_lm: no kernel runs here. The LM trainer, ``python -m
   repro_torch.launch.train``'s ``main``, on granite-moe-1b-a400m at full
   width and depth (``MOE_TRAIN``: 40 steps of 8 x 512 tokens checkpointed
   at 40, the same command with ``--steps 50``, which must resume, then 5
   steps with ``--compress-grads``): the loss at every step, median ms a
   step, tokens/s, peak memory, each checkpoint save's and restore's
   seconds and bytes; it fails on a non-finite loss, on a last-10-step
   mean loss not below the first 10's, or on a missed resume. Then
   qwen2-moe-a2.7b at full width and depth, seeded random bf16 weights:
   batch 4, a 128-token prompt and 16 greedy decode steps through
   ``get_model(cfg).prefill/decode``, in bf16 and from ``quantize_tree``
   at 8 and 4 bits with each layer dequantized when it runs; checks: one
   layer's ``moe_ffn`` on the card against the CPU (the same routing, or a
   near tie; atol 0.02), ``quantize_tree`` of a slice of every leaf kind
   bitwise the CPU's, the lazy per-layer dequantization bitwise
   ``dequantize_tree``'s. Then xlstm-350m's prefill + decode against its
   forward at full width (atol 0.2 at 4 layers; full depth recorded);
10. families: the audio, VLM and hybrid families at full width, seeded
   random weights, each model freed before the next, its peak memory
   printed. seamless-m4t-medium (12 + 12 layers): 40 AdamW steps of
   ``make_train_step(get_model(cfg))`` on 8 x 512 random frames and
   bigram decoder tokens (lr 3e-4 constant; the phase fails unless the
   last 5 steps' mean loss is below the first 5's), then 4 x 1,000 frames
   encoded and 32 greedy tokens, held to a teacher-forced ``forward`` on
   them (atol 0.15). internvl2-26b (48 layers): ``Model.loss`` at batch 1
   on 256 patch embeddings and 256 text tokens (finite, within 2.0 of
   ln V), then a 4 x 512 prompt and 16 greedy steps with the dense head
   and with the int8 head on ``quant_matmul``. jamba-1.5-large-398b cut
   to one group of 8 layers (7 Mamba + 1 attention) and 4 experts: the
   flash branch against the dense path at T 4,096 (atol 0.02); one Mamba
   mixer on the card against the CPU lane on 256 tokens and against 512
   ``mamba_step``s (atol 0.05); the reckoned peak (under 75 GB); a 1 x
   10,240 prefill (the flash branch, 40 Mamba chunks) and 16 greedy steps
   with the dense head and the int8 head; prefill + decode against
   ``forward`` at ``MOE_CAPACITY_FACTOR`` 8.0 (atol 0.25). Every int8 head
   run is held to the plain version on its own hidden state (rtol 1e-4 /
   atol 1e-3) and ``quant_matmul`` must launch once per head run; after
   the counts are read it is timed at both head shapes
   (``QMM_FAMILY_SHAPES``: CUDA-graph device time, byte bound, plain
   version, f32 ``matmul`` on the dequantized head);
11. timing: each kernel, its plain version and the PyTorch library call
   (CUDA events, after warm-up) at the main paths' shapes and at the
   serving shapes; for the bank kernels the median and range of 5 repeats
   beside ``torch.bmm`` with and without its ``index_select`` gather and
   dequantize + ``bmm``, and at the serving shapes also device times from a
   CUDA graph; for the scans (search, P = 1, serving and scalar-chunk
   shapes) and ``quant_matmul`` (int8, int4) the device time from a CUDA
   graph (``graph_ms``, median and range of 5) beside the event-timed call
   (``cuda_ms_stats``, which a short kernel's host work can outlast); the
   scalar forward with its MxVs on ``bank_mxv_pop`` and on
   ``torch.matmul``, one generation's evaluation per lane, and peak device
   memory; ``bank_mxv_pop`` at the xLSTM's shapes beside ``torch.bmm``
   with its ``index_select`` (``time_xlstm_mxvs``). In the
   ``kernels`` line the scans' and ``quant_matmul``'s ``ms`` are graph
   device times and ``host_ms`` the event-timed call (``ms_from`` says
   which).

Each path (3, 4, 5, 6, 7, 8, 9, 10) runs with the launch counts set to 0
just before it and read just after (phase 5: in the resumed child, around its
search; phase 8: around each of its two searches);
the ``kernels`` line's ``launches`` add up those reads.
The last line is ``{"ok": true, "device": {...}}``; a failed phase raises
and the script exits non-zero. It exits non-zero, printing no result, where
no CUDA device is present or the port's sources are missing.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s
# (TF32 is off by the parity rule, so the CUDA-core rate is the ceiling)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
# flops per (lane, sequence, step, channel) of the SRU recurrence: two gate
# pre-activations (2 mul + 4 add), two sigmoids (neg, exp, add, div each),
# the state update (2 mul, 2 add) and h (1 mul)
SCAN_FLOPS = 21

SERVE_LANES, SERVE_CHUNK, SERVE_TAIL = 8, 16, 7
SMALL_ROWS = 32                             # timing: more calls per run below
SCAN_SHAPE = (16, 32, 48, 550)              # (P, B, T, n)
SERVE_SCAN_SHAPES = ((SERVE_LANES, 1, SERVE_CHUNK, 550),
                     (4, 1, SERVE_TAIL, 550))
# timed scans: (P, B, T, n) and the wrapper; P = 1 runs ``sru_scan``
TIMED_SCANS = {"search": ("sru_scan_pop", SCAN_SHAPE),
               "scalar": ("sru_scan", (1,) + SCAN_SHAPE[1:]),
               "serving": ("sru_scan_pop", SERVE_SCAN_SHAPES[0]),
               "scalar_chunk": ("sru_scan", (1, 1, SERVE_CHUNK, 550))}
MXV_SHAPES = {                              # name: (P, M, m, N)
    "L": (16, 1536, 256, 1650),
    "Pr": (16, 1536, 1100, 256),
    "FC": (16, 1536, 1100, 1904),
    "L0": (16, 1536, 23, 1650),
    "ragged": (5, 70, 23, 130),
}
KERNELS = {
    "sru_scan_pop": ("src/repro_torch/csrc/sru_scan_pop.cu",
                     "src/repro/kernels/sru_scan.py:244"),
    "sru_scan": ("src/repro_torch/csrc/sru_scan_pop.cu",
                 "src/repro/kernels/sru_scan.py:72"),
    "bank_mxv_pop": ("src/repro_torch/csrc/bank_mxv_pop.cu",
                     "src/repro/kernels/sru_scan.py:131"),
    "bank_qmm_pop": ("src/repro_torch/csrc/bank_qmm_pop.cu",
                     "src/repro/kernels/sru_scan.py:186"),
    "quant_matmul": ("src/repro_torch/csrc/quant_matmul.cu",
                     "src/repro/kernels/quant_matmul.py:57"),
}
LM_BATCH, LM_PROMPT, LM_GEN = 4, 128, 32
QMM_SHAPES = {"head": (4, 2048, 100352),    # (M, K, N): the LM head
              "ragged": (5, 1037, 1001)}
SLOS = ("premium", "standard", "economy")
TRAIN_STEPS = 400             # train_small_sru's default (the reference's)
BEACON_STEPS = 60             # retraining steps a beacon (paper experiment 3)
SEARCH_KW = dict(generations=2, pop=10, initial=40, seed=0)
# the xLSTM search target at full xlstm-350m width and depth: its training
# (steps of batch x seq tokens, AdamW at a constant lr after 10 warm-up
# steps, TF32 products; xlstm_train_probe.py chose it, PERF.md), the
# baseline val error it must reach, validation (4 subsets of batch x seq
# next-token frames), retraining steps a beacon (20, not the SRU's 60: a
# full-width retrain step takes ~0.6 s and the search may place 8
# beacons), the lanes a comparison holds at once, and the beacon distance
# threshold (the paper's 6 for the SRU's 6 searchable layers, scaled to
# the xLSTM's 25)
XLSTM_ARCH = "xlstm-350m"
XLSTM_TRAIN = dict(steps=240, batch=4096, seq=3, lr=1e-3,
                   schedule="constant", tf32=True)
XLSTM_BASELINE_BAR = 90.0
XLSTM_VAL = dict(val_batch=4, val_seq=64)
XLSTM_RETRAIN_STEPS = 20
XLSTM_LANES = 16
XLSTM_DISTANCE = 25.0
# bank_mxv_pop at the xLSTM's MxV shapes, (P, M, m, N) and bank rows: P = 64
# lanes of 1,024 folded frames; the sLSTM's recurrent MxV runs P x H lanes
# of the 16 folded sequences against the (K x H, dh, 4 dh) bank view
XLSTM_MXV_SHAPES = {"fc": ((64, 1024, 1024, 2048), 4),
                    "wx": ((64, 1024, 1024, 8192), 4),
                    "head": ((64, 1024, 1024, 50432), 4),
                    "rec": ((256, 16, 512, 2048), 16)}
# the moe_lm phase: granite-moe-1b-a400m trained at full width by
# launch/train.py (steps of batch x seq tokens: four MoE groups of 1,024 a
# layer; a constant lr, so that the resumed run continues the first one's
# schedule; lr 3e-4: at 1e-3 and 3e-3 the loss did not fall over 50 steps,
# PERF.md), qwen2-moe-a2.7b served at full width, the xLSTM's decode at
# full width (its check at 4 layers; PERF.md)
MOE_TRAIN_ARCH = "granite-moe-1b-a400m"
MOE_TRAIN = dict(batch=8, seq=512, lr=3e-4, steps=40, resumed_steps=50,
                 compress_steps=5)
MOE_SERVE_ARCH = "qwen2-moe-a2.7b"
MOE_SERVE = dict(batch=4, prompt=128, gen=16)
XLSTM_DECODE = dict(batch=4, prompt=64, gen=16, checked_layers=4)
# the families phase: seamless-m4t-medium trained (steps of batch x seq
# tokens, lr constant, as moe_lm's trainer) and served (4 x 1,000 frames,
# about 20 s of audio at 50 frames a second, then 32 greedy tokens) at full
# width and depth; internvl2-26b's loss (256 patches + 256 text tokens)
# and serving (4 x 512 + 16) at full width and depth; jamba-1.5-large-398b
# at full width cut to one group of 8 layers and 4 of its 16 experts (one
# 16-expert layer alone is 19.3 GB), a 10,240-token prefill (past
# DENSE_ATTN_MAX) and 16 decode steps, with its card checks' sizes
AUDIO = dict(arch="seamless-m4t-medium", batch=8, seq=512, lr=3e-4,
             steps=40, serve_batch=4, frames=1000, gen=32)
VLM = dict(arch="internvl2-26b", patches=256, text=256, batch=4, prompt=512,
           gen=16)
HYBRID = dict(arch="jamba-1.5-large-398b", layers=8, experts=4,
              prompt=10240, gen=16, mamba_cpu_tokens=256, mamba_steps=512,
              flash_check_T=4096, check_prompt=256, check_steps=17)
# quant_matmul's (M, K, N) at the int8 heads of the families phase
QMM_FAMILY_SHAPES = {"jamba": (1, 8192, 65536), "internvl2": (4, 6144, 92672)}
TRAINED_DIR = "trained"       # the training checkpoint, under the work dir
STORE_DIR = "search_store"    # the uninterrupted beacon run's SearchStore
CHILD_TIMEOUT_S = 600


@dataclass
class BeaconRun:
    """The uninterrupted checkpointed beacon search of ``beacon_search``."""
    store: Path
    sram: int
    seconds: float
    summary: dict           # run_summary of its result
    front: list             # its front's allocations


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_stats(fn, iters: int, repeats: int = 5) -> dict:
    """``cuda_ms`` repeated: the median and the range of ``repeats``
    timings of ``iters`` calls each (single short runs can be 2x off)."""
    runs = sorted(cuda_ms(fn, iters, warmup=3 if i == 0 else 1)
                  for i in range(repeats))
    return {"median": statistics.median(runs), "min": runs[0],
            "max": runs[-1]}


def graph_ms(fn, launches: int = 20) -> dict:
    """Device time per call of ``fn`` with the host out of the way:
    ``launches`` calls captured in one CUDA graph, the graph replayed
    (``cuda_ms_stats``), divided by ``launches``. Where a call's host work
    outlasts its kernels (the serving shapes), ``cuda_ms`` times the host
    and this times the device."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    stats = cuda_ms_stats(graph.replay, 5)
    return {k: v / launches for k, v in stats.items()}


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / FP32_FLOP_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ inputs

def scan_inputs(shape, seed, dev):
    """Streams as the main path gives them: column thirds of one MxV output."""
    import torch
    g = torch.Generator().manual_seed(seed)
    P, B, T, n = shape
    u = torch.randn((P, B, T, 3 * n), generator=g).to(dev)
    vecs = [(torch.randn((n,), generator=g) * 0.5).to(dev) for _ in range(4)]
    return (u[..., :n], u[..., n:2 * n], u[..., 2 * n:]), vecs


def bank_inputs(shape, seed, dev):
    """x, f32 bank, packed bank and a menu index per lane covering every
    menu entry; weights sized like the model's, with the most negative code
    of every grid present."""
    import numpy as np
    import torch
    from repro_torch.core import quantization as Q
    P, M, m, N = shape
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((m, N), generator=g) / m ** 0.5
    w[0, :4] = -w.abs().max() * 4
    trips = Q.menu_triples(Q.SUPPORTED_BITS, lambda b: float(w.abs().max())
                           if b == 16 else sampled_clip(w, b))
    w = w.to(dev)
    bank = Q.build_weight_bank(w, trips)
    packed = Q.build_packed_weight_bank(w, trips)
    x = torch.randn((P, M, m), generator=g).to(dev)
    idx = torch.from_numpy((np.arange(P) % 4).astype(np.int32)).to(dev)
    return x, bank, packed, idx


def sampled_clip(w, bits):
    """The MMSE clip of ``w`` taken from a strided sample of 65,536 weights:
    the 64-step host search over a whole 205 M-weight LM head would take
    minutes."""
    from repro_torch.core import quantization as Q
    w = w.flatten()
    return Q.mmse_clip(w[:: max(1, w.numel() // 65536)].float(), bits)


def qmm_inputs(shape, bits, seed, dev):
    """x (M, K) and a (K, N) head packed at ``bits``, drawn on the card:
    int8 clipped at max |w| (as ``serving.lm.int8_head``), 4 and 2 bits at
    the sampled MMSE clip."""
    import torch
    from repro_torch.kernels import ops
    M, K, N = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((K, N), generator=g, device=dev) / K ** 0.5
    w[0, :4] = -w.abs().max() * 4
    clip = float(w.abs().max()) if bits == 8 else sampled_clip(w, bits)
    packed, scales = ops.pack_for_kernel(w, bits, clip)
    x = torch.randn((M, K), generator=g, device=dev)
    return x, packed, scales


def qmm_cost(shape, packed):
    M, K, N = shape
    nbytes = 4 * M * K + packed.numel() + 4 * N + 4 * M * N
    return nbytes, 2 * M * K * N


def scan_cost(shape):
    P, B, T, n = shape
    elems = P * B * T * n
    return 4 * (5 * elems + P * B * n + 4 * n), SCAN_FLOPS * elems


def mxv_cost(shape, idx, container_bytes_per_weight=4.0):
    P, M, m, N = shape
    rows = len(set(idx.tolist()))
    nbytes = 4 * P * M * m + rows * m * N * container_bytes_per_weight \
        + 4 * P * M * N
    return nbytes, 2 * P * M * m * N


def errs(got, want):
    d = (got.double() - want.double()).abs()
    rel = d / want.double().abs().clamp_min(1e-30)
    return float(d.max()), float(rel.max())


# ------------------------------------------------------------------ phases

def phase_setup():
    import torch
    from repro_torch.kernels import build, ops
    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    build_s = time.perf_counter() - t0
    log = (lib.parent / "build.log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    # wall seconds of each nvcc (the compiles, then the link)
    nvcc_s = [float(t) for t in re.findall(r"^\[([0-9.]+) s\]$", log, re.M)]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    bank = bank_kernel_resources(log)
    for c in range(len(ops.BANK_CONFIGS)):     # the table is the library's
        ops.bank_config_info(c)
    emit({"phase": "setup", "bank_kernels": bank,
          "bank_spill_bytes": sum(k["spill_stores"] + k["spill_loads"]
                                  for k in bank)})
    emit({"phase": "setup", "scan_qmm_kernels": scan_qmm_resources(log),
          "qmm_launch": qmm_occupancy()})
    emit({"phase": "setup", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": round(build_s, 3),
          "nvcc_s": nvcc_s, "nvcc_s_sum": round(sum(nvcc_s), 3),
          "library": str(lib.relative_to(REPO)), "ptxas": ptxas})
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    return smi[0] if smi else None


def bank_kernel_resources(log: str):
    """Registers, spill bytes and dynamic shared memory of every bank-kernel
    instantiation, from the ``-Xptxas -v`` lines of ``build.log``."""
    from repro_torch.kernels import ops
    tiles = {(c.bm, c.bn): i for i, c in enumerate(ops.BANK_CONFIGS)}
    out = []
    for block in re.split(r"(?=ptxas info\s+: Compiling entry function)", log):
        name = re.search(r"(bank_(?:mxv|qmm)_pop)_kernelIN9bank_gemm4TileILi"
                         r"(\d+)ELi(\d+)E(?:Li\d+E)*EE(?:Li(\d+)E)?E", block)
        if not name:
            continue
        kernel, bm, bn, width = name.groups()
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        cfg = tiles[(int(bm), int(bn))]
        out.append({"kernel": kernel, "config": cfg, "tile": f"{bm}x{bn}",
                    "copy_width": int(width) if width else None,
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_stores": int(spill.group(1)) if spill else 0,
                    "spill_loads": int(spill.group(2)) if spill else 0,
                    "smem_dynamic": ops.BANK_CONFIGS[cfg].smem_bytes})
    # bank_mxv_pop at each of 3 copy widths, bank_qmm_pop once
    if len(out) != 4 * len(ops.BANK_CONFIGS):
        raise AssertionError(f"found {len(out)} bank-kernel instantiations "
                             f"in build.log")
    return out


def scan_qmm_resources(log: str):
    """Registers and spill bytes of every scan and ``quant_matmul``
    instantiation, from the ``-Xptxas -v`` lines of ``build.log``."""
    out = []
    for block in re.split(r"(?=ptxas info\s+: Compiling entry function)", log):
        scan = re.search(r"sru_scan_pop_kernel", block)
        qmm = re.search(r"quant_matmul_kernelILi(\d)ELi(\d)ELb(\d)E", block)
        if not (scan or qmm):
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        row = ({"kernel": "sru_scan_pop"} if scan
               else {"kernel": "quant_matmul", "bits": int(qmm.group(1)),
                     "mt": int(qmm.group(2)), "vec": qmm.group(3) == "1"})
        out.append({**row, "registers": int(regs.group(1)) if regs else None,
                    "spill_bytes": (int(spill.group(1)) + int(spill.group(2))
                                    if spill else 0)})
    want = 1 + 2 * 3 * 2      # the scan; quant_matmul: 2 row tiles x 3 bits x vec
    if len(out) != want:
        raise AssertionError(f"found {len(out)} scan and quant_matmul "
                             f"instantiations in build.log, expected {want}")
    return out


def qmm_occupancy():
    """The blocks an SM holds of each ``quant_matmul`` launch (the runtime's
    occupancy calculator, for 4 and 8 rows of x a block); raises unless
    the LM head's grid is one resident wave."""
    import torch
    from repro_torch.kernels import ops
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    M, _, N = QMM_SHAPES["head"]
    rows = []
    for m in (M, 8):
        for bits in (8, 4, 2):
            occ = ops.quant_matmul_occupancy(m, N, bits)
            rows.append({"M": m, "N": N, "bits": bits, **occ,
                         "slots": sms * occ["blocks_per_sm"]})
            if m == M and occ["blocks"] > sms * occ["blocks_per_sm"]:
                raise AssertionError(f"the LM head's quant_matmul grid is "
                                     f"not one resident wave: {rows[-1]}")
    return rows


def check_scan(shape, path, dev):
    """``sru_scan_pop`` and ``sru_scan`` (lane 0's streams) against their
    plain versions at ``shape``, and ``sru_scan`` bitwise equal to lane 0
    of ``sru_scan_pop``; returns their max abs errors."""
    import torch
    from repro_torch.kernels import ops, ref
    out, results = {}, {}
    streams, vecs = scan_inputs(shape, 1, dev)
    single = [s[0] for s in streams]
    for name, args, shp in (("sru_scan_pop", streams, shape),
                            ("sru_scan", single, shape[1:])):
        got = results[name] = getattr(ops, name)(*args, *vecs)
        want = getattr(ref, name + "_ref")(*args, *vecs)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        out[name] = max(errs(g, w)[0] for g, w in zip(got, want))
        emit({"phase": "kernels", "kernel": name, "path": path,
              "shape": shp, "max_abs_err": out[name],
              "max_rel_err": max(errs(g, w)[1] for g, w in zip(got, want)),
              "tol": "rtol 1e-5, atol 1e-5"})
    if not all(torch.equal(g, w[0]) for g, w in zip(
            results["sru_scan"], results["sru_scan_pop"])):
        raise AssertionError(f"sru_scan != lane 0 of sru_scan_pop at {shape}")
    return out


def check_banks(layer, shape, path, dev):
    """``bank_mxv_pop`` (not at L0, whose f32 product comes from the
    u-bank) and ``bank_qmm_pop`` against their plain versions at ``shape``,
    and ``bank_qmm_pop`` bitwise against ``bank_mxv_pop`` on the
    dequantized bank; returns their max abs errors."""
    import torch
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import ops, ref
    out = {}
    x, bank, packed, idx = bank_inputs(shape, 2, dev)
    row = {"phase": "kernels", "path": path, "layer": layer, "shape": shape,
           "tol": "rtol 1e-4, atol 1e-3"}
    if layer != "L0":
        got = ops.bank_mxv_pop(x, bank, idx)
        want = ref.bank_mxv_pop_ref(x, bank, idx)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
        out["bank_mxv_pop"], r = errs(got, want)
        emit({**row, "kernel": "bank_mxv_pop",
              "max_abs_err": out["bank_mxv_pop"], "max_rel_err": r})
    got_q = ops.bank_qmm_pop(x, packed, idx)
    want_q = ref.bank_qmm_pop_ref(x, packed, idx)
    on_deq = ops.bank_mxv_pop(x, Q.dequant_packed_bank(packed), idx)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_q, want_q, rtol=1e-4, atol=1e-3)
    bitwise = bool(torch.equal(got_q, on_deq))
    out["bank_qmm_pop"], r = errs(got_q, want_q)
    emit({**row, "kernel": "bank_qmm_pop", "max_abs_err": out["bank_qmm_pop"],
          "max_rel_err": r, "bitwise_equal_to_mxv_on_dequant": bitwise})
    if not bitwise:
        raise AssertionError(f"bank_qmm_pop != bank_mxv_pop on the "
                             f"dequantized bank at {shape}")
    return out


def check_bank_configs(layer, shape, dev):
    """Every tile configuration forced on ``shape``: both bank kernels
    bitwise equal across configurations, and to the wrapper's choice."""
    import torch
    from repro_torch.kernels import ops
    x, bank, packed, idx = bank_inputs(shape, 3, dev)
    n = len(ops.BANK_CONFIGS)
    outs = {name: [fn(x, b, idx, config=c) for c in range(n)]
            for name, fn, b in (("bank_mxv_pop", ops.bank_mxv_pop, bank),
                                ("bank_qmm_pop", ops.bank_qmm_pop, packed))}
    chosen = {"bank_mxv_pop": ops.bank_mxv_pop(x, bank, idx),
              "bank_qmm_pop": ops.bank_qmm_pop(x, packed, idx)}
    torch.cuda.synchronize()
    equal = {name: all(torch.equal(o[c], o[0]) for c in range(n))
             and torch.equal(chosen[name], o[0]) for name, o in outs.items()}
    emit({"phase": "kernels", "layer": layer, "shape": shape,
          "configs": n, "chosen_config": {
              k: ops.bank_config(shape[0], shape[1], shape[3], kernel=k)
              for k in chosen},
          "bitwise_equal_across_configs": equal})
    if not all(equal.values()):
        raise AssertionError(f"bank configurations disagree at {shape}: "
                             f"{equal}")


def phase_kernels(dev):
    """Each kernel against its plain version; returns max abs errors at the
    search path's shapes (scan: SCAN_SHAPE; MxVs: FC) and ``quant_matmul``
    at the LM head."""
    import torch
    from repro_torch.kernels import ops, ref
    out = {}
    out.update(check_scan(SCAN_SHAPE, "search", dev))
    check_scan((3, 5, 7, 13), "ragged", dev)
    for shape in SERVE_SCAN_SHAPES:
        check_scan(shape, "serving", dev)
    for name, shape in MXV_SHAPES.items():
        errs_ = check_banks(name, shape,
                            "ragged" if name == "ragged" else "search", dev)
        if name == "FC":
            out.update(errs_)
            check_bank_configs(name, shape, dev)
    for name, (_, _, m, N) in MXV_SHAPES.items():
        if name != "ragged":      # the serving step: a full chunk, a tail
            for lanes, rows in ((SERVE_LANES, SERVE_CHUNK), (4, SERVE_TAIL)):
                check_banks(name, (lanes, rows, m, N), "serving", dev)
    for label, shape in QMM_SHAPES.items():
        for bits in (8, 4, 2):
            x, packed, scales = qmm_inputs(shape, bits, 6 + bits, dev)
            got = ops.quant_matmul(x, packed, scales, bits)
            want = ref.quant_matmul_ref(x, packed, scales, bits)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
            a, r = errs(got, want)
            emit({"phase": "kernels", "kernel": "quant_matmul", "bits": bits,
                  "shape": shape, "max_abs_err": a, "max_rel_err": r,
                  "tol": "rtol 1e-4, atol 1e-3"})
            if label == "head" and bits == 8:
                out["quant_matmul"] = a
    return out


def phase_main_path(dev, work):
    """The search on the paper's model, trained on the card (and saved as
    a training checkpoint under ``work``), through the kernels."""
    import numpy as np
    import torch
    from repro_torch.configs.sru_timit import CONFIG
    from repro_torch.core import api
    from repro_torch.kernels import ops

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    target = train_target(dev)
    save_trained(target, dev, work / TRAINED_DIR)
    calls = []
    evaluate = target.val_error_batch

    def recording(allocs, params=None, **kw):
        calls.append((list(allocs), time.perf_counter()))
        out = evaluate(allocs, params, **kw)
        calls[-1] = (calls[-1][0], time.perf_counter() - calls[-1][1])
        return out

    target.val_error_batch = recording
    t0 = time.perf_counter()
    res = api.SearchSession(target, "silago",
                            ("error", "speedup", "energy")).run(
        generations=2, pop=10, initial=40, seed=0)
    t_search = time.perf_counter() - t0
    del target.val_error_batch
    rows = res.table()                     # test error: scalar forward
    front = [r["alloc"] for r in rows]
    packed_errs = target.val_error_batch(front, bank_format="packed")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    emit({"phase": "main_path", "model": CONFIG.name,
          "params": sum(CONFIG.layer_weight_counts().values()),
          "val_subsets": [list(f.shape) for f, _ in target.val_subsets],
          "baseline_val_error": target.baseline_val_error,
          "baseline_test_error": target.baseline_test_error,
          "generation_sizes": [len(a) for a, _ in calls],
          "generation_s": [round(s, 4) for _, s in calls],
          "search_s": round(t_search, 3),
          "n_evals": res.n_evals, "launches": counts})
    for r, pe in zip(rows, packed_errs):
        emit({"phase": "main_path", "front": {
            "alloc": {k: list(v) for k, v in r["alloc"].items()},
            "error": r["error"], "packed_error": pe,
            "test_error": r["test_error"], "speedup": r["speedup"],
            "energy": r["energy"], "compression": r["compression"]}})
    for name, n in counts.items():
        if n <= 0 and name != "quant_matmul":       # the LM head's kernel
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"search path ({counts})")
    for r in rows:
        if not np.isfinite([r["error"], r["test_error"]]).all():
            raise AssertionError(f"non-finite front row {r}")
    peak = torch.cuda.max_memory_allocated()

    # cross-checks on generation 0's allocations (after the counts are read)
    allocs0 = calls[0][0]
    cmp = compare_lanes(target, allocs0)
    lanes_s = {}
    for lane, kw in (("kernel", {}), ("plain", {"use_kernel": False})):
        target.val_error_batch(allocs0, **kw)         # banks built, warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        target.val_error_batch(allocs0, **kw)
        torch.cuda.synchronize()
        lanes_s[lane] = time.perf_counter() - t0
    emit({"phase": "main_path", "generation0_lanes": len(allocs0),
          "generation0_eval_s": lanes_s, **cmp,
          "max_memory_allocated": peak})
    return counts, target


def train_target(dev):
    """The search target: the paper's model trained on the card by
    ``train_small_sru`` (the reference's recipe: 400 steps of batch 8 x 48
    frames, lr 3e-3), then calibrated. Emits the loss every 50 steps, the
    median train step, the training seconds and the baseline errors; raises
    on a non-finite loss, a loss that does not fall (the last 50 steps'
    mean against the first 50's) or a baseline val error of 100 %."""
    import numpy as np
    import torch
    from repro_torch.configs.sru_timit import CONFIG
    from repro_torch.core import sru_experiment as X
    losses, stamps = [], []

    def log(step, loss):
        losses.append(float(loss))            # waits for the step
        stamps.append(time.perf_counter())

    t0 = time.perf_counter()
    target = X.train_small_sru(TRAIN_STEPS, cfg=CONFIG, device=dev, log=log)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    step_ms = np.diff([t0] + stamps) * 1e3
    first, last = np.mean(losses[:50]), np.mean(losses[-50:])
    emit({"phase": "main_path", "training": {
        "model": CONFIG.name, "steps": len(losses), "batch": 8, "seq": 48,
        "lr": 3e-3, "loss_every_50": {i + 1: losses[i] for i in
                                      range(49, len(losses), 50)},
        "first_50_mean": first, "last_50_mean": last,
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_range": [float(step_ms.min()), float(step_ms.max())],
        "train_s": stamps[-1] - t0, "train_and_calibrate_s": total_s,
        "baseline_val_error": target.baseline_val_error,
        "baseline_test_error": target.baseline_test_error}})
    if not np.isfinite(losses).all():
        raise AssertionError("training produced a non-finite loss")
    if not last < first:
        raise AssertionError(f"training loss did not fall: first 50 steps "
                             f"{first:.4f}, last 50 {last:.4f}")
    if not target.baseline_val_error < 100.0:
        raise AssertionError(f"the trained model's val error is "
                             f"{target.baseline_val_error} %")
    return target


def save_trained(target, dev, ckpt_dir):
    """The trained params saved by ``training.checkpoint.save`` and
    restored into a fresh template on the card: raises unless the restored
    tree's ``tree_digest`` and the target's ``target_fingerprint`` equal
    the trained ones. The resume phase's children start from this
    checkpoint."""
    import dataclasses
    import torch
    from repro_torch.core import checkpointing as ckpt
    from repro_torch.core import durable_io
    from repro_torch.models import sru
    from repro_torch.training import checkpoint as tc
    t0 = time.perf_counter()
    path = tc.save(str(ckpt_dir), TRAIN_STEPS, target.params, keep=1)
    save_s = time.perf_counter() - t0
    template = sru.init_params(torch.Generator().manual_seed(1), target.cfg,
                               device=dev)
    t0 = time.perf_counter()
    restored, step = tc.restore(str(ckpt_dir), template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    digest = durable_io.tree_digest(target.params)
    got = {"tree_digest": durable_io.tree_digest(restored),
           "target_fingerprint": ckpt.target_fingerprint(
               dataclasses.replace(target, params=restored))}
    want = {"tree_digest": digest,
            "target_fingerprint": ckpt.target_fingerprint(target)}
    on_card = all(t.is_cuda for t in durable_io.flatten_tree(
        restored).values())
    emit({"phase": "main_path", "training_checkpoint": {
        "step": step, "bytes": dir_bytes(Path(path)),
        "save_s": save_s, "restore_s": restore_s, "restored_on_card": on_card,
        "tree_digest": digest[:16],
        "target_fingerprint": want["target_fingerprint"][:16],
        "equal": got == want}})
    if got != want or not on_card:
        raise AssertionError(f"the restored training checkpoint differs: "
                             f"{got} != {want} (on the card: {on_card})")


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def best_within(rows, baseline, budget):
    """The best speedup on a front within ``budget`` pp of the baseline
    error (``examples/mohaq_search_sru.py``), None where no row is."""
    ok = [r["speedup"] for r in rows if r["error"] <= baseline + budget]
    return max(ok) if ok else None


def front_rows(rows):
    return [{"alloc": {k: list(v) for k, v in r["alloc"].items()},
             "error": r["error"], "test_error": r["test_error"],
             "speedup": r["speedup"]} for r in rows]


def phase_beacon_search(dev, target, work):
    """The paper's experiment 3 on the trained target: Bitfusion, (error,
    speedup), the small-SRAM bound, inference-only and then beacon-based
    (Algorithm 1, 60 retraining steps a beacon), checkpointed into a
    ``SearchStore`` under ``work``. Every beacon's generations are scored
    through the kernels; one beacon's params are held to the plain lane
    and the packed banks (``compare_lanes``). Returns the phase's launch
    counts and the beacon run (``BeaconRun``) the resume phase repeats."""
    import numpy as np
    import torch
    from repro_torch.core import api
    from repro_torch.kernels import ops
    from repro_torch.training.optimizer import tree_leaves

    sram = beacon_sram(target)
    # share_memo=False: the inference-only run scores every candidate
    # instead of reusing the silago search's errors, so its time stands
    # beside the beacon run's (which starts a memo of its own anyway)
    sess = api.SearchSession(target, "bitfusion", ("error", "speedup"),
                             sram_override=sram, share_memo=False)
    kw = dict(SEARCH_KW)
    retrain_s, scored = [], []
    retrainer, evaluate = target.beacon_retrainer, target.val_error_batch

    def timed_retrainer(steps, **skw):
        fn = retrainer(steps, **skw)

        def retrain(alloc, base):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(alloc, base)
            torch.cuda.synchronize()
            retrain_s.append(time.perf_counter() - t)
            return out
        return retrain

    def recording(allocs, params=None, **ekw):
        scored.extend(a for a in allocs if a not in scored)
        return evaluate(allocs, params, **ekw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    inference = sess.run(**kw)
    torch.cuda.synchronize()
    inference_s = time.perf_counter() - t0
    target.beacon_retrainer, target.val_error_batch = (timed_retrainer,
                                                       recording)
    store = work / STORE_DIR
    try:
        t0 = time.perf_counter()
        beacon = sess.run(beacons=True, retrain_steps=BEACON_STEPS,
                          checkpoint_dir=str(store), **kw)
        torch.cuda.synchronize()
        beacon_s = time.perf_counter() - t0
    finally:
        del target.beacon_retrainer, target.val_error_batch
    bs = beacon.beacon_search
    beacons = [{"alloc": {k: list(v) for k, v in b.alloc.items()},
                "retrain_s": s,
                "error_base_params": target.val_error(b.alloc),
                "error_beacon_params": target.val_error(b.alloc,
                                                        params=b.params)}
               for b, s in zip(bs.beacons, retrain_s)]
    rows_inf, rows_b = inference.table(), beacon.table()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    base = target.baseline_val_error
    emit({"phase": "beacon_search", "platform": "bitfusion",
          "sram_bytes": sram, "retrain_steps": BEACON_STEPS,
          "n_retrains": bs.n_retrains, "beacons": beacons,
          "inference_only_s": inference_s, "beacon_s": beacon_s,
          "n_evals": {"inference_only": inference.n_evals,
                      "beacon": beacon.n_evals},
          "front_inference_only": front_rows(rows_inf),
          "front_beacon": front_rows(rows_b),
          "best_speedup_within_pp": {
              budget: {"inference_only": best_within(rows_inf, base, budget),
                       "beacon": best_within(rows_b, base, budget)}
              for budget in (2, 4, 8)},
          "launches": counts,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    emit({"phase": "beacon_search", "checkpoint_stats":
          beacon.checkpoint_stats, "store_bytes": dir_bytes(store),
          "store_files": sum(1 for f in store.rglob("*") if f.is_file())})
    if bs.n_retrains < 1:
        raise AssertionError("the beacon search retrained no beacon")
    for name in ("sru_scan_pop", "bank_mxv_pop", "sru_scan"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched in the beacon "
                                 f"search ({counts})")
    values = ([r["error"] for r in rows_inf + rows_b]
              + [r["test_error"] for r in rows_inf + rows_b]
              + [b[k] for b in beacons
                 for k in ("error_base_params", "error_beacon_params")])
    if not np.isfinite(values).all():
        raise AssertionError(f"non-finite beacon-search results {values}")
    for b in bs.beacons:
        for leaf in tree_leaves(b.params):
            if not torch.isfinite(leaf).all():
                raise AssertionError("a beacon has non-finite params")

    # every allocation the beacon search scored, under the first beacon's
    # params (after the counts are read)
    cmp = compare_lanes(target, scored, params=bs.beacons[0].params,
                        phase="beacon_search")
    emit({"phase": "beacon_search", "lanes_on_beacon": 0,
          "allocations": len(scored), **cmp})
    return counts, BeaconRun(store=store, sram=sram, seconds=beacon_s,
                             summary=run_summary(beacon),
                             front=[r["alloc"] for r in rows_b])


def beacon_sram(target) -> int:
    """The small-SRAM bound of the beacon search (paper experiment 3)."""
    mat = sum(target.layer_weights.values())
    return int((mat * 3.5 + target.vector_weights * 16) / 8)


def beacon_settings():
    """The ``SETTINGS.json`` of the beacon search's store
    (``SearchSession.run``'s run settings)."""
    return {"generations": SEARCH_KW["generations"],
            "pop": SEARCH_KW["pop"], "initial": SEARCH_KW["initial"],
            "objectives": ["error", "speedup"], "beacons": True,
            "retrain_steps": BEACON_STEPS, "distance_threshold": 6.0}


def run_summary(res) -> dict:
    """What a resumed beacon search must reproduce, in JSON form: the front
    (``front_key``), evaluations, retrains and each beacon's digest."""
    from repro_torch.core import durable_io
    bs = res.beacon_search
    return json.loads(json.dumps({
        "front_key": res.front_key(), "n_evals": res.n_evals,
        "n_retrains": bs.n_retrains,
        "beacon_digests": [durable_io.tree_digest(b.params)
                           for b in bs.beacons]}))


def configure_torch():
    """The port on the path and the parity flags set (TF32 and reduced
    bf16 reductions off), in this process and in the resume children."""
    import torch
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resume_child(spec: dict) -> int:
    """One process of the resume phase (``--resume-child SPEC``): restore
    the trained params from the training checkpoint, build the target on
    the card, and run the beacon search of ``beacon_search`` into
    ``spec["store"]`` (resuming it when ``spec["resume"]``). With
    ``spec["kill_after"]`` the process kills itself with SIGKILL right
    after ``SearchStore.save`` commits that generation. Prints one
    ``RESULT {...}`` line."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is present")
    configure_torch()
    from repro_torch.configs.sru_timit import CONFIG
    from repro_torch.core import api
    from repro_torch.core import checkpointing as ckpt
    from repro_torch.core import sru_experiment as X
    from repro_torch.kernels import ops
    from repro_torch.models import sru
    from repro_torch.training import checkpoint as tc
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    template = sru.init_params(torch.Generator().manual_seed(1), CONFIG,
                               device=dev)
    params, _ = tc.restore(spec["trained"], template)
    target = X.target_from_params(CONFIG, params, device=dev)
    fingerprint = ckpt.target_fingerprint(target)
    if fingerprint != spec["fingerprint"]:
        raise AssertionError(f"the restored target's fingerprint "
                             f"{fingerprint[:12]} is not the trained one's "
                             f"{spec['fingerprint'][:12]}")
    setup_s = time.perf_counter() - t0
    if spec["kill_after"] is not None:
        real_save = ckpt.SearchStore.save

        def save_then_die(self, key, settings, state, **kw):
            path = real_save(self, key, settings, state, **kw)
            if state.next_gen == spec["kill_after"]:
                os.kill(os.getpid(), signal.SIGKILL)
            return path
        ckpt.SearchStore.save = save_then_die
    retrain_s = []
    retrainer = target.beacon_retrainer

    def timed_retrainer(steps, **kw):
        fn = retrainer(steps, **kw)

        def retrain(alloc, base):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(alloc, base)
            torch.cuda.synchronize()
            retrain_s.append(time.perf_counter() - t)
            return out
        return retrain

    target.beacon_retrainer = timed_retrainer
    lines = []
    sess = api.SearchSession(target, "bitfusion", ("error", "speedup"),
                             sram_override=spec["sram"], share_memo=False)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = sess.run(beacons=True, retrain_steps=BEACON_STEPS,
                   checkpoint_dir=spec["store"], resume=spec["resume"],
                   log=lines.append, **SEARCH_KW)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "repro" or m.startswith("repro.")]
    if bad:
        raise AssertionError(f"imported the reference stack: {bad[:5]}")
    print("RESULT " + json.dumps({
        **run_summary(res), "setup_s": setup_s, "search_s": search_s,
        "retrain_s": retrain_s,
        "resumed": [ln for ln in lines if "resumed from checkpoint" in ln],
        "checkpoint_stats": res.checkpoint_stats, "launches": counts}),
        flush=True)
    return 0


def spawn_child(spec: dict):
    """Run ``resume_child`` in a fresh Python process; returns the
    completed process and its wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--resume-child",
         json.dumps(spec)], capture_output=True, text=True,
        timeout=CHILD_TIMEOUT_S, cwd=str(REPO))
    return proc, time.perf_counter() - t0


def child_result(proc) -> dict:
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"resume child failed (rc {proc.returncode}):"
                             f"\n{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def phase_resume(target, work, run: BeaconRun):
    """Crash and resume of the beacon search on the card, in two child
    processes that each restore the trained params from the training
    checkpoint: the first runs ``run``'s search into a fresh store and
    SIGKILLs itself right after generation K is committed (K: the first
    generation whose checkpoint in ``run``'s store holds a retrain); the
    second resumes that store. Fails unless the first died by SIGKILL with
    a retrain on disk, the resumed run equals ``run`` in front, evaluations,
    retrains and beacon digests, and it ran only the retrains the store did
    not hold. Then ``front_from_store`` on ``run``'s store gives ``run``'s
    front, which ``pack_deployment``/``load_deployment`` round-trip with
    equal digests. Returns the children's launch counts."""
    from repro_torch.core import checkpointing as ckpt
    from repro_torch.core import durable_io
    from repro_torch.core.hardware import get_platform
    from repro_torch.kernels import ops
    from repro_torch.serving import convert, load_deployment

    key = ckpt.search_key(target, get_platform("bitfusion"),
                          SEARCH_KW["seed"], sram_bytes=run.sram)
    settings = beacon_settings()
    store = ckpt.SearchStore(str(run.store))
    on_disk = {}
    for g in store.generations(key, settings):
        path = Path(store.dir_for(key, settings)) / store._FMT.format(g)
        state, _ = ckpt.deserialize_state(
            durable_io.read_checksummed(str(path)), target.params)
        on_disk[g] = state.n_retrains
    total = run.summary["n_retrains"]
    if on_disk.get(SEARCH_KW["generations"]) != total:
        raise AssertionError(f"the uninterrupted store's retrains per "
                             f"generation {on_disk} end below {total}")
    # the first generation with a retrain on disk, before the last one;
    # one that leaves retrains to run after the kill where there is one
    held = [g for g in sorted(on_disk)
            if g < SEARCH_KW["generations"] and on_disk[g] >= 1]
    if not held:
        raise AssertionError(f"no generation before the last holds a "
                             f"retrain: {on_disk}")
    kill_after = next((g for g in held if on_disk[g] < total), held[0])

    killed_store = work / "killed_store"
    spec = {"trained": str(work / TRAINED_DIR), "store": str(killed_store),
            "sram": run.sram, "fingerprint": ckpt.target_fingerprint(target),
            "resume": False, "kill_after": kill_after}
    killed, killed_s = spawn_child(spec)
    if killed.returncode != -signal.SIGKILL:
        raise AssertionError(f"the first child was to die by SIGKILL, rc "
                             f"{killed.returncode}:\n{killed.stderr[-3000:]}")
    if any(ln.startswith("RESULT ") for ln in killed.stdout.splitlines()):
        raise AssertionError("the killed child printed a result")
    mid = ckpt.SearchStore(str(killed_store)).load_latest(
        key, settings, params_template=target.params)
    if mid is None or mid.next_gen != kill_after or mid.n_retrains < 1:
        raise AssertionError(f"the killed child's store holds generation "
                             f"{getattr(mid, 'next_gen', None)} with "
                             f"{getattr(mid, 'n_retrains', None)} retrains "
                             f"(expected {kill_after}, >= 1)")
    if mid.beacon_digests != run.summary["beacon_digests"][:mid.n_retrains]:
        raise AssertionError("the killed child's stored beacons differ from "
                             "the uninterrupted run's")

    resumed, resumed_s = spawn_child({**spec, "resume": True,
                                      "kill_after": None})
    got = child_result(resumed)
    counts = {k: got["launches"].get(k, 0) for k in ops.launch_counts()}
    want = run.summary
    same = {k: got[k] == want[k] for k in want}
    retrains_after = len(got["retrain_s"])
    emit({"phase": "resume", "kill_after_generation": kill_after,
          "retrains_per_generation_uninterrupted": on_disk,
          "retrains_restored_from_disk": mid.n_retrains,
          "retrains_run_after_kill": retrains_after,
          "retrain_s_after_kill": got["retrain_s"],
          "killed_child": {"rc": killed.returncode, "wall_s": killed_s,
                           "store_bytes": dir_bytes(killed_store)},
          "resumed_child": {"wall_s": resumed_s, "setup_s": got["setup_s"],
                            "search_s": got["search_s"],
                            "log": got["resumed"],
                            "checkpoint_stats": got["checkpoint_stats"]},
          "uninterrupted_search_s": run.seconds,
          "equal_to_uninterrupted": same, "n_evals": got["n_evals"],
          "n_retrains": got["n_retrains"], "launches": counts})
    if not all(same.values()):
        raise AssertionError(f"the resumed run differs from the "
                             f"uninterrupted one: {same}")
    if not got["resumed"]:
        raise AssertionError("the second child did not resume")
    if retrains_after != want["n_retrains"] - mid.n_retrains:
        raise AssertionError(f"the resumed child ran {retrains_after} "
                             f"retrains; the store held {mid.n_retrains} "
                             f"of {want['n_retrains']}")

    # the uninterrupted store's front, packed and loaded back
    allocs, rows = convert.front_from_store(str(run.store), target)

    def keyed(front):
        return sorted({tuple(sorted((n, tuple(v)) for n, v in a.items()))
                       for a in front})

    t0 = time.perf_counter()
    manifest = convert.pack_deployment(target, allocs, str(work / "artifact"),
                                       objectives=rows)
    loaded, banks, extras = load_deployment(str(work / "artifact"))
    pack_s = time.perf_counter() - t0
    digest = durable_io.tree_digest({"banks": banks, "extras": extras})
    emit({"phase": "resume", "front_from_store": {
        "allocations": len(allocs), "equal_to_run_front":
            keyed(allocs) == keyed(run.front),
        "objectives": rows, "pack_and_load_s": pack_s,
        "tree_digest": manifest["tree_digest"][:16],
        "digest_equal": digest == manifest["tree_digest"]}})
    if keyed(allocs) != keyed(run.front):
        raise AssertionError(f"front_from_store gave {keyed(allocs)}, the "
                             f"run's front is {keyed(run.front)}")
    if digest != manifest["tree_digest"] or \
            keyed(loaded["allocs"]) != keyed(allocs):
        raise AssertionError("the packed front does not round-trip")
    return counts


def compare_lanes(target, allocs, params=None, phase="main_path"):
    """Kernel lane vs plain lane (both f32 banks), and f32 vs packed banks
    (both kernel lane), on the same allocations under ``params`` (default:
    the target's): argmax agreement over all frames, per-lane error % and
    the top-2 logit margin of every frame whose argmax differs (a margin of
    0 is an exact tie)."""
    import torch
    from repro_torch.models import sru
    params = target.params if params is None else params

    def logits(**kw):
        ev = target.batched_evaluator(True, kw.get("bank_format", "f32"),
                                      kw.get("use_kernel"))
        banks = ev._banks_for(params)
        stack = ev._stack(allocs)[:len(allocs)]
        return sru.forward_population(params, target.cfg,
                                      ev._feats_all, stack, banks=banks,
                                      use_kernel=ev.use_kernel), ev

    labels = torch.cat([l for _, l in target.val_subsets])
    result = {}
    base, ev = logits()
    P = len(allocs)

    def err(pred):
        wrong = (pred != labels[None]).reshape(P, ev._n_subsets, -1)
        return (100.0 * wrong.sum(-1).double() / wrong.shape[-1]
                ).max(-1).values

    result["lane_error_pct"] = err(base.argmax(-1)).tolist()
    for name, kw in (("kernel_vs_plain", {"use_kernel": False}),
                     ("f32_vs_packed", {"bank_format": "packed"})):
        other, _ = logits(**kw)
        a, b = base.argmax(-1), other.argmax(-1)
        differ = a != b
        top2 = torch.topk(other, 2, dim=-1).values
        margins = (top2[..., 0] - top2[..., 1])[differ]
        d_err = (err(a) - err(b)).abs()
        agree = 1.0 - float(differ.double().mean())
        result[name] = {
            "frames": int(differ.numel()), "frames_differ": int(differ.sum()),
            "argmax_agreement": agree,
            "lanes_with_error_change": int((d_err > 0).sum()),
            "max_abs_error_pp": float(d_err.max()),
            "differing_frame_margins": sorted(margins.tolist())[:20],
            "max_abs_logit_diff": float((base - other).abs().max())}
        if agree < 0.999 or float(d_err.max()) > 0.1:
            emit({"phase": phase, name: result[name]})
            raise AssertionError(f"{name}: argmax agreement {agree:.5f} "
                                 f"(need >= 0.999) or error change "
                                 f"{float(d_err.max()):.3f} pp (need <= 0.1)")
    return result


def phase_lm_serve(dev):
    """Greedy decode of stablelm-1.6b at full width with the int8 head on
    ``quant_matmul``; returns the path's launch counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import lm

    cfg = get_config("stablelm-1.6b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_lm(0, cfg, dev)
    head = lm.int8_head(params, cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=g, device=dev)
    checks = []                  # per head run: (differing rows, margins)
    hiddens = []

    def checked_head(hidden):
        """The kernel head, and the plain head on the same hidden state."""
        y = head(hidden)
        h2 = hidden.reshape(-1, hidden.shape[-1]).to(torch.float32)
        plain = ref.quant_matmul_ref(h2, head.packed, head.scales, head.bits)
        differ = y.reshape(plain.shape).argmax(-1) != plain.argmax(-1)
        top2 = torch.topk(plain, 2, dim=-1).values
        checks.append((int(differ.sum()),
                       (top2[:, 0] - top2[:, 1])[differ].tolist()))
        hiddens.append(h2)
        return y

    ops.reset_launch_counts()
    quant = lm.decode_loop(params, cfg, tokens, LM_GEN, head_fn=checked_head)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    emit({"phase": "lm_serve", "model": cfg.name, "params": cfg.n_params(),
          "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
          "head_runs": len(checks), "launches": counts,
          "int8_head_bytes": head.nbytes, "setup_s": round(setup_s, 3)})
    if counts["quant_matmul"] != LM_GEN + 1:
        raise AssertionError(f"quant_matmul launched {counts['quant_matmul']}"
                             f" times, expected one per head run "
                             f"({LM_GEN + 1})")
    margins = [m for _, ms in checks for m in ms]
    if any(m > 1e-3 for m in margins):
        raise AssertionError(f"kernel and plain int8 heads pick different "
                             f"tokens at top-2 margins {sorted(margins)}")

    # timing, the dense head and the int4 head (after the counts are read)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = tfm.prefill(params, cfg, tokens,
                                max_len=LM_PROMPT + LM_GEN, head_fn=head)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    t0 = time.perf_counter()
    for _ in range(LM_GEN):
        logits, cache = tfm.decode_step(params, cfg, cache, nxt, head_fn=head)
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / LM_GEN * 1e3
    dense = lm.decode_loop(params, cfg, tokens, LM_GEN)
    head4 = lm.quant_head(params, cfg, 4, sampled_clip(
        tfm.logits_head_weight(params, cfg), 4))
    h = torch.cat(hiddens)
    w = tfm.logits_head_weight(params, cfg).to(torch.float32)
    exact = h @ w
    int4_agree = float((head4(h).argmax(-1) == exact.argmax(-1))
                       .double().mean())
    int8_agree = float((head(h).argmax(-1) == exact.argmax(-1))
                       .double().mean())
    emit({"phase": "lm_serve", "kernel_vs_plain_head": {
        "positions": LM_BATCH * len(checks),
        "positions_differ": sum(n for n, _ in checks),
        "differing_margins": sorted(margins)},
        "int8_vs_dense_bf16_token_agreement": float(
            (quant == dense).double().mean()),
        "head_argmax_agreement_vs_f32_head": {"int8": int8_agree,
                                              "int4": int4_agree},
        "prefill_s": prefill_s, "decode_ms_per_token": decode_ms,
        "max_memory_allocated": torch.cuda.max_memory_allocated()})
    del params, cache, exact, w
    torch.cuda.empty_cache()
    return counts


@contextlib.contextmanager
def recording_act_quant(runs):
    """While open, every activation fake-quantization (activations quantize
    through the STE, weights without it) appends its input and grid
    (x, scale, lo, hi) to ``runs[-1]["acts"]``."""
    from repro_torch.core import quantization as Q
    fq = Q.fake_quant_triple

    def rec(x, scale, lo, hi, use_ste=True):
        if use_ste:
            runs[-1]["acts"].append((x, scale, lo, hi))
        return fq(x, scale, lo, hi, use_ste)

    Q.fake_quant_triple = rec
    try:
        yield
    finally:
        Q.fake_quant_triple = fq


@contextlib.contextmanager
def scalar_mxv_on_matmul():
    """The scalar ``forward(qp=)`` with its MxVs on ``torch.matmul``
    (cuBLAS) in place of ``bank_mxv_pop`` with P = 1."""
    import torch
    from repro_torch.models import sru
    mxv = sru._mxv
    sru._mxv = torch.matmul
    try:
        yield
    finally:
        sru._mxv = mxv


def act_names(cfg):
    """The model's activation quantizations in the order a forward runs
    them: L0, Pr1, L1, ..., FC."""
    names = []
    for i in range(cfg.n_sru_layers):
        names += [f"L{i}"] + ([f"Pr{i + 1}"] if i < cfg.n_sru_layers - 1
                              else [])
    return names + ["FC"]


def grid_codes(x, scale, lo, hi):
    """The grid index ``clip(round(x / scale), lo, hi)`` that the quantizer
    gives ``x`` (its STE output can differ from index * scale in the last
    bit where it clips), and ``x / scale``; grids are scalars or one per
    lane."""
    import torch
    f32 = [torch.as_tensor(v, dtype=torch.float32, device=x.device)
           for v in (scale, lo, hi)]
    t = x / f32[0]
    return torch.clamp(torch.round(t), f32[1], f32[2]), t


def compare_by_ties(runs_a, runs_b, names, rtol=1e-4, atol=1e-3):
    """Two computations of the same forwards, lane by lane, from their
    records (``recording_act_quant``; ``logits`` (lanes, T, classes)).

    A lane whose activations take the same grid codes at every layer must
    give logits within the tolerance. Otherwise take the first layer where
    a code differs: its inputs must agree within the tolerance (upstream
    both sides had the same codes, so only summation orders differ), and
    every differing code must be one step apart, from inputs that lie on the
    two sides of one rounding midpoint and within 1e-3 of a step of each
    other: a tie that the two summation orders break differently. From there
    on the lane's values may differ by whole grid steps, so its logits are
    not held to the tolerance. Raises on any other difference; returns
    counts and the worst readings (in grid steps)."""
    import torch
    st = {"lanes": 0, "lanes_bitwise": 0, "lanes_tie": 0, "tie_codes": 0,
          "tie_layers": {}, "max_input_gap_steps": 0.0,
          "max_midpoint_dist_steps": 0.0, "logits": 0,
          "logits_out_of_tol": 0, "max_abs_logit_diff": 0.0}
    for ra, rb in zip(runs_a, runs_b, strict=True):
        la = torch.as_tensor(ra["logits"]).cpu()
        lb = torch.as_tensor(rb["logits"]).cpu()
        codes = [(grid_codes(*a), grid_codes(*b))
                 for a, b in zip(ra["acts"], rb["acts"], strict=True)]
        differs = torch.stack([(ka != kb).flatten(1).any(1)
                               for (ka, _), (kb, _) in codes]).cpu()
        for p in range(la.shape[0]):
            out_tol = ~torch.isclose(la[p], lb[p], rtol=rtol, atol=atol)
            st["lanes"] += 1
            st["logits"] += out_tol.numel()
            st["logits_out_of_tol"] += int(out_tol.sum())
            st["max_abs_logit_diff"] = max(st["max_abs_logit_diff"], float(
                (la[p] - lb[p]).abs().max()))
            hit = differs[:, p].nonzero()
            if len(hit) == 0:
                if out_tol.any():
                    raise AssertionError(
                        f"{int(out_tol.sum())} logits outside rtol {rtol} / "
                        f"atol {atol} with equal activation codes")
                st["lanes_bitwise"] += int(torch.equal(la[p], lb[p]))
                continue
            j = int(hit[0])
            torch.testing.assert_close(ra["acts"][j][0][p],
                                       rb["acts"][j][0][p],
                                       rtol=rtol, atol=atol)
            (ka, ta), (kb, tb) = codes[j]
            d = ka[p] != kb[p]
            ka, kb = ka[p][d].double(), kb[p][d].double()
            ta, tb = ta[p][d].double(), tb[p][d].double()
            mid = (ka + kb) / 2
            reading = {
                "layer": names[j], "codes": int(d.sum()),
                "one_step": bool(((ka - kb).abs() == 1).all()),
                "straddle": bool(((ta - mid) * (tb - mid) <= 0).all()),
                "input_gap_steps": float((ta - tb).abs().max()),
                "midpoint_dist_steps": float(torch.maximum(
                    (ta - mid).abs(), (tb - mid).abs()).max())}
            if not (reading["one_step"] and reading["straddle"]
                    and reading["input_gap_steps"] <= 1e-3):
                raise AssertionError(f"an activation code differs by more "
                                     f"than a tie: {reading}")
            st["lanes_tie"] += 1
            st["tie_codes"] += reading["codes"]
            st["tie_layers"][names[j]] = st["tie_layers"].get(names[j], 0) + 1
            for k in ("input_gap_steps", "midpoint_dist_steps"):
                st["max_" + k] = max(st["max_" + k], reading[k])
    return st


def argmax_agreement(pairs):
    """The share of frames whose argmax agrees, over (logits, logits)
    pairs."""
    import numpy as np
    agree = frames = 0
    for a, b in pairs:
        am = np.asarray(a).argmax(-1)
        agree += int((am == np.asarray(b).argmax(-1)).sum())
        frames += am.size
    return agree / frames


def phase_front_serve(dev, target):
    """The Pareto-front server on the paper's SRU; returns the path's
    launch counts."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch import serving as S
    from repro_torch.kernels import ops
    from repro_torch.models import sru

    names = list(target.layer_names)
    presets = [{n: (b, 8) for n in names} for b in (2, 4, 8, 16)]
    # stand-in objective rows (the untrained model scores 100 % everywhere)
    objectives = [{"error": e} for e in (12.0, 7.0, 3.0, 1.0)]
    (REPO / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=REPO / "build") as d:
        manifest = S.pack_deployment(target, presets, d,
                                     objectives=objectives)
        art = S.DeploymentArtifact.load(d)
    pack_s = time.perf_counter() - t0
    engine = S.ServingEngine(art, device=dev)
    plain = S.ServingEngine(art, device=dev, use_kernel=False)
    rng = np.random.default_rng(0)
    sizes = [64, 160] + rng.integers(64, 161, 10).tolist()
    reqs = [S.Request(rid=i, slo=SLOS[i % 3],
                      feats=rng.normal(size=(n, art.cfg.input_dim))
                      .astype(np.float32)) for i, n in enumerate(sizes)]

    def serve(eng, kind="ContinuousBatcher"):
        bat = getattr(S, kind)(eng, S.Router(art), max_lanes=SERVE_LANES,
                               chunk=SERVE_CHUNK, collect=True)
        for r in reqs:
            bat.submit(r)
        return bat, bat.run_until_idle()

    def traced_serve(eng):
        """Serve the requests again, keeping each dispatch's record."""
        runs, step = [], eng.step

        def recorded_step(feats, qp):
            runs.append({"acts": []})
            runs[-1]["logits"] = step(feats, qp)
            return runs[-1]["logits"]

        eng.step = recorded_step
        try:
            with recording_act_quant(runs):
                bat, _ = serve(eng)
        finally:
            del eng.step
        return bat, runs

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    cont, log = serve(engine)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    summary = log.summary()
    ser, slog = serve(engine, "SerialGroupBatcher")

    # every request's chunks through the scalar forward(qp=), as it runs and
    # with its MxVs on torch.matmul, and the traffic again on both lanes
    chunks = [(r.rid, s, torch.from_numpy(r.feats[s:s + SERVE_CHUNK])
               .to(dev)[None], target.qp_for(presets[log.requests[r.rid]
                                                     .alloc]))
              for r in reqs for s in range(0, len(r.feats), SERVE_CHUNK)]

    def traced_scalar():
        runs = []
        with recording_act_quant(runs):
            for _, _, feats, qp in chunks:
                runs.append({"acts": []})
                runs[-1]["logits"] = sru.forward(target.params, target.cfg,
                                                 feats, qp=qp)
        return runs

    scalar = traced_scalar()
    with scalar_mxv_on_matmul():
        scalar_mm = traced_scalar()
    kern_bat, kern_runs = traced_serve(engine)
    plain_bat, plain_runs = traced_serve(plain)

    frames = chunks_eq = 0
    worst = 0.0
    for (rid, s, _, _), run in zip(chunks, scalar):
        want = run["logits"][0].cpu().numpy()
        part = cont.results[rid][s:s + SERVE_CHUNK]
        np.testing.assert_allclose(part, want, rtol=1e-4, atol=1e-3)
        worst = max(worst, float(np.abs(part - want).max()))
        frames += part.shape[0]
        chunks_eq += int(np.array_equal(part, want))
    vs_scalar = {"frames": frames, "argmax_agreement": argmax_agreement(
        (cont.results[rid][s:s + SERVE_CHUNK], run["logits"][0].cpu())
        for (rid, s, _, _), run in zip(chunks, scalar)),
        "max_abs_diff": worst, "chunks_bitwise_equal": chunks_eq / len(chunks)}
    layer_order = act_names(target.cfg)
    vs_plain = compare_by_ties(kern_runs, plain_runs, layer_order)
    vs_plain["argmax_agreement"] = argmax_agreement(
        (kern_bat.results[r.rid], plain_bat.results[r.rid]) for r in reqs)
    mm = compare_by_ties(scalar, scalar_mm, layer_order)
    mm["argmax_agreement"] = argmax_agreement(
        (a["logits"][0].cpu(), b["logits"][0].cpu())
        for a, b in zip(scalar, scalar_mm))
    reruns_equal = all(
        np.array_equal(cont.results[r.rid], ser.results[r.rid])
        and np.array_equal(cont.results[r.rid], kern_bat.results[r.rid])
        for r in reqs)
    emit({"phase": "front_serve", "model": target.cfg.name,
          "allocs": len(presets), "pack_s": round(pack_s, 3),
          "bytes": manifest["bytes"], "requests": len(reqs),
          "frames": sum(sizes), "completed": summary["n_completed"],
          "frames_per_s": summary["tokens_per_s"],
          "dispatches": sum(s.n_dispatches for s in log.steps),
          "serial_dispatches": sum(s.n_dispatches for s in slog.steps),
          "steps": len(log.steps), "launches": counts,
          "by_slo": summary["by_slo"],
          "served_vs_scalar": vs_scalar,
          "kernel_vs_plain_lane": vs_plain,
          "scalar_matmul_vs_scalar": mm,
          "serial_and_rerun_logits_bitwise_equal": reruns_equal})
    if summary["n_completed"] != len(reqs) or frames != sum(sizes):
        raise AssertionError(f"served {summary['n_completed']} of "
                             f"{len(reqs)} requests, {frames} frames")
    for what, agree in (("served vs scalar", vs_scalar["argmax_agreement"]),
                        ("kernel vs plain lane",
                         vs_plain["argmax_agreement"])):
        if agree < 0.999:
            raise AssertionError(f"{what} argmax agreement {agree:.5f} "
                                 f"< 0.999")
    for name in ("bank_qmm_pop", "sru_scan_pop"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched by the server "
                                 f"({counts})")
    return counts


# ------------------------------------------------------------------ xLSTM

def train_xlstm(dev, cfg):
    """The xLSTM search target: ``cfg`` trained on the card by
    ``train_small_xlstm`` (``XLSTM_TRAIN``: 240 steps of 4,096 x 3 bigram
    tokens, two labelled frames a row, at a constant lr 1e-3 with TF32
    products), calibrated on ``XLSTM_VAL``'s validation tokens (4 x 64, TF32
    off). Emits the loss at ten points, the median step, the seconds and
    the baseline errors; raises on a non-finite loss or a baseline val
    error not below ``XLSTM_BASELINE_BAR`` (an untrained model scores
    ~100 %, and every candidate with it)."""
    import numpy as np
    import torch
    from repro_torch.core import xlstm_target as XT
    losses, stamps = [], []

    def log(step, loss):
        losses.append(float(loss))            # waits for the step
        stamps.append(time.perf_counter())

    t0 = time.perf_counter()
    target = XT.train_small_xlstm(cfg=cfg, device=dev, log=log,
                                  **XLSTM_TRAIN, **XLSTM_VAL)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    step_ms = np.diff([t0] + stamps) * 1e3
    every = max(1, len(losses) // 10)
    emit({"phase": "xlstm_search", "training": {
        "model": cfg.name, **XLSTM_TRAIN, "n_noise": XT.N_NOISE,
        "loss_every": {i + 1: losses[i] for i in
                       range(every - 1, len(losses), every)},
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_range": [float(step_ms.min()), float(step_ms.max())],
        "train_s": stamps[-1] - t0, "train_and_calibrate_s": total_s,
        "baseline_val_error": target.baseline_val_error,
        "baseline_test_error": target.baseline_test_error,
        "max_memory_allocated": torch.cuda.max_memory_allocated()}})
    if not np.isfinite(losses).all():
        raise AssertionError("xLSTM training produced a non-finite loss")
    if not target.baseline_val_error < XLSTM_BASELINE_BAR:
        raise AssertionError(f"the trained xLSTM's baseline val error "
                             f"{target.baseline_val_error} % is not below "
                             f"{XLSTM_BASELINE_BAR} %")
    return target


@contextlib.contextmanager
def checking_bank_mxvs(banks, out):
    """While open, every ``bank_mxv_pop`` call is held to its plain version
    on the same inputs (rtol 1e-4 / atol 1e-3): the path's own
    activations, every leaf's bank and the lanes' menu indices, the
    sLSTM's recurrent MxV at every time step included. ``out`` maps
    ``"{layer}.{leaf}"`` to the largest abs error of that leaf's calls; a
    call is told to its leaf by its bank's storage (the recurrent bank is
    a view of ``banks[layer]["r"]``)."""
    import torch
    from repro_torch.kernels import ops, ref
    owner = {b.data_ptr(): f"{name}.{key}" for name, layer in banks.items()
             for key, b in layer.items()}
    assert len(owner) == sum(len(layer) for layer in banks.values())
    real = ops.bank_mxv_pop

    def check(x, bank, idx):
        got = real(x, bank, idx)
        want = ref.bank_mxv_pop_ref(x, bank, idx)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
        leaf = owner[bank.data_ptr()]
        out[leaf] = max(out.get(leaf, 0.0), errs(got, want)[0])
        return got

    # the wrapper counts through its module-level name, so the stand-in
    # holds the count while it stands in; its launches are not added back
    # (a comparison's launches do not count)
    check.launches = real.launches
    ops.bank_mxv_pop = check
    try:
        yield
    finally:
        ops.bank_mxv_pop = real


@contextlib.contextmanager
def float64_plain_mxvs():
    """While open, the plain lane's MxV (``ref.bank_mxv_pop_ref``) sums in
    float64 and rounds once to float32: a third summation order, nearer the
    exact sum than either float32 lane."""
    import torch
    from repro_torch.kernels import ref
    plain = ref.bank_mxv_pop_ref

    def f64(x, bank, idx):
        return torch.bmm(x.double(),
                         bank.index_select(0, idx.long()).double()).float()

    ref.bank_mxv_pop_ref = f64
    try:
        yield
    finally:
        ref.bank_mxv_pop_ref = plain


def compare_xlstm_lanes(target, allocs):
    """The kernel lane against the plain lane (both on the same f32 banks)
    on ``allocs``, ``XLSTM_LANES`` lanes at a time, with the block inputs
    of both recorded. Per lane: the error % of each lane, whether its block
    inputs stayed bitwise equal (then its logits must agree within rtol
    1e-4 / atol 1e-3: only the head's f32 MxV differs) or the first layer
    where they differ and by how much there, relative to that input's
    largest |value|. Upstream of it both lanes fed bitwise-equal inputs to
    products that differ only in summation order (each MxV is held to its
    plain version on the path's inputs), and a bf16 cast of the two sums
    can fall one step apart; the untrained model turns a step that small
    into different logits (PERF.md), so a lane is not held to the
    tolerance after its first divergence, but there its inputs must agree
    within one bf16 step of the input's largest |value| (2^-7 of it).
    Every frame whose argmax differs must have a plain top-2 margin below
    its lane's logit gap. A witness lane, the plain lane with every MxV
    summed in float64 (``float64_plain_mxvs``), is scored against the
    plain lane the same way (``float64_vs_plain``): how far a third
    summation order, and no kernel, moves the errors.
    Also every MxV call of the first chunk's kernel lane against its plain
    version on the same inputs (``checking_bank_mxvs``) and the lane flip: a changed allocation in lane 0
    moves no other lane's logits. Returns the readings."""
    import torch
    from repro_torch.core import xlstm_target as XT
    ev = target.batched_evaluator()
    banks = ev._banks_for(target.params)
    toks, labels = ev._feats_all, ev._labels_all
    names = target.layer_names
    path = {}
    st = {"lanes": 0, "lanes_inputs_equal": 0, "lanes_logits_close": 0,
          "first_divergence_layers": {}, "max_first_divergence_rel": 0.0,
          "frames": 0, "frames_differ": 0, "differing_frame_margins": [],
          "max_lane_gap": 0.0, "differing_frames_at_margin_0": 0,
          "max_differing_margin": 0.0,
          "error_pct": {"kernel": [], "plain": [], "float64": []},
          "float64_frames_differ": 0}

    def err(pred):
        wrong = (pred != labels[None]).reshape(pred.shape[0],
                                              ev._n_subsets, -1)
        return (100.0 * wrong.sum(-1).double() / wrong.shape[-1]
                ).max(-1).values.tolist()

    for c in range(0, len(allocs), XLSTM_LANES):
        chunk = allocs[c:c + XLSTM_LANES]
        stack = ev._stack(chunk)[:len(chunk)]
        runs = {}
        for lane, uk in (("kernel", True), ("plain", False)):
            runs[lane] = [{"acts": []}]
            with contextlib.ExitStack() as hooks:
                hooks.enter_context(recording_act_quant(runs[lane]))
                if uk and c == 0:
                    hooks.enter_context(checking_bank_mxvs(banks, path))
                runs[lane][0]["logits"] = XT.forward_population(
                    target.params, target.cfg, toks, stack, banks=banks,
                    use_kernel=uk)
        with float64_plain_mxvs():
            l64 = XT.forward_population(target.params, target.cfg, toks,
                                        stack, banks=banks, use_kernel=False)
        torch.cuda.synchronize()
        lk, lp = runs["kernel"][0]["logits"], runs["plain"][0]["logits"]
        st["error_pct"]["float64"] += err(l64.argmax(-1))
        st["float64_frames_differ"] += int(
            (l64.argmax(-1) != lp.argmax(-1)).sum())
        del l64
        if c == 0:
            st["path_mxv_max_abs_err"] = path
            flipped = [{n: ((2, 2) if a != (2, 2) else (16, 16))
                        for n, a in chunk[0].items()}] + chunk[1:]
            other = XT.forward_population(
                target.params, target.cfg, toks,
                ev._stack(flipped)[:len(chunk)], banks=banks,
                use_kernel=True)
            st["lane_flip"] = {
                "lane0_moved": not torch.equal(other[0], lk[0]),
                "others_bitwise_equal": bool(torch.equal(other[1:], lk[1:]))}
            if not st["lane_flip"]["others_bitwise_equal"]:
                raise AssertionError("changing lane 0's allocation moved "
                                     "another lane's logits")
            del other
        st["error_pct"]["kernel"] += err(lk.argmax(-1))
        st["error_pct"]["plain"] += err(lp.argmax(-1))
        differ = lk.argmax(-1) != lp.argmax(-1)
        top2 = torch.topk(lp, 2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        gap = (lk - lp).abs().flatten(1).max(1).values
        for p in range(len(chunk)):
            st["lanes"] += 1
            g = float(gap[p])
            st["max_lane_gap"] = max(st["max_lane_gap"], g)
            m = margin[p][differ[p]]
            st["frames"] += differ[p].numel()
            st["frames_differ"] += int(differ[p].sum())
            st["differing_frame_margins"] += m.tolist()
            st["differing_frames_at_margin_0"] += int((m == 0).sum())
            if m.numel():
                st["max_differing_margin"] = max(st["max_differing_margin"],
                                                 float(m.max()))
            if (m >= g).any():
                raise AssertionError(f"lane {c + p}: an argmax differs at a "
                                     f"plain margin >= its gap {g}")
            st["lanes_logits_close"] += int(torch.allclose(
                lk[p], lp[p], rtol=1e-4, atol=1e-3))
            first = next((j for j, (a, b) in enumerate(zip(
                runs["kernel"][0]["acts"], runs["plain"][0]["acts"]))
                if not torch.equal(a[0][p], b[0][p])), None)
            if first is None:
                st["lanes_inputs_equal"] += 1
                torch.testing.assert_close(lk[p], lp[p], rtol=1e-4,
                                           atol=1e-3)
                continue
            if first == 0:            # precedes every MxV of the forward
                raise AssertionError(f"lane {c + p}: the first layer's "
                                     f"inputs differ between the lanes")
            xa = runs["kernel"][0]["acts"][first][0][p].float()
            xb = runs["plain"][0]["acts"][first][0][p].float()
            rel = float((xa - xb).abs().max() / xa.abs().max())
            if rel > 2.0 ** -7:
                raise AssertionError(f"lane {c + p}: the inputs of "
                                     f"{names[first]} first part by {rel} "
                                     f"of their range, over a bf16 step")
            st["first_divergence_layers"][names[first]] = \
                st["first_divergence_layers"].get(names[first], 0) + 1
            st["max_first_divergence_rel"] = max(
                st["max_first_divergence_rel"], rel)
        del runs, lk, lp
        torch.cuda.empty_cache()
    ek, ep = st["error_pct"]["kernel"], st["error_pct"]["plain"]
    st["argmax_agreement"] = 1.0 - st["frames_differ"] / st["frames"]
    st["lanes_with_error_change"] = sum(a != b for a, b in zip(ek, ep))
    st["max_abs_error_pp"] = max(abs(a - b) for a, b in zip(ek, ep))
    e64 = st["error_pct"]["float64"]
    st["float64_vs_plain"] = {
        "argmax_agreement": 1.0 - st.pop("float64_frames_differ")
        / st["frames"],
        "lanes_with_error_change": sum(a != b for a, b in zip(e64, ep)),
        "max_abs_error_pp": max(abs(a - b) for a, b in zip(e64, ep))}
    st["differing_frame_margins"] = sorted(st["differing_frame_margins"])[:20]
    return st


def phase_xlstm_search(dev):
    """The xLSTM search target at full xlstm-350m width and depth: trained
    on the card, calibrated, banks built; the inference-only search
    (bitfusion, (error, speedup), an SRAM that holds any allocation) with
    every quantized MxV on ``bank_mxv_pop``; the kernel lane against
    the plain lane on generation 0's candidates; then the beacon search
    (``XLSTM_RETRAIN_STEPS`` a beacon), with one retrain of the front's
    fastest allocation where the search retrains none. Returns the path's
    launch counts (the two searches)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.kernels import ops

    cfg = get_config(XLSTM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    target = train_xlstm(dev, cfg)
    weights = sum(target.layer_weights.values())
    t0 = time.perf_counter()
    banks = target.batched_evaluator()._banks_for(target.params)
    torch.cuda.synchronize()
    emit({"phase": "xlstm_search", "config": cfg.name,
          "layers": len(target.layer_names),
          "genes": 2 * len(target.layer_names),
          "searchable_weights": weights,
          "head_weights": target.layer_weights["head"],
          "vector_weights": target.vector_weights,
          "bank_bytes": sum(b.numel() * b.element_size()
                            for layer in banks.values()
                            for b in layer.values()),
          "bank_build_s": time.perf_counter() - t0,
          "val_subsets": [list(t.shape) for t, _ in target.val_subsets]})
    del banks
    # an SRAM that holds the model at 16 bits, so that every allocation is
    # feasible in memory, as Bitfusion's 2 MB holds the reference's search
    # config (the SRU's experiment-3 bound of 3.5 bits a weight would admit
    # almost no allocation over 25 layers)
    sram = (weights + target.vector_weights) * 2
    sess = api.SearchSession(target, "bitfusion", ("error", "speedup"),
                             sram_override=sram, share_memo=False)
    calls, evaluate = [], target.val_error_batch

    def recording(allocs, params=None, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = evaluate(allocs, params, **kw)
        calls.append((list(allocs), time.perf_counter() - t))
        return out

    target.val_error_batch = recording
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        res = sess.run(**SEARCH_KW)
        torch.cuda.synchronize()
    finally:
        del target.val_error_batch
    search_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    rows = res.table()
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "xlstm_search", "platform": "bitfusion",
          "sram_bytes": sram, "generation_sizes": [len(a) for a, _ in calls],
          "generation_s": [round(t, 4) for _, t in calls],
          "search_s": search_s, "n_evals": res.n_evals,
          "front": front_rows(rows), "launches": counts,
          "max_memory_allocated": peak})
    if counts["bank_mxv_pop"] <= 0:
        raise AssertionError(f"bank_mxv_pop was not launched by the xLSTM "
                             f"search ({counts})")
    if not np.isfinite([r["error"] for r in rows]
                       + [r["test_error"] for r in rows]).all():
        raise AssertionError(f"non-finite xLSTM front {rows}")

    # generation 0's candidates on both lanes (after the counts are read)
    allocs0 = calls[0][0]
    emit({"phase": "xlstm_search", "kernel_vs_plain": compare_xlstm_lanes(
        target, allocs0), "allocations": len(allocs0)})

    retrain_s, retrainer = [], target.beacon_retrainer

    def timed_retrainer(steps, **kw):
        fn = retrainer(steps, **kw)

        def retrain(alloc, base):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(alloc, base)
            torch.cuda.synchronize()
            retrain_s.append(time.perf_counter() - t)
            return out
        return retrain

    target.beacon_retrainer = timed_retrainer
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        beacon = sess.run(beacons=True, retrain_steps=XLSTM_RETRAIN_STEPS,
                          distance_threshold=XLSTM_DISTANCE, **SEARCH_KW)
        torch.cuda.synchronize()
    finally:
        del target.beacon_retrainer
    beacon_s = time.perf_counter() - t0
    beacon_counts = ops.launch_counts()
    bs = beacon.beacon_search
    made = [(b.alloc, b.params, s) for b, s in zip(bs.beacons, retrain_s)]
    if not made:          # the search retrained none: retrain the fastest
        alloc = max(rows, key=lambda r: r["speedup"])["alloc"]
        t = time.perf_counter()
        params = target.retrain(alloc, steps=XLSTM_RETRAIN_STEPS)
        torch.cuda.synchronize()
        made = [(alloc, params, time.perf_counter() - t)]
    beacons = [{"alloc": {k: list(v) for k, v in a.items()}, "retrain_s": t,
                "error_base_params": target.val_error(a),
                "error_beacon_params": target.val_error(a, params=p)}
               for a, p, t in made]
    emit({"phase": "xlstm_search", "beacon_search": {
        "retrain_steps": XLSTM_RETRAIN_STEPS,
        "distance_threshold": XLSTM_DISTANCE,
        "n_retrains": bs.n_retrains, "beacons": beacons,
        "from_session": bs.n_retrains > 0, "beacon_s": beacon_s,
        "n_evals": beacon.n_evals, "front": front_rows(beacon.table()),
        "launches": beacon_counts,
        "max_memory_allocated": torch.cuda.max_memory_allocated()}})
    values = [b[k] for b in beacons
              for k in ("error_base_params", "error_beacon_params")]
    if not np.isfinite(values).all():
        raise AssertionError(f"non-finite xLSTM beacon errors {values}")
    del target, made, bs, beacon, sess
    torch.cuda.empty_cache()
    return {k: counts[k] + beacon_counts[k] for k in counts}


def moe_train(dev, work: Path) -> dict:
    """``launch.train.main`` on granite-moe-1b-a400m at full width and
    depth (``MOE_TRAIN``): 40 steps checkpointed at step 40, the same
    command again with ``--steps 50`` (it must resume from step 40), then 5
    steps with ``--compress-grads`` and no checkpoint. Each checkpoint
    save's and restore's seconds and bytes are read by wrapping
    ``training.checkpoint.save`` / ``restore`` for the phase. Raises on a
    non-finite loss, on a mean of the last 10 steps' losses not below the
    first 10's, or on a run that did not resume."""
    import numpy as np
    import torch
    from repro_torch.launch import train
    from repro_torch.training import checkpoint as ck

    ckpt_dir = work / "moe_ckpt"
    io_rows = []
    save, restore = ck.save, ck.restore

    def timed(kind, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            row = {"kind": kind, "seconds": time.perf_counter() - t}
            if kind == "save":
                row.update(step=a[1], bytes=dir_bytes(Path(out)))
            else:
                row["step"] = out[1]
            io_rows.append(row)
            return out
        return call

    base = ["--arch", MOE_TRAIN_ARCH, "--batch", str(MOE_TRAIN["batch"]),
            "--seq", str(MOE_TRAIN["seq"]), "--lr", str(MOE_TRAIN["lr"]),
            "--schedule", "constant", "--log-every", "1",
            "--device", str(dev)]
    runs = {"first": ["--steps", str(MOE_TRAIN["steps"]), "--ckpt-dir",
                      str(ckpt_dir), "--ckpt-every", str(MOE_TRAIN["steps"])],
            "resumed": ["--steps", str(MOE_TRAIN["resumed_steps"]),
                        "--ckpt-dir", str(ckpt_dir), "--ckpt-every",
                        str(MOE_TRAIN["steps"])],
            "compress_grads": ["--steps", str(MOE_TRAIN["compress_steps"]),
                               "--compress-grads"]}
    tokens = MOE_TRAIN["batch"] * MOE_TRAIN["seq"]
    out, stream = {}, []
    ck.save, ck.restore = timed("save", save), timed("restore", restore)
    try:
        for name, extra in runs.items():
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                final = train.main(base + extra)
            torch.cuda.synchronize()
            log = buf.getvalue()
            steps = [(int(i), float(loss), float(ms)) for i, loss, ms in
                     re.findall(r"\[train\] step (\d+)/\d+ loss=(\S+) "
                                r"lr=\S+ (\d+)ms/step", log)]
            ms = [m for _, _, m in steps[1:]] or [steps[0][2]]
            out[name] = {
                "args": extra, "wall_s": time.perf_counter() - t0,
                "first_step": steps[0][0], "last_step": steps[-1][0],
                "loss": {i: loss for i, loss, _ in steps},
                "final_loss": final,
                "step_ms_median": float(np.median(ms)),
                "step_ms_first": steps[0][2],
                "tokens_per_s": tokens / (float(np.median(ms)) / 1e3),
                "resumed": "resumed from step" in log,
                "memory_allocated_before": held,
                "max_memory_allocated": torch.cuda.max_memory_allocated()}
            if name != "compress_grads":
                stream += [loss for _, loss, _ in steps]
            emit({"phase": "moe_lm", "train": {name: out[name]}})
        disk = shutil.disk_usage(work)
    finally:
        ck.save, ck.restore = save, restore
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    head, tail = float(np.mean(stream[:10])), float(np.mean(stream[-10:]))
    summary = {"model": MOE_TRAIN_ARCH, **MOE_TRAIN, "tokens_per_step":
               tokens, "checkpoint_io": io_rows,
               "first_10_mean": head, "last_10_mean": tail,
               "disk_free_bytes": disk.free}
    emit({"phase": "moe_lm", "train_summary": summary})
    summary["runs"] = out
    losses = stream + list(out["compress_grads"]["loss"].values())
    if not np.isfinite(losses).all():
        raise AssertionError(f"moe_lm training: a non-finite loss {losses}")
    if not tail < head:
        raise AssertionError(f"moe_lm training: the last 10 steps' mean "
                             f"loss {tail} is not below the first 10's "
                             f"{head}")
    first = MOE_TRAIN["steps"] + 1
    if not (out["resumed"]["resumed"]
            and out["resumed"]["first_step"] == first
            and not out["first"]["resumed"]):
        raise AssertionError(f"moe_lm training did not resume from step "
                             f"{MOE_TRAIN['steps']}: {out['resumed']}")
    if [r["kind"] for r in io_rows] != ["save", "restore", "save"]:
        raise AssertionError(f"moe_lm checkpoints: {io_rows}")
    return summary


def moe_cpu_checks(params, cfg, dev) -> dict:
    """The card against the CPU on qwen2-moe's own weights: layer 0's
    ``moe_ffn`` on a seeded (4, 32, D) bf16 hidden state (the same routing
    at every token, or a near tie; the output within atol 0.02), and
    ``quantize_tree`` at 8 and 4 bits of a slice of every leaf kind (each
    stacked block leaf's layer 0, kept 3-D or 4-D; 4,096 rows of the
    embedding and columns of the head) bitwise."""
    import torch
    from repro_torch.core import quantization as Q
    from repro_torch.core.durable_io import flatten_tree
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tfm

    def to_cpu(tree):
        return cm.tree_map(lambda t: t.cpu(), tree)
    p = tfm.layer(params["blocks"], 0)["ffn"]
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((4, 32, cfg.d_model), generator=g, device=dev).to(
        torch.bfloat16)
    got = cm.moe_ffn(p, x, top_k=cfg.top_k)
    p_cpu, x_cpu = to_cpu(p), x.cpu()
    want = cm.moe_ffn(p_cpu, x_cpu, top_k=cfg.top_k)
    gates = (torch.softmax(x.reshape(-1, cfg.d_model).float() @ p["router"],
                           -1).cpu(),
             torch.softmax(x_cpu.reshape(-1, cfg.d_model).float()
                           @ p_cpu["router"], -1))
    top = [torch.topk(gt, cfg.top_k + 1, -1) for gt in gates]
    picks = [t.indices[:, :cfg.top_k].sort(-1).values for t in top]
    same = (picks[0] == picks[1]).all(-1)
    margin = top[1].values[:, cfg.top_k - 1] - top[1].values[:, cfg.top_k]
    err = float((got.cpu().float() - want.float()).abs().max())
    ffn = {"shape": list(x.shape), "tokens_routed_differently":
           int((~same).sum()), "min_top_k_margin": float(margin.min()),
           "max_abs_err": err, "atol": 0.02}
    if not same.all():
        if float(margin[~same].max()) >= 1e-5:
            raise AssertionError(f"moe_ffn routes differently on the card "
                                 f"away from a near tie: {ffn}")
    elif not err <= 0.02:
        raise AssertionError(f"moe_ffn on the card is off the CPU's: {ffn}")
    blocks = cm.tree_map(lambda t: t[:1], params["blocks"])
    tree = {"blocks": blocks, "embed": params["embed"][:4096],
            "lm_head": params["lm_head"][:, :4096],
            "final_norm": params["final_norm"]}
    quant = {}
    for bits in (8, 4):
        card = Q.quantize_tree(tree, bits)
        host = Q.quantize_tree(to_cpu(tree), bits)
        flat_c, flat_h = flatten_tree(card), flatten_tree(host)
        equal = {k: torch.equal(flat_c[k].cpu(), flat_h[k]) for k in flat_h}
        quant[bits] = {"leaves": len(equal), "bitwise_equal": all(
            equal.values())}
        if not all(equal.values()):
            raise AssertionError(f"quantize_tree at {bits} bits on the card "
                                 f"differs from the CPU's: "
                                 f"{[k for k, v in equal.items() if not v]}")
    return {"moe_ffn_vs_cpu": ffn, "quantize_tree_vs_cpu": quant}


def lazy_dequant_check(qtree, spec, bits, n_layers) -> dict:
    """Every stacked leaf dequantized whole (``dequantize_tree`` of the
    leaf) at layers 0 and L - 1 against ``DequantizedByLayer``'s layer:
    bitwise."""
    import torch
    from repro_torch.core import quantization as Q
    from repro_torch.models import transformer as tfm
    from repro_torch.core.durable_io import flatten_tree
    lazy = Q.DequantizedByLayer(qtree, spec, bits)
    layers = {i: flatten_tree(tfm.layer(lazy["blocks"], i))
              for i in (0, n_layers - 1)}
    equal = True
    for name, leaf_spec in flatten_tree(spec["blocks"]).items():
        node = qtree["blocks"]
        for key in name.split("/"):
            node = node[key]
        whole = Q.dequantize_tree(node, leaf_spec, bits)
        for i, got in layers.items():
            equal &= bool(torch.equal(whole[i], got[name]))
        del whole
    return {"leaves": len(layers[0]), "layers": sorted(layers),
            "bitwise_equal": equal}


def moe_serve(dev) -> dict:
    """qwen2-moe-a2.7b at full width and depth, seeded random bf16 weights
    drawn on the card: batch 4, a 128-token prompt and 16 greedy decode
    steps through ``registry.get_model(cfg).prefill/decode``
    (``make_serve_prefill/decode``), in bf16 and then from
    ``quantize_tree`` at 8 and at 4 bits with each layer dequantized when it
    runs (``DequantizedByLayer``). Before the bf16 tree is freed,
    ``moe_cpu_checks``; after, the lazy dequantization against whole-leaf
    ``dequantize_tree`` (``lazy_dequant_check``). Token agreement
    with bf16 is reported, not held to a bar (random weights under one
    scale a tensor)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import quantization as Q
    from repro_torch.core.durable_io import flatten_tree
    from repro_torch.models.registry import get_model
    from repro_torch.training import train_step as ts

    cfg = get_config(MOE_SERVE_ARCH)
    B, P, G = MOE_SERVE["batch"], MOE_SERVE["prompt"], MOE_SERVE["gen"]
    model = get_model(cfg, dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                           device=dev)
    prefill = ts.make_serve_prefill(model, {"max_len": P + G})
    decode = ts.make_serve_decode(model)

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for t in flatten_tree(tree).values())

    def serve(p):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = prefill(p, {"tokens": prompt})
        tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        row = {"prefill_s": time.perf_counter() - t}
        toks, step_ms = [tok], []
        for _ in range(G):
            t = time.perf_counter()
            logits, cache = decode(p, cache, {"token": tok})
            tok = logits[:, -1].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            toks.append(tok)
        if not torch.isfinite(logits.float()).all():
            raise AssertionError("moe_lm serve: non-finite logits")
        row.update(decode_ms_per_token=float(np.median(step_ms)),
                   decode_ms_range=[min(step_ms), max(step_ms)],
                   cache_positions=cache["cur"])
        return row, torch.cat(toks, dim=1)

    out = {"model": cfg.name, "params": cfg.n_params(),
           "active_params": cfg.n_active_params(), "batch": B, "prompt": P,
           "decode_steps": G, "init_s": init_s,
           "memory_allocated_before": held}
    widths = {}
    row, dense = serve(params)
    widths["bf16"] = {**row, "weight_bytes": nbytes(params)}
    out["checks"] = moe_cpu_checks(params, cfg, dev)
    spec = Q.tree_spec(params)
    qtrees = {}
    for bits in (8, 4):
        t = time.perf_counter()
        qtrees[bits] = Q.quantize_tree(params, bits)
        torch.cuda.synchronize()
        widths[f"int{bits}"] = {"quantize_s": time.perf_counter() - t,
                                "weight_bytes": nbytes(qtrees[bits])}
    out["peak_with_bf16_and_both_quantized"] =         torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for bits, qtree in qtrees.items():
        lazy = Q.DequantizedByLayer(qtree, spec, bits)
        row, toks = serve(lazy)
        widths[f"int{bits}"].update(
            row, token_agreement_with_bf16=float(
                (toks == dense).float().mean()),
            first_step_agreement=float((toks[:, 0] == dense[:, 0]).float()
                                       .mean()),
            lazy_dequant=lazy_dequant_check(qtree, spec, bits,
                                            cfg.n_layers))
        if not widths[f"int{bits}"]["lazy_dequant"]["bitwise_equal"]:
            raise AssertionError(f"lazy dequantization at {bits} bits is "
                                 f"not bitwise dequantize_tree's")
    out["peak_quantized_only"] = torch.cuda.max_memory_allocated()
    out["widths"] = widths
    emit({"phase": "moe_lm", "serve": out})
    del qtrees
    torch.cuda.empty_cache()
    return out


def xlstm_decode(dev) -> dict:
    """xlstm-350m at full width, random weights drawn on the card:
    ``prefill`` of 64 tokens and 16 ``decode_step``s (batch 4) against
    ``forward`` over the 80 tokens, at ``XLSTM_DECODE["checked_layers"]``
    layers (every position's logits within atol 0.2, the CPU tests' bound)
    and at full depth (recorded, no bar: a random-init xLSTM carries a
    summation-order difference of its chunked and stepped forms into
    logit differences that grow with depth)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import xlstm
    from repro_torch.models.registry import get_model

    full_cfg = get_config("xlstm-350m")
    B, P, G = XLSTM_DECODE["batch"], XLSTM_DECODE["prompt"], \
        XLSTM_DECODE["gen"]
    rows = {}
    for layers in (XLSTM_DECODE["checked_layers"], full_cfg.n_layers):
        cfg = dataclasses.replace(full_cfg, n_layers=layers)
        model = get_model(cfg, dev)
        params = model.init(0)
        g = torch.Generator(device=dev).manual_seed(2)
        tokens = torch.randint(0, cfg.vocab_size, (B, P + G), generator=g,
                               device=dev)
        with torch.no_grad():
            full = xlstm.forward(params, cfg, tokens).float()
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, state = model.prefill(params, {"tokens": tokens[:, :P]})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        errs_ = [float((logits[:, 0].float() - full[:, P - 1]).abs().max())]
        step_ms = []
        for i in range(P, P + G):
            t = time.perf_counter()
            logits, state = model.decode(params, state,
                                         {"token": tokens[:, i:i + 1]})
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            errs_.append(float((logits[:, 0].float() - full[:, i])
                               .abs().max()))
        rows[layers] = {"layers": layers, "prefill_s": prefill_s,
                        "decode_ms_per_token": float(np.median(step_ms)),
                        "max_abs_err_vs_forward": max(errs_),
                        "err_by_position": errs_,
                        "logit_max": float(full.abs().max()),
                        "state_cur": state["cur"]}
        del params, full, state
        torch.cuda.empty_cache()
    checked = rows[XLSTM_DECODE["checked_layers"]]
    out = {"model": full_cfg.name, "batch": B, "prompt": P,
           "decode_steps": G, "atol": 0.2, "checked": checked,
           "full_depth": rows[full_cfg.n_layers],
           "decode_ms_per_token": rows[full_cfg.n_layers][
               "decode_ms_per_token"]}
    emit({"phase": "moe_lm", "xlstm_decode": out})
    if not checked["max_abs_err_vs_forward"] <= 0.2:
        raise AssertionError(f"xLSTM prefill + decode is off its forward by "
                             f"{checked['max_abs_err_vs_forward']}")
    return out


def phase_moe_lm(dev) -> dict:
    """The LM trainer, MoE serving from quantized trees and the xLSTM's
    decode (``moe_train``, ``moe_serve``, ``xlstm_decode``). The path runs
    none of the CUDA kernels; its launch counts are read all the same."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as tmp:
        train = moe_train(dev, Path(tmp))
    serve = moe_serve(dev)
    decode = xlstm_decode(dev)
    counts = ops.launch_counts()
    emit({"phase": "moe_lm", "seconds": time.perf_counter() - t0,
          "launches": counts, "train_tokens_per_s": {
              k: v["tokens_per_s"] for k, v in train["runs"].items()},
          "serve_decode_ms_per_token": {
              k: v["decode_ms_per_token"]
              for k, v in serve["widths"].items()},
          "xlstm_decode_ms_per_token": decode["decode_ms_per_token"]})
    return counts


# ------------------------------------------------------------- families

def reset_peak():
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def tree_bytes(tree) -> int:
    from repro_torch.core.durable_io import flatten_tree
    return sum(t.numel() * t.element_size()
               for t in flatten_tree(tree).values())


class RecordingHead:
    """The int8 head as the path calls it, keeping each call's hidden
    state and kernel output (``held_to_plain`` compares them afterwards
    with the plain version, so no comparison launches the kernel)."""

    def __init__(self, head):
        self.head, self.runs = head, []

    def __call__(self, hidden):
        import torch
        y = self.head(hidden)
        self.runs.append((hidden.reshape(-1, hidden.shape[-1]).to(
            torch.float32), y.reshape(-1, y.shape[-1])))
        return y

    def held_to_plain(self) -> dict:
        """Every run's kernel output against ``quant_matmul_ref`` on the
        same hidden state: rtol 1e-4 / atol 1e-3 (raises otherwise)."""
        import torch
        from repro_torch.kernels import ref
        worst = 0.0
        for h, y in self.runs:
            want = ref.quant_matmul_ref(h, self.head.packed, self.head.scales,
                                        self.head.bits)
            torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-3)
            worst = max(worst, errs(y, want)[0])
            del want
        return {"head_runs": len(self.runs), "shape": [
            self.runs[0][0].shape[0], *self.head.packed.shape],
            "max_abs_err": worst, "tol": "rtol 1e-4, atol 1e-3"}


def greedy(prefill, decode, gen):
    """``prefill()`` -> (logits, cache), then ``gen`` greedy steps of
    ``decode(cache, token)`` -> (logits, cache). Returns (tokens (B, gen +
    1), every step's last-position f32 logits (B, gen + 1, V), prefill s,
    median decode ms a step)."""
    import numpy as np
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = prefill()
    tok = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    toks, outs, step_ms = [tok], [logits[:, -1].float()], []
    for _ in range(gen):
        t = time.perf_counter()
        logits, cache = decode(cache, tok)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        toks.append(tok)
        outs.append(logits[:, -1].float())
    out = torch.stack(outs, 1)
    if not torch.isfinite(out).all():
        raise AssertionError("families: non-finite logits in decode")
    return torch.cat(toks, 1), out, prefill_s, float(np.median(step_ms))


def lm_greedy(params, cfg, prompt, gen, head_fn=None):
    """``greedy`` through ``transformer.prefill`` / ``decode_step`` with the
    output head ``head_fn`` (dense when None)."""
    from repro_torch.models import transformer as tfm
    return greedy(
        lambda: tfm.prefill(params, cfg, prompt,
                            max_len=prompt.shape[1] + gen, head_fn=head_fn),
        lambda cache, tok: tfm.decode_step(params, cfg, cache, tok,
                                           head_fn=head_fn), gen)


def decode_vs_forward(logits, full, atol) -> dict:
    """Each prefill / decode step's logits (B, n, V) against the forward's at
    the same positions (B, n, V): the largest difference a position."""
    by_pos = (logits.float() - full.float()).abs().amax(dim=(0, 2))
    return {"max_abs_err": float(by_pos.max()), "atol": atol,
            "err_by_position": [float(e) for e in by_pos],
            "logit_max": float(full.float().abs().max())}


def audio_family(dev) -> dict:
    """seamless-m4t-medium at full width and depth, seeded random weights
    drawn on the card: ``AUDIO["steps"]`` AdamW steps of
    ``make_train_step(get_model(cfg))`` on random frames and bigram decoder
    tokens (the loss's last-5 mean must fall below its first-5); then
    ``Model.prefill`` on 4 x 1,000 frames and 32 greedy decode steps, held
    to a teacher-forced ``encdec.forward`` on the chosen tokens (atol
    0.15)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.models import encdec
    from repro_torch.models.registry import get_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    cfg = get_config(AUDIO["arch"])
    model = get_model(cfg, dev)
    held = reset_peak()
    state = ts.init_train_state(model, 0)
    ocfg = opt.AdamWConfig(lr=AUDIO["lr"], schedule="constant",
                           warmup_steps=max(AUDIO["steps"] // 20, 1),
                           total_steps=AUDIO["steps"])
    step = ts.make_train_step(model, ocfg)
    B, S = AUDIO["batch"], AUDIO["seq"]
    data = synthetic.lm_batches(cfg.vocab_size, B, S, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    losses, step_ms = [], []
    for _ in range(AUDIO["steps"]):
        b = next(data)
        batch = {"frames": torch.randn((B, S, cfg.frontend_dim), generator=g,
                                       device=dev).to(torch.bfloat16),
                 "dec_tokens": b["tokens"], "labels": b["labels"]}
        t = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t) * 1e3)
    train_peak = torch.cuda.max_memory_allocated()
    head, tail = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    train = {"steps": AUDIO["steps"], "batch": B, "seq": S, "lr": AUDIO["lr"],
             "loss": losses, "first_5_mean": head, "last_5_mean": tail,
             "step_ms_median": float(np.median(step_ms[1:])),
             "step_ms_first": step_ms[0],
             "tokens_per_s": B * S / (float(np.median(step_ms[1:])) / 1e3),
             "max_memory_allocated": train_peak}
    emit({"phase": "families", "audio_train": train})
    if not np.isfinite(losses).all() or not tail < head:
        raise AssertionError(f"families audio training: the last 5 steps' "
                             f"mean loss {tail} is not below the first 5's "
                             f"{head} (or not finite)")
    params = state["params"]
    del state, metrics, batch
    reset_peak()
    SB, T, G = AUDIO["serve_batch"], AUDIO["frames"], AUDIO["gen"]
    frames = torch.randn((SB, T, cfg.frontend_dim), generator=g,
                         device=dev).to(torch.bfloat16)
    toks, logits, prefill_s, ms = greedy(
        lambda: model.prefill(params, {"frames": frames, "max_len": G + 1}),
        lambda cache, tok: model.decode(params, cache, {"token": tok}), G)
    with torch.no_grad():
        bos = torch.zeros((SB, 1), dtype=toks.dtype, device=dev)
        full = encdec.forward(params, cfg, frames,
                              torch.cat([bos, toks[:, :-1]], 1))
    check = decode_vs_forward(logits, full, 0.15)
    serve = {"batch": SB, "frames": T, "decode_steps": G,
             "prefill_s": prefill_s, "decode_ms_per_token": ms,
             "decode_vs_forward": check,
             "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit({"phase": "families", "audio_serve": serve})
    if not check["max_abs_err"] <= 0.15:
        raise AssertionError(f"families audio: prefill + decode is off the "
                             f"teacher-forced forward: {check}")
    out = {"model": cfg.name, "params": cfg.n_params(),
           "weight_bytes": tree_bytes(params), "memory_before": held,
           "train": train, "serve": serve}
    del params, full, logits
    return out


def vlm_family(dev) -> dict:
    """internvl2-26b at full width and depth, seeded random bf16 weights:
    ``Model.loss`` under ``no_grad`` at batch 1 on 256 patch embeddings and
    256 bigram text tokens (finite, within 2.0 of ln V); then a 4 x 512
    prompt and 16 greedy decode steps with the dense head and with the int8
    head on ``quant_matmul`` (every head run held to the plain version)."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.models.registry import get_model
    from repro_torch.serving import lm

    cfg = get_config(VLM["arch"])
    model = get_model(cfg, dev)
    held = reset_peak()
    t = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    g = torch.Generator(device=dev).manual_seed(4)
    b = synthetic.lm_batch(cfg.vocab_size, 1, VLM["text"], device=dev)
    batch = {"tokens": b["tokens"], "labels": b["labels"],
             "patch_embeds": torch.randn(
                 (1, VLM["patches"], cfg.d_model), generator=g,
                 device=dev).to(torch.bfloat16)}
    with torch.no_grad():
        t = time.perf_counter()
        loss = float(model.loss(params, batch))
        torch.cuda.synchronize()
        loss_s = time.perf_counter() - t
    ln_v = math.log(cfg.vocab_size)
    out = {"model": cfg.name, "params": cfg.n_params(),
           "weight_bytes": tree_bytes(params), "init_s": init_s,
           "memory_before": held,
           "loss": {"value": loss, "ln_vocab": ln_v, "seconds": loss_s,
                    "patches": VLM["patches"], "text_tokens": VLM["text"]}}
    if not (math.isfinite(loss) and abs(loss - ln_v) <= 2.0):
        raise AssertionError(f"families vlm: loss {loss} is not within 2.0 "
                             f"of ln V = {ln_v}")
    prompt = torch.randint(0, cfg.vocab_size, (VLM["batch"], VLM["prompt"]),
                           generator=g, device=dev)
    head = RecordingHead(lm.int8_head(params, cfg))
    dense, _, d_prefill, d_ms = lm_greedy(params, cfg, prompt, VLM["gen"])
    quant, _, q_prefill, q_ms = lm_greedy(params, cfg, prompt, VLM["gen"],
                                          head_fn=head)
    out["serve"] = {
        "batch": VLM["batch"], "prompt": VLM["prompt"],
        "decode_steps": VLM["gen"], "int8_head_bytes": head.head.nbytes,
        "dense": {"prefill_s": d_prefill, "decode_ms_per_token": d_ms},
        "int8": {"prefill_s": q_prefill, "decode_ms_per_token": q_ms},
        "token_agreement": float((quant == dense).float().mean()),
        "first_token_agreement": float((quant[:, 0] == dense[:, 0]).float()
                                       .mean())}
    out["head_vs_plain"] = head.held_to_plain()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit({"phase": "families", "vlm": out})
    del params, head
    return out


def moe_buffer_bytes(cfg, tokens: int, capacity_factor: float) -> int:
    """Device bytes one ``moe_ffn`` call holds at once on ``tokens`` tokens:
    the f32 gate and up weights, the dispatched rows (bf16, and f32), the
    gate and up products, their SiLU and product (f32) and the bf16 hidden
    state, over every expert's ``groups * capacity`` rows."""
    import math
    from repro_torch.models import common as cm
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_ff
    S = min(cm.MOE_GROUP_SIZE, tokens)
    rows = -(-tokens // S) * max(1, math.ceil(S * cfg.top_k
                                              * capacity_factor / E))
    return 2 * E * D * F * 4 + E * rows * (D * 6 + F * 4 * 4 + F * 2)


def mamba_checks(params, cfg, dev) -> dict:
    """At full width, on group 0's first Mamba mixer: ``mamba_fwd`` on 256
    seeded tokens on the card against the port's CPU lane (output and state
    within atol 0.05), and ``mamba_fwd`` against 512 ``mamba_step``s on the
    card (atol 0.05, the reference's bound)."""
    import torch
    from repro_torch.models import common as cm
    from repro_torch.models import mamba as mb
    from repro_torch.models import transformer as tfm
    p = tfm.mamba_layer(params["mamba_blocks"], 0, 0)["mamba"]
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((1, HYBRID["mamba_steps"], cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    n = HYBRID["mamba_cpu_tokens"]
    got, st = mb.mamba_fwd(p, cfg, x[:, :n], return_state=True)
    p_cpu = cm.tree_map(lambda t: t.cpu(), p)
    want, st_cpu = mb.mamba_fwd(p_cpu, cfg, x[:, :n].cpu(), return_state=True)
    vs_cpu = {"tokens": n, "atol": 0.05,
              "max_abs_err": float((got.cpu().float() - want.float()).abs()
                                   .max()),
              "state_h_max_abs_err": float((st["h"].cpu() - st_cpu["h"])
                                           .abs().max()),
              "state_conv_max_abs_err": float(
                  (st["conv"].cpu().float() - st_cpu["conv"].float())
                  .abs().max())}
    full, fst = mb.mamba_fwd(p, cfg, x, return_state=True)
    state = {"h": torch.zeros_like(fst["h"]),
             "conv": torch.zeros_like(fst["conv"])}
    worst = 0.0
    with torch.no_grad():
        for t in range(x.shape[1]):
            y, state = mb.mamba_step(p, cfg, x[:, t:t + 1], state)
            worst = max(worst, float((y[:, 0].float() - full[:, t].float())
                                     .abs().max()))
    stepped = {"steps": x.shape[1], "atol": 0.05, "max_abs_err": worst,
               "state_h_max_abs_err": float((state["h"] - fst["h"]).abs()
                                            .max()),
               "out_max": float(full.float().abs().max())}
    out = {"mamba_vs_cpu": vs_cpu, "chunked_vs_stepped": stepped}
    bad = [k for k, v in out.items() if not (
        v["max_abs_err"] <= 0.05 and v["state_h_max_abs_err"] <= 0.05)]
    if bad:
        raise AssertionError(f"families hybrid Mamba checks failed: {out}")
    return out


def flash_check(cfg, dev) -> dict:
    """The flash-style branch (forced by ``dense_max`` 1,024) against the
    dense path at the hybrid's head geometry, B 1, T 4,096, causal:
    atol 0.02."""
    import torch
    from repro_torch.models import common as cm
    T = HYBRID["flash_check_T"]
    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn((1, T, cfg.n_heads, cfg.head_dim), generator=g,
                    device=dev).to(torch.bfloat16)
    k, v = (torch.randn((1, T, cfg.n_kv_heads, cfg.head_dim), generator=g,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    torch.cuda.synchronize()
    t = time.perf_counter()
    flash = cm.gqa_attention(q, k, v, dense_max=1024)
    torch.cuda.synchronize()
    flash_s = time.perf_counter() - t
    t = time.perf_counter()
    dense = cm.gqa_attention(q, k, v)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t
    out = {"T": T, "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "atol": 0.02, "flash_s": flash_s, "dense_s": dense_s,
           "max_abs_err": float((flash.float() - dense.float()).abs().max())}
    if not out["max_abs_err"] <= 0.02:
        raise AssertionError(f"families: flash branch off the dense path: "
                             f"{out}")
    return out


def hybrid_family(dev) -> dict:
    """jamba-1.5-large-398b at full width, cut to one group of 8 layers (7
    Mamba + 1 attention) and 4 experts (memory: one 16-expert layer is 19.3
    GB), seeded random bf16 weights drawn a layer at a time: the flash
    branch against the dense path; the Mamba checks; a 1 x 10,240 prefill
    (past ``DENSE_ATTN_MAX``: the attention layer runs the flash branch;
    40 Mamba chunks) and 16 greedy decode steps with the dense head and
    with the int8 head on ``quant_matmul`` (every head run held to the plain
    version); then, at ``MOE_CAPACITY_FACTOR`` 8.0, prefill + decode
    against ``forward`` (atol 0.25, the reference's hybrid bound)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import lm

    full_cfg = get_config(HYBRID["arch"])
    cfg = dataclasses.replace(full_cfg, n_layers=HYBRID["layers"],
                              n_experts=HYBRID["experts"])
    held = reset_peak()
    out = {"model": full_cfg.name, "cuts": {
        "layers": [full_cfg.n_layers, cfg.n_layers],
        "experts": [full_cfg.n_experts, cfg.n_experts]},
        "params": cfg.n_params(), "full_params": full_cfg.n_params(),
        "memory_before": held, "flash_vs_dense": flash_check(cfg, dev)}
    P = HYBRID["prompt"]
    weights = 2 * cfg.n_params()           # every leaf bf16 but a few f32
    reckoned = {"weights": weights, "moe_call": moe_buffer_bytes(
        cfg, P, cm.MOE_CAPACITY_FACTOR), "held": held}
    reckoned["total"] = sum(reckoned.values())
    out["reckoned_peak_bytes"] = reckoned
    if reckoned["total"] > 75e9:
        raise AssertionError(f"families hybrid: reckoned peak {reckoned}")
    reset_peak()
    t = time.perf_counter()
    params = tfm.init_lm(0, cfg, dev)
    torch.cuda.synchronize()
    out.update(init_s=time.perf_counter() - t,
               weight_bytes=tree_bytes(params))
    out["mamba"] = mamba_checks(params, cfg, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (1, P), generator=g,
                           device=dev)
    head = RecordingHead(lm.int8_head(params, cfg))
    dense, _, d_prefill, d_ms = lm_greedy(params, cfg, prompt, HYBRID["gen"])
    quant, _, q_prefill, q_ms = lm_greedy(params, cfg, prompt,
                                          HYBRID["gen"], head_fn=head)
    out["serve"] = {
        "batch": 1, "prompt": P, "decode_steps": HYBRID["gen"],
        "dense": {"prefill_s": d_prefill, "decode_ms_per_token": d_ms},
        "int8": {"prefill_s": q_prefill, "decode_ms_per_token": q_ms},
        "token_agreement": float((quant == dense).float().mean()),
        "first_token_agreement": float((quant[:, 0] == dense[:, 0]).float()
                                       .mean()),
        "max_memory_allocated": torch.cuda.max_memory_allocated()}
    out["head_vs_plain"] = head.held_to_plain()
    del head
    saved = cm.MOE_CAPACITY_FACTOR
    cm.MOE_CAPACITY_FACTOR = 8.0
    try:
        n, steps = HYBRID["check_prompt"], HYBRID["check_steps"]
        toks = torch.randint(0, cfg.vocab_size, (1, n + steps), generator=g,
                             device=dev)
        with torch.no_grad():
            full = tfm.forward(params, cfg, toks)
        logits, cache = tfm.prefill(params, cfg, toks[:, :n],
                                    max_len=n + steps)
        outs = [logits[:, -1]]
        for i in range(n, n + steps - 1):
            logits, cache = tfm.decode_step(params, cfg, cache,
                                            toks[:, i:i + 1])
            outs.append(logits[:, -1])
        check = decode_vs_forward(torch.stack(outs, 1),
                                  full[:, n - 1:n + steps - 1], 0.25)
    finally:
        cm.MOE_CAPACITY_FACTOR = saved
    out["decode_vs_forward"] = {"prompt": n, "decode_steps": steps - 1,
                                "capacity_factor": 8.0, **check}
    emit({"phase": "families", "hybrid": out})
    if not check["max_abs_err"] <= 0.25:
        raise AssertionError(f"families hybrid: prefill + decode is off "
                             f"forward: {check}")
    del params, cache, full
    return out


def time_new_heads(dev) -> list:
    """``quant_matmul`` int8 at the hybrid's and the VLM's head shapes
    (``QMM_FAMILY_SHAPES``) on seeded heads: against its plain version
    (rtol 1e-4 / atol 1e-3), then the CUDA-graph device time beside the
    byte bound, the plain version and the f32 ``matmul`` on the
    dequantized head."""
    import torch
    from repro_torch.kernels import ops, ref
    rows = []
    for name, shape in QMM_FAMILY_SHAPES.items():
        x, packed, scales = qmm_inputs(shape, 8, 30, dev)
        got = ops.quant_matmul(x, packed, scales, 8)
        want = ref.quant_matmul_ref(x, packed, scales, 8)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
        w_deq = (ref.unpack_weights(packed, 8, shape[1]).to(torch.float32)
                 * scales[None, :])
        b, by = bound_ms(*qmm_cost(shape, packed))

        def call():
            ops.quant_matmul(x, packed, scales, 8)

        graph = graph_ms(call)
        row = {"name": "quant_matmul", "head": name, "shape": shape,
               "bits": 8, "max_abs_err": errs(got, want)[0],
               "ms": graph["median"], "graph_ms": graph,
               "host_ms": cuda_ms_stats(call, 20)["median"],
               "plain_ms": cuda_ms(lambda: ref.quant_matmul_ref(
                   x, packed, scales, 8), 5),
               "bound_ms": b, "bound_by": by,
               "library_ms": graph_ms(lambda: torch.matmul(x, w_deq))[
                   "median"]}
        row["share_of_bound"] = b / row["ms"]
        emit({"phase": "families", "qmm_timing": row})
        rows.append(row)
        del w_deq, x, packed, scales
    return rows


def phase_families(dev):
    """The audio, VLM and hybrid families at full width (``audio_family``,
    ``vlm_family``, ``hybrid_family``), each freed before the next; the
    launch counts are read over the three, then ``quant_matmul`` is timed
    at the two new head shapes. Returns (counts, the timing rows)."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    audio = audio_family(dev)
    vlm = vlm_family(dev)
    hybrid = hybrid_family(dev)
    counts = ops.launch_counts()
    seconds = time.perf_counter() - t0
    reset_peak()
    heads = time_new_heads(dev)
    runs = vlm["head_vs_plain"]["head_runs"] \
        + hybrid["head_vs_plain"]["head_runs"]
    emit({"phase": "families", "seconds": seconds, "launches": counts,
          "int8_head_runs": runs, "card": torch.cuda.get_device_name(0),
          "audio_train_step_ms": audio["train"]["step_ms_median"],
          "audio_decode_ms_per_token": audio["serve"]["decode_ms_per_token"],
          "vlm_decode_ms_per_token": {
              k: vlm["serve"][k]["decode_ms_per_token"]
              for k in ("dense", "int8")},
          "hybrid_prefill_s": hybrid["serve"]["int8"]["prefill_s"],
          "hybrid_decode_ms_per_token": {
              k: hybrid["serve"][k]["decode_ms_per_token"]
              for k in ("dense", "int8")},
          "peak_bytes": {"audio": max(audio["train"]["max_memory_allocated"],
                                      audio["serve"]["max_memory_allocated"]),
                         "vlm": vlm["max_memory_allocated"],
                         "hybrid": hybrid["serve"]["max_memory_allocated"]}})
    if counts["quant_matmul"] != runs:
        raise AssertionError(f"quant_matmul launched {counts['quant_matmul']}"
                             f" times, expected one per int8 head run "
                             f"({runs})")
    return counts, heads


def time_xlstm_mxvs(dev):
    """``bank_mxv_pop`` at the xLSTM's MxV shapes (``XLSTM_MXV_SHAPES``,
    seeded inputs drawn on the card, rows built as the target builds them)
    beside the library call that computes the same function, ``torch.bmm``
    with its ``index_select`` gather: the median and range of 5 repeats
    each, the bound and its share."""
    import torch
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import ops
    rows = {}
    for name, ((P, M, m, N), K) in XLSTM_MXV_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(30)
        w = torch.randn((m, N), generator=g, device=dev) / m ** 0.5
        trips = Q.menu_triples(Q.SUPPORTED_BITS, lambda b: float(
            w.abs().max()) if b == 16 else sampled_clip(w, b))
        bank = Q.build_weight_bank(w, trips)
        del w
        if K != len(Q.SUPPORTED_BITS):      # the recurrent view: K x H rows
            bank = bank.repeat_interleave(K // bank.shape[0], dim=0)
        x = torch.randn((P, M, m), generator=g, device=dev)
        idx = torch.arange(P, dtype=torch.int32, device=dev) % K
        iters = 2 if N > 10000 else 5
        b, by = bound_ms(*mxv_cost((P, M, m, N), idx))
        row = {"phase": "timing", "xlstm_mxv": name, "shape": [P, M, m, N],
               "bank_rows": K, "config": ops.bank_config(P, M, N),
               "bound_ms": b, "bound_by": by,
               "bank_mxv_pop": cuda_ms_stats(
                   lambda: ops.bank_mxv_pop(x, bank, idx), iters),
               "bmm_index_select": cuda_ms_stats(
                   lambda: torch.bmm(x, bank.index_select(0, idx.long())),
                   iters)}
        row["share_of_bound"] = b / row["bank_mxv_pop"]["median"]
        row["vs_bmm"] = (row["bank_mxv_pop"]["median"]
                         / row["bmm_index_select"]["median"])
        emit(row)
        rows[name] = row
        del x, bank
        torch.cuda.empty_cache()
    return rows


def time_banks(dev):
    """Both bank kernels at the search shapes (P = 16 lanes of 1536 rows)
    and the serving shapes (8 lanes of a 16-frame chunk, 4 lanes of a 7-frame
    tail), beside ``torch.bmm`` with the ``index_select`` gather (the
    same function as ``bank_mxv_pop``), ``bmm`` on a gathered copy made
    beforehand, and dequantize + ``bmm`` (``bank_qmm_pop``'s plain
    version): the median and range of 5 repeats each; at the search shapes
    also both kernels with each tile configuration forced (``by_config``),
    at the serving shapes their device time in a CUDA graph (``*_graph``).
    Returns the rows by shape name."""
    import torch
    from repro_torch.kernels import ops, ref
    shapes = {name: shp for name, shp in MXV_SHAPES.items()
              if name != "ragged"}
    for name, (_, _, m, N) in MXV_SHAPES.items():
        if name != "ragged":
            shapes[f"serve_{name}"] = (SERVE_LANES, SERVE_CHUNK, m, N)
            shapes[f"tail_{name}"] = (4, SERVE_TAIL, m, N)
    rows = {}
    for name, shp in shapes.items():
        x, bank, packed, idx = bank_inputs(shp, 4, dev)
        gathered = bank.index_select(0, idx.long())
        iters = 10 if shp[1] > SMALL_ROWS else 50
        qb = sum(packed[k].numel() * packed[k].element_size()
                 for k in ("q2", "q4", "q8", "q16")) / (shp[2] * shp[3] * 4)
        bounds = {"bank_mxv_pop": bound_ms(*mxv_cost(shp, idx)),
                  "bank_qmm_pop": bound_ms(*mxv_cost(
                      shp, idx, container_bytes_per_weight=qb))}
        row = {"phase": "timing", "layer": name, "shape": shp,
               "config": {k: ops.bank_config(shp[0], shp[1], shp[3],
                                             kernel=k)
                          for k in ("bank_mxv_pop", "bank_qmm_pop")},
               "bound_ms": {k: b for k, (b, _) in bounds.items()},
               "bound_by": {k: by for k, (_, by) in bounds.items()}}
        for key, fn in (
                ("bank_mxv_pop", lambda: ops.bank_mxv_pop(x, bank, idx)),
                ("bank_qmm_pop", lambda: ops.bank_qmm_pop(x, packed, idx)),
                ("bmm_index_select",
                 lambda: torch.bmm(x, bank.index_select(0, idx.long()))),
                ("bmm_gathered", lambda: torch.bmm(x, gathered)),
                ("dequant_bmm",
                 lambda: ref.bank_qmm_pop_ref(x, packed, idx))):
            row[key] = cuda_ms_stats(fn, iters)
            if shp[1] <= SMALL_ROWS and key != "dequant_bmm":
                row[key + "_graph"] = graph_ms(fn)
        if shp[1] > SMALL_ROWS:      # every configuration, forced
            row["by_config"] = {
                name: [cuda_ms_stats(lambda: fn(x, b, idx, config=c),
                                     iters)["median"]
                       for c in range(len(ops.BANK_CONFIGS))]
                for name, fn, b in (("bank_mxv_pop", ops.bank_mxv_pop, bank),
                                    ("bank_qmm_pop", ops.bank_qmm_pop,
                                     packed))}
        mxv = row["bank_mxv_pop"]["median"]
        row["mxv_share_of_bound"] = row["bound_ms"]["bank_mxv_pop"] / mxv
        row["mxv_vs_bmm"] = mxv / row["bmm_index_select"]["median"]
        row["qmm_vs_mxv"] = row["bank_qmm_pop"]["median"] / mxv
        row["qmm_vs_dequant_bmm"] = (row["bank_qmm_pop"]["median"]
                                     / row["dequant_bmm"]["median"])
        emit(row)
        rows[name] = row
        del x, bank, packed, gathered
    return rows


def time_scans(dev):
    """The scans at ``TIMED_SCANS``' shapes: device time from a CUDA graph
    (the ``ms`` of the ``kernels`` line), the event-timed call beside it
    (``host_ms``: back-to-back calls, whose host work can outlast a short
    kernel), the plain version and the bound. Returns the ``kernels`` rows
    of the search (``sru_scan_pop``) and P = 1 (``sru_scan``) shapes."""
    from repro_torch.kernels import ops, ref
    rows = []
    for label, (name, shape) in TIMED_SCANS.items():
        streams, vecs = scan_inputs(shape, 3, dev)
        args = streams if name == "sru_scan_pop" else [s[0] for s in streams]
        fn, plain = getattr(ops, name), getattr(ref, name + "_ref")
        b, by = bound_ms(*scan_cost(shape))
        graph = graph_ms(lambda: fn(*args, *vecs))
        host = cuda_ms_stats(lambda: fn(*args, *vecs), 20)
        row = dict(name=name, shape=shape if name == "sru_scan_pop"
                   else shape[1:], ms=graph["median"], host_ms=host["median"],
                   ms_from="cuda_graph", plain_ms=cuda_ms(
                       lambda: plain(*args, *vecs), 3, 1),
                   bound_ms=b, bound_by=by, library_ms=None)
        emit({"phase": "timing", "scan": label, **row, "graph_ms": graph,
              "cuda_ms_stats": host, "share_of_bound": b / row["ms"]})
        if label in ("search", "scalar"):
            rows.append(row)
    return rows


def profile_training(dev, target, steps: int = 3):
    """Where a training step's time goes: ``steps`` steps of the
    full-precision train step and of a retraining step (``qspec``: weights
    4 bits, activations 8) under ``torch.profiler``, after one warm step
    each. Per step: device kernels and memory operations launched, their
    summed device time, and the host wall time with the profiler off
    (median of ``steps`` synchronised steps); the device's idle share is
    1 - device time / wall time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import synthetic
    from repro_torch.models import sru
    from repro_torch.training import optimizer as opt
    from repro_torch.training import qat

    cfg = target.cfg
    batch = next(synthetic.speech_batches(target.task, 8, 48, seed=5,
                                          device=dev))
    alloc = {n: (4, 8) for n in target.layer_names}
    wclips = {n: target.wclips[(n, 4)] for n in target.layer_names}
    kinds = {
        "train": (opt.AdamWConfig(lr=3e-3, schedule="cosine",
                                  warmup_steps=20, total_steps=400,
                                  weight_decay=0.0), {}),
        "retrain": (opt.AdamWConfig(lr=3e-4, schedule="constant",
                                    warmup_steps=5, weight_decay=0.0,
                                    total_steps=60),
                    dict(qspec=alloc, wclips=wclips,
                         act_ranges=target.act_ranges))}
    out = {}
    for kind, (ocfg, fkw) in kinds.items():
        state = opt.init_opt_state(target.params)

        def step():
            opt.adamw_step(ocfg, lambda p, f, l: qat.frame_nll(
                sru.forward_train(p, cfg, f, **fkw), l), target.params,
                state, batch["feats"], batch["labels"])

        wall = []
        for _ in range(steps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        wall_ms = float(np.median(wall[1:]))
        device_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
        out[kind] = {"device_ops_per_step": len(device) / steps,
                     "device_ms_per_step": device_ms / steps,
                     "wall_ms_per_step": wall_ms,
                     "idle_share": (1.0 - device_ms / steps / wall_ms
                                    if device else None)}
    emit({"phase": "timing", "training_step_profile": out,
          "note": "device time is None where the profiler saw no kernels"})
    return out


def phase_timing(dev, max_err, counts, smi_line, target):
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import sru
    profile_training(dev, target)
    time_xlstm_mxvs(dev)
    kernels = time_scans(dev)
    bank_rows = time_banks(dev)
    for name in ("bank_mxv_pop", "bank_qmm_pop"):
        r = bank_rows["FC"]
        kernels.append(dict(
            name=name, shape=r["shape"], ms=r[name]["median"],
            host_ms=r[name]["median"], ms_from="events",
            plain_ms=r["dequant_bmm" if name == "bank_qmm_pop"
                       else "bmm_index_select"]["median"],
            bound_ms=r["bound_ms"][name], bound_by=r["bound_by"][name],
            library_ms=(r["bmm_index_select"]["median"]
                        if name == "bank_mxv_pop" else None)))
    # the scalar forward(qp=) (test error, the served step's oracle) with
    # its MxVs on bank_mxv_pop (P = 1), as it runs, and on torch.matmul
    qp = target.qp_for({n: (8, 8) for n in target.layer_names})
    for feats in (target.val_subsets[0][0],
                  target.val_subsets[0][0][:1, :SERVE_CHUNK]):
        def fwd():
            sru.forward(target.params, target.cfg, feats, qp=qp)
        row = {"phase": "timing", "scalar_forward": list(feats.shape),
               "bank_mxv_pop_ms": cuda_ms(fwd, 5)}
        with scalar_mxv_on_matmul():
            row["matmul_ms"] = cuda_ms(fwd, 5)
        emit(row)
    # quant_matmul at the LM head: int8 (the kernels line) and int4, beside
    # the f32 matmul on the dequantized head and the dense bf16 head
    shape = QMM_SHAPES["head"]
    for bits in (8, 4):
        x, packed, scales = qmm_inputs(shape, bits, 20 + bits, dev)
        w_deq = (ref.unpack_weights(packed, bits, shape[1]).to(torch.float32)
                 * scales[None, :])
        b, by = bound_ms(*qmm_cost(shape, packed))

        def call():
            ops.quant_matmul(x, packed, scales, bits)

        graph, host = graph_ms(call), cuda_ms_stats(call, 20)
        row = dict(
            name="quant_matmul", shape=shape, bits=bits, ms=graph["median"],
            host_ms=host["median"], ms_from="cuda_graph", graph_ms=graph,
            cuda_ms_stats=host,
            plain_ms=cuda_ms(
                lambda: ref.quant_matmul_ref(x, packed, scales, bits), 5),
            bound_ms=b, bound_by=by,
            library_ms=graph_ms(lambda: torch.matmul(x, w_deq))["median"])
        row["share_of_bound"] = b / row["ms"]
        del w_deq
        emit({"phase": "timing", **row})
        if bits == 8:
            kernels.append(row)
            w_bf = torch.randn(shape[1:], device=dev, dtype=torch.bfloat16)
            x_bf = x.to(torch.bfloat16)
            emit({"phase": "timing", "dense_bf16_head_ms": graph_ms(
                lambda: torch.matmul(x_bf, w_bf))["median"], "shape": shape,
                "bound_ms": bound_ms(2 * (shape[1] * shape[2] + shape[0] * (
                    shape[1] + shape[2])), 0)[0]})
            del w_bf
    out = []
    for k in kernels:
        src, replaces = KERNELS[k["name"]]
        out.append({"name": k["name"], "route": "cuda", "source": src,
                    "replaces": replaces, "launches": counts[k["name"]],
                    "max_abs_err": max_err[k["name"]], "ms": k["ms"],
                    "host_ms": k["host_ms"], "ms_from": k["ms_from"],
                    "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                    "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                    "shape": list(k["shape"])})
    emit({"phase": "timing", "card": smi_line, "kernels_detail": out})
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is present; this script measures the card")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"the port's sources are missing under {SRC}")
    configure_torch()
    dev = torch.device("cuda")

    smi_line = phase_setup()
    max_err = phase_kernels(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        counts, target = phase_main_path(dev, work)
        beacon_counts, run = phase_beacon_search(dev, target, work)
        paths = [beacon_counts, phase_resume(target, work, run)]
    paths += [phase_lm_serve(dev), phase_front_serve(dev, target),
              phase_xlstm_search(dev), phase_moe_lm(dev)]
    family_counts, family_heads = phase_families(dev)
    paths.append(family_counts)
    max_err["quant_matmul"] = max([max_err["quant_matmul"]] + [
        r["max_abs_err"] for r in family_heads])
    for path_counts in paths:
        counts = {k: counts[k] + path_counts[k] for k in counts}
    kernels = phase_timing(dev, max_err, counts, smi_line, target)
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "repro" or m.startswith("repro.")]
    if bad:
        raise AssertionError(f"imported the reference stack: {bad[:5]}")
    print(smi_line, flush=True)
    print(json.dumps({"kernels": [{k: v for k, v in row.items()
                                   if k != "shape"} for row in kernels]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resume-child"]:
        sys.exit(resume_child(json.loads(sys.argv[2])))
    sys.exit(main())
