#!/usr/bin/env python3
"""Drive the PyTorch port of MOHAQ on one CUDA card and check it.

    python3 chip_smoke.py            # all phases; needs one CUDA device

Phases, each printing JSON lines:

1. setup: build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   call), print the card and its power limit;
2. kernels: each kernel against its plain PyTorch version on seeded inputs
   at the main path's full-width shapes and at a ragged shape
   (scan: 1e-5; MxVs: rtol 1e-4 / atol 1e-3; the packed MxV bitwise equal
   to the f32 MxV on the dequantized bank);
3. main path: the inference-only MOHAQ search on the paper's model
   (``configs/sru_timit.py``, full width, seeded random weights, synthetic
   speech): calibrate, build banks, ``SearchSession(target, "silago",
   ("error", "speedup", "energy")).run(generations=2, pop=10, initial=40)``,
   score the front in the packed deployment format and on the test set.
   Every kernel's launch count over that run must be > 0. Then, on
   generation 0's allocations, the kernel lane against the plain lane and
   the f32 bank format against the packed one;
4. timing: each kernel, its plain version and the PyTorch library call
   (CUDA events, after warm-up), one generation's evaluation per lane, and
   peak device memory.

The last line is ``{"ok": true, "device": {...}}``; a failed phase raises
and the script exits non-zero. It exits non-zero, printing no result, where
no CUDA device is present or the port's sources are missing.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
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

SCAN_SHAPE = (16, 32, 48, 550)              # (P, B, T, n)
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
}


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
    sample = w.flatten()[:: max(1, w.numel() // 65536)].numpy()
    trips = Q.menu_triples(Q.SUPPORTED_BITS, lambda b: float(w.abs().max())
                           if b == 16 else Q.mmse_clip(sample, b))
    w = w.to(dev)
    bank = Q.build_weight_bank(w, trips)
    packed = Q.build_packed_weight_bank(w, trips)
    x = torch.randn((P, M, m), generator=g).to(dev)
    idx = torch.from_numpy((np.arange(P) % 4).astype(np.int32)).to(dev)
    return x, bank, packed, idx


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
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    build_s = time.perf_counter() - t0
    log = (lib.parent / "build.log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    emit({"phase": "setup", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": round(build_s, 3),
          "library": str(lib.relative_to(REPO)), "ptxas": ptxas})
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    return smi[0] if smi else None


def phase_kernels(dev):
    """Each kernel against its plain version; returns max abs errors at the
    main path's shapes (scan: SCAN_SHAPE; MxVs: FC)."""
    import torch
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import ops, ref
    out = {}
    for label, shape in (("full", SCAN_SHAPE), ("ragged", (3, 5, 7, 13))):
        streams, vecs = scan_inputs(shape, 1, dev)
        got = ops.sru_scan_pop(*streams, *vecs)
        want = ref.sru_scan_pop_ref(*streams, *vecs)
        torch.cuda.synchronize()
        worst = max(errs(g, w)[0] for g, w in zip(got, want))
        worst_rel = max(errs(g, w)[1] for g, w in zip(got, want))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        emit({"phase": "kernels", "kernel": "sru_scan_pop", "shape": shape,
              "max_abs_err": worst, "max_rel_err": worst_rel,
              "tol": "rtol 1e-5, atol 1e-5"})
        if label == "full":
            out["sru_scan_pop"] = worst
        single = [s[0] for s in streams]
        got1 = ops.sru_scan(*single, *vecs)
        want1 = ref.sru_scan_ref(*single, *vecs)
        torch.cuda.synchronize()
        worst1 = max(errs(g, w)[0] for g, w in zip(got1, want1))
        for g, w in zip(got1, want1):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        emit({"phase": "kernels", "kernel": "sru_scan", "shape": shape[1:],
              "max_abs_err": worst1,
              "max_rel_err": max(errs(g, w)[1] for g, w in zip(got1, want1)),
              "tol": "rtol 1e-5, atol 1e-5"})
        if label == "full":
            out["sru_scan"] = worst1
    for name, shape in MXV_SHAPES.items():
        x, bank, packed, idx = bank_inputs(shape, 2, dev)
        row = {"phase": "kernels", "shape": shape,
               "tol": "rtol 1e-4, atol 1e-3"}
        if name != "L0":              # L0's f32 product comes from the u-bank
            got = ops.bank_mxv_pop(x, bank, idx)
            want = ref.bank_mxv_pop_ref(x, bank, idx)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
            a, r = errs(got, want)
            emit({**row, "kernel": "bank_mxv_pop", "layer": name,
                  "max_abs_err": a, "max_rel_err": r})
            if name == "FC":
                out["bank_mxv_pop"] = a
        got_q = ops.bank_qmm_pop(x, packed, idx)
        want_q = ref.bank_qmm_pop_ref(x, packed, idx)
        on_deq = ops.bank_mxv_pop(x, Q.dequant_packed_bank(packed), idx)
        torch.cuda.synchronize()
        torch.testing.assert_close(got_q, want_q, rtol=1e-4, atol=1e-3)
        bitwise = bool(torch.equal(got_q, on_deq))
        a, r = errs(got_q, want_q)
        emit({**row, "kernel": "bank_qmm_pop", "layer": name,
              "max_abs_err": a, "max_rel_err": r,
              "bitwise_equal_to_mxv_on_dequant": bitwise})
        if not bitwise:
            raise AssertionError(f"bank_qmm_pop != bank_mxv_pop on the "
                                 f"dequantized bank at {shape}")
        if name == "FC":
            out["bank_qmm_pop"] = a
    return out


def phase_main_path(dev):
    """The search on the paper's model through the kernels."""
    import numpy as np
    import torch
    from repro_torch.configs.sru_timit import CONFIG
    from repro_torch.core import api
    from repro_torch.core import sru_experiment as X
    from repro_torch.kernels import ops
    from repro_torch.models import sru

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    target = X.build_untrained_sru(CONFIG, seed=0, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
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
          "build_target_s": round(t_build, 3),
          "search_s": round(t_search, 3),
          "n_evals": res.n_evals, "launches": counts})
    for r, pe in zip(rows, packed_errs):
        emit({"phase": "main_path", "front": {
            "alloc": {k: list(v) for k, v in r["alloc"].items()},
            "error": r["error"], "packed_error": pe,
            "test_error": r["test_error"], "speedup": r["speedup"],
            "energy": r["energy"], "compression": r["compression"]}})
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path ({counts})")
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
    return counts, lanes_s


def compare_lanes(target, allocs):
    """Kernel lane vs plain lane (both f32 banks), and f32 vs packed banks
    (both kernel lane), on the same allocations: argmax agreement over all
    frames, per-lane error % and the top-2 logit margin of every frame
    whose argmax differs (a margin of 0 is an exact tie)."""
    import torch
    from repro_torch.models import sru

    def logits(**kw):
        ev = target.batched_evaluator(True, kw.get("bank_format", "f32"),
                                      kw.get("use_kernel"))
        banks = ev._banks_for(target.params)
        stack = ev._stack(allocs)[:len(allocs)]
        return sru.forward_population(target.params, target.cfg,
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
            emit({"phase": "main_path", name: result[name]})
            raise AssertionError(f"{name}: argmax agreement {agree:.5f} "
                                 f"(need >= 0.999) or error change "
                                 f"{float(d_err.max()):.3f} pp (need <= 0.1)")
    return result


def phase_timing(dev, max_err, counts, smi_line):
    import torch
    from repro_torch.kernels import ops, ref
    kernels = []
    streams, vecs = scan_inputs(SCAN_SHAPE, 3, dev)
    nbytes, flops = scan_cost(SCAN_SHAPE)
    for name, fn, plain, shape, (nb, fl) in (
            ("sru_scan_pop", lambda: ops.sru_scan_pop(*streams, *vecs),
             lambda: ref.sru_scan_pop_ref(*streams, *vecs), SCAN_SHAPE,
             (nbytes, flops)),
            ("sru_scan", lambda: ops.sru_scan(*(s[0] for s in streams), *vecs),
             lambda: ref.sru_scan_ref(*(s[0] for s in streams), *vecs),
             SCAN_SHAPE[1:], scan_cost((1,) + SCAN_SHAPE[1:]))):
        b, by = bound_ms(nb, fl)
        kernels.append(dict(name=name, shape=shape, ms=cuda_ms(fn, 20),
                            plain_ms=cuda_ms(plain, 3, 1), bound_ms=b,
                            bound_by=by, library_ms=None))
    x, bank, packed, idx = bank_inputs(MXV_SHAPES["FC"], 4, dev)
    shape = MXV_SHAPES["FC"]
    nb, fl = mxv_cost(shape, idx)
    b, by = bound_ms(nb, fl)
    kernels.append(dict(
        name="bank_mxv_pop", shape=shape,
        ms=cuda_ms(lambda: ops.bank_mxv_pop(x, bank, idx), 10),
        plain_ms=cuda_ms(lambda: ref.bank_mxv_pop_ref(x, bank, idx), 10),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(lambda: torch.bmm(x, bank.index_select(0, idx)),
                           10)))
    qbytes = (sum(packed[k].numel() * packed[k].element_size()
                  for k in ("q2", "q4", "q8", "q16"))
              / (shape[2] * shape[3]))            # all four rows are selected
    nb, fl = mxv_cost(shape, idx, container_bytes_per_weight=qbytes / 4)
    b, by = bound_ms(nb, fl)
    kernels.append(dict(
        name="bank_qmm_pop", shape=shape,
        ms=cuda_ms(lambda: ops.bank_qmm_pop(x, packed, idx), 10),
        plain_ms=cuda_ms(lambda: ref.bank_qmm_pop_ref(x, packed, idx), 10),
        bound_ms=b, bound_by=by, library_ms=None))
    for name, shp in (("L", MXV_SHAPES["L"]), ("Pr", MXV_SHAPES["Pr"]),
                      ("L0", MXV_SHAPES["L0"])):
        x, bank, packed, idx = bank_inputs(shp, 5, dev)
        row = {"phase": "timing", "layer": name, "shape": shp}
        if name != "L0":
            row["bank_mxv_pop_ms"] = cuda_ms(
                lambda: ops.bank_mxv_pop(x, bank, idx), 10)
            row["bmm_ms"] = cuda_ms(
                lambda: torch.bmm(x, bank.index_select(0, idx)), 10)
        row["bank_qmm_pop_ms"] = cuda_ms(
            lambda: ops.bank_qmm_pop(x, packed, idx), 10)
        emit(row)
    out = []
    for k in kernels:
        src, replaces = KERNELS[k["name"]]
        out.append({"name": k["name"], "route": "cuda", "source": src,
                    "replaces": replaces, "launches": counts[k["name"]],
                    "max_abs_err": max_err[k["name"]], "ms": k["ms"],
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
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    smi_line = phase_setup()
    max_err = phase_kernels(dev)
    counts, _ = phase_main_path(dev)
    kernels = phase_timing(dev, max_err, counts, smi_line)
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
    sys.exit(main())
