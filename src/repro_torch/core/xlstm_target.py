"""The xLSTM ``SearchTarget``: the second architecture behind the MOHAQ
search.

Port of the reference package's ``core/xlstm_target.py``. The model is the
registry xLSTM LM (``models/xlstm.py``, family "ssm": alternating
mLSTM/sLSTM block pairs), searched for per-layer (w_bits, a_bits)
allocations through the same engine as the SRU: NSGA-II,
``MOHAQProblem`` and the generic ``PopulationEvaluator``.

Each searchable layer is one block's matmul weights, sharing one weight
grid (MMSE clip per bit-width, pooled over the block's matrices) and one
activation grid calibrated at the block input:

  ``m{g}``  mLSTM pair member g:  wq, wk, wv, wz, wo
  ``s{g}``  sLSTM pair member g:  wx, r (recurrent kernel), wo
  ``head``  the LM head projection

Gate weights, biases, norms and the embedding are not searched; they count
as 16-bit ``vector_weights``.

Banks: every quantizable leaf gets a ``(|menu|, *leaf.shape)`` stack of
its fake-quantized forms (``Q.build_weight_bank``, bitwise the reference's
rows, bf16 for the bf16 leaves), held widened to float32 so that
``kernels.ops.bank_mxv_pop`` reads it in place. ``forward_population``
has three lanes, all (P, B, T, V) f32 logits:

- requant (``banks=None``): each lane fake-quantizes its weights;
- plain (``use_kernel=False``): each MxV is ``kernels/ref.py``'s
  ``bank_mxv_pop_ref`` (``torch.bmm`` on the gathered rows);
- kernel (``use_kernel=True``, the default on a CUDA device): each MxV is
  one ``bank_mxv_pop`` launch, the sLSTM's per-head recurrent product
  included (its (K, H, dh, 4dh) bank viewed as K·H rows, one lane per
  (candidate, head), one launch per time step and layer).

Error metric: next-token top-1 error % on the bigram task
(``data/synthetic.py::lm_batch``), the MAX over 4 validation subsets, as
the SRU target scores frames.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core import batched_eval
from repro_torch.core import quantization as Q
from repro_torch.core.mohaq import Alloc
from repro_torch.data import synthetic
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.models import transformer as tfm
from repro_torch.models import xlstm
from repro_torch.training import optimizer as opt

# quantizable matmul leaves per block kind (see module docstring)
QUANT_LEAVES = {"m": ("wq", "wk", "wv", "wz", "wo"),
                "s": ("wx", "r", "wo")}
# the task's noise fan-out: 2 equiprobable continuations, a 50 % top-1
# error floor, leaving a wide range for quantization to degrade across
N_NOISE = 2
# parameter sets whose banks an evaluator keeps: the base params and one
# beacon (xlstm-350m's f32 banks take 5.66 GB a set)
BANK_CACHE_SIZE = 2


def search_config() -> ArchConfig:
    """CPU-searchable miniature of xlstm-350m: 2 (mLSTM, sLSTM) pairs, 5
    searchable layers, a 10-gene genome."""
    return dataclasses.replace(
        get_config("xlstm-350m").reduced(),
        name="xlstm_search", n_layers=4, d_model=64, n_heads=4,
        vocab_size=64)


def quant_layer_names(cfg: ArchConfig) -> Tuple[str, ...]:
    names: List[str] = []
    for g in range(cfg.n_layers // 2):
        names += [f"m{g}", f"s{g}"]
    return tuple(names + ["head"])


def _layer_leaves(params, cfg: ArchConfig, name: str) -> Dict[str, torch.Tensor]:
    """The full-precision quantizable leaves of one searchable layer."""
    if name == "head":
        return {"lm_head": params["lm_head"]}
    g = int(name[1:])
    sub = params["pairs"]["mlstm" if name[0] == "m" else "slstm"]
    return {k: sub[k][g] for k in QUANT_LEAVES[name[0]]}


def forward(params, cfg: ArchConfig, tokens, get_w, q_act,
            layer_mxv: Optional[Callable] = None, lanes: int = 0,
            jit_norms: bool = True):
    """The block-pair forward with quantization hooks. ``get_w(name)`` ->
    replacement dict for the layer's quantizable leaves; ``q_act(name, x)``
    -> the (possibly fake-quantized) block-input activation.
    ``layer_mxv(name)`` -> (mm, rec) replaces the layer's products (see
    ``models/xlstm.py``; ``rec`` None keeps the sLSTM's einsum), and
    ``lanes`` > 0 gives every activation a leading lane axis of that size
    (the population forward). Returns f32 logits (..., B, T, V).

    ``jit_norms``: each norm after a residual add reads the float32 sum,
    as the reference's jitted forward does (``cm.add_rms_norm``); False
    reads the rounded bf16 sum, as its op-by-op calibration does."""
    x = tfm.embed_tokens(params, cfg, tokens)
    if lanes:
        x = x.expand((lanes,) + tuple(x.shape))
    y = None                          # the block output still to be added

    def add_norm(x, y, w):
        if y is None:
            return x, cm.rms_norm(x, w, cfg.norm_eps)
        if jit_norms:
            return cm.add_rms_norm(x, y, w, cfg.norm_eps)
        x = x + y
        return x, cm.rms_norm(x, w, cfg.norm_eps)

    def layer(name, block):
        """(block params, mm, rec) of searchable layer ``name``."""
        if layer_mxv is None:
            p = {**block, **get_w(name)}
            return p, xlstm.dense_mm(p), None
        return (block,) + tuple(layer_mxv(name))

    for g in range(cfg.n_layers // 2):
        bp = xlstm.pair(params, g)
        m, s = f"m{g}", f"s{g}"
        x, xin = add_norm(x, y, bp["norm_m"])
        p, mm, _ = layer(m, bp["mlstm"])
        y = xlstm.mlstm_fwd(p, cfg, q_act(m, xin), mm=mm)
        x, xin = add_norm(x, y, bp["norm_s"])
        p, mm, rec = layer(s, bp["slstm"])
        y = xlstm.slstm_fwd(p, cfg, q_act(s, xin), mm=mm, rec=rec)
    _, xin = add_norm(x, y, params["final_norm"])
    xq = q_act("head", xin)
    _, mm, _ = layer("head", {"lm_head": params["lm_head"]})
    return mm("lm_head", xq, f32=True)


def forward_plain(params, cfg: ArchConfig, tokens):
    """Full-precision forward (identity hooks): the baseline path."""
    return forward(params, cfg, tokens,
                   lambda name: _layer_leaves(params, cfg, name),
                   lambda name, x: x)


@torch.no_grad()
def forward_population(params, cfg: ArchConfig, tokens, qp_stack,
                       banks=None, use_kernel: Optional[bool] = None):
    """Score P quantization candidates in one forward. ``qp_stack``: (P, L,
    6) float32 on the model's device, each lane's (w_scale, w_lo, w_hi,
    a_scale, a_lo, a_hi) grid per layer in ``quant_layer_names`` order;
    ``tokens`` (B, T) shared by every lane. Returns f32 logits
    (P, B, T, V).

    With ``banks`` (``XLSTMTarget.make_banks`` of the same params) each
    lane reads its leaves' bank rows by ``menu_index_from_hi(w_hi)``;
    without, every lane fake-quantizes its leaves (pure grid values, the
    bank rows' expression). ``use_kernel`` (default: True on a CUDA
    device) runs every MxV through ``kernels.ops.bank_mxv_pop``;
    ``use_kernel=False`` is the plain lane (``bank_mxv_pop_ref``), for the
    CPU and the card's cross-check. An MxV's input is widened to a
    contiguous f32 (P, M, m) and its output cast back to the dtype the
    reference has there: bf16 after ``cm.dense``, f32 for ``wx``, ``r``
    and the head."""
    if use_kernel is None:
        use_kernel = tokens.device.type == "cuda"
    mxv = kops.bank_mxv_pop if use_kernel else kref.bank_mxv_pop_ref
    names = quant_layer_names(cfg)
    li = {n: i for i, n in enumerate(names)}
    P, H = qp_stack.shape[0], cfg.n_heads
    dev = qp_stack.device
    lane_ids = torch.arange(P, dtype=torch.int32, device=dev)
    w_idx = (Q.menu_index_from_hi(qp_stack[:, :, 2])
             if banks is not None else None)                     # (P, L)

    def lane_grid(name, col, ndim):
        return qp_stack[:, li[name], col].reshape((P,) + (1,) * (ndim - 1))

    def q_act(name, x):                       # per-lane activation grids
        return Q.fake_quant_triple(x, *(lane_grid(name, c, x.ndim)
                                        for c in (3, 4, 5)))

    def bank_of(name, key):
        """The leaf's f32 bank and each lane's row in it."""
        if banks is not None:
            return banks[name][key], w_idx[:, li[name]].contiguous()
        w = _layer_leaves(params, cfg, name)[key]
        rows = Q.fake_quant_triple(w[None], *(lane_grid(name, c, w.ndim + 1)
                                              for c in (0, 1, 2)),
                                   use_ste=False)
        return rows.to(torch.float32), lane_ids

    def layer_mxv(name):
        def mm(key, x, f32=False):
            bank, idx = bank_of(name, key)
            x2 = x.reshape(P, -1, x.shape[-1]).to(torch.float32).contiguous()
            out = mxv(x2, bank, idx).reshape(x.shape[:-1] + bank.shape[-1:])
            return out if f32 else out.to(x.dtype)

        if name[0] != "s":
            return mm, None
        bank, idx = bank_of(name, "r")                # (K, H, dh, 4 dh)
        K, _, dh, n4 = bank.shape
        r_bank = bank.reshape(K * H, dh, n4)
        r_idx = (idx[:, None] * H + torch.arange(
            H, dtype=torch.int32, device=dev)).reshape(-1).contiguous()

        def rec(h):                                   # (P * B, H, dh) f32
            hb = h.reshape(P, -1, H, dh).transpose(1, 2).reshape(
                P * H, -1, dh).contiguous()
            out = mxv(hb, r_bank, r_idx)              # (P * H, B, 4 dh)
            return out.reshape(P, H, -1, n4).transpose(1, 2).reshape(
                -1, H, n4)
        return mm, rec

    return forward(params, cfg, tokens, None, q_act, layer_mxv=layer_mxv,
                   lanes=P)


def calibrate(params, cfg: ArchConfig, token_batches) -> Dict[str, float]:
    """Expected block-input activation ranges = median of per-batch
    max-abs (the paper's calibration recipe)."""
    cal = Q.ActRangeCalibrator()

    def q_act(name, x):
        cal.observe(name, x)
        return x

    with torch.no_grad():           # the reference calibrates op by op
        for toks in token_batches:
            forward(params, cfg, toks,
                    lambda name: _layer_leaves(params, cfg, name), q_act,
                    jit_norms=False)
    return cal.expected_ranges()


def weight_grids(params, cfg: ArchConfig):
    """(wclips, wranges): per-(layer, bits) MMSE clips pooled over the
    block's matrices, and per-layer max |w| for the 16-bit rows. On a
    card the MMSE search runs on the device (``Q.mmse_clip``)."""
    wclips: Dict[Tuple[str, int], float] = {}
    wranges: Dict[str, float] = {}
    for name in quant_layer_names(cfg):
        leaves = _layer_leaves(params, cfg, name)
        flat = torch.cat([v.detach().to(torch.float32).flatten()
                          for v in leaves.values()])
        if flat.device.type != "cuda":
            flat = flat.numpy()          # the reference's host search
        wranges[name] = float(abs(flat).max())
        for bits in (2, 4, 8):
            wclips[(name, bits)] = Q.mmse_clip(flat, bits)
    return wclips, wranges


@dataclass
class XLSTMTarget:
    """``SearchTarget`` over a trained and calibrated registry xLSTM.
    ``val_subsets``/``test_batches``: lists of (tokens (B, T), next-token
    labels (B, T)) int64 tensors on the params' device."""
    cfg: ArchConfig
    params: dict
    val_subsets: list               # 4 x (tokens, next-token labels)
    test_batches: list
    act_ranges: Dict[str, float]
    wclips: Dict[Tuple[str, int], float]
    wranges: Dict[str, float]
    baseline_val_error: float = 0.0
    baseline_test_error: float = 0.0

    supports_retrain = True            # SearchTarget: beacons available

    def __post_init__(self):
        self.shared_error_memo: Dict[tuple, float] = {}
        self._evaluators: Dict[tuple, batched_eval.PopulationEvaluator] = {}
        self._bank_cache: Dict[int, tuple] = {}     # shared by evaluators
        self._qp_tables = None

    # ---- search-space description ----

    @property
    def layer_names(self) -> Tuple[str, ...]:
        return quant_layer_names(self.cfg)

    @property
    def menu(self) -> Tuple[int, ...]:
        return Q.SUPPORTED_BITS

    # ---- hardware-objective inputs ----

    @property
    def layer_weights(self) -> Dict[str, int]:
        return {name: sum(v.numel() for v in
                          _layer_leaves(self.params, self.cfg, name).values())
                for name in self.layer_names}

    @property
    def layer_macs(self) -> Dict[str, int]:
        """Per-token MACs == matmul weights per layer (each matrix weight
        multiplies once per token, recurrent kernels once per step)."""
        return self.layer_weights

    @property
    def vector_weights(self) -> int:
        """Everything outside the searchable matrices (embedding, norms,
        gate weights, biases): stored at 16 bits, never searched."""
        total = sum(leaf.numel() for leaf in opt.tree_leaves(self.params))
        return total - sum(self.layer_weights.values())

    @property
    def fixed_ops(self) -> int:
        """Max-precision op estimate per token (gating exponentials, norms,
        the mLSTM's activation x activation products): ~32 ops per
        inner-dim element per block. Only shifts the Eq. 4 speedup
        normalization."""
        return 32 * self.cfg.ssm_d_inner * self.cfg.n_layers

    # ---- beacon retraining ----

    def beacon_retrainer(self, retrain_steps: int = 60, *,
                         skip_retrains: int = 0):
        """One retraining context per search: the returned
        ``retrain_fn(alloc, base_params)`` draws successive batches from a
        single seeded token stream, so the k-th retrain of any search sees
        the same data whichever allocation triggered it. ``skip_retrains``
        fast-forwards the stream past the first N retrains (each consumes
        exactly ``retrain_steps`` batches)."""
        from repro_torch.training import qat
        data = synthetic.lm_batches(
            self.cfg.vocab_size, 8, 33, seed=3,
            start_step=skip_retrains * retrain_steps, n_noise=N_NOISE,
            device=self.params["lm_head"].device)

        def retrain_fn(alloc: Alloc, base_params):
            wclips = {n: self.wclips[(n, a[0])]
                      for n, a in alloc.items() if a[0] != 16}
            return qat.retrain_xlstm(base_params, self.cfg, alloc, data,
                                     steps=retrain_steps,
                                     act_ranges=self.act_ranges,
                                     wclips=wclips)
        return retrain_fn

    def retrain(self, alloc: Alloc, base_params=None, *, steps: int = 60):
        """One-off binary-connect retrain under ``alloc`` (fresh stream)."""
        base = self.params if base_params is None else base_params
        return self.beacon_retrainer(steps)(alloc, base)

    # ---- quantization-grid plumbing ----

    def qp_for(self, alloc: Alloc):
        qp = {}
        for name, (wb, ab) in alloc.items():
            wtrip = Q.quant_triple(
                wb, self.wclips[(name, wb)] if wb != 16
                else self.wranges[name])
            atrip = Q.quant_triple(ab, self.act_ranges[name])
            qp[name] = tuple(np.float32(v) for v in (wtrip + atrip))
        return qp

    def qp_menu_tables(self):
        if self._qp_tables is None:
            names = self.layer_names
            K = len(Q.SUPPORTED_BITS)
            w_t = np.empty((len(names), K, 3), np.float32)
            a_t = np.empty((len(names), K, 3), np.float32)
            for i, nm in enumerate(names):
                for k, b in enumerate(Q.SUPPORTED_BITS):
                    w_t[i, k] = Q.quant_triple(
                        b, self.wranges[nm] if b == 16
                        else self.wclips[(nm, b)])
                    a_t[i, k] = Q.quant_triple(b, self.act_ranges[nm])
            self._qp_tables = (w_t, a_t)
        return self._qp_tables

    def make_banks(self, params):
        """Per-layer, per-leaf quantized-weight banks against this target's
        frozen grids: the reference's rows (bf16 for bf16 leaves), held as
        contiguous float32 stacks for the MxV kernel."""
        banks = {}
        for name in self.layer_names:
            trips = Q.menu_triples(
                Q.SUPPORTED_BITS,
                lambda b, _n=name: (self.wranges[_n] if b == 16
                                    else self.wclips[(_n, b)]))
            banks[name] = {
                k: Q.build_weight_bank(w, trips).to(torch.float32).contiguous()
                for k, w in _layer_leaves(params, self.cfg, name).items()}
        return banks

    # ---- error evaluation ----

    def batched_evaluator(self, use_banks: bool = True,
                          use_kernel: Optional[bool] = None, mesh=None,
                          partition: str = "shard_map"
                          ) -> batched_eval.PopulationEvaluator:
        """Lazily built population evaluator, one per (banks, lane, mesh,
        partition). ``use_kernel`` defaults to the kernel lane on a card;
        ``mesh`` shards the population (``distributed/pop_sharding.py``)."""
        key = (use_banks, use_kernel, mesh,
               partition if mesh is not None else "")
        if key not in self._evaluators:
            cfg = self.cfg

            def forward_pop(params, tokens, qp_stack, banks):
                return forward_population(params, cfg, tokens, qp_stack,
                                          banks=banks, use_kernel=use_kernel)

            self._evaluators[key] = batched_eval.PopulationEvaluator(
                self.layer_names, self.val_subsets, self.qp_for,
                forward_pop, mesh=mesh, partition=partition,
                make_banks=self.make_banks, use_banks=use_banks,
                qp_tables=self.qp_menu_tables(),
                bank_cache_size=BANK_CACHE_SIZE, bank_cache=self._bank_cache)
        return self._evaluators[key]

    def val_error_batch(self, allocs, params=None, *, use_banks: bool = True,
                        use_kernel: Optional[bool] = None, mesh=None,
                        partition: str = "shard_map") -> List[float]:
        """Max-over-subsets next-token error % for every allocation in one
        dispatch (buckets, folding, banks); ``mesh`` shards it."""
        params = self.params if params is None else params
        return self.batched_evaluator(use_banks, use_kernel, mesh=mesh,
                                      partition=partition
                                      ).errors(allocs, params)

    @torch.no_grad()
    def val_error(self, alloc: Optional[Alloc] = None,
                  params=None) -> float:
        params = self.params if params is None else params
        if alloc is not None:
            return self.val_error_batch([alloc], params=params)[0]
        errs = []
        for toks, labels in self.val_subsets:
            logits = forward_plain(params, self.cfg, toks)
            e = int((torch.argmax(logits, -1) != labels).sum())
            errs.append(100.0 * e / labels.numel())
        return max(errs)

    @torch.no_grad()
    def test_error(self, alloc: Optional[Alloc] = None,
                   params=None) -> float:
        params = self.params if params is None else params
        te = tn = 0
        for toks, labels in self.test_batches:
            if alloc is None:
                logits = forward_plain(params, self.cfg, toks)
            else:
                stack = torch.from_numpy(batched_eval.stack_qps(
                    [self.qp_for(alloc)], list(self.layer_names))).to(
                        toks.device)
                logits = forward_population(params, self.cfg, toks,
                                            stack)[0]
            te += int((torch.argmax(logits, -1) != labels).sum())
            tn += labels.numel()
        return 100.0 * te / tn


# ------------------------------------------------------------- training

def _eval_sets(cfg: ArchConfig, batch: int = 2, seq: int = 16,
               n_val: int = 4, n_test: int = 2, device="cuda"):
    """Fixed validation subsets and test batches: (tokens[:-1],
    tokens[1:]) next-token pairs from the seeded bigram stream (no ignored
    positions, so error counts are exact integers over every frame)."""
    def mk(seed, step):
        toks = synthetic.lm_batch(cfg.vocab_size, batch, seq + 1,
                                  seed=seed, step=step, n_noise=N_NOISE,
                                  device=device)["tokens"]
        return toks[:, :-1].contiguous(), toks[:, 1:].contiguous()
    val = [mk(77, i) for i in range(n_val)]
    test = [mk(88, 1000 + i) for i in range(n_test)]
    return val, test


def target_from_params(cfg: ArchConfig, params, *, device="cuda",
                       val_batch: int = 2, val_seq: int = 16) -> XLSTMTarget:
    """``params`` (trained, or restored) calibrated on the validation
    tokens only and wrapped with its evaluation sets (``_eval_sets`` of
    ``val_batch`` x ``val_seq`` tokens) and its full-precision baseline
    errors. Deterministic, so two processes that hold the same params
    build the same target."""
    val, test = _eval_sets(cfg, val_batch, val_seq, device=device)
    act_ranges = calibrate(params, cfg, [t for t, _ in val])
    wclips, wranges = weight_grids(params, cfg)
    target = XLSTMTarget(cfg, params, val, test, act_ranges, wclips, wranges)
    target.baseline_val_error = target.val_error()
    target.baseline_test_error = target.test_error()
    return target


def train_small_xlstm(steps: int = 120, *, cfg: Optional[ArchConfig] = None,
                      batch: int = 8, seq: int = 32, lr: float = 1e-2,
                      schedule: str = "cosine", tf32: bool = False,
                      seed: int = 0, device="cuda", verbose: bool = False,
                      log: Optional[Callable[[int, torch.Tensor], None]] = None,
                      val_batch: int = 2, val_seq: int = 16) -> XLSTMTarget:
    """Train the registry xLSTM (``search_config()`` by default) on the
    synthetic bigram task, calibrate it and wrap it as a ``SearchTarget``:
    AdamW (10 warm-up steps, no weight decay) on ``steps`` batches of
    ``batch`` x ``seq`` tokens; the defaults are the reference's recipe,
    ``schedule`` ("cosine" there, or "constant") the learning rate's. The
    initial weights come from a ``torch.Generator`` seeded with ``seed``
    and the token streams from numpy, so they differ from the reference's.
    ``log(step, loss)`` is called after every step with the loss as a
    0-dim tensor on ``device``; ``verbose`` prints it every 40 steps.

    ``tf32``: on a card, the training steps' float32 products run on TF32
    tensor cores. A bf16 value (8 significant bits) is exact in TF32 (11),
    so the products of bf16 leaves and activations are those of float32;
    the float32 operands (gate and recurrent weights, states, cotangents) are
    rounded to TF32. Calibration and the baseline errors run with the
    caller's setting."""
    cfg = cfg or search_config()
    model = registry.get_model(cfg, device)
    params = model.init(seed)
    ocfg = opt.AdamWConfig(lr=lr, schedule=schedule, warmup_steps=10,
                           total_steps=steps, weight_decay=0.0)
    ostate = opt.init_opt_state(params)
    data = synthetic.lm_batches(cfg.vocab_size, batch, seq, seed=11,
                                n_noise=N_NOISE, device=device)
    flags = torch.backends.cuda.matmul
    caller_tf32 = flags.allow_tf32
    for i in range(steps):
        flags.allow_tf32 = tf32 or caller_tf32
        try:
            params, ostate, loss = opt.adamw_step(ocfg, model.loss, params,
                                                  ostate, next(data))
        finally:
            flags.allow_tf32 = caller_tf32
        if log is not None:
            log(i, loss)
        if verbose and (i + 1) % 40 == 0:
            print(f"  [xlstm-train] step {i + 1}/{steps} "
                  f"loss {float(loss):.3f}")
    return target_from_params(cfg, params, device=device,
                              val_batch=val_batch, val_seq=val_seq)


def xlstm_contract_harness(device="cuda"):
    """Tiny-but-real xLSTM instance for the contract checker (see
    ``repro_torch.core.target_registry``). The reduced xlstm-350m cut to
    two blocks, d_model 16, 2 heads and a vocabulary of 32 keeps every
    model dimension off the checker's activation marker dim (T=3), so
    marker-carrying rounding ops are activation fake-quants and any other
    is a weight requantization the banked lane must not contain. The
    weights are the port's own seeded draw (``init`` at seed 0). The
    banks are f32 only and there is no serving decode step, as in the
    reference: C5 checks ``forward_pop``."""
    from repro_torch.core.target_registry import ContractHarness, MARKER_DIM
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    cfg = dataclasses.replace(get_config("xlstm-350m").reduced(),
                              name="xlstm_contract", n_layers=2,
                              d_model=16, n_heads=2, vocab_size=32)
    params = registry.get_model(cfg, dev).init(0)
    B, T = 2, MARKER_DIM
    toks = torch.from_numpy((np.arange(B * T).reshape(B, T)
                             % cfg.vocab_size).astype(np.int64)).to(dev)
    labels = toks
    names = quant_layer_names(cfg)
    act_ranges = {n: 1.0 for n in names}
    wclips = {(n, b): 0.5 for n in names for b in (2, 4, 8)}
    wranges = {n: 1.0 for n in names}
    target = XLSTMTarget(cfg, params, [(toks, labels)] * 4,
                         [(toks, labels)], act_ranges, wclips, wranges)

    def forward_pop(params, feats, qp_stack, banks=None):
        return forward_population(params, cfg, feats, qp_stack, banks=banks)

    return ContractHarness(
        name="xlstm", target=target, feats=toks, labels=labels,
        layer_names=names, marker_dim=T,
        anchor_path="src/repro_torch/core/xlstm_target.py",
        forward_pop=forward_pop,
        make_evaluator=lambda: target.batched_evaluator(use_banks=True),
        forward_decode=None)
