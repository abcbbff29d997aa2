"""xlstm-350m (arXiv:2405.04517) whole, searched for Bitfusion: its set-up
through the port, and its plain reference.

Set-up makes the weights and the validation tokens on the device from the
configuration's ``model_seed`` (the same model in every run), labels each
position with the full-precision reference's own argmax, and hands them to
the port's ``xlstm_target``: ``calibrate``, ``weight_grids`` and
``XLSTMTarget``. Every generation runs through
``XLSTMTarget.val_error_batch``: the kernel lane with float32 banks, one
``bank_mxv_pop`` launch a product, the sLSTM's recurrent product once a step
and layer.

The reference (``Ref``, ``ref_forward``) is the block-pair LM in plain
PyTorch: alternating mLSTM (the stabilised parallel form, one chunk of up to
128 tokens) and sLSTM (a loop over the steps), bf16 activations between the
blocks as the configuration states, every product of exact float32 sums
(TF32 off) or, for the control, of operands in a lower ``Precision``. A
quantized 24-block stack amplifies a last-bit difference into a different
grid step and so into different logits, whichever side is right; so the
reference follows the program from block to block: each block of the
reference runs on the input it forms itself (residual adds, norms,
activation grids) from the program's previous block outputs, and is compared
with the program's block. The program's calibration forward is followed and
compared the same way, and the reference takes its activation ranges from
the block inputs it formed there. The ranges of the reference's own
full-precision forward are compared with the program's as well: a
last-bit difference moves those of the later blocks by some percent on
either side, so that comparison has a limit of its own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

import refquant as RQ
from yardstick import bank_mxv_cost

BF16 = torch.bfloat16
QUANT_LEAVES = {"m": ("wq", "wk", "wv", "wz", "wo"), "s": ("wx", "r", "wo")}


# ------------------------------------------------------------- the model

def dims(spec) -> dict:
    D, H = spec["d_model"], spec["n_heads"]
    di = spec["ssm_expand"] * D
    vp = -(-spec["vocab_size"] // 256) * 256
    return {"D": D, "H": H, "di": di, "dh": di // H, "G": spec["n_layers"] // 2,
            "V": vp}


def layer_names(spec) -> List[str]:
    names = []
    for g in range(dims(spec)["G"]):
        names += [f"m{g}", f"s{g}"]
    return names + ["head"]


def leaf_shapes(spec) -> Dict[str, Dict[str, tuple]]:
    d = dims(spec)
    D, H, di, dh = d["D"], d["H"], d["di"], d["dh"]
    out = {}
    for name in layer_names(spec):
        if name == "head":
            out[name] = {"lm_head": (D, d["V"])}
        elif name[0] == "m":
            out[name] = {"wq": (D, di), "wk": (D, di), "wv": (D, di),
                         "wz": (D, di), "wo": (di, D)}
        else:
            out[name] = {"wx": (D, 4 * di), "r": (H, dh, 4 * dh),
                         "wo": (di, D)}
    return out


def layer_weights(spec) -> Dict[str, int]:
    """Matmul weights of each searchable layer, which are its MACs a token
    (the recurrent kernel multiplies once a step)."""
    return {n: sum(math.prod(s) for s in leaves.values())
            for n, leaves in leaf_shapes(spec).items()}


def make_params(spec, seed: int, device) -> dict:
    """Weights from the seed, on the device, in one draw, in the port's
    layout (the G block pairs stacked): matrices ~ N(0, 1/fan_in) in bf16
    (the recurrent kernel and the gate weights float32), norms 1 + N(0,
    0.01), forget biases 3 + N(0, 0.01), other biases N(0, 0.01)."""
    d = dims(spec)
    D, H, di, dh, G, V = d["D"], d["H"], d["di"], d["dh"], d["G"], d["V"]
    sD, si, sh = 1 / math.sqrt(D), 1 / math.sqrt(di), 1 / math.sqrt(dh)
    plan = [  # (path, shape, scale, shift, dtype)
        (("embed",), (V, D), sD, 0.0, BF16),
        (("pairs", "norm_m"), (G, D), 0.1, 1.0, torch.float32),
        (("pairs", "mlstm", "wq"), (G, D, di), sD, 0.0, BF16),
        (("pairs", "mlstm", "wk"), (G, D, di), sD, 0.0, BF16),
        (("pairs", "mlstm", "wv"), (G, D, di), sD, 0.0, BF16),
        (("pairs", "mlstm", "wi"), (G, D, H), sD, 0.0, torch.float32),
        (("pairs", "mlstm", "wf"), (G, D, H), sD, 0.0, torch.float32),
        (("pairs", "mlstm", "fbias"), (G, H), 0.1, 3.0, torch.float32),
        (("pairs", "mlstm", "wz"), (G, D, di), sD, 0.0, BF16),
        (("pairs", "mlstm", "wo"), (G, di, D), si, 0.0, BF16),
        (("pairs", "norm_s"), (G, D), 0.1, 1.0, torch.float32),
        (("pairs", "slstm", "wx"), (G, D, 4 * di), sD, 0.0, BF16),
        (("pairs", "slstm", "r"), (G, H, dh, 4 * dh), sh, 0.0,
         torch.float32),
        (("pairs", "slstm", "bias"), (G, 4 * di), 0.1, 0.0, torch.float32),
        (("pairs", "slstm", "wo"), (G, di, D), si, 0.0, BF16),
        (("final_norm",), (D,), 0.1, 1.0, torch.float32),
        (("lm_head",), (D, V), sD, 0.0, BF16),
    ]
    g = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for _, s, _, _, _ in plan)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    params: dict = {}
    off = 0
    for path, shape, scale, shift, dtype in plan:
        k = math.prod(shape)
        t = flat[off:off + k].reshape(shape) * scale + shift
        node = params
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = t.to(dtype).contiguous()
        off += k
    return params


def make_tokens(spec, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed + 1)
    n = spec["val_subsets"] * spec["sequences_per_subset"]
    return torch.randint(0, spec["vocab_size"], (n, spec["tokens"]),
                         generator=g, device=device, dtype=torch.int64)


def leaves_of(params, name) -> Dict[str, torch.Tensor]:
    if name == "head":
        return {"lm_head": params["lm_head"]}
    g = int(name[1:])
    sub = params["pairs"]["mlstm" if name[0] == "m" else "slstm"]
    return {k: sub[k][g] for k in QUANT_LEAVES[name[0]]}


# ------------------------------------------------------------- reference

def _rms_norm(x, w, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def _add_norm(x, y, w, eps, fused: bool):
    """The residual add and the next norm: ``fused`` reads the float32 sum
    (keeping the bf16-rounded sum as the residual), else the rounded sum."""
    if y is None:
        return x, _rms_norm(x, w, eps)
    if fused:
        h = x.float() + y.float()
        return h.to(x.dtype), _rms_norm(h, w, eps).to(x.dtype)
    x = x + y
    return x, _rms_norm(x, w, eps)


def _silu(x):
    return x * (1.0 / (1.0 + torch.exp(-x)))


class Ref:
    """The reference's blocks for L lanes on the rows of ``tokens`` (B, T):
    ``trips`` {layer: (w_trips (L, 3), a_trips (L, 3))} gives each lane's
    weight and activation grids, or None for the full-precision model (one
    lane). ``prec``: the arithmetic of the products."""

    def __init__(self, spec, params, trips, prec, B: int, T: int):
        self.spec, self.params, self.trips, self.prec = spec, params, trips, prec
        self.d = dims(spec)
        self.quant = trips is not None
        self.L = len(next(iter(trips.values()))[0]) if self.quant else 1
        self.B, self.T = B, T
        self.dev = params["lm_head"].device
        if T > 128:
            raise ValueError("the reference's mLSTM is one chunk of <= 128")

    def _grid(self, arr, col, ndim):
        t = torch.as_tensor(arr[:, col], dtype=torch.float32, device=self.dev)
        return t.reshape((self.L,) + (1,) * (ndim - 1))

    def q_act(self, name, x):
        if not self.quant:
            return x
        a = self.trips[name][1]
        return RQ.fake_quant(x, *(self._grid(a, c, x.ndim) for c in range(3)))

    def weight(self, name, w):
        """(L, *w.shape) float32: each lane's quantized weight."""
        if not self.quant:
            return w.float()[None]
        wt = self.trips[name][0]
        return RQ.fake_quant(w[None], *(self._grid(wt, c, w.ndim + 1)
                                        for c in range(3)), ste=False).float()

    def mm(self, name, w, x, f32=False):
        wl = self.weight(name, w)
        out = self.prec.mm(x.reshape(self.L, -1, x.shape[-1]).float(), wl)
        out = out.reshape(x.shape[:-1] + (wl.shape[-1],))
        return out if f32 else out.to(x.dtype)

    def embed(self, tokens):
        x = self.params["embed"][tokens].to(BF16)
        return x[None].expand((self.L,) + tuple(x.shape))

    def mlstm(self, g, x):
        """The mLSTM block of pair g on its (quantized) input x (L, B, T, D)."""
        name, prec = f"m{g}", self.prec
        D, H, di, dh = (self.d[k] for k in ("D", "H", "di", "dh"))
        L, B, T = self.L, self.B, self.T
        p = {k: v[g] for k, v in self.params["pairs"]["mlstm"].items()}
        q, k, v = (self.mm(name, p[key], x).reshape(L * B, T, H, dh).float()
                   for key in ("wq", "wk", "wv"))
        xf = x.float().reshape(L, -1, D)
        logi = prec.mm(xf, p["wi"]).reshape(L * B, T, H)
        logf = F.logsigmoid(prec.mm(xf, p["wf"]) + p["fbias"]).reshape(
            L * B, T, H)
        gcs = torch.cumsum(logf, dim=1)
        tq = torch.arange(T, device=self.dev)
        causal = (tq[:, None] >= tq[None, :])[None, :, :, None]
        intra = logi[:, None] + (gcs[:, :, None] - gcs[:, None])
        intra = torch.where(causal, intra, torch.full_like(intra, -1e30))
        m_new = torch.maximum(gcs, intra.max(dim=2).values)
        s = torch.einsum("bthd,bshd->btsh", prec.operand(q),
                         prec.operand(k)) * (1.0 / math.sqrt(dh))
        w = torch.exp(intra - m_new[:, :, None]) * s * causal.float()
        num = torch.einsum("btsh,bshd->bthd", prec.operand(w),
                           prec.operand(v))
        den = w.sum(dim=2)
        y = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
        y = y.reshape(L, B, T, di)
        z = _silu(self.mm(name, p["wz"], x).float())
        return self.mm(name, p["wo"], (y * z).to(x.dtype))

    def slstm(self, g, x):
        """The sLSTM block of pair g: the steps' loop."""
        name, prec = f"s{g}", self.prec
        H, di, dh = (self.d[k] for k in ("H", "di", "dh"))
        L, B, T = self.L, self.B, self.T
        p = {k: v[g] for k, v in self.params["pairs"]["slstm"].items()}
        pre = (self.mm(name, p["wx"], x, f32=True) + p["bias"]).reshape(
            L * B, T, H, dh, 4)
        rl = prec.operand(self.weight(name, p["r"]))        # (L, H, dh, 4dh)
        c = n = h = m = torch.zeros((L * B, H, dh), dtype=torch.float32,
                                    device=self.dev)
        hs = []
        for t in range(T):
            r = torch.einsum("lbhd,lhde->lbhe",
                             prec.operand(h).reshape(L, B, H, dh), rl)
            r = r.reshape(L * B, H, 4, dh).transpose(2, 3)
            gt = pre[:, t] + r
            logi, logf = gt[..., 0], F.logsigmoid(gt[..., 1])
            zt, o = torch.tanh(gt[..., 2]), torch.sigmoid(gt[..., 3])
            m_new = torch.maximum(logf + m, logi)
            i_, f_ = torch.exp(logi - m_new), torch.exp(logf + m - m_new)
            c = f_ * c + i_ * zt
            n = torch.clamp(f_ * n + i_, min=1e-6)
            h = o * (c / n)
            m = m_new
            hs.append(h)
        y = torch.stack(hs, dim=1).reshape(L, B, T, di).to(x.dtype)
        return self.mm(name, p["wo"], y)

    def head(self, x):
        return self.mm("head", self.params["lm_head"], x, f32=True)

    def blocks(self):
        """(name, pair index, norm weight key, block) in the model's order."""
        for g in range(self.d["G"]):
            yield f"m{g}", g, "norm_m", self.mlstm
            yield f"s{g}", g, "norm_s", self.slstm


@torch.no_grad()
def ref_forward(spec, params, tokens, trips, prec, calib=None):
    """Logits (L, B, T, V) float32 of L lanes. With ``trips`` None, the
    full-precision model, whose norms read the rounded residual sums (as an
    op-by-op calibration does); else the lanes', whose norms read the
    float32 sums. ``calib`` receives each block input's max |x|."""
    ref = Ref(spec, params, trips, prec, *tokens.shape)
    eps, pairs = spec["norm_eps"], params["pairs"]
    fused = trips is not None
    x = ref.embed(tokens)
    y = None
    for name, g, norm, block in ref.blocks():
        x, xin = _add_norm(x, y, pairs[norm][g], eps, fused)
        if calib is not None:
            calib.setdefault(name, []).append(float(xin.abs().max()))
        y = block(g, ref.q_act(name, xin))
    _, xin = _add_norm(x, y, params["final_norm"], eps, fused)
    if calib is not None:
        calib.setdefault("head", []).append(float(xin.abs().max()))
    return ref.head(ref.q_act("head", xin))


@torch.no_grad()
def follow(ref, side, tokens, feed, calib=None):
    """The reference ``ref`` along the program's residual stream: each block
    runs on the input the reference forms itself (residual adds, norms,
    activation grids) from ``feed``, the program's block outputs in the
    model's order, and is compared with the program's block (or, with
    ``side``, a reference in another precision, on the same input).
    Returns (the widest ``RQ.part_median`` of a block's output rows, the
    head's quantized input). ``calib`` receives each block input's max
    |x|; the norms read the float32 sums where ``ref`` has lanes, the
    rounded ones for the full-precision model."""
    spec, params = ref.spec, ref.params
    eps, pairs = spec["norm_eps"], params["pairs"]
    x = ref.embed(tokens)
    y = None
    worst = 0.0
    for i, (name, g, norm, block) in enumerate(ref.blocks()):
        x, xin = _add_norm(x, y, pairs[norm][g], eps, ref.quant)
        if calib is not None:
            calib.setdefault(name, []).append(float(xin.abs().max()))
        xq = ref.q_act(name, xin)
        y_ref = block(g, xq)
        if i >= len(feed):
            raise RuntimeError("the program's block outputs were not "
                               "captured")
        y = feed[i].reshape(y_ref.shape)
        y_side = y if side is None else getattr(side, block.__name__)(g, xq)
        worst = max(worst, RQ.part_median(RQ.row_gaps(y_side, y_ref)))
        del y_ref, y_side
    _, xin = _add_norm(x, y, params["final_norm"], eps, ref.quant)
    if calib is not None:
        calib.setdefault("head", []).append(float(xin.abs().max()))
    return worst, ref.q_act("head", xin)


def _median_ranges(calib) -> Dict[str, float]:
    return {k: float(np.median(v)) for k, v in calib.items()}


def ref_ranges(spec, params, cal_batches, prec, feeds=None, side=None):
    """The activation ranges, the median over the calibration batches of
    each block input's max |x|: of the reference's own full-precision
    forward, or with ``feeds`` (one list of the program's block outputs a
    batch) of the block inputs it forms along the program's calibration,
    each block compared as ``follow`` does. Returns (ranges, the widest
    block gap; 0 without ``feeds``)."""
    calib: Dict[str, list] = {}
    worst = 0.0
    for i, toks in enumerate(cal_batches):
        if feeds is None:
            ref_forward(spec, params, toks, None, prec, calib=calib)
            continue
        ref = Ref(spec, params, None, prec, *toks.shape)
        other = (Ref(spec, params, None, side, *toks.shape)
                 if side is not None else None)
        gap, _ = follow(ref, other, toks, feeds[i], calib=calib)
        worst = max(worst, gap)
    return _median_ranges(calib), worst


def ref_weight_grids(spec, params):
    """(wclips, wranges) worked out again: MMSE clips at 2/4/8 bits over a
    layer's matrices pooled, searched in float64 on the device; max
    |w|."""
    clips, wr = {}, {}
    for name in layer_names(spec):
        flat = torch.cat([w.detach().float().flatten()
                          for w in leaves_of(params, name).values()])
        wr[name] = float(flat.abs().max())
        for bits in (2, 4, 8):
            clips[(name, bits)] = (RQ.mmse_clip_f64(flat, bits)
                                   if flat.device.type == "cuda"
                                   else RQ.mmse_clip_host(flat.numpy(), bits))
        del flat
    return clips, wr


# ------------------------------------------------------------- set-up

def port_config(spec):
    """The port's ``ArchConfig`` of the configuration."""
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config("xlstm-350m"), name=spec["name"],
        n_layers=spec["n_layers"], d_model=spec["d_model"],
        n_heads=spec["n_heads"], n_kv_heads=spec["n_heads"],
        vocab_size=spec["vocab_size"], ssm_expand=spec["ssm_expand"],
        slstm_every=spec["slstm_every"], norm_eps=spec["norm_eps"])


class Cell:
    def __init__(self, spec, traffic, seed, dev, steps):
        from repro_torch.core import xlstm_target as XT

        self.spec, self.dev = spec, dev
        self.names = layer_names(spec)
        self.n_subsets = spec["val_subsets"]
        self.subset_rows = spec["sequences_per_subset"]
        cfg = self.cfg = port_config(spec)
        with steps("weights"):
            self.params = make_params(spec, seed, dev)
        with steps("data"):
            self.tokens = make_tokens(spec, seed, dev)
        with steps("reference_labels"):
            logits = ref_forward(spec, self.params, self.tokens, None,
                                 RQ.Precision("f32"))
            self.labels = torch.argmax(logits[0], dim=-1)
            del logits
        B = self.subset_rows
        val = [(self.tokens[s * B:(s + 1) * B].contiguous(),
                self.labels[s * B:(s + 1) * B].contiguous())
               for s in range(self.n_subsets)]
        self.cal_batches = [t for t, _ in val]
        # the program's calibration, its block outputs kept for the
        # reference to follow
        from repro_torch.models import xlstm
        self._xlstm = xlstm
        self.cal_feeds = []
        blocks = {a: getattr(xlstm, a) for a in ("mlstm_fwd", "slstm_fwd")}

        def keep(fn):
            def wrapper(*args, **kw):
                out = fn(*args, **kw)
                self.cal_feeds.append(out.detach().clone())
                return out
            return wrapper
        try:
            for a, fn in blocks.items():
                setattr(xlstm, a, keep(fn))
            with steps("calibration"):
                act = XT.calibrate(self.params, cfg, self.cal_batches)
        finally:
            for a, fn in blocks.items():
                setattr(xlstm, a, fn)
        n_blocks = 2 * dims(spec)["G"]
        self.cal_feeds = [self.cal_feeds[i:i + n_blocks] for i in
                          range(0, len(self.cal_feeds), n_blocks)]
        with steps("clips"):
            wclips, wranges = XT.weight_grids(self.params, cfg)
        target = XT.XLSTMTarget(cfg, self.params, val, val[:1], act, wclips,
                                wranges)
        with steps("baseline_errors"):
            target.baseline_val_error = target.val_error()
        target.make_banks = steps.timed("banks", target.make_banks)
        self.target = target
        self.sram_override = (sum(target.layer_weights.values())
                              + target.vector_weights) * 2
        self.forward_hook = (XT, "forward_population")

    def evaluator(self):
        return self.target.batched_evaluator()

    def window_hooks(self, capture):
        """The block outputs of the kept dispatches' sampled lanes and
        sequences, in the model's order: the program's state that the
        reference follows."""
        def keep(fn):
            def wrapper(*args, **kw):
                out = fn(*args, **kw)
                rec = capture.current
                if rec is not None:
                    lanes = torch.as_tensor(rec["lanes"], device=out.device)
                    rows = torch.as_tensor(rec["rows"], device=out.device)
                    rec.setdefault("blocks", []).append(
                        out.index_select(0, lanes).index_select(1, rows)
                        .clone())
                return out
            return wrapper
        return [(self._xlstm, a, keep(getattr(self._xlstm, a)))
                for a in ("mlstm_fwd", "slstm_fwd")]

    def sample_allocs(self, rng, n):
        out = []
        for _ in range(n):
            bits = rng.choice((2, 4, 8, 16), (len(self.names), 2))
            out.append({nm: (int(b[0]), int(b[1]))
                        for nm, b in zip(self.names, bits)})
        return out

    def work(self, p: int) -> dict:
        """The work one dispatch's ``p`` real lanes need: every product of
        the kernel lane, the recurrent one each step."""
        s, d = self.spec, dims(self.spec)
        D, H, di, dh, G = d["D"], d["H"], d["di"], d["dh"], d["G"]
        N = self.n_subsets * self.subset_rows
        T = s["tokens"]
        M = N * T
        mxv = []
        for _ in range(G):
            mxv += [bank_mxv_cost(p, M, D, di, 4)] * 4
            mxv.append(bank_mxv_cost(p, M, di, D, 4))
            mxv.append(bank_mxv_cost(p, M, D, 4 * di, 4))
            mxv += [bank_mxv_cost(p * H, N, dh, 4 * dh, 4 * H)] * T
            mxv.append(bank_mxv_cost(p, M, di, D, 4))
        mxv.append(bank_mxv_cost(p, M, D, d["V"], 4))
        flops = 2 * sum(layer_weights(s).values()) * M * p
        return {"mxv": mxv, "scan": [], "model_flops": flops}

    def program_outputs(self) -> dict:
        t = self.target
        banks = t.batched_evaluator()._banks_for(t.params)
        return {"grids": (dict(t.act_ranges), dict(t.wclips),
                          dict(t.wranges)),
                "banks": banks}

    def release(self):
        self.target = None


def setup(spec, traffic, seed, dev, steps):
    return Cell(spec, traffic, seed, dev, steps)


# ------------------------------------------------------------- check

@torch.no_grad()
def check(cell, program, dispatches, control=None) -> dict:
    """The numbers compared, the program's (or with ``control``, the
    lower-precision reference's) against the float32 reference's:

    - ``grid_rel``: the activation ranges, MMSE clips and weight ranges
      against the reference's own (its full-precision forward's ranges);
    - ``cal_block_rms``: the program's calibration forward, block by block
      as ``follow`` compares it; ``cal_grid_rel``: its ranges against those
      the reference takes from the block inputs it formed there (the grids
      the lanes below are held to);
    - ``bank_rel``: the float32 banks against the weights quantized on the
      reference's own clips and ranges;
    - ``block_rms``: each block's output on the sampled lanes and sequences
      against the reference's block on the input it forms from the
      previous blocks' outputs; ``logit_part`` (and ``logit_med``,
      ``top_gap``) the same at the head;
    - ``count_gap_pp`` and ``err_gap_pp``: the counts the evaluator reduced
      against those of the argmax of its logits and the fold's labels, and
      the errors the search received against those counts (exact)."""
    spec, params, tokens = cell.spec, cell.params, cell.tokens
    f32 = RQ.Precision("f32")
    ctl = RQ.Precision(control) if control else None
    names = layer_names(spec)
    clips, wr = ref_weight_grids(spec, params)
    own, _ = ref_ranges(spec, params, cell.cal_batches, f32)
    fed, cal_gap = ref_ranges(spec, params, cell.cal_batches, f32,
                              feeds=cell.cal_feeds, side=ctl)
    grids = (fed, clips, wr)
    if ctl is None:
        side_own = side_fed = program["grids"]
    else:
        side_own = (ref_ranges(spec, params, cell.cal_batches, ctl)[0],
                    clips, wr)
        side_fed = grids
    out = {"grid_rel": RQ.grid_gap(side_own, (own, clips, wr)),
           "cal_grid_rel": RQ.grid_gap(side_fed, grids),
           "cal_block_rms": cal_gap}
    gap = 0.0
    for name in names:
        trips = [RQ.quant_triple(b, wr[name] if b == 16 else clips[(name, b)])
                 for b in RQ.MENU]
        for key, w in leaves_of(params, name).items():
            ref = torch.stack([RQ.fake_quant(w, *t, ste=False).float()
                               for t in trips])
            side = (program["banks"][name][key] if ctl is None
                    else ctl.operand(ref))
            gap = max(gap, RQ.max_rel(side, ref))
            del ref, side
    out["bank_rel"] = gap
    program.clear()

    block_rms = count_gap = err_gap = 0.0
    prog_rows, ref_rows = [], []
    for rec in dispatches:
        allocs = rec["allocs"]
        trips = RQ.lane_trips(names, [allocs[i] for i in rec["lanes"]], grids)
        toks = tokens[rec["rows"]]
        ref = Ref(spec, params, trips, f32, *toks.shape)
        side = Ref(spec, params, trips, ctl, *toks.shape) if ctl else None
        worst, xq = follow(ref, side, toks, rec.get("blocks", []))
        block_rms = max(block_rms, worst)
        ref_rows.append(ref.head(xq).cpu())
        prog_rows.append(rec["logits"].cpu() if ctl is None
                         else side.head(xq).cpu())
        cg, eg = RQ.reduction_gaps(allocs, rec["argmax"], cell.labels,
                                   rec["counts"], rec["errors"],
                                   cell.n_subsets)
        count_gap, err_gap = max(count_gap, cg), max(err_gap, eg)
    out["block_rms"] = block_rms
    out["count_gap_pp"] = count_gap
    out["err_gap_pp"] = err_gap
    if prog_rows:
        out.update(RQ.logit_stats(torch.cat([p.flatten(0, 1)
                                             for p in prog_rows]),
                                  torch.cat([r.flatten(0, 1)
                                             for r in ref_rows])))
    return out
