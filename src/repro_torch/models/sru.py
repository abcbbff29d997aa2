"""Simple Recurrent Unit (SRU) speech model — the paper's experimental
model, in PyTorch.

Port of the reference package's ``models/sru.py``. Architecture (paper
Table 4): 4 Bi-SRU layers (n=550 per direction) with 3 projection layers
(p=256) between them, FC to 1904 phone-state posteriors, FBANK input m=23.

SRU cell (paper Eq. 2):
    u_t = W x_t                          (the only MxV — time-parallel)
    f_t = sigma(W_f x_t + v_f . c_{t-1} + b_f)
    r_t = sigma(W_r x_t + v_r . c_{t-1} + b_r)
    c_t = f_t . c_{t-1} + (1 - f_t) . u_t
    h_t = r_t . c_t + (1 - r_t) . x_t    (highway only when m == n)

Params are nested dicts of tensors in the reference's pytree layout
(``params_from_numpy``/``params_to_numpy`` carry them across), and the
public functions keep its layouts: (P, B, T, m) streams and (P, L, 6) qp
stacks. The population forward has a plain lane (PyTorch ops) and a kernel
lane (``kernels/ops.py``: the CUDA kernels on a card, their plain versions
on the CPU); on a CUDA device it takes the kernel lane unless told
otherwise. Training and beacon retraining go through ``forward_train``
(``forward(qspec=)``), a differentiable forward of ``torch.matmul`` and a
time-step loop, as the reference's is ``jnp.einsum`` and ``lax.scan``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import quantization as Q
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

LAYER_NAMES = ("L0", "Pr1", "L1", "Pr2", "L2", "Pr3", "L3", "FC")


def layer_names_for(n_sru_layers: int):
    names = ["L0"]
    for i in range(1, n_sru_layers):
        names += [f"Pr{i}", f"L{i}"]
    return tuple(names + ["FC"])


@dataclass(frozen=True)
class SRUModelConfig:
    name: str = "sru_timit"
    input_dim: int = 23
    hidden: int = 550          # per direction
    proj: int = 256
    n_sru_layers: int = 4
    n_outputs: int = 1904
    family: str = "sru"

    @property
    def bi_out(self) -> int:
        return 2 * self.hidden

    def layer_input_dims(self) -> Dict[str, int]:
        d = {"L0": self.input_dim, "Pr1": self.bi_out, "FC": self.bi_out}
        for i in range(1, self.n_sru_layers):
            d[f"L{i}"] = self.proj
            if i >= 2:
                d[f"Pr{i}"] = self.bi_out
        return d

    def layer_names(self):
        return layer_names_for(self.n_sru_layers)

    def layer_weight_counts(self) -> Dict[str, int]:
        """MxV matrix weights per layer (== MACs per frame), paper Table 4."""
        c = {}
        for name in self.layer_names():
            m = self.layer_input_dims()[name]
            if name.startswith("L"):
                c[name] = 2 * 3 * self.hidden * m          # Bi-SRU: 2 dirs x 3 mats
            elif name.startswith("Pr"):
                c[name] = self.bi_out * self.proj
            else:
                c[name] = self.bi_out * self.n_outputs
        return c

    def vector_weight_count(self) -> int:
        """v_f, v_r + biases per direction per SRU layer (16-bit, unsearched)."""
        return self.n_sru_layers * 2 * 4 * self.hidden

    def total_weights(self) -> int:
        return sum(self.layer_weight_counts().values()) + self.vector_weight_count()

    def model_bytes(self, layer_bits: Optional[Dict[str, int]] = None,
                    base_bits: int = 32) -> float:
        if layer_bits is None:
            return self.total_weights() * base_bits / 8
        bits = Q.compressed_bits(self.layer_weight_counts(), layer_bits,
                                 self.vector_weight_count())
        return bits / 8


# ---------------------------------------------------------------- params

def init_params(generator: torch.Generator, cfg: SRUModelConfig,
                device="cuda") -> Dict:
    """Random params in the reference layout, drawn on the CPU from
    ``generator`` (so a seed gives the same weights on every device) and
    moved to ``device``. The reference draws with ``jax.random``, so the
    values differ from its ``init_params`` at the same seed; carry its
    weights across with ``params_from_numpy`` instead."""
    dev = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    p: Dict = {}
    dims = cfg.layer_input_dims()
    for name in cfg.layer_names():
        m = dims[name]
        s = 1.0 / math.sqrt(m)
        if name.startswith("L"):
            n = cfg.hidden
            p[name] = {d: {"W": normal(m, 3 * n) * s,
                           "v": normal(2, n) * 0.1,
                           "b": torch.zeros((2, n), dtype=torch.float32)}
                       for d in ("fwd", "bwd")}
        elif name.startswith("Pr"):
            p[name] = {"W": normal(m, cfg.proj) * s}
        else:
            p[name] = {"W": normal(m, cfg.n_outputs) * s,
                       "b": torch.zeros((cfg.n_outputs,), dtype=torch.float32)}
    return _tree_map(lambda t: t.to(dev), p)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree, device="cuda") -> Dict:
    """The reference's param pytree (nested dicts of arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's tensors."""
    dev = resolve_device(device)
    return _tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)


def params_to_numpy(tree) -> Dict:
    """Inverse of ``params_from_numpy``: nested dicts of numpy arrays."""
    return _tree_map(lambda t: t.detach().cpu().numpy(), tree)


# ---------------------------------------------------------------- forward

def _mxv(x, w):
    """x (..., m) @ w (m, N) as one bank MxV with P = 1
    (``kernels.ops.bank_mxv_pop``: the kernel on a card, ``torch.bmm`` on
    the CPU), so each output sums in the order the population lanes use
    and a served chunk equals the scalar forward on it bitwise. A library
    matmul would sum in another order (on the CPU ``torch.matmul`` does
    already), and a last-bit difference before an activation grid can move
    a value one grid step."""
    idx = torch.zeros((1,), dtype=torch.int32, device=x.device)
    out = kops.bank_mxv_pop(x.reshape(1, -1, x.shape[-1]).contiguous(),
                            w[None].contiguous(), idx)
    return out.reshape(x.shape[:-1] + (w.shape[-1],))


def _sru_dir(dp, w, x, *, reverse: bool, quant16_vectors: bool):
    """One SRU direction with MxV weight ``w``. x: (B, T, m) -> (B, T, n).
    The recurrence runs through ``kernels.ops.sru_scan`` (the CUDA kernel
    with P = 1 on a card, its plain version on the CPU)."""
    n = dp["v"].shape[1]
    v, b = dp["v"], dp["b"]
    if quant16_vectors:
        v = Q.fixed_point_16(v)
        b = Q.fixed_point_16(b)
    u = _mxv(x, w)                                            # (B,T,3n)
    if reverse:
        u = u.flip(1)
    h, r, _ = kops.sru_scan(u[..., :n], u[..., n:2 * n], u[..., 2 * n:],
                            v[0], v[1], b[0], b[1])
    if x.shape[-1] == n:                                      # highway skip
        xx = x.flip(1) if reverse else x
        h = h + (1.0 - r) * xx
    if reverse:
        h = h.flip(1)
    return h


def quant_triples_for(alloc, wclips: Dict[Tuple[str, int], float],
                      act_ranges: Dict[str, float],
                      wranges: Dict[str, float]):
    """The dynamic quantization-parameter dict for ``forward(qp=)``:
    {name: 6 float32} — scale/lo/hi of the weight grid and activation grid.
    Host numpy, per candidate."""
    qp = {}
    for name, (wb, ab) in alloc.items():
        wtrip = Q.quant_triple(
            wb, wclips[(name, wb)] if wb != 16 else wranges[name])
        atrip = Q.quant_triple(ab, act_ranges[name])
        qp[name] = tuple(np.float32(v) for v in (wtrip + atrip))
    return qp


def build_weight_banks(params, cfg: SRUModelConfig,
                       wclips: Dict[Tuple[str, int], float],
                       wranges: Dict[str, float],
                       menu: Tuple[int, ...] = Q.SUPPORTED_BITS,
                       packed: bool = False):
    """Quantized-weight banks for a parameter set: a tree mirroring
    ``params`` in which each MxV weight is a (|menu|, m, h) stack whose row
    k is the weight on menu entry k's frozen grid (``packed=True``: the
    packed-integer containers instead), and the 16-bit recurrent vectors
    and biases are quantized once alongside."""
    def build(w, t):
        if packed:
            return Q.build_packed_weight_bank(w, t, menu)
        return Q.build_weight_bank(w, t)

    banks: Dict = {}
    for name in cfg.layer_names():
        trips = Q.menu_triples(
            menu, lambda b: wranges[name] if b == 16 else wclips[(name, b)])
        if name.startswith("L"):
            banks[name] = {
                d: {"W": build(params[name][d]["W"], trips),
                    "v": Q.fixed_point_16(params[name][d]["v"]),
                    "b": Q.fixed_point_16(params[name][d]["b"])}
                for d in ("fwd", "bwd")}
        else:
            banks[name] = {"W": build(params[name]["W"], trips)}
    return banks


def weight_ranges(params, cfg: SRUModelConfig) -> Dict[str, float]:
    out = {}
    for name in cfg.layer_names():
        if name.startswith("L"):
            w = max(float(torch.max(torch.abs(params[name]["fwd"]["W"]))),
                    float(torch.max(torch.abs(params[name]["bwd"]["W"]))))
        else:
            w = float(torch.max(torch.abs(params[name]["W"])))
        out[name] = w
    return out


def forward(params, cfg: SRUModelConfig, feats,
            calibrator: Optional[Q.ActRangeCalibrator] = None,
            qp: Optional[Dict[str, tuple]] = None,
            qspec: Optional[Dict[str, Tuple[int, int]]] = None,
            wclips: Optional[Dict[str, float]] = None,
            act_ranges: Optional[Dict[str, float]] = None):
    """feats: (B, T, input_dim) -> logits (B, T, n_outputs).

    Two quantization entry points, as in the reference:
    - ``qp[name] = (w_scale, w_lo, w_hi, a_scale, a_lo, a_hi)``: dynamic
      grids for each quantized layer, the evaluation path (no gradients,
      the kernels on a card). MxV inputs are fake-quantized (with the STE
      expression, as in the reference), MxV weights are pure grid values,
      recurrent vectors/biases 16-bit fixed point. ``calibrator``
      observes each MxV input once.
    - ``qspec[name] = (w_bits, a_bits)``: static bits, the differentiable
      path that retrains beacons (``forward_train``, with ``wclips`` and
      ``act_ranges``)."""
    if qspec is not None:
        if qp is not None or calibrator is not None:
            raise ValueError("qspec (the training path) takes neither qp "
                             "nor a calibrator")
        return forward_train(params, cfg, feats, qspec=qspec, wclips=wclips,
                             act_ranges=act_ranges)
    return _forward_eval(params, cfg, feats, calibrator, qp)


@torch.no_grad()
def _forward_eval(params, cfg: SRUModelConfig, feats, calibrator, qp):
    """The evaluation forward: MxVs on ``_mxv`` (``bank_mxv_pop``, P = 1)
    and the recurrence on ``kernels.ops.sru_scan``."""
    quantized = qp is not None

    def prep_w(name, w):
        if qp is not None and name in qp:
            ws, wl, wh = qp[name][:3]
            return Q.fake_quant_triple(w, ws, wl, wh, use_ste=False)
        return w

    def prep_x(name, x):
        if calibrator is not None:
            calibrator.observe(name, x)
        if qp is not None and name in qp:
            as_, al, ah = qp[name][3:]
            return Q.fake_quant_triple(x, as_, al, ah)
        return x

    x = feats
    for i in range(cfg.n_sru_layers):
        name = f"L{i}"
        lp = params[name]
        xq = prep_x(name, x)
        fw = _sru_dir(lp["fwd"], prep_w(name, lp["fwd"]["W"]), xq,
                      reverse=False, quant16_vectors=quantized)
        bw = _sru_dir(lp["bwd"], prep_w(name, lp["bwd"]["W"]), xq,
                      reverse=True, quant16_vectors=quantized)
        x = torch.cat([fw, bw], dim=-1)                       # (B,T,2n)
        if i < cfg.n_sru_layers - 1:
            pname = f"Pr{i + 1}"
            x = _mxv(prep_x(pname, x), prep_w(pname, params[pname]["W"]))
    xq = prep_x("FC", x)
    return _mxv(xq, prep_w("FC", params["FC"]["W"])) + params["FC"]["b"]


def _bi_sru_train(lp, w_fwd, w_bwd, x, *, quant16_vectors: bool):
    """Both directions of one Bi-SRU layer, differentiable. x: (B, T, m) ->
    (B, T, 2n). The recurrence is the reference's ``lax.scan`` body as a
    loop over time steps that autograd differentiates, with the two
    directions stacked so that a step is one set of elementwise ops (the
    backward direction runs on time-reversed streams). Its products are
    ``torch.matmul``, as the reference's are ``jnp.einsum``."""
    n = lp["fwd"]["v"].shape[1]
    B, T = x.shape[:2]
    vs, bs = [], []
    for key in ("fwd", "bwd"):
        v, b = lp[key]["v"], lp[key]["b"]
        if quant16_vectors:                   # no STE: zero gradient
            v, b = Q.fixed_point_16(v), Q.fixed_point_16(b)
        vs.append(v)
        bs.append(b)
    v = torch.stack(vs)[:, None]                          # (2, 1, 2, n)
    b = torch.stack(bs)[:, None]
    u = torch.stack([torch.matmul(x, w_fwd),
                     torch.matmul(x, w_bwd).flip(1)])     # (2, B, T, 3n)
    u = u.reshape(2, B, T, 3, n)                          # u_w, u_f, u_r
    c = u.new_zeros((2, B, n))
    hs, rs = [], []
    for t in range(T):
        ut = u[:, :, t]
        g = torch.sigmoid(ut[:, :, 1:] + v * c[:, :, None] + b)   # f, r
        f, r = g[:, :, 0], g[:, :, 1]
        c = f * c + (1.0 - f) * ut[:, :, 0]
        hs.append(r * c)
        rs.append(r)
    h = torch.stack(hs, dim=2)                            # (2, B, T, n)
    if x.shape[-1] == n:                                  # highway skip
        h = h + (1.0 - torch.stack(rs, dim=2)) * torch.stack([x, x.flip(1)])
    return torch.cat([h[0], h[1].flip(1)], dim=-1)


def forward_train(params, cfg: SRUModelConfig, feats,
                  qspec: Optional[Dict[str, Tuple[int, int]]] = None,
                  wclips: Optional[Dict[str, float]] = None,
                  act_ranges: Optional[Dict[str, float]] = None):
    """The differentiable forward of training and beacon retraining (the
    reference's ``forward`` without ``qp``). feats: (B, T, input_dim) ->
    logits (B, T, n_outputs).

    ``qspec=None``: full precision. ``qspec[name] = (w_bits, a_bits)``:
    binary-connect quantization of the listed layers — MxV weights through
    ``ste_quantize_weight`` at ``wclips[name]`` (the MMSE clip if missing),
    MxV inputs through ``quantize_activation`` at ``act_ranges[name]``
    (the input's max |x| if missing), and every recurrent vector and bias
    16-bit fixed point without STE, so their gradients are zero and
    retraining leaves them as they are."""
    quantized = qspec is not None
    wclips = wclips or {}
    act_ranges = act_ranges or {}

    def prep_w(name, w):
        if quantized and name in qspec:
            bits = qspec[name][0]
            clip = wclips.get(name)
            if clip is None and bits != 16:
                clip = Q.mmse_clip(w, bits)
            return Q.ste_quantize_weight(w, bits, clip)
        return w

    def prep_x(name, x):
        if quantized and name in qspec:
            rng = act_ranges.get(name)
            if rng is None:
                rng = float(torch.max(torch.abs(x)))
            return Q.quantize_activation(x, qspec[name][1], rng)
        return x

    x = feats
    for i in range(cfg.n_sru_layers):
        name = f"L{i}"
        lp = params[name]
        x = _bi_sru_train(lp, prep_w(name, lp["fwd"]["W"]),
                          prep_w(name, lp["bwd"]["W"]), prep_x(name, x),
                          quant16_vectors=quantized)
        if i < cfg.n_sru_layers - 1:
            pname = f"Pr{i + 1}"
            x = torch.matmul(prep_x(pname, x),
                             prep_w(pname, params[pname]["W"]))
    return (torch.matmul(prep_x("FC", x), prep_w("FC", params["FC"]["W"]))
            + params["FC"]["b"])

def extend_banks_u0(banks, cfg: SRUModelConfig, feats, a_trips,
                    use_kernel: Optional[bool] = None):
    """Add the input-layer u-bank to an f32 bank tree.

    L0's MxV input is ``fake_quant(feats, a_grid)`` with ``feats`` the
    evaluator's frozen validation fold, and both the activation grid and
    the weight are one of |menu| entries. So L0's product takes at most
    |menu|^2 values per direction: precompute them all ((Ka*Kw, B, T, 3n)
    per direction, row ``a*Kw + w``), and each generation's dispatch
    gathers L0's u streams instead of running P quantize passes and P
    MxVs. ``a_trips``: (Ka, 3) float32 activation triples of L0 in menu
    order. The rows are computed by the same MxV as the forward's lane
    (``use_kernel``, default: the kernel on a card), so a gathered row
    equals what that lane would compute. Only valid when the L0 highway
    skip is inactive (``input_dim != hidden``)."""
    if cfg.input_dim == cfg.hidden:
        raise ValueError("u0 bank invalid under the L0 highway skip "
                         "(input_dim == hidden)")
    if use_kernel is None:
        use_kernel = feats.device.type == "cuda"
    mxv = kops.bank_mxv_pop if use_kernel else kref.bank_mxv_pop_ref
    a_trips = np.asarray(a_trips, np.float32)
    out = dict(banks)
    out["L0"] = {key: dict(banks["L0"][key]) for key in ("fwd", "bwd")}
    B, T, m = feats.shape
    with torch.no_grad():
        xq = torch.stack([Q.fake_quant_triple(feats, t[0], t[1], t[2])
                          .reshape(B * T, m) for t in a_trips])   # (Ka,BT,m)
        for key in ("fwd", "bwd"):
            w = banks["L0"][key]["W"]
            if isinstance(w, dict):
                raise ValueError("the u0 bank needs the f32 bank format")
            kw = w.shape[0]
            ka = len(a_trips)
            x = xq.repeat_interleave(kw, dim=0).contiguous()      # row a*kw+w
            widx = torch.arange(kw, dtype=torch.int32,
                                device=w.device).repeat(ka)
            u = mxv(x, w, widx)                                   # (Ka*Kw,BT,3n)
            out["L0"][key]["U"] = u.reshape(ka * kw, B, T, u.shape[-1])
    return out


@torch.no_grad()
def forward_population(params, cfg: SRUModelConfig, feats, qp_stack,
                       banks=None, use_kernel: Optional[bool] = None):
    """Score P quantization candidates in one forward.

    ``qp_stack``: (P, L, 6) float32 tensor on the model's device — each
    lane's (w_scale, w_lo, w_hi, a_scale, a_lo, a_hi) grid per layer in
    ``cfg.layer_names()`` order. ``feats``: (B, T, m) shared by every lane,
    or (P, B, T, m) one input per lane. Returns logits (P, B, T, n_out).

    ``banks`` (from ``build_weight_banks`` for the same ``params``, f32 or
    packed): each lane's weights come from bank row
    ``menu_index_from_hi(w_hi)``, computed from the qp stack on its device;
    without banks every lane requantizes its weights. An f32 tree extended
    by ``extend_banks_u0`` serves L0 from the u-bank.

    ``use_kernel`` (default: True on a CUDA device): the MxVs run through
    ``kernels.ops.bank_step`` and the recurrences through
    ``kernels.ops.sru_scan_pop``. ``use_kernel=False`` is the plain lane
    (``torch.bmm`` and the plain scan), for the CPU, the tests and the
    card's cross-check. On the CPU both lanes compute the same thing, since
    the wrappers run the plain versions there."""
    if use_kernel is None:
        use_kernel = feats.device.type == "cuda"
    mxv_step = kops.bank_step if use_kernel else kref.bank_step_ref
    scan = kops.sru_scan_pop if use_kernel else kref.sru_scan_pop_ref
    names = list(cfg.layer_names())
    li = {nm: i for i, nm in enumerate(names)}
    P = qp_stack.shape[0]
    n = cfg.hidden
    dev = qp_stack.device
    w_idx = (Q.menu_index_from_hi(qp_stack[:, :, 2])
             if banks is not None else None)                     # (P, L)

    def lane_grid(name, col, ndim):
        return qp_stack[:, li[name], col].reshape((P,) + (1,) * (ndim - 1))

    def q_act(name, x):                       # per-lane activation grids
        return Q.fake_quant_triple(x, *(lane_grid(name, c, x.ndim)
                                        for c in (3, 4, 5)))

    def mxv_layer(xq, name, sub=None):
        """(P, B, T, m) -> (P, B, T, h): each lane's quantized MxV."""
        if banks is not None:
            node = banks[name] if sub is None else banks[name][sub]
            bank, idx = node["W"], w_idx[:, li[name]].contiguous()
        else:                                 # requantize every lane
            w = params[name]["W"] if sub is None else params[name][sub]["W"]
            bank = Q.fake_quant_triple(w[None], *(lane_grid(name, c, 3)
                                                  for c in (0, 1, 2)),
                                       use_ste=False)
            idx = torch.arange(P, dtype=torch.int32, device=dev)
        x2 = xq.reshape(P, -1, xq.shape[-1])
        u = mxv_step(x2, bank, idx)
        return u.reshape(xq.shape[:3] + (u.shape[-1],))

    if feats.ndim == 4:
        if feats.shape[0] != P:
            raise ValueError(f"per-lane feats lead axis {feats.shape[0]} "
                             f"!= population size {P}")
        x = feats
    else:
        x = feats.expand((P,) + tuple(feats.shape))
    for i in range(cfg.n_sru_layers):
        name = f"L{i}"
        lp = params[name]
        # the u0 gate: banks, a shared fold, an extended tree, no L0 highway
        use_u0 = (i == 0 and banks is not None and feats.ndim == 3
                  and "U" in banks["L0"]["fwd"] and feats.shape[-1] != n)
        if use_u0:
            a_idx0 = Q.menu_index_from_hi(qp_stack[:, li[name], 5])
            n_w = banks[name]["fwd"]["W"].shape[0]
            combo = a_idx0 * n_w + w_idx[:, li[name]]
            xq = None
        else:
            xq = q_act(name, x)
        highway = x.shape[-1] == n
        hs = []
        for key in ("fwd", "bwd"):
            if use_u0:
                u = banks[name][key]["U"].index_select(0, combo)
            else:
                u = mxv_layer(xq, name, key)                     # (P,B,T,3n)
            if key == "bwd":
                u = u.flip(2)
            if banks is not None:             # 16-bit vectors pre-quantized
                v, b = banks[name][key]["v"], banks[name][key]["b"]
            else:
                v = Q.fixed_point_16(lp[key]["v"])
                b = Q.fixed_point_16(lp[key]["b"])
            h, r, _ = scan(u[..., :n], u[..., n:2 * n], u[..., 2 * n:],
                           v[0], v[1], b[0], b[1])
            if highway:
                h = h + (1.0 - r) * (xq if key == "fwd" else xq.flip(2))
            hs.append(h)
        x = torch.cat([hs[0], hs[1].flip(2)], dim=-1)
        if i < cfg.n_sru_layers - 1:
            pname = f"Pr{i + 1}"
            x = mxv_layer(q_act(pname, x), pname)
    xq = q_act("FC", x)
    return mxv_layer(xq, "FC") + params["FC"]["b"]


def forward_decode_step(params, cfg: SRUModelConfig, feats, qp_stack,
                        banks=None, use_kernel: Optional[bool] = None):
    """One serving decode step: P request lanes, one chunk each.

    ``feats``: (P, T, m), lane *i* holding request *i*'s current chunk of T
    frames; ``qp_stack``: (P, L, 6), lane *i*'s row is request *i*'s
    allocation (its grids, from which the banked lanes recover the menu
    index). The whole mixed-allocation batch is one population forward with
    per-lane feats, so a request with another allocation changes a gather
    index, not the number of dispatches; on a card (``use_kernel`` default)
    each MxV is one ``bank_qmm_pop`` (packed banks) and each recurrence one
    ``sru_scan_pop`` launch.

    The Bi-SRU is bidirectional, so a step is chunk-synchronous: each
    lane's chunk runs the whole forward with fresh recurrent state, like the
    scalar ``forward(qp=)`` on that chunk. Returns logits (P, T, n_outputs).
    """
    if feats.ndim != 3:
        raise ValueError(f"decode-step feats must be (P, T, m), got "
                         f"shape {tuple(feats.shape)}")
    return forward_population(params, cfg, feats[:, None], qp_stack,
                              banks=banks, use_kernel=use_kernel)[:, 0]


def calibrate(params, cfg: SRUModelConfig, feats_batches) -> Dict[str, float]:
    """Expected activation ranges = median over batches of the max-abs."""
    cal = Q.ActRangeCalibrator()
    for feats in feats_batches:
        forward(params, cfg, feats, calibrator=cal)
    return cal.expected_ranges()


def weight_clips(params, cfg: SRUModelConfig,
                 bits_by_layer: Dict[str, int]) -> Dict[str, float]:
    """MMSE clip per layer at a given bit-width (weights of both directions
    pooled for Bi-SRU layers). Host numpy, as in the reference."""
    clips = {}
    for name, bits in bits_by_layer.items():
        if bits == 16:
            continue
        if name.startswith("L"):
            w = np.concatenate(
                [params[name]["fwd"]["W"].detach().cpu().numpy().ravel(),
                 params[name]["bwd"]["W"].detach().cpu().numpy().ravel()])
        else:
            w = params[name]["W"].detach().cpu().numpy().ravel()
        clips[name] = Q.mmse_clip(w, bits)
    return clips
