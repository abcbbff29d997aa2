"""The paper's Bi-SRU (arXiv:2108.01192, Table 4) searched for SiLago: its
set-up through the port, and its plain reference.

Set-up makes the weights and the validation fold on the device from the
configuration's ``model_seed`` (the same model in every run), labels each
frame with the full-precision reference's own argmax (so the unquantized
model scores near 0 % and every quantized lane's error measures what its
allocation costs), and hands them to the port's
``sru_experiment.calibrated_target``. The search evaluates every generation
through ``TrainedSRU.val_error_batch``: the kernel lane with float32 banks
and the input layer's u-bank.

The reference (``ref_*``) is the Bi-SRU of paper Eq. 2 in plain PyTorch,
fake-quantized per lane: each lane's grids are worked out again from the
weights and the fold (activation ranges, MMSE clips, weight ranges), its
weights quantized on them, its products exact float32 (TF32 off) or, for the
control, in a lower ``Precision``.
"""
from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

import refquant as RQ
from yardstick import bank_mxv_cost, scan_cost

# ------------------------------------------------------------- the model


def layer_names(spec) -> List[str]:
    names = ["L0"]
    for i in range(1, spec["n_sru_layers"]):
        names += [f"Pr{i}", f"L{i}"]
    return names + ["FC"]


def layer_input_dims(spec) -> Dict[str, int]:
    bi = 2 * spec["hidden"]
    d = {"L0": spec["input_dim"], "FC": bi}
    for i in range(1, spec["n_sru_layers"]):
        d[f"L{i}"] = spec["proj"]
        d[f"Pr{i}"] = bi
    return d


def layer_weights(spec) -> Dict[str, int]:
    """MxV weights of each layer, which are its MACs a frame."""
    n, dims = spec["hidden"], layer_input_dims(spec)
    out = {}
    for name in layer_names(spec):
        m = dims[name]
        if name.startswith("L"):
            out[name] = 2 * 3 * n * m
        elif name.startswith("Pr"):
            out[name] = m * spec["proj"]
        else:
            out[name] = m * spec["n_outputs"]
    return out


def make_params(spec, seed: int, device) -> dict:
    """Weights from the seed, on the device, in one draw: W ~ N(0, 1/m),
    the recurrent vectors and every bias ~ N(0, 0.01)."""
    n, dims = spec["hidden"], layer_input_dims(spec)
    shapes = []
    for name in layer_names(spec):
        m = dims[name]
        if name.startswith("L"):
            for d in ("fwd", "bwd"):
                shapes += [((name, d, "W"), (m, 3 * n), 1 / math.sqrt(m)),
                           ((name, d, "v"), (2, n), 0.1),
                           ((name, d, "b"), (2, n), 0.1)]
        elif name.startswith("Pr"):
            shapes.append(((name, "W"), (m, spec["proj"]), 1 / math.sqrt(m)))
        else:
            shapes += [((name, "W"), (m, spec["n_outputs"]),
                        1 / math.sqrt(m)),
                       ((name, "b"), (spec["n_outputs"],), 0.1)]
    g = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    params: dict = {}
    off = 0
    for key, shape, scale in shapes:
        k = math.prod(shape)
        node = params
        for part in key[:-1]:
            node = node.setdefault(part, {})
        node[key[-1]] = (flat[off:off + k].reshape(shape) * scale).contiguous()
        off += k
    return params


def make_feats(spec, seed: int, device) -> torch.Tensor:
    """The fold's features: (subsets x utterances, frames, inputs) standard
    normal, as mean- and variance-normalised FBANKs are."""
    g = torch.Generator(device=device).manual_seed(seed + 1)
    n_utt = spec["val_subsets"] * spec["utterances_per_subset"]
    return torch.randn((n_utt, spec["frames"], spec["input_dim"]),
                       generator=g, device=device, dtype=torch.float32)


# ------------------------------------------------------------- reference

def _scan(u, v, b):
    """Paper Eq. 2's recurrence over (L, N, T, 3n) streams -> h, r."""
    n = v.shape[-1]
    uw, uf, ur = u[..., :n], u[..., n:2 * n], u[..., 2 * n:]
    c = torch.zeros(u.shape[:2] + (n,), dtype=torch.float32, device=u.device)
    hs, rs = [], []
    for t in range(u.shape[2]):
        f = torch.sigmoid(uf[:, :, t] + v[0] * c + b[0])
        r = torch.sigmoid(ur[:, :, t] + v[1] * c + b[1])
        c = f * c + (1.0 - f) * uw[:, :, t]
        hs.append(r * c)
        rs.append(r)
    return torch.stack(hs, 2), torch.stack(rs, 2)


def _lane_mm(x, w, prec):
    """(L, N, T, m) x (L, m, h) -> (L, N, T, h), each lane its own weight."""
    L = x.shape[0]
    out = prec.mm(x.reshape(L, -1, x.shape[-1]), w)
    return out.reshape(x.shape[:-1] + (w.shape[-1],))


@torch.no_grad()
def ref_logits(spec, params, feats, trips, prec, calib=None):
    """Logits (L, N, T, V) of L lanes. ``trips``: {layer: (w_trips (L, 3),
    a_trips (L, 3))} as float32 host arrays, or None for the full-precision
    forward; ``calib`` (a dict) receives each MxV input's max |x| per layer
    (the full-precision forward only)."""
    dev = feats.device
    quant = trips is not None
    L = len(next(iter(trips.values()))[0]) if quant else 1
    n = spec["hidden"]

    def lane_grid(arr, col, ndim):
        t = torch.as_tensor(arr[:, col], dtype=torch.float32, device=dev)
        return t.reshape((L,) + (1,) * (ndim - 1))

    def q_act(name, x):
        if calib is not None:
            calib.setdefault(name, []).append(float(x.abs().max()))
        if not quant:
            return x
        a = trips[name][1]
        return RQ.fake_quant(x, *(lane_grid(a, c, x.ndim) for c in range(3)))

    def q_w(name, w):
        if not quant:
            return w[None].expand((L,) + tuple(w.shape))
        wt = trips[name][0]
        return RQ.fake_quant(w[None], *(lane_grid(wt, c, 3) for c in range(3)),
                             ste=False)

    x = feats[None].expand((L,) + tuple(feats.shape))
    for i in range(spec["n_sru_layers"]):
        name = f"L{i}"
        xq = q_act(name, x)
        hs = []
        for d in ("fwd", "bwd"):
            lp = params[name][d]
            v, b = lp["v"], lp["b"]
            if quant:
                v, b = RQ.fixed_point_16(v), RQ.fixed_point_16(b)
            u = _lane_mm(xq, q_w(name, lp["W"]), prec)
            if d == "bwd":
                u = u.flip(2)
            h, r = _scan(u, v, b)
            if xq.shape[-1] == n:
                h = h + (1.0 - r) * (xq if d == "fwd" else xq.flip(2))
            hs.append(h if d == "fwd" else h.flip(2))
        x = torch.cat(hs, dim=-1)
        if i < spec["n_sru_layers"] - 1:
            pname = f"Pr{i + 1}"
            x = _lane_mm(q_act(pname, x), q_w(pname, params[pname]["W"]),
                         prec)
    x = q_act("FC", x)
    return _lane_mm(x, q_w("FC", params["FC"]["W"]), prec) \
        + params["FC"]["b"]


def ref_grids(spec, params, cal_batches, prec):
    """(act_ranges, wclips, wranges) worked out again: the median over the
    calibration batches of each MxV input's max |x| in the full-precision
    forward; MMSE clips at 2/4/8 bits (a Bi-SRU layer's two directions
    pooled); max |W|."""
    calib: Dict[str, list] = {}
    for f in cal_batches:
        ref_logits(spec, params, f, None, prec, calib=calib)
    act = {k: float(np.median(v)) for k, v in calib.items()}
    wr, flat = {}, {}
    for name in layer_names(spec):
        if name.startswith("L"):
            w = torch.cat([params[name][d]["W"].flatten()
                           for d in ("fwd", "bwd")])
        else:
            w = params[name]["W"].flatten()
        flat[name] = w.detach().cpu().numpy()
        wr[name] = float(np.abs(flat[name]).max())
    # the host searches of the layers and bit-widths side by side (numpy
    # leaves the interpreter's lock while it computes)
    keys = [(name, bits) for name in flat for bits in (2, 4, 8)]
    with ThreadPoolExecutor(max_workers=8) as pool:
        found = list(pool.map(lambda k: RQ.mmse_clip_host(flat[k[0]], k[1]),
                              keys))
    return act, dict(zip(keys, found)), wr


# ------------------------------------------------------------- set-up

class Cell:
    def __init__(self, spec, traffic, seed, dev, steps):
        from repro_torch.core import sru_experiment as SE
        from repro_torch.models import sru
        from repro_torch.models.sru import SRUModelConfig

        self.spec, self.dev = spec, dev
        self.names = layer_names(spec)
        self.n_subsets = spec["val_subsets"]
        self.subset_rows = spec["utterances_per_subset"]
        with steps("weights"):
            self.params = make_params(spec, seed, dev)
        with steps("data"):
            self.feats = make_feats(spec, seed, dev)
        with steps("reference_labels"):
            logits = ref_logits(spec, self.params, self.feats, None,
                                RQ.Precision("f32"))
            self.labels = torch.argmax(logits[0], dim=-1)
            del logits
        B = self.subset_rows
        subsets = [(self.feats[s * B:(s + 1) * B].contiguous(),
                    self.labels[s * B:(s + 1) * B].contiguous())
                   for s in range(self.n_subsets)]
        self.cal_batches = [f for f, _ in subsets]
        cfg = SRUModelConfig(name=spec["name"], input_dim=spec["input_dim"],
                             hidden=spec["hidden"], proj=spec["proj"],
                             n_sru_layers=spec["n_sru_layers"],
                             n_outputs=spec["n_outputs"])
        self.cfg = cfg
        restore = [(sru, "calibrate", steps.timed("calibration",
                                                  sru.calibrate)),
                   (sru, "weight_clips", steps.timed("clips",
                                                     sru.weight_clips)),
                   (sru, "weight_ranges", steps.timed("clips",
                                                      sru.weight_ranges)),
                   (SE.TrainedSRU, "val_error",
                    steps.timed("baseline_errors", SE.TrainedSRU.val_error)),
                   (SE.TrainedSRU, "test_error",
                    steps.timed("baseline_errors",
                                SE.TrainedSRU.test_error))]
        old = [(o, a, getattr(o, a)) for o, a, _ in restore]
        try:
            for o, a, v in restore:
                setattr(o, a, v)
            self.target = SE.calibrated_target(cfg, self.params, None,
                                               subsets, subsets[:1],
                                               self.cal_batches)
        finally:
            for o, a, v in old:
                setattr(o, a, v)
        # the banks and the u-bank are built by the first dispatch
        self.target.make_banks = steps.timed("banks", self.target.make_banks)
        self._extend = sru.extend_banks_u0
        sru.extend_banks_u0 = steps.timed("u_bank", sru.extend_banks_u0)
        self._sru = sru
        self.sram_override = None
        self.forward_hook = (sru, "forward_population")

    def evaluator(self):
        # the warm-up search has built the banks: the program's function
        # is back in place for the window
        self._sru.extend_banks_u0 = self._extend
        return self.target.batched_evaluator()

    def sample_allocs(self, rng, n):
        out = []
        for _ in range(n):
            bits = [int(b) for b in rng.choice((4, 8, 16), len(self.names))]
            out.append({nm: (b, b) for nm, b in zip(self.names, bits)})
        return out

    def work(self, p: int) -> dict:
        """The work one dispatch's ``p`` real lanes need: the kernel
        lane's MxVs (L0 is gathered from the u-bank) and scans."""
        s = self.spec
        M = self.n_subsets * self.subset_rows * s["frames"]
        n, bi, pr = s["hidden"], 2 * s["hidden"], s["proj"]
        mxv = []
        for i in range(1, s["n_sru_layers"]):
            mxv.append(bank_mxv_cost(p, M, bi, pr, 4))
            mxv += [bank_mxv_cost(p, M, pr, 3 * n, 4)] * 2
        mxv.append(bank_mxv_cost(p, M, bi, s["n_outputs"], 4))
        scans = [scan_cost(p, self.n_subsets * self.subset_rows,
                           s["frames"], n)] * (2 * s["n_sru_layers"])
        flops = 2 * sum(layer_weights(s).values()) * M * p
        return {"mxv": mxv, "scan": scans, "model_flops": flops}

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

def _bank_rows(spec, params, grids, prec):
    """Reference rows of every layer's bank: {(layer, dir): (4, m, h)},
    and the 16-bit vectors {(layer, dir, key): tensor}."""
    act, clips, wr = grids
    rows, vecs = {}, {}
    for name in layer_names(spec):
        trips = [RQ.quant_triple(b, wr[name] if b == 16 else clips[(name, b)])
                 for b in RQ.MENU]
        dirs = ("fwd", "bwd") if name.startswith("L") else (None,)
        for d in dirs:
            node = params[name][d] if d else params[name]
            rows[(name, d)] = torch.stack([
                prec.operand(RQ.fake_quant(node["W"], *t, ste=False))
                for t in trips])
            if d:
                for k in ("v", "b"):
                    vecs[(name, d, k)] = RQ.fixed_point_16(node[k])
    return rows, vecs


@torch.no_grad()
def check(cell, program, dispatches, control=None) -> dict:
    """The numbers compared, each the program's (or with ``control``, the
    lower-precision reference's) against the float32 reference's: the
    grids (``grid_rel``), the banks and the u-bank (``bank_rel``,
    ``ubank_rel``), the logits of the sampled lanes and utterances
    (``logit_med_stable``, the median row among those that the reference
    in float64 leaves where float32 puts them, for a small error on most
    rows; ``logit_rms``, the mean, for a large one on a few; ``logit_med``
    over every row, ``stable_share``, ``logit_rms_stable``, ``logit_part``,
    ``logit_max``, ``top_gap``: readings only), and each lane's counts and
    errors (``ref_count_gap_pp``, ``ref_err_gap_pp``:
    argmax flips at near-ties move them by summation order alone). The
    counts the evaluator reduced are also held to those of the argmax of
    its own logits and the fold's labels, and the errors the search
    received to those counts (``count_gap_pp``, ``err_gap_pp``: exact)."""
    spec, params, feats = cell.spec, cell.params, cell.feats
    f32, f64 = RQ.Precision("f32"), RQ.Precision("f64")
    ctl = RQ.Precision(control) if control else None
    names = layer_names(spec)
    grids = ref_grids(spec, params, cell.cal_batches, f32)
    if ctl is None:
        side_grids = program["grids"]
    else:
        side_grids = ref_grids(spec, params, cell.cal_batches, ctl)
    out = {"grid_rel": RQ.grid_gap(side_grids, grids)}

    rows, vecs = _bank_rows(spec, params, grids, f32)
    if ctl is None:
        banks = program["banks"]
        side_rows = {(n, d): (banks[n][d]["W"] if d else banks[n]["W"])
                     for n, d in rows}
        side_vecs = {(n, d, k): banks[n][d][k] for n, d, k in vecs}
    else:
        side_rows, side_vecs = _bank_rows(spec, params, grids, ctl)
    out["bank_rel"] = max(
        [RQ.max_rel(side_rows[k], rows[k]) for k in rows]
        + [RQ.max_rel(side_vecs[k], vecs[k]) for k in vecs])

    # the u-bank: every (activation, weight) menu pair of L0, row by row
    a_trips = [RQ.quant_triple(b, grids[0]["L0"]) for b in RQ.MENU]
    N, T, m = feats.shape
    gap = 0.0
    for d in ("fwd", "bwd"):
        for a, at in enumerate(a_trips):
            xq = RQ.fake_quant(feats, *at).reshape(N * T, m)
            for w in range(len(RQ.MENU)):
                ref = f32.mm(xq, rows[("L0", d)][w])
                if ctl is None:
                    side = program["banks"]["L0"][d]["U"][a * len(RQ.MENU)
                                                          + w]
                else:
                    side = ctl.mm(xq, rows[("L0", d)][w])
                gap = max(gap, RQ.max_rel(side.reshape(ref.shape), ref))
    out["ubank_rel"] = gap
    program.clear()

    B, F = cell.subset_rows, spec["frames"]
    frames = B * F
    count_gap = err_gap = ref_count_gap = ref_err_gap = 0.0
    prog_rows, ref_rows, wit_gaps = [], [], []
    block = int(spec.get("reference_lanes", 8))
    for rec in dispatches:
        allocs = rec["allocs"]
        n = len(allocs)
        ref_counts = np.zeros((n, cell.n_subsets), np.int64)
        side_counts = np.zeros_like(ref_counts)
        for lo in range(0, n, block):
            sel = list(range(lo, min(n, lo + block)))
            trips = RQ.lane_trips(names, [allocs[i] for i in sel], grids)
            logits = ref_logits(spec, params, feats, trips, f32)
            wrong = torch.argmax(logits, -1) != cell.labels[None]
            ref_counts[sel] = wrong.reshape(len(sel), cell.n_subsets, -1
                                            ).sum(-1).cpu().numpy()
            keep = [i for i in sel if i in rec["lanes"]]
            if keep:
                kept = logits[[i - lo for i in keep]][:, rec["rows"]]
                ref_rows.append(kept.cpu())
                # the witness: the same lanes and rows in float64
                wit = ref_logits(spec, params, feats[rec["rows"]],
                                 RQ.lane_trips(names,
                                               [allocs[i] for i in keep],
                                               grids), f64)
                wit_gaps.append(RQ.row_gaps(wit, kept).cpu())
                del kept, wit
            if ctl is not None:
                clog = ref_logits(spec, params, feats,
                                  RQ.lane_trips(names,
                                                [allocs[i] for i in sel],
                                                side_grids), ctl)
                cw = torch.argmax(clog, -1) != cell.labels[None]
                side_counts[sel] = cw.reshape(len(sel), cell.n_subsets, -1
                                              ).sum(-1).cpu().numpy()
                if keep:
                    prog_rows.append(clog[[i - lo for i in keep]][
                        :, rec["rows"]].cpu())
                del clog, cw
            del logits, wrong
        if ctl is None:
            side_counts = np.asarray(rec["counts"])[:n].astype(np.int64)
            side_err = np.asarray(rec["errors"], float)
            prog_rows.append(rec["logits"].cpu())
            cg, eg = RQ.reduction_gaps(allocs, rec["argmax"], cell.labels,
                                       rec["counts"], rec["errors"],
                                       cell.n_subsets)
            count_gap, err_gap = max(count_gap, cg), max(err_gap, eg)
        else:
            side_err = (100.0 * side_counts / frames).max(axis=1)
        ref_err = (100.0 * ref_counts / frames).max(axis=1)
        ref_count_gap = max(ref_count_gap, float(
            np.abs(side_counts - ref_counts).max()) * 100.0 / frames)
        ref_err_gap = max(ref_err_gap, float(np.abs(side_err - ref_err).max()))
    out["count_gap_pp"] = count_gap
    out["err_gap_pp"] = err_gap
    out["ref_count_gap_pp"] = ref_count_gap
    out["ref_err_gap_pp"] = ref_err_gap
    if prog_rows:
        prog_all = torch.cat([p.flatten(0, 1) for p in prog_rows])
        ref_all = torch.cat([r.flatten(0, 1) for r in ref_rows])
        wit_all = torch.cat([w.flatten(0, 1) for w in wit_gaps])
        out.update(RQ.logit_stats(prog_all, ref_all))
        out["logit_med_stable"] = RQ.stable_median(
            RQ.row_gaps(prog_all, ref_all), wit_all)
        stable = wit_all <= RQ.STABLE_GAP
        out["stable_share"] = float(stable.double().mean())
        if bool(stable.any()):
            out["logit_rms_stable"] = float(
                RQ.row_gaps(prog_all, ref_all)[stable].mean())
    return out
