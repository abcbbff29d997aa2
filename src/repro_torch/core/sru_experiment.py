"""The SRU search target: a calibrated Bi-SRU served to the MOHAQ search.

Port of ``TrainedSRU`` and ``train_small_sru`` from the reference
package's ``core/sru_experiment.py``. The target is built from plain
arrays — cfg, params, validation/test sets, activation ranges, MMSE weight
clips and weight ranges — so a test can hand it exactly the reference's
arrays. ``train_small_sru`` trains a Bi-SRU on synthetic speech and
calibrates it; the target retrains beacons (``beacon_retrainer``) for the
beacon-based search. ``target_from_params`` calibrates and wraps given
params (those of a training checkpoint), ``build_untrained_sru`` random
ones: the same recipe without the training loop.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import batched_eval
from repro_torch.core import quantization as Q
from repro_torch.core.mohaq import Alloc
from repro_torch.data import synthetic
from repro_torch.models import sru
from repro_torch.models.sru import SRUModelConfig
from repro_torch.training import optimizer as opt
from repro_torch.training import qat

SEARCH_CFG = SRUModelConfig(name="sru_search", input_dim=23, hidden=96,
                            proj=48, n_sru_layers=4, n_outputs=64)
PAPER_CFG = SRUModelConfig()   # exact Table 4 model


@dataclass
class TrainedSRU:
    """A calibrated Bi-SRU as a ``repro_torch.core.api.SearchTarget``.

    ``val_subsets``/``test_batches``: lists of (feats (B, T, m) f32,
    labels (B, T) int) tensors on the params' device. ``act_ranges``:
    {layer: calibrated range}; ``wclips``: {(layer, bits): MMSE clip} for
    2/4/8 bits; ``wranges``: {layer: max |w|} for the 16-bit grids."""
    cfg: SRUModelConfig
    params: dict
    task: Optional[synthetic.SpeechTask]
    val_subsets: list
    test_batches: list
    act_ranges: Dict[str, float]
    wclips: Dict[Tuple[str, int], float]
    wranges: Dict[str, float]
    baseline_val_error: float = 0.0
    baseline_test_error: float = 0.0
    # shared across every base-params search built from this model
    shared_error_memo: Dict[tuple, float] = field(default_factory=dict)

    supports_retrain = True            # SearchTarget: beacons available

    def __post_init__(self):
        self._batched_eval = {}
        self._bank_caches = {}         # shared by evaluators of one lane
        self._qp_tables = None

    # ---- SearchTarget: search-space / hardware-objective surface ----

    @property
    def layer_names(self) -> Tuple[str, ...]:
        return tuple(self.cfg.layer_names())

    @property
    def menu(self) -> Tuple[int, ...]:
        return Q.SUPPORTED_BITS

    @property
    def layer_macs(self) -> Dict[str, int]:
        """MxV MACs per frame == matrix weights per layer (paper Table 4)."""
        return self.cfg.layer_weight_counts()

    @property
    def layer_weights(self) -> Dict[str, int]:
        return self.cfg.layer_weight_counts()

    @property
    def vector_weights(self) -> int:
        return self.cfg.vector_weight_count()

    @property
    def fixed_ops(self) -> int:
        """Element-wise + sigmoid op count per frame (runs at max precision;
        folded into the speedup normalization, Eq. 4)."""
        return 14 * self.cfg.hidden * 2 * self.cfg.n_sru_layers * 2

    # ---- SearchTarget: beacon retraining ----

    def beacon_retrainer(self, retrain_steps: int = 60, *,
                         skip_retrains: int = 0):
        """One retraining context per search: the returned
        ``retrain_fn(alloc, base_params)`` draws successive batches from a
        single seeded stream, so the k-th retrain of any search sees the
        same data whichever allocation triggered it. ``skip_retrains``
        fast-forwards the stream past the first N retrains (each consumes
        exactly ``retrain_steps`` batches), so a resumed search's next
        retrain sees the batches the uninterrupted run would."""
        data = synthetic.speech_batches(
            self.task, 8, 48, seed=3,
            start_step=skip_retrains * retrain_steps,
            device=self.params["FC"]["W"].device)

        def retrain_fn(alloc: Alloc, base_params):
            wclips = {n: self.wclips[(n, a[0])]
                      for n, a in alloc.items() if a[0] != 16}
            return qat.retrain_sru(base_params, self.cfg, alloc, data,
                                   steps=retrain_steps,
                                   act_ranges=self.act_ranges,
                                   wclips=wclips)
        return retrain_fn

    def retrain(self, alloc: Alloc, base_params=None, *, steps: int = 60):
        """One-off binary-connect retrain under ``alloc`` (fresh stream)."""
        base = self.params if base_params is None else base_params
        return self.beacon_retrainer(steps)(alloc, base)

    # ---- SearchTarget: quantization-grid plumbing ----

    def qp_for(self, alloc: Alloc):
        return sru.quant_triples_for(alloc, self.wclips, self.act_ranges,
                                     self.wranges)

    def make_banks(self, params):
        """f32 quantized-weight banks for ``params`` on the frozen grids."""
        return sru.build_weight_banks(params, self.cfg, self.wclips,
                                      self.wranges)

    def make_packed_banks(self, params):
        """Packed-integer banks (int codes + scales): the same grids as
        ``make_banks``, >= 4x smaller, dequantizing to its rows bitwise."""
        return sru.build_weight_banks(params, self.cfg, self.wclips,
                                      self.wranges, packed=True)

    def qp_menu_tables(self):
        """Two (L, |menu|, 3) float32 tables of weight / activation
        ``quant_triple`` rows in ``Q.SUPPORTED_BITS`` order."""
        if self._qp_tables is None:
            names = list(self.cfg.layer_names())
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

    def batched_evaluator(self, use_banks: bool = True,
                          bank_format: str = "f32",
                          use_kernel: Optional[bool] = None, mesh=None,
                          partition: str = "shard_map"
                          ) -> batched_eval.BatchedSRUEvaluator:
        """Lazily built population evaluator, one per (banks, format,
        lane, mesh, partition). ``use_kernel`` defaults to the kernel lane
        on a card; ``mesh`` shards the population over its "pop" axis
        (``partition``: see ``distributed/pop_sharding.py``). Meshes
        compare by their devices and axis, so equal meshes built afresh
        share one evaluator."""
        key = (use_banks, bank_format, use_kernel, mesh,
               partition if mesh is not None else "")
        if key not in self._batched_eval:
            lane = (use_kernel if use_kernel is not None
                    else self.val_subsets[0][0].device.type == "cuda")
            banks = self._bank_caches.setdefault(
                (use_banks, bank_format, lane), {})
            self._batched_eval[key] = batched_eval.BatchedSRUEvaluator(
                self.cfg, self.val_subsets, self.qp_for,
                use_kernel=use_kernel, mesh=mesh, partition=partition,
                make_banks=self.make_banks,
                use_banks=use_banks, qp_tables=self.qp_menu_tables(),
                bank_format=bank_format,
                make_packed_banks=self.make_packed_banks, bank_cache=banks)
        return self._batched_eval[key]

    def val_error_batch(self, allocs, params=None, *,
                        use_banks: bool = True, bank_format: str = "f32",
                        use_kernel: Optional[bool] = None, mesh=None,
                        partition: str = "shard_map") -> List[float]:
        """Max error over the validation subsets for every allocation in
        one forward; equal to ``val_error`` per allocation up to frames
        whose argmax the lanes' different summation orders flip. ``mesh``
        partitions the candidates over devices (the same counts)."""
        params = self.params if params is None else params
        return self.batched_evaluator(use_banks, bank_format, use_kernel,
                                      mesh=mesh, partition=partition
                                      ).errors(allocs, params)

    def _count(self, params, feats, labels, alloc):
        qp = None if alloc is None else self.qp_for(alloc)
        logits = sru.forward(params, self.cfg, feats, qp=qp)
        return int((torch.argmax(logits, -1) != labels).sum()), labels.numel()

    def val_error(self, alloc: Optional[Alloc] = None,
                  params=None) -> float:
        """MAX error over the validation subsets (paper §4.2)."""
        params = self.params if params is None else params
        errs = []
        for feats, labels in self.val_subsets:
            e, n = self._count(params, feats, labels, alloc)
            errs.append(100.0 * e / n)
        return max(errs)

    def test_error(self, alloc: Optional[Alloc] = None,
                   params=None) -> float:
        params = self.params if params is None else params
        te = tn = 0
        for feats, labels in self.test_batches:
            e, n = self._count(params, feats, labels, alloc)
            te += e
            tn += n
        return 100.0 * te / tn


def calibrated_target(cfg: SRUModelConfig, params, task, val_subsets,
                      test_batches, cal_feats) -> TrainedSRU:
    """Calibrate ``params`` (activation ranges over ``cal_feats``, MMSE
    clips at 2/4/8 bits, weight ranges) and wrap it as a target with its
    full-precision baseline errors."""
    act_ranges = sru.calibrate(params, cfg, cal_feats)
    wclips = {}
    for bits in (2, 4, 8):
        for name, c in sru.weight_clips(
                params, cfg, {n: bits for n in cfg.layer_names()}).items():
            wclips[(name, bits)] = c
    wranges = sru.weight_ranges(params, cfg)
    target = TrainedSRU(cfg, params, task, val_subsets, test_batches,
                        act_ranges, wclips, wranges)
    target.baseline_val_error = target.val_error()
    target.baseline_test_error = target.test_error()
    return target


def target_from_params(cfg: SRUModelConfig, params, *,
                       device="cuda") -> TrainedSRU:
    """``params`` (trained, or restored from a training checkpoint)
    calibrated and wrapped with the synthetic task's evaluation sets, as
    ``train_small_sru`` wraps what it trains: 4 validation subsets of 8
    sequences of 48 frames and a test set of 32 sequences. Deterministic,
    so a second process that restores the same params builds the same
    target (the same ``checkpointing.target_fingerprint``, ranges, clips
    and errors)."""
    task = synthetic.SpeechTask(input_dim=cfg.input_dim,
                                n_states=cfg.n_outputs)
    raw_subsets, raw_test = synthetic.speech_eval_sets(
        task, batch=4, seq=48, device=device)

    def stack(bs):
        return (torch.cat([b["feats"] for b in bs]),
                torch.cat([b["labels"] for b in bs]))

    subsets = [stack(s) for s in raw_subsets]
    test = [stack(raw_test)]
    cal_feats = [b["feats"] for s in raw_subsets for b in s]
    return calibrated_target(cfg, params, task, subsets, test, cal_feats)


def train_small_sru(steps: int = 400, *, cfg: SRUModelConfig = SEARCH_CFG,
                    batch: int = 8, seq: int = 48, lr: float = 3e-3,
                    seed: int = 0, device="cuda", verbose: bool = False,
                    log: Optional[Callable[[int, torch.Tensor], None]] = None
                    ) -> TrainedSRU:
    """Train a Bi-SRU on the synthetic speech task and calibrate it: AdamW
    (cosine schedule, 20 warm-up steps, no weight decay) on ``steps``
    batches of ``batch`` x ``seq`` frames, the reference's recipe.

    The initial weights come from a ``torch.Generator`` seeded with
    ``seed`` (``sru.init_params``): the reference draws them from
    ``jax.random.PRNGKey(0)``, which the port cannot reproduce, and its
    feature streams differ too (``data/synthetic.py``), so the trained
    weights differ from the reference's. ``log(step, loss)`` is called
    after every step with the loss as a 0-dim tensor on ``device``;
    ``verbose`` prints it every 50 steps."""
    task = synthetic.SpeechTask(input_dim=cfg.input_dim,
                                n_states=cfg.n_outputs)
    params = sru.init_params(torch.Generator().manual_seed(seed), cfg,
                             device=device)
    ocfg = opt.AdamWConfig(lr=lr, schedule="cosine", warmup_steps=20,
                           total_steps=steps, weight_decay=0.0)
    ostate = opt.init_opt_state(params)

    def loss_fn(p, feats, labels):
        return qat.frame_nll(sru.forward_train(p, cfg, feats), labels)

    data = synthetic.speech_batches(task, batch, seq, device=device)
    for i in range(steps):
        b = next(data)
        params, ostate, loss = opt.adamw_step(ocfg, loss_fn, params, ostate,
                                              b["feats"], b["labels"])
        if log is not None:
            log(i, loss)
        if verbose and (i + 1) % 50 == 0:
            print(f"  [sru-train] step {i+1}/{steps} loss {float(loss):.3f}")
    return target_from_params(cfg, params, device=device)


def build_untrained_sru(cfg: SRUModelConfig, *, seed: int = 0,
                        device="cuda") -> TrainedSRU:
    """A calibrated target with random weights drawn from ``seed``
    (``target_from_params`` on untrained weights). Its errors are those of
    an untrained model."""
    params = sru.init_params(torch.Generator().manual_seed(seed), cfg,
                             device=device)
    return target_from_params(cfg, params, device=device)


def sru_contract_harness(device="cuda"):
    """Tiny-but-real SRU instance for the contract checker (see
    ``repro_torch.core.target_registry``). Every dimension avoids the
    checker's activation marker dim (T=3): hidden=6 (bi-state 12), proj=4,
    input 5, outputs 7, two layers; so a rounding op whose shapes carry a
    3 can only be an activation fake-quant, and one that does not is a
    weight (re)quantization the banked lane must not contain. The weights
    are the port's own seeded draw (``init_params`` at seed 0). On a card
    the forwards run through ``bank_mxv_pop``/``bank_qmm_pop`` and
    ``sru_scan_pop`` at these widths, far below every tile."""
    from repro_torch.core.target_registry import ContractHarness, MARKER_DIM
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    cfg = SRUModelConfig(name="sru_contract", input_dim=5, hidden=6,
                         proj=4, n_sru_layers=2, n_outputs=7)
    params = sru.init_params(torch.Generator().manual_seed(0), cfg,
                             device=dev)
    B, T = 2, MARKER_DIM
    feats = torch.from_numpy(np.linspace(
        -1.0, 1.0, B * T * cfg.input_dim, dtype=np.float32
    ).reshape(B, T, cfg.input_dim)).to(dev)
    labels = torch.zeros((B, T), dtype=torch.int64, device=dev)
    names = list(cfg.layer_names())
    act_ranges = {n: 1.0 for n in names}
    wclips = {(n, b): 0.5 for n in names for b in (2, 4, 8)}
    wranges = {n: 1.0 for n in names}
    trained = TrainedSRU(cfg, params, None, [(feats, labels)] * 4,
                         [(feats, labels)], act_ranges, wclips, wranges,
                         0.0, 0.0)

    def forward_pop(params, feats, qp_stack, banks=None):
        return sru.forward_population(params, cfg, feats, qp_stack,
                                      banks=banks)

    def forward_decode(params, feats_lane, qp_stack, banks=None):
        # the serving hot path: feats_lane (P, T, m), one request chunk per
        # population lane; C5 checks that no lane reaches another
        return sru.forward_decode_step(params, cfg, feats_lane, qp_stack,
                                       banks=banks)

    return ContractHarness(
        name="sru", target=trained, feats=feats, labels=labels,
        layer_names=tuple(names), marker_dim=T,
        anchor_path="src/repro_torch/models/sru.py", forward_pop=forward_pop,
        make_evaluator=lambda: trained.batched_evaluator(use_banks=True),
        forward_decode=forward_decode)
