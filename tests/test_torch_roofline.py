"""The port's roofline counter (``repro_torch/roofline/counter.py``): exact
counts of single aten ops, the kernel wrappers' counts by formula whichever
lane runs them, trip multiplication, the memory reckoning, and FLOPs parity
with the reference's HLO analyzer on the reference's compiled CPU steps.

Parity holds within 1 % for every family and step kind but one: the port's
mLSTM (``models/xlstm.py::mlstm_fwd``) skips two terms that are exactly
zero, which the reference computes (ROADMAP queue 3, fault 12):

- the first chunk's inter-chunk read-out, ``einsum("bthd,bhde,bth->bthe")``
  (2*B*H*T0*dh*dh FLOPs) and ``einsum("bthd,bhd,bth->bth")`` (2*B*H*T0*dh),
  against the zero state (T0: the first chunk's length);
- the state update after the last chunk when no state is returned,
  ``einsum("bthd,bthe,bth->bhde")`` and ``einsum("bthd,bth->bhd")``, in the
  training forward, its recomputation and their backward.

So the xLSTM prefill equals the reference once the first read-out is added
back by formula, and the xLSTM train step (one chunk at the reduced 32
tokens, where both terms are skipped in every pass) counts 0.741 of the
reference's FLOPs: its stated tolerance is 27 %."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import reduced_shape as ref_reduced_shape
from repro.models.registry import get_model as ref_get_model
from repro.models.registry import input_specs as ref_input_specs
from repro.roofline.hlo_analysis import analyze_hlo
from repro.training import optimizer as ROPT
from repro.training import train_step as RTS
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeConfig, reduced_shape
from repro_torch.core import quantization as Q
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.roofline import counter as C
from repro_torch.roofline import report as R

FAMILIES = {"dense": "stablelm-1.6b", "moe": "granite-moe-1b-a400m",
            "ssm": "xlstm-350m", "hybrid": "jamba-1.5-large-398b",
            "audio": "seamless-m4t-medium", "vlm": "internvl2-26b"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: with six test workers on eight cores a
    multithreaded op waits on its own threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(t):
    return torch.empty_like(t, device="meta")


def _fields(c):
    d = c.as_dict()
    d.pop("n_ops")
    return d


# ---------------------------------------------------------------- aten ops

def test_one_mm_exact():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    c = C.count(torch.matmul, a, b)
    assert c.flops == 2 * 8 * 16 * 4
    assert c.flops_by_dtype == {"float32": 2 * 8 * 16 * 4}
    assert c.hbm_bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    assert c.min_hbm_bytes == c.hbm_bytes
    assert (c.argument_bytes, c.temp_bytes, c.output_bytes) == (
        4 * (8 * 16 + 16 * 4), 4 * 8 * 4, 4 * 8 * 4)
    assert _fields(C.count(torch.matmul, _meta(a), _meta(b))) == _fields(c)


def test_one_bmm_exact_in_bf16():
    a = torch.randn(3, 8, 16).to(torch.bfloat16)
    b = torch.randn(3, 16, 4).to(torch.bfloat16)
    c = C.count(torch.bmm, a, b)
    assert c.flops_by_dtype == {"bfloat16": 2 * 3 * 8 * 16 * 4}
    assert c.hbm_bytes == 2 * 3 * (8 * 16 + 16 * 4 + 8 * 4)
    # priced at the tensor-core rate
    assert R.compute_seconds(c) == pytest.approx(
        c.flops / R.H100_BF16_FLOP_S)


def test_view_chain_costs_nothing():
    x = torch.randn(4, 6, 8)

    def views(x):
        return x.reshape(4, 48).t()[3:9].unsqueeze(0).expand(2, 6, 4)
    c = C.count(views, x)
    assert (c.flops, c.hbm_bytes, c.n_ops, c.temp_bytes) == (0, 0, 0, 0)
    assert c.min_hbm_bytes == 0


def test_broadcast_operand_is_read_once_and_memory_follows_frees():
    x, v = torch.randn(64, 32), torch.randn(32)

    def f(x, v):
        y = x * v             # v broadcast: 32 elements read, not 64 * 32
        z = y + 1.0
        del y
        return z * 3.0
    c = C.count(f, x, v)
    n = 64 * 32 * 4
    assert c.hbm_bytes == (n + 32 * 4 + n) + (n + n) + (n + n)
    assert c.temp_bytes == 2 * n          # two buffers alive at once
    assert c.output_bytes == n
    assert c.min_hbm_bytes == n + 32 * 4 + n


def test_in_place_write_into_an_argument_is_charged_once():
    cache, x = torch.zeros(4, 16, 8), torch.randn(4, 1, 8)

    def write(cache, x):
        cache[:, 5:6] = x
        return cache
    c = C.count(write, cache, x)
    assert c.alias_bytes == 4 * 8 * 4
    assert c.min_hbm_bytes == 2 * 4 * 8 * 4       # x read, the slice written
    assert c.output_bytes == 0 and c.temp_bytes == 0


def test_older_storages_freed_in_turn_keep_their_bytes():
    """Two older storages, both read and then freed one after the other,
    each keep their own bytes among the arguments and their reads."""
    held = [torch.randn(64, 32), torch.randn(16, 8)]
    sizes = [t.untyped_storage().nbytes() for t in held]

    def f():
        s = held[0].sum() + held[1].sum()
        held.clear()
        return s * 2.0
    c = C.count(f)
    assert c.argument_bytes == sum(sizes)
    assert c.min_hbm_bytes == sum(sizes) + 4          # both read, s written


def test_live_storages_do_not_keep_their_counter_alive():
    import gc
    import weakref
    x = torch.randn(8, 4)
    counter = C.Counter(arguments=(x,))
    with counter:
        y = x * 2.0
    counter.finish(y)
    ref = weakref.ref(counter)
    del counter
    gc.collect()
    assert ref() is None
    assert torch.equal(y, x * 2.0)      # x and the step's output still alive


def test_log_sigmoid_scratch_buffer_is_not_charged():
    """The CPU's log_sigmoid kernel also fills a scratch buffer that the
    CUDA kernel returns empty: the count charges the input and the output
    only, as on the card."""
    x = torch.randn(4, 8)
    c = C.count(torch.nn.functional.logsigmoid, x)
    assert c.hbm_bytes == 2 * 4 * 8 * 4 and c.temp_bytes == 4 * 8 * 4
    m = C.count(torch.nn.functional.logsigmoid, _meta(x))
    assert _fields(m) == _fields(c)


# ---------------------------------------------------------------- kernels

def _scan_args(P, B, T, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    u = torch.randn((P, B, T, 3 * n), generator=g)
    vecs = [torch.randn((n,), generator=g) for _ in range(4)]
    return u, vecs


def _bank(m, N, seed=1):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((m, N), generator=g) / m ** 0.5
    trips = Q.menu_triples(Q.SUPPORTED_BITS, lambda b: float(w.abs().max()))
    return Q.build_weight_bank(w, trips), Q.build_packed_weight_bank(w, trips)


def _kernel_cases():
    P, B, T, n = 3, 2, 5, 7
    u, vecs = _scan_args(P, B, T, n)
    bank, packed = _bank(12, 10)
    x = torch.randn(P, 6, 12)
    idx = torch.tensor([0, 3, 1], dtype=torch.int32)
    w = torch.randn(40, 24)
    qw, sc = ops.pack_for_kernel(w, 4, float(w.abs().max()))
    xq = torch.randn(5, 40)
    return {
        "sru_scan_pop": (
            lambda u, *v: ops.sru_scan_pop(u[..., :n], u[..., n:2 * n],
                                           u[..., 2 * n:], *v),
            (u, *vecs), ops.scan_cost(P, B, T, n)),
        "sru_scan": (
            lambda u, *v: ops.sru_scan(u[0, ..., :n], u[0, ..., n:2 * n],
                                       u[0, ..., 2 * n:], *v),
            (u, *vecs), ops.scan_cost(1, B, T, n)),
        "bank_mxv_pop": (ops.bank_mxv_pop, (x, bank, idx),
                         ops.bank_mxv_cost(P, 6, 12, 10, 4)),
        "bank_qmm_pop": (ops.bank_qmm_pop, (x, packed, idx),
                         ops.bank_qmm_cost(
                             P, 6, 12, 10,
                             [packed[k].numel() * packed[k].element_size()
                              for k in ("q2", "q4", "q8", "q16")],
                             packed["scale"].numel() * 4)),
        "quant_matmul": (lambda x, q, s: ops.quant_matmul(x, q, s, 4),
                         (xq, qw, sc), ops.quant_matmul_cost(5, 40, 24,
                                                             qw.numel())),
    }


def _to_meta(a):
    if isinstance(a, dict):
        return {k: _to_meta(v) for k, v in a.items()}
    return _meta(a)


@pytest.mark.parametrize("name", sorted(_kernel_cases()))
def test_wrapper_counts_its_formula_on_cpu_and_on_meta(name):
    fn, args, cost = _kernel_cases()[name]
    cpu = C.count(fn, *args)
    meta_args = [_to_meta(a) for a in args]
    out = fn(*meta_args)
    assert all(t.device.type == "meta" for t in C._tensors(out))
    meta = C.count(fn, *meta_args)
    assert _fields(cpu) == _fields(meta)
    assert cpu.launches == {name: 1}
    assert cpu.flops == cost.flops
    assert cpu.flops_by_dtype == ({"float32": cost.flops} if cost.flops
                                  else {})
    assert cpu.elementwise_flops == cost.elementwise_flops
    assert cpu.hbm_bytes == cost.hbm_bytes
    assert cpu.min_hbm_bytes == cost.hbm_bytes
    assert ops.launch_counts()[name] == 0       # no launch on the CPU


def test_scan_counts_scan_flops_elementwise():
    assert ops.SCAN_FLOPS == 21
    c = ops.scan_cost(16, 32, 48, 550)
    assert c.elementwise_flops == 21 * 16 * 32 * 48 * 550
    assert c.hbm_bytes == 4 * (5 * 16 * 32 * 48 * 550 + 16 * 32 * 550
                               + 4 * 550)


# ---------------------------------------------------------------- trips

def test_trips_multiply_the_body():
    a, b = torch.randn(8, 16), torch.randn(16, 4)

    def loop(a, b):
        out = []
        for _ in C.trips(6):
            out.append(a @ b)
        return out
    folded = C.count(loop, a, b)
    unfolded = C.count(loop, a, b, fold_trips=False)
    one = C.count(torch.matmul, a, b)
    assert folded.flops == unfolded.flops == 6 * one.flops
    assert folded.hbm_bytes == unfolded.hbm_bytes == 6 * one.hbm_bytes
    assert folded.n_ops == 4 * one.n_ops         # trips 0, 1, 2 and 5
    assert list(C.trips(3)) == [0, 1, 2]          # no counter: range


def test_accum_steps_4_counts_one_microbatch_times_four():
    cfg = get_config("stablelm-1.6b").reduced()
    shape = ShapeConfig("t", 16, 8, "train")
    counts = {}
    for accum, fold in ((1, True), (4, True), (4, False), (8, True),
                        (8, False)):
        step, args, got = D.build_step(cfg, shape, accum_steps=accum)
        assert got == accum
        counts[accum, fold] = C.count(step, *args, fold_trips=fold)
    assert counts[4, True].flops == counts[4, False].flops \
        == counts[8, True].flops == counts[8, False].flops \
        == counts[1, True].flops
    # a loop of four trips runs whole; of eight, four microbatches of
    # dispatches (trips 0 and 1, trip 2 counted five times, trip 7)
    assert counts[4, True].n_ops == counts[4, False].n_ops
    assert counts[8, True].n_ops < 0.6 * counts[8, False].n_ops


@pytest.mark.parametrize("accum", [2, 6])
def test_folded_train_step_reckons_the_unfolded_peak(accum):
    """The folded microbatch loop's later trips run beside the first's
    float32 gradient accumulator, so its reckoned peak is the unfolded
    loop's; FLOPs and bytes stay ``accum`` microbatches."""
    cfg = get_config("stablelm-1.6b").reduced()
    shape = ShapeConfig("t", 16, 12, "train")
    step, args, _ = D.build_step(cfg, shape, accum_steps=accum)
    step(*args)          # fills the process's rotary-table cache first
    folded = C.count(step, *args)
    unfolded = C.count(step, *args, fold_trips=False)
    assert folded.reckoned_peak_bytes == unfolded.reckoned_peak_bytes
    assert folded.temp_bytes == unfolded.temp_bytes
    assert folded.flops == unfolded.flops
    assert folded.hbm_bytes == unfolded.hbm_bytes


def test_top_contributors_list_ops_and_kernels():
    x, bank = torch.randn(4, 6, 12), _bank(12, 10)[0]
    idx = torch.arange(4, dtype=torch.int32)

    def f(x, bank, idx):
        return torch.tanh(ops.bank_mxv_pop(x, bank, idx)) @ torch.ones(10, 3)
    top = C.top_contributors(f, x, bank, idx, top=3)
    assert top["by_flops"][0][0] == "bank_mxv_pop"
    assert {r[0] for r in top["by_bytes"]} >= {"bank_mxv_pop", "mm"}


# ---------------------------------------------------------------- parity

def _ref_flops(arch, shape):
    cfg = ref_get_config(arch).reduced()
    model = ref_get_model(cfg)
    specs = ref_input_specs(cfg, shape)
    static = {}
    if "max_len" in specs:
        static["max_len"] = specs.pop("max_len")
    init = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    if shape.kind == "train":
        state = jax.eval_shape(
            lambda: RTS.init_train_state(model, jax.random.PRNGKey(0)))
        lowered = jax.jit(RTS.make_train_step(model, ROPT.AdamWConfig())
                          ).lower(state, specs)
    elif shape.kind == "prefill":
        lowered = jax.jit(RTS.make_serve_prefill(model, static)).lower(
            init, specs)
    else:
        cache = jax.eval_shape(
            lambda: model.init_cache(shape.global_batch, shape.seq_len))
        lowered = jax.jit(RTS.make_serve_decode(model)).lower(init, cache,
                                                              specs)
    return analyze_hlo(lowered.compile().as_text(), 1).flops


def _skipped_first_readout(cfg, shape):
    """The reference's first-chunk read-out against the zero state, which
    the port's mLSTM skips: 2*B*H*T0*dh*(dh + 1) FLOPs a mLSTM layer."""
    H, dh = cfg.n_heads, cfg.ssm_d_inner // cfg.n_heads
    t0 = min(128, shape.seq_len)
    return (cfg.n_layers // 2) * 2 * shape.global_batch * H * t0 * dh * (
        dh + 1)


@pytest.mark.parametrize("kind", [0, 1, 2], ids=["train", "prefill",
                                                 "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_flops_parity_with_the_reference_analyzer(family, kind):
    arch = FAMILIES[family]
    want = _ref_flops(arch, ref_reduced_shape(REF_SHAPES[kind]))
    cfg, shape = get_config(arch).reduced(), reduced_shape(SHAPES[kind])
    step, args, _ = D.build_step(cfg, shape, accum_steps=1)
    got = C.count(step, *args).flops
    if family == "ssm" and shape.kind == "prefill":
        assert got + _skipped_first_readout(cfg, shape) == want
    elif family == "ssm" and shape.kind == "train":
        # both zero-state terms skipped in the forward, the recomputation
        # and the backward (module docstring)
        assert got == pytest.approx(want, rel=0.27) and got < want
    else:
        assert got == pytest.approx(want, rel=0.01)
