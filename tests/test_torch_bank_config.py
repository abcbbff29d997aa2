"""The bank GEMM's launch plan, chosen on the host (``kernels/ops.py``):
which tile configuration of ``csrc/bank_gemm.cuh`` a shape gets, which copy
width the strides and base pointers allow, and that every configuration
fits the card's shared memory. The kernels themselves, every configuration
forced, are held to each other bitwise in ``test_torch_cuda.py``."""
import pytest
import torch

from repro_torch.kernels import ops

# (m, N) of the search path's MxVs: the first SRU layer's input, a hidden
# layer's 3n outputs, a projection, the output layer
LAYERS = {"L0": (23, 1650), "L": (256, 1650), "Pr": (1100, 256),
          "FC": (1100, 1904)}
SMEM_PER_SM = 233472             # H100: 228 KB of shared memory per SM
RESERVED_PER_BLOCK = 1024        # the runtime's share of each block's


@pytest.mark.parametrize("P", [16, 32])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_search_shapes_get_a_large_m_tile(layer, P):
    cfg = ops.BANK_CONFIGS[ops.bank_config(P, 1536, LAYERS[layer][1])]
    assert cfg.bm == 128


@pytest.mark.parametrize("P,M", [(8, 16), (4, 7), (1, 16), (8, 1)])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_serving_shapes_get_the_small_m_tile(layer, P, M):
    cfg = ops.BANK_CONFIGS[ops.bank_config(P, M, LAYERS[layer][1])]
    assert cfg.bm == 16


def test_large_m_tile_follows_how_the_grid_fills_the_card():
    """Pr at P = 16: 384 blocks of 128 x 128 fill 1.45 waves of 264 slots
    (2 an SM), 768 of 128 x 64 fill 1.94 of 396 (3 an SM): the smaller
    tile leaves less of the card idle. At P = 32 both fill whole waves and
    the larger tile, cheaper per output, wins; FC fills 10.9 waves of it,
    L 9.5."""
    assert ops.bank_config(16, 1536, 256) == 1
    assert ops.bank_config(32, 1536, 256) == 0
    assert ops.bank_config(16, 1536, 1904) == 0
    assert ops.bank_config(16, 1536, 1650) == 0


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_packed_kernel_takes_the_three_block_tile_at_the_search_shapes(layer):
    """bank_qmm_pop's loads and dequantization hide better behind three
    blocks an SM (128 x 64) than two (128 x 128): it takes the smaller
    large-M tile wherever the grid allows, at the search's P = 16."""
    N = LAYERS[layer][1]
    assert ops.bank_config(16, 1536, N, kernel="bank_qmm_pop") == 1
    assert ops.bank_config(8, 16, N, kernel="bank_qmm_pop") == 2


def test_config_choice_follows_the_card_size():
    """The same shape on a card with more SMs may change tile, never to one
    that is not in the table."""
    for sms in (1, 66, 132, 264):
        for P in (1, 3, 16):
            for N in (1, 64, 256, 1650, 1904):
                assert ops.bank_config(P, 1536, N, sms) in (0, 1)


@pytest.mark.parametrize("i", range(len(ops.BANK_CONFIGS)))
def test_every_config_fits_the_card(i):
    cfg = ops.BANK_CONFIGS[i]
    smem = cfg.smem_bytes + 4 * cfg.bn          # bank_qmm_pop's scales too
    assert smem <= ops.SMEM_PER_BLOCK
    # the blocks its launch bounds promise fit one SM's shared memory and
    # threads
    assert cfg.min_blocks * (smem + RESERVED_PER_BLOCK) <= SMEM_PER_SM
    assert cfg.min_blocks * cfg.threads <= 2048
    # whole warps; TN = 8 columns and TM rows per thread cover the tile
    assert cfg.threads % 32 == 0
    assert (cfg.bm // cfg.tm) * (cfg.bn // 8) == cfg.threads
    # every configuration shares the K depth, so the zero-filled tail of
    # the last K tile, and with it every output bit, is the same
    assert cfg.bk == ops.BANK_CONFIGS[0].bk == 16


def test_smem_bytes_count_both_rings():
    cfg = ops.BANK_CONFIGS[0]
    assert cfg.smem_bytes == 4 * 4 * (16 * 132 + 16 * 128) == 66560


@pytest.mark.parametrize("what,quantities,widths,want", [
    ("f32 rows of 23", (4 * 23, 0), (16, 8, 4), 4),
    ("f32 bank rows at L, N = 1650", (4 * 1650, 4 * 256), (16, 8, 4), 8),
    ("f32 rows at FC", (4 * 1904, 4 * 1100), (16, 8, 4), 16),
    ("int8 rows at L, N = 1650", (1650,), (16, 8, 4, 2, 1), 2),
    ("int8 rows at N = 255", (255,), (16, 8, 4, 2, 1), 1),
    ("int16 rows at N = 255", (2 * 255,), (16, 8, 4, 2), 2),
    ("a base 4 bytes past 16", (4 * 1904, 256 + 4), (16, 8, 4), 4),
    ("a base 8 bytes past 16", (4 * 1904, 256 + 8), (16, 8, 4), 8),
])
def test_copy_width_divides_every_stride_and_base(what, quantities, widths,
                                                  want):
    w = ops.copy_width(*quantities, widths=widths)
    assert w == want, what
    assert all(q % w == 0 for q in quantities)


def test_copy_width_refuses_what_no_width_divides():
    with pytest.raises(ValueError, match="no copy width"):
        ops.copy_width(4 * 23, 2)                # an f32 base at 2 bytes


def test_forced_config_out_of_range_is_refused():
    dev = torch.device("cpu")
    assert ops._bank_config_for("bank_mxv_pop", dev, 2, 3, 4, 2) == 2
    for bad in (-1, len(ops.BANK_CONFIGS)):
        with pytest.raises(ValueError, match="config"):
            ops._bank_config_for("bank_mxv_pop", dev, 2, 3, 4, bad)


def test_cpu_wrappers_ignore_the_config():
    """On the CPU a wrapper runs the plain version, whatever configuration
    is asked for: the choice concerns the card's tiles only."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 6, generator=g)
    bank = torch.randn(4, 6, 7, generator=g)
    idx = torch.tensor([3, 0], dtype=torch.int32)
    want = ops.bank_mxv_pop(x, bank, idx)
    for c in range(len(ops.BANK_CONFIGS)):
        assert torch.equal(ops.bank_mxv_pop(x, bank, idx, config=c), want)

