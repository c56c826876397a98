"""The batch-1 matvecs' plans on the CPU: the exact-f32 matvec's
(``q4k_matvec`` / ``q40_matvec``, ``csrc/q4k_matmul.cu``) and
``q80_matvec``'s (``csrc/q80_matvec.cu``, ``q80_plan``).

``ops.quant_matmul.matvec_splits`` picks, from N, K and the SM count, how
many warps of one CTA a row's 32-blocks are split over; the kernel takes
row tiles of MV_WARPS / splits groups of MV_ROWS rows, and split s of a
row takes blocks [s KB / S, (s + 1) KB / S), in groups of 8 blocks where
K/32 allows (``matvec_blocks``; ``matvec_units`` below lays out the tiles).
Pinned here for every linear of llama2-7b and
tinyllama-1.1b at the H100's 132 SMs, and for N in {1, 37, 300}: every
(row, block) in exactly one unit, every split whole 32-blocks and none
empty, the split count a power of two dividing the CTA's warps. A sum
taken in the units' order (each split's blocks, then the splits in order)
is held against the plain version ``qmatmul_ref`` at 1e-4 * max, the
kernel's bound on the card: only the order of the f32 block sum moves.

``q80_plan`` gives ``q80_matvec`` the same units (4-row groups, 8 warps a
CTA, ``matvec_blocks``' spans) from its own split rule, with its ring depth
and grid; pinned here the same way, its sums held against
``qmatmul_ref(..., torch.bfloat16)``, its reference rounding."""

import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm

SMS = 132


def matvec_units(n: int, k: int, splits: int, rows_a_group=qm.MV_ROWS):
    """(rows, blocks) of each warp's share of each row tile, in the
    kernel's order (tile, row group, split): a tile is MV_WARPS / splits
    groups of ``rows_a_group`` rows (MV_ROWS; Q80_ROWS for q80_matvec),
    cut at N; a group's warps take its rows' ``matvec_blocks`` spans, and
    their partial sums are added in split order."""
    groups = qm.MV_WARPS // splits
    out = []
    for t0 in range(0, n, groups * rows_a_group):
        for g in range(groups):
            r0 = t0 + g * rows_a_group
            rows = range(r0, min(r0 + rows_a_group, n))
            if rows:
                out += [(rows, span)
                        for span in qm.matvec_blocks(k, splits)]
    return out


SHAPES_7B = [(12288, 4096), (4096, 4096), (24576, 4096), (4096, 12288),
             (4096, 11008), (32000, 4096)]
SHAPES_TINY = [(2048, 2048), (2560, 2048), (11264, 2048), (2048, 5632)]
SMALL = [(n, k) for n in (1, 37, 300) for k in (256, 2048, 5632, 12288)]

# the split at each listed shape on 132 SMs: full-width layers take one
# warp a row group; W_o and the w_down layers, and tinyllama's narrow
# layers, split each row
PINNED = {(24576, 4096): 1, (12288, 4096): 1, (32000, 4096): 1,
          (4096, 4096): 4, (4096, 12288): 4, (4096, 11008): 4,
          (2048, 2048): 2, (2560, 2048): 2, (11264, 2048): 1,
          (2048, 5632): 4}


@pytest.mark.parametrize("n,k", SHAPES_7B + SHAPES_TINY + SMALL)
def test_every_row_block_in_exactly_one_unit(n, k):
    s = qm.matvec_splits(n, k, SMS)
    assert s in (1, 2, 4, 8) and qm.MV_WARPS % s == 0
    if (n, k) in PINNED:
        assert s == PINNED[(n, k)]
    kb = k // 32
    spans = qm.matvec_blocks(k, s)
    assert len(spans) == s
    assert spans[0][0] == 0 and spans[-1][1] == kb
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 == b0
    assert all(b1 > b0 for b0, b1 in spans)           # none empty
    assert s == 1 or min(b1 - b0 for b0, b1 in spans) >= 32
    seen = np.zeros((n, kb), np.int64)
    units = matvec_units(n, k, s)
    for rows, (b0, b1) in units:
        assert 1 <= len(rows) <= qm.MV_ROWS
        seen[rows.start:rows.stop, b0:b1] += 1
    assert (seen == 1).all()
    assert len(units) == -(-n // qm.MV_ROWS) * s


def test_split_count_follows_the_sm_count():
    """Fewer SMs need fewer splits; a width that fills the card takes
    none; K below 64 blocks cannot split."""
    assert qm.matvec_splits(4096, 4096, 132) == 4
    assert qm.matvec_splits(4096, 4096, 32) == 1
    assert qm.matvec_splits(4096, 4096, 66) == 2
    assert qm.matvec_splits(100000, 4096, 132) == 1
    assert qm.matvec_splits(8, 1024, 132) == 1
    with pytest.raises(ValueError):
        qm.matvec_splits(8, 48, 132)


@pytest.mark.parametrize("fmt", ["q4_k", "q4_0"])
@pytest.mark.parametrize("n,k,sms", [(37, 2048, 132), (300, 5632, 132),
                                     (64, 4096, 8)])
def test_sum_in_the_units_order_matches_the_plain_version(fmt, n, k, sms):
    rng = np.random.default_rng(n + k)
    w = torch.from_numpy((rng.normal(size=(n, k)) * k ** -0.5)
                         .astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(1, k)).astype(np.float32))
    ql = qm.quantize(w, fmt)
    wd = qm.dequantize(ql).double().reshape(n, k // 32, 32)
    xb = x.double().reshape(k // 32, 32)
    # w = q * scale - min a block: the per-block f32 dot and fold of the
    # kernel, here in f64 (the order of the splits is what is checked)
    per_block = (wd * xb).sum(-1)                          # [n, KB]
    s = qm.matvec_splits(n, k, sms)
    y = torch.zeros(n, dtype=torch.float64)
    for rows, (b0, b1) in matvec_units(n, k, s):
        y[rows.start:rows.stop] += per_block[rows.start:rows.stop,
                                             b0:b1].sum(-1)
    ref = qm.qmatmul_ref(x, ql, torch.float32)[0].double()
    assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()


# q80_plan at each listed shape on 132 SMs: (splits, stages, grid). Two
# stages and two CTAs an SM up to K 8192, three stages and one CTA at
# K 11008 / 12288; with 2-row groups every 7B and tinyllama linear fills
# the card unsplit, the start cases (N = 4) split in eight
PINNED_Q80 = {(24576, 4096): (1, 2, 264), (12288, 4096): (1, 2, 264),
              (32000, 4096): (1, 2, 264), (4096, 4096): (1, 2, 256),
              (4096, 12288): (1, 3, 132), (4096, 11008): (1, 3, 132),
              (2048, 2048): (1, 2, 128), (2560, 2048): (1, 2, 160),
              (11264, 2048): (1, 2, 264), (2048, 5632): (1, 2, 128),
              (4, 4096): (8, 2, 2), (4, 5632): (8, 2, 2),
              (300, 12288): (4, 3, 75), (37, 5632): (8, 2, 19)}


@pytest.mark.parametrize("n,k", SHAPES_7B + SHAPES_TINY + SMALL
                         + [(4, 4096), (4, 5632), (1, 96), (37, 8224)])
def test_q80_plan_covers_every_row_block_once(n, k):
    s, stages, grid = qm.q80_plan(n, k, SMS)
    assert s in (1, 2, 4, 8) and qm.MV_WARPS % s == 0
    assert stages == qm.q80_stages(k)[0]
    if (n, k) in PINNED_Q80:
        assert (s, stages, grid) == PINNED_Q80[(n, k)]
    tiles = -(-n // (qm.MV_WARPS // s * qm.Q80_ROWS))
    assert 1 <= grid <= min(tiles, qm.q80_stages(k)[1] * SMS)
    kb = k // 32
    spans = qm.matvec_blocks(k, s)
    assert spans[0][0] == 0 and spans[-1][1] == kb
    assert all(b1 > b0 for b0, b1 in spans)           # none empty
    seen = np.zeros((n, kb), np.int64)
    for rows, (b0, b1) in matvec_units(n, k, s, qm.Q80_ROWS):
        seen[rows.start:rows.stop, b0:b1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("k,want", [(2048, (2, 2)), (4096, (2, 2)),
                                    (5632, (2, 2)), (8192, (2, 2)),
                                    (11008, (3, 1)), (12288, (3, 1)),
                                    (28672, (3, 1)), (32768, (2, 1))])
def test_q80_stages_fit_the_shared_memory(k, want):
    """The ring depth and CTAs an SM: what fits 228 KB an SM (227 KB a
    CTA, 1 KB reserved each); past that, K is refused."""
    assert qm.q80_stages(k) == want
    stages, per_sm = want
    cta = (qm.q80_x_bytes(k) + qm.MV_WARPS * stages * qm.Q80_STAGE_BYTES
           + qm.Q80_STATIC_BYTES)
    assert cta <= qm.SMEM_PER_CTA
    assert per_sm * (cta + qm.SMEM_RESERVED_PER_CTA) <= qm.SMEM_PER_SM


def test_q80_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        qm.q80_stages(48 * 1024)
    with pytest.raises(ValueError):
        qm.q80_plan(0, 4096, SMS)
    assert qm.q80_plan(4096, 4096, 32)[0] <= qm.q80_plan(4096, 4096, SMS)[0]


@pytest.mark.parametrize("n,k,sms", [(37, 2048, 132), (300, 5632, 132),
                                     (64, 4096, 8), (5, 96, 132)])
def test_q80_sum_in_the_units_order_matches_the_plain_version(n, k, sms):
    rng = np.random.default_rng(n + k)
    w = torch.from_numpy((rng.normal(size=(n, k)) * k ** -0.5)
                         .astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(1, k)).astype(np.float32))
    ql = qm.quantize(w, "q8_0")
    # bf16(q * d) . bf16(x) a block, each product exact, here in f64
    wd = qm.dequantize(ql).to(torch.bfloat16).double().reshape(
        n, k // 32, 32)
    xb = x.to(torch.bfloat16).double().reshape(k // 32, 32)
    per_block = (wd * xb).sum(-1)
    s = qm.q80_plan(n, k, sms)[0]
    y = torch.zeros(n, dtype=torch.float64)
    for rows, (b0, b1) in matvec_units(n, k, s, qm.Q80_ROWS):
        y[rows.start:rows.stop] += per_block[rows.start:rows.stop,
                                             b0:b1].sum(-1)
    ref = qm.qmatmul_ref(x, ql, torch.bfloat16)[0].double()
    assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()
