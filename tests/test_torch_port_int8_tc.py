"""Row 7 (``csrc/int8_volume.cu``, the int8 correlation volume on the
tensor cores): the kernel's tiling, fragments and epilogue, emulated on
the CPU, bit for bit.

The kernel runs only on the card.  A block owns kMT m16 tiles of one
image row's W1 against kNChunk columns of W2 at a time; it copies the
int8 slabs into shared memory in rows of kRowBytes (16-byte chunks in
kStages commit groups, zeros past C and past the real rows), reads the
``mma.sync.m16n8k32`` fragments with ``ldmatrix`` from lane addresses,
scales the int32 accumulators in their fragments into a staged fp32 tile
and stores each output row from the stage.  These tests rebuild that in
numpy from the source's constants: which (w1, w2) outputs each block
writes (exactly once, for ragged W1, W2 and C), the fill's walk over
(row, chunk), the fragments as the PTX ISA lays them out (A row-major 16
x 32, B column-major 32 x 8, C 16 x 8: g = lane / 4, t = lane % 4), the
zero-filled k tail, and the epilogue's three roundings in JAX's order;
then the whole emulated kernel against the plain version
``quant.int8_volume_plain`` and the JAX package's
``pallas_int8_corr_volume`` (interpret mode), both bitwise (int32 views).
Inputs are made with numpy from a seed.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raftstereo_tpu.ops import quant as jquant
from raftstereo_tpu_torch.ops import _build, quant
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse


def geometry():
    """The tiling constants of ``int8_volume.cu``."""
    src = _build.source_text("int8_volume")

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    g = {n: const(n) for n in ("kMT", "kWarps", "kNChunk", "kKChunk",
                               "kStages")}
    assert re.search(r"kNTW = kNChunk / 8 / kWarps;", src)
    assert re.search(r"kRowBytes = kKChunk \+ 16;", src)
    assert re.search(r"kOutStride = kNChunk \+ 8;", src)
    g["kThreads"] = 32 * g["kWarps"]
    g["kNTW"] = g["kNChunk"] // 8 // g["kWarps"]
    g["kRowBytes"] = g["kKChunk"] + 16
    g["kOutStride"] = g["kNChunk"] + 8
    g["kARows"] = 16 * g["kMT"]
    return g


LANES = np.arange(32)
GROUP, QUAD = LANES // 4, LANES % 4


def stage_chunks(ksteps, stages):
    """The 16-byte chunks [q0, q0 + nq) of each commit group."""
    out = []
    for st in range(stages):
        q0 = 2 * (st * ksteps // stages)
        out.append((q0, 2 * ((st + 1) * ksteps // stages) - q0))
    return out


def fill_walk(slab_rows, nq, threads):
    """The (row, chunk) pairs ``fill_slab`` visits, thread by thread."""
    seen = []
    if nq <= 0:
        return seen
    dr, dq = threads // nq, threads % nq
    for t in range(threads):
        row, q = t // nq, t % nq
        while row < slab_rows:
            seen.append((row, q))
            row, q = row + dr, q + dq
            if q >= nq:
                q, row = q - nq, row + 1
    return seen


def ldmatrix_x4(smem, addr):
    """ldmatrix .x4 .b16: lane i gets, from matrix j, the 32-bit word
    i % 4 of the row whose address lane 8j + i/4 gave.  -> (32, 4)
    uint32."""
    regs = np.zeros((32, 4), np.uint32)
    for j in range(4):
        start = addr[8 * j + GROUP] + 4 * QUAD
        b = smem[start[:, None] + np.arange(4)].astype(np.uint32)
        regs[:, j] = b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24
    return regs


def _bytes(reg):
    return np.stack([(reg >> (8 * i)) & 0xFF for i in range(4)],
                    -1).astype(np.uint8).view(np.int8)


def mma_s8(d, a, b):
    """mma.sync.m16n8k32.row.col.s32.s8.s8.s32 with the PTX ISA's
    fragment layouts; d (32, 4) int64 accumulators, a (32, 4) and b (32,
    2) uint32 registers."""
    am = np.zeros((16, 32), np.int64)
    bm = np.zeros((32, 8), np.int64)
    for r in range(4):
        v = _bytes(a[:, r])                       # (32 lanes, 4 bytes)
        rows = GROUP + (8 if r in (1, 3) else 0)
        cols = 4 * QUAD + (16 if r >= 2 else 0)
        am[rows[:, None], cols[:, None] + np.arange(4)] = v
    for r in range(2):
        v = _bytes(b[:, r])
        ks = 4 * QUAD + 16 * r
        bm[ks[:, None] + np.arange(4), GROUP[:, None]] = v
    full = am @ bm                                # (16, 8) exact
    return d + np.stack([full[GROUP, 2 * QUAD], full[GROUP, 2 * QUAD + 1],
                         full[GROUP + 8, 2 * QUAD],
                         full[GROUP + 8, 2 * QUAD + 1]], -1)


def emulate(q1, s1, q2, s2, tail=0, stats=None):
    """``int8_corr_volume`` as the kernel computes it, block by block:
    q1 (N, W1, C), q2 (N, W2, C) int8, s1 (N, W1), s2 (N, W2) float32 ->
    (N, W1, W2) float32.  ``tail`` fills the chunks past C with that byte
    instead of 0 (a trap for the zero fill).  ``stats`` counts each
    output's writes."""
    g = geometry()
    mt, ntw, nchunk, kchunk = g["kMT"], g["kNTW"], g["kNChunk"], g["kKChunk"]
    rb, ostride, arows = g["kRowBytes"], g["kOutStride"], g["kARows"]
    n_rows, w1, c = q1.shape
    w2 = q2.shape[1]
    inv = np.float32(quant.inv_sqrt_channels(c))
    out = np.full((n_rows, w1, w2), np.nan, np.float32)
    writes = np.zeros((n_rows, w1, w2), np.int64)
    sb_off = arows * rb
    for n in range(n_rows):
        for r0 in range(0, w1, arows):
            rows = min(arows, w1 - r0)
            for n0 in range(0, w2, nchunk):
                cols = min(nchunk, w2 - n0)
                acc = np.zeros((mt, ntw, g["kWarps"], 32, 4), np.int64)
                for k0 in range(0, c, kchunk):
                    kc = min(kchunk, c - k0)
                    ksteps = (kc + 31) // 32
                    smem = np.full((arows + nchunk) * rb, 0xAB, np.uint8)
                    for base, src, nr, slab in (
                            (0, q1[n, r0:], rows, arows),
                            (sb_off, q2[n, n0:], cols, nchunk)):
                        for q0, nq in stage_chunks(ksteps, g["kStages"]):
                            for row, q in fill_walk(slab, nq,
                                                    g["kThreads"]):
                                qq = q0 + q
                                at = base + row * rb + 16 * qq
                                if row < nr and 16 * qq < kc:
                                    chunk = src[row, k0 + 16 * qq:
                                                k0 + 16 * qq + 16]
                                    smem[at:at + 16] = chunk.view(np.uint8)
                                else:
                                    smem[at:at + 16] = tail
                    for ks in range(ksteps):
                        a = [ldmatrix_x4(smem, (m * 16 + (LANES & 15)) * rb
                                         + ks * 32 + (LANES >> 4) * 16)
                             for m in range(mt)]
                        for w in range(g["kWarps"]):
                            for j in range(0, ntw, 2):
                                nt = w * ntw + j
                                if nt * 8 >= cols:
                                    break
                                b = ldmatrix_x4(
                                    smem, sb_off
                                    + ((nt + (LANES >> 4)) * 8 + (LANES & 7))
                                    * rb + ks * 32
                                    + ((LANES >> 3) & 1) * 16)
                                for m in range(mt):
                                    acc[m, j, w] = mma_s8(acc[m, j, w], a[m],
                                                          b[:, :2])
                                    acc[m, j + 1, w] = mma_s8(
                                        acc[m, j + 1, w], a[m], b[:, 2:])
                # epilogue into the stage, then the rows' stores
                stage = np.full((arows, ostride), np.nan, np.float32)
                s1s = np.full(arows, np.float32(7.0), np.float32)
                s2s = np.full(nchunk, np.float32(7.0), np.float32)
                s1s[:rows] = s1[n, r0:r0 + rows]
                s2s[:cols] = s2[n, n0:n0 + cols]
                for m in range(mt):
                    ra = m * 16 + GROUP
                    for w in range(g["kWarps"]):
                        for j in range(ntw):
                            col = (w * ntw + j) * 8 + 2 * QUAD
                            if (w * ntw + j) * 8 >= cols:
                                break
                            d = acc[m, j, w].astype(np.int32)
                            for e, (rr, cc) in enumerate(
                                    ((ra, col), (ra, col + 1),
                                     (ra + 8, col), (ra + 8, col + 1))):
                                scale = s1s[rr] * s2s[cc]
                                stage[rr, cc] = (d[:, e].astype(np.float32)
                                                 * scale) * inv
                out[n, r0:r0 + rows, n0:n0 + cols] = stage[:rows, :cols]
                writes[n, r0:r0 + rows, n0:n0 + cols] += 1
    if stats is not None:
        stats["writes"] = writes
    return out


def _int_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def _inputs(rows, w1, w2, c, seed):
    """Codes over the full int8 range, rows of +127, -127 and -128 on
    every channel, and zero scales (signed zeros in the output)."""
    rng = np.random.default_rng(seed)
    q1 = rng.integers(-128, 128, (rows, w1, c)).astype(np.int8)
    q2 = rng.integers(-128, 128, (rows, w2, c)).astype(np.int8)
    for q in (q1, q2):
        q[0, 0], q[0, -1] = 127, -128
        q[-1, 1 % q.shape[1]] = -127
    s1 = rng.uniform(1e-3, 0.1, (rows, w1)).astype(np.float32)
    s2 = rng.uniform(1e-3, 0.1, (rows, w2)).astype(np.float32)
    s1[0, w1 // 2] = 0.0
    s2[-1, ::3] = 0.0
    return q1, s1, q2, s2


def _plain(q1, s1, q2, s2):
    t = [torch.from_numpy(a)[None] for a in (q1, s1, q2, s2)]
    return quant.int8_volume_plain(*t)[0].numpy()


@pytest.mark.parametrize("c", [16, 48, 256])
@pytest.mark.parametrize("w1", [9, 130, 240, 241])
@pytest.mark.parametrize("w2", [9, 130, 240, 241])
def test_tiles_write_every_output_once(w1, w2, c):
    """Every (w1, w2) output of an image row is written by exactly one
    block, from a stage entry some lane's fragment filled, and every
    n8 tile the epilogue reads had its products; the fill visits every
    (row, chunk) of both slabs once, the chunks past C zero-filled."""
    g = geometry()
    arows, nchunk, ntw = g["kARows"], g["kNChunk"], g["kNTW"]
    count = np.zeros((w1, w2), np.int64)
    for r0 in range(0, w1, arows):
        rows = min(arows, w1 - r0)
        for n0 in range(0, w2, nchunk):
            cols = min(nchunk, w2 - n0)
            staged = np.zeros((arows, g["kOutStride"]), bool)
            multiplied = set()
            for w in range(g["kWarps"]):
                for j in range(0, ntw, 2):
                    if (w * ntw + j) * 8 >= cols:
                        break
                    multiplied |= {w * ntw + j, w * ntw + j + 1}
                for j in range(ntw):
                    nt = w * ntw + j
                    if nt * 8 >= cols:
                        break
                    assert nt in multiplied
                    for m in range(g["kMT"]):
                        for rr in (m * 16 + GROUP, m * 16 + GROUP + 8):
                            for cc in (nt * 8 + 2 * QUAD,
                                       nt * 8 + 2 * QUAD + 1):
                                staged[rr, cc] = True
            assert staged[:rows, :cols].all()
            count[r0:r0 + rows, n0:n0 + cols] += 1
    assert (count == 1).all()
    kc = min(g["kKChunk"], c)
    ksteps = (kc + 31) // 32
    chunks = [(q0 + q, row) for q0, nq in stage_chunks(ksteps, g["kStages"])
              for row, q in fill_walk(nchunk, nq, g["kThreads"])]
    assert sorted(chunks) == [(q, row) for q in range(2 * ksteps)
                              for row in range(nchunk)]


def test_fragments_follow_the_ptx_layouts():
    """ldmatrix from the kernel's lane addresses, then the m16n8k32 mma
    on the PTX ISA's fragment layouts, gives the exact int8 product of
    one k-step: the address math puts A row-major and B column-major."""
    g = geometry()
    rb = g["kRowBytes"]
    rng = np.random.default_rng(3)
    a = rng.integers(-128, 128, (16, 32)).astype(np.int8)
    b = rng.integers(-128, 128, (16, 32)).astype(np.int8)  # 2 n8 tiles
    smem = np.zeros(32 * rb + 64, np.uint8)
    for r in range(16):
        smem[r * rb + 32:r * rb + 64] = a[r].view(np.uint8)   # k-step 1
        smem[(16 + r) * rb + 32:(16 + r) * rb + 64] = b[r].view(np.uint8)
    ra = ldmatrix_x4(smem, (LANES & 15) * rb + 32 + (LANES >> 4) * 16)
    rbm = ldmatrix_x4(smem, 16 * rb + ((LANES >> 4) * 8 + (LANES & 7)) * rb
                      + 32 + ((LANES >> 3) & 1) * 16)
    want = a.astype(np.int64) @ b.astype(np.int64).T           # (16, 16)
    for half in range(2):
        d = mma_s8(np.zeros((32, 4), np.int64), ra,
                   rbm[:, 2 * half:2 * half + 2])
        cols = 8 * half + 2 * QUAD
        assert (d[:, 0] == want[GROUP, cols]).all()
        assert (d[:, 1] == want[GROUP, cols + 1]).all()
        assert (d[:, 2] == want[GROUP + 8, cols]).all()
        assert (d[:, 3] == want[GROUP + 8, cols + 1]).all()


@pytest.mark.parametrize("c", [16, 48])
def test_zero_filled_k_tail(c):
    """C = 16 or 48 leaves half of the last 32-deep k-step past C: the
    kernel zero-fills it in shared memory, so the sum is exact; any other
    fill in both operands changes it."""
    q1, s1, q2, s2 = _inputs(1, 20, 18, c, seed=c)
    want = _plain(q1, s1, q2, s2)
    assert _int_bits(emulate(q1, s1, q2, s2), want)
    assert not _int_bits(emulate(q1, s1, q2, s2, tail=1), want)


def test_epilogue_rounding_order():
    """(float(acc) * (s1 * s2)) * inv, each product rounded once in that
    order, is the plain version bit for bit (signed zeros from a zero
    scale included); the other association is not."""
    rng = np.random.default_rng(5)
    acc = rng.integers(-127 * 127 * 256, 127 * 127 * 256, (64, 64))
    acc[0, 0], acc[1, 1] = 128 * 128 * 256, -5
    s1 = rng.uniform(1e-4, 0.1, 64).astype(np.float32)
    s2 = rng.uniform(1e-4, 0.1, 64).astype(np.float32)
    s2[1] = 0.0
    inv = np.float32(quant.inv_sqrt_channels(256))
    a32 = acc.astype(np.int32)
    mine = (a32.astype(np.float32) * (s1[:, None] * s2[None, :])) * inv
    plain = quant.dequant_epilogue(torch.from_numpy(a32),
                                   torch.from_numpy(s1),
                                   torch.from_numpy(s2), 256).numpy()
    assert _int_bits(mine, plain)
    assert np.signbit(plain[1, 1]) and plain[1, 1] == 0
    other = ((a32.astype(np.float32) * s1[:, None]) * s2[None, :]) * inv
    assert not _int_bits(other, plain)


@pytest.mark.parametrize("rows,w1,w2,c", [(2, 20, 18, 48), (1, 50, 9, 16),
                                          (1, 9, 30, 64)])
def test_emulated_kernel_bitwise_plain_and_jax(rows, w1, w2, c):
    """The whole emulated kernel, ragged tiles included, every output
    written once: bitwise equal to the plain version and to the JAX
    package's Pallas kernel in interpret mode."""
    q1, s1, q2, s2 = _inputs(rows, w1, w2, c, seed=w1 + w2)
    stats = {}
    got = emulate(q1, s1, q2, s2, stats=stats)
    assert (stats["writes"] == 1).all()
    assert _int_bits(got, _plain(q1, s1, q2, s2))
    want = np.asarray(jquant.pallas_int8_corr_volume(
        *(jnp.asarray(a)[None] for a in (q1, s1, q2, s2))))[0]
    assert _int_bits(got, want)
    assert np.signbit(want[want == 0]).any()   # -0 from the zero scales
