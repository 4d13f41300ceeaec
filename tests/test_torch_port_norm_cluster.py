"""Row 8's cluster form (``csrc/inorm.cu``'s ``inorm_cluster_kernel``,
``norm.in_norm_cluster``): its plan and numerics, on the CPU.

The kernel runs only on the card.  These tests hold what surrounds it,
from the source's own constants: the form ``instance_norm_act`` takes at
each shape (blocks a plane and bytes a block; the two-kernel form beyond
16 blocks of the largest slice), and that the slices of a plane cover it
once; an emulation of the kernel's summation order (per thread over its
16-byte vectors, or its scalars where the plane is not a whole number of
vectors, a butterfly per warp, the warps in order, the cluster's ranks
in order; fp32) within 1e-5 of ``in_stats_plain``; and the whole op with
those statistics against the JAX package's ``instance_norm_act`` (its
Pallas kernels in interpret mode) in fp32 and bf16, with and without
relu, on a constant plane (the variance's clamp), a NaN plane and planes
of a size that is not a multiple of the vector.  Inputs are made with
numpy from a seed.
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse

from raftstereo_tpu.ops.pallas_norm import instance_norm_act as jax_in
from raftstereo_tpu_torch.ops import _build
from raftstereo_tpu_torch.ops import norm

BF16_ULP = 2.0 ** -7
INORM_TOL = 1e-5  # fp32 plane sums in another order
SMEM_PER_SM, SMEM_PER_BLOCK, RESERVED = 233472, 232448, 1024  # H100 bytes


@functools.lru_cache(maxsize=None)
def constants():
    """The cluster form's constants, from ``inorm.cu``."""
    src = _build.sources()["inorm"].read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+);", src).group(1))

    got = {n: const(n) for n in ("kClusterThreads", "kMaxCluster",
                                 "kTargetSliceBytes", "kMaxSliceBytes")}
    # the slice and the vector form, as the C entry point computes them
    assert "slice = ((hw + cs - 1) / cs + v - 1) / v * v" in src
    assert "vec = hw % v == 0 && aligned16(x) && aligned16(y)" in src
    assert "__launch_bounds__(kClusterThreads, 3)" in src
    return got


def plan(hw, esize):
    """The form at planes of ``hw`` values of ``esize`` bytes, derived from
    the source's constants: (blocks a plane, values a block), None for the
    two-kernel form."""
    c = constants()
    v = 16 // esize

    def vals(cs):
        return -(-(-(-hw // cs)) // v) * v

    for cs in (1, 2, 4, 8, 16):
        if cs <= c["kMaxCluster"] and vals(cs) * esize <= c[
                "kTargetSliceBytes"]:
            return cs, vals(cs)
    cs = c["kMaxCluster"]
    return (cs, vals(cs)) if vals(cs) * esize <= c["kMaxSliceBytes"] else None


def test_constants_fit_the_card():
    """The wrapper's numbers are the source's; three blocks of the target
    slice fit an SM's shared memory (with the static sums and the 1 KB the
    card reserves a block) and a block of the largest slice fits a block's
    limit."""
    c = constants()
    assert (norm._MAX_CLUSTER, norm._TARGET_SLICE, norm._MAX_SLICE) == (
        c["kMaxCluster"], c["kTargetSliceBytes"], c["kMaxSliceBytes"])
    static = 8 * (c["kClusterThreads"] // 32) + 8 + 8 + 8
    assert 3 * (c["kTargetSliceBytes"] + static + RESERVED) <= SMEM_PER_SM
    assert c["kMaxSliceBytes"] + static <= SMEM_PER_BLOCK
    assert c["kTargetSliceBytes"] % 16 == c["kMaxSliceBytes"] % 16 == 0


@pytest.mark.parametrize("shape,dtype,want", [
    ((2, 64, 288, 480), torch.float32, (8, 69120)),   # op_serve
    ((12, 64, 160, 360), torch.float32, (4, 57600)),  # op_train
    ((2, 64, 288, 480), torch.bfloat16, (4, 69120)),
    ((12, 64, 160, 360), torch.bfloat16, (2, 57600)),
    ((3, 5, 7, 9), torch.float32, (1, 256)),
    ((1, 2, 5, 7), torch.bfloat16, (1, 80)),
    ((1, 1, 896, 1024), torch.float32, (16, 229376)),  # the last that fits
    ((1, 1, 897, 1024), torch.float32, None),           # two kernels
    ((1, 2, 1024, 1024), torch.float32, None),
    ((1, 1, 1792, 1024), torch.bfloat16, (16, 229376)),
    ((1, 1, 1793, 1024), torch.bfloat16, None)],
    ids=["op_serve", "op_train", "op_serve_bf16", "op_train_bf16", "odd",
         "odd_bf16", "largest", "beyond", "megapixel", "largest_bf16",
         "beyond_bf16"])
def test_form_at_each_shape(shape, dtype, want):
    """``cluster_plan`` at each shape: blocks a plane and bytes a block
    (``want`` as (blocks, bytes)) as the source's constants give them; the
    ranks' slices cover every value of the plane once, the last ranks
    possibly short or empty."""
    esize = 2 if dtype == torch.bfloat16 else 4
    hw = shape[2] * shape[3]
    got = norm.cluster_plan(hw, dtype)
    assert got == plan(hw, esize)
    assert (None if got is None else (got[0], got[1] * esize)) == want
    if got is not None:
        cs, vals = got
        seen = np.zeros(hw, int)
        for r in range(cs):
            seen[r * vals:min((r + 1) * vals, hw)] += 1
        assert (seen == 1).all() and (cs - 1) * vals < hw


def _fma(v, q):
    """fmaf(v, v, q) in fp32 (through float64: v*v is exact there)."""
    return (v.astype(np.float64) * v + q).astype(np.float32)


def _butterfly(s):
    """``s += __shfl_xor_sync(s, m)`` for m = 16 .. 1 over the last axis
    (32 lanes); fp32."""
    lanes = np.arange(32)
    for m in (16, 8, 4, 2, 1):
        s = s + s[..., lanes ^ m]
    return s


def cluster_sums(x):
    """(sum, sum of squares), each (B*C,) fp32, of an NCHW tensor's planes
    in the cluster kernel's order (16-byte vectors where H*W is a multiple
    of the vector, scalars otherwise)."""
    threads = constants()["kClusterThreads"]
    b, c, h, w = x.shape
    hw = h * w
    esize = x.element_size()
    cs, vals = plan(hw, esize)
    v = 16 // esize if hw % (16 // esize) == 0 else 1  # values an access
    planes = x.float().reshape(b * c, hw).numpy()
    total = np.zeros((2, b * c), np.float32)
    for r in range(cs):
        sl = planes[:, r * vals:min((r + 1) * vals, hw)]
        n_acc = -(-sl.shape[1] // v)
        rounds = -(-n_acc // threads)
        # access a of thread t is a = t + k * threads; pad with zeros, which
        # leave both sums as they were
        pad = np.zeros((b * c, rounds * threads * v), np.float32)
        pad[:, :sl.shape[1]] = sl
        acc = pad.reshape(b * c, rounds, threads, v)
        s = np.zeros((b * c, threads), np.float32)
        q = np.zeros((b * c, threads), np.float32)
        for k in range(rounds):
            for e in range(v):
                s = s + acc[:, k, :, e]
                q = _fma(acc[:, k, :, e], q)
        for i, t in enumerate((s, q)):
            lanes = _butterfly(t.reshape(b * c, threads // 32, 32))[..., 0]
            blk = np.zeros(b * c, np.float32)
            for wp in range(threads // 32):  # the warps in order
                blk = blk + lanes[:, wp]
            total[i] = total[i] + blk  # the ranks in order
    return total


def raw_var(x):
    """s2/n - mean^2 of each plane from ``cluster_sums``, before the
    clamp; and the mean."""
    s1, s2 = cluster_sums(x)
    n = np.float32(x.shape[2] * x.shape[3])
    mean = s1 / n
    return s2 / n - mean * mean, mean


def cluster_stats(x):
    """(mean, rstd), each (B, C) fp32, from ``cluster_sums`` by the
    kernel's epilogue (the variance clamped at 0, NaN kept)."""
    var, mean = raw_var(x)
    var = np.where(np.isnan(var), var, np.maximum(var, np.float32(0)))
    rstd = np.float32(1) / np.sqrt(var + np.float32(1e-5))
    b, c = x.shape[:2]
    return (torch.from_numpy(mean.reshape(b, c)),
            torch.from_numpy(rstd.reshape(b, c)))


def _input(shape, dtype, seed, special=True):
    """A seeded NCHW input centred off zero; with ``special``, plane (0, 1)
    constant (2001: sums exact in any order, so the mean is exact and the
    plane normalises to 0, while s2/n - mean^2 can round below 0) and
    plane (1, 0) holding one NaN."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 1.7 + 0.6).astype(np.float32)
    if special:
        x[0, 1] = 2001.0
        x[1, 0, shape[2] // 2, shape[3] // 3] = np.nan
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("shape,dtype", [
    ((1, 2, 288, 480), torch.float32),
    ((1, 2, 160, 360), torch.float32),
    ((1, 2, 288, 480), torch.bfloat16),
    ((2, 3, 45, 37), torch.float32),
    ((2, 3, 45, 37), torch.bfloat16)],
    ids=["serve_planes", "train_planes", "serve_planes_bf16", "odd",
         "odd_bf16"])
def test_cluster_order_within_tol_of_plain(shape, dtype):
    """The cluster form's statistics in the kernel's order within 1e-5 of
    ``in_stats_plain`` (relative to max(1, |plain|)) at the op path's
    plane sizes (8 and 4 blocks a plane) and an odd one (H*W not a whole
    number of vectors: the scalar path)."""
    x = _input(shape, dtype, 3, special=False)
    for got, want in zip(cluster_stats(x), norm.in_stats_plain(x)):
        err = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        assert err <= INORM_TOL, err


def _close(got, want, rel):
    """Equal NaN positions; elsewhere |got - want| <= rel * max(1,
    |want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    err = np.abs(got[ok] - want[ok]) / np.maximum(1.0, np.abs(want[ok]))
    assert err.max() <= rel, err.max()


@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 3, 6, 7), (2, 3, 8, 16),
                                   (2, 3, 160, 130), (2, 3, 45, 37)],
                         ids=["hw42", "hw128", "two_blocks", "hw1665"])
def test_cluster_op_matches_jax(shape, dtype, relu):
    """The op with the cluster form's statistics (and the kernel's apply,
    which is ``in_apply_plain``'s arithmetic), and the port's
    ``instance_norm_act`` on the CPU, against the JAX package's
    ``instance_norm_act`` (interpret mode): within 1e-5 of max(1, |ref|) in
    fp32, one bf16 ulp in bf16; a constant plane (0 throughout; its
    variance rounds to 0 or below, and below -1e-5, where the plane would
    be NaN without the clamp, in fp32 at every H*W but 128 and in bf16 at
    1665), a NaN plane (NaN throughout, as in JAX), H*W = 42 and 1665 (not
    a multiple of 4 or 8), 128 and two blocks a plane (20,800 values)."""
    x = _input(shape, dtype, 5)
    hw = shape[2] * shape[3]
    var = raw_var(x)[0][1]  # the constant plane
    assert var <= 0 and (var < -1e-5) == (
        hw == 1665 or (dtype == torch.float32 and hw != 128)), var
    jx = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy(),
                     jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = np.asarray(jax_in(jx, relu).astype(jnp.float32))
    rel = BF16_ULP if dtype == torch.bfloat16 else INORM_TOL
    emulated = norm.in_apply_plain(x, *cluster_stats(x), relu)
    port = norm.instance_norm_act(x, relu)
    for got in (emulated, port):
        assert got.dtype == dtype
        _close(got.float().permute(0, 2, 3, 1).numpy(), want, rel)
    assert np.isnan(want[1, ..., 0]).all()
    assert not np.isnan(want[0]).any() and not want[0, ..., 1].any()
