"""The port's lookup at caller-given taps (rows 3 and 4 of PERF.md's kernel
table) and stand-alone instance norm (row 8) against the JAX package on
the CPU: the plain versions, which the CUDA kernels are held to on the
card, against ``pallas_alt_lookup``, ``pallas_alt_pyramid_flat`` and
``instance_norm_act`` run as the JAX package's tests run them here (the
Pallas kernels in interpret mode).

Tolerances: the lookup in fp32 within 1e-5 of max(1, |ref|) (dots of
length C summed in another order, and the hat weight 1 - |j - t| against
the lerp weight f, equal up to fp32 rounding); with a bf16 output within
one bf16 ulp (2^-7) of max(1, |ref|); its gradients within 1e-4 of the
largest (sums of up to 2*K products per column, reordered), the taps'
exactly 0.  Instance norm within 1e-5 in fp32 (plane sums in another
order) and one bf16 ulp in bf16; its gradient within 1e-4 of the
largest in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse

from raftstereo_tpu.ops import pallas_alt as jalt
from raftstereo_tpu.ops.pallas_norm import instance_norm_act as jax_in
from raftstereo_tpu_torch.ops import alt_lookup as talt
from raftstereo_tpu_torch.ops import norm as tnorm

BF16_ULP = 2.0 ** -7


def _close(got, want, rel, name=""):
    """Equal NaN positions; elsewhere |got - want| <= rel * max(1, |want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
    ok = ~np.isnan(want)
    err = np.abs(got[ok] - want[ok]) / np.maximum(1.0, np.abs(want[ok]))
    assert err.size == 0 or err.max() <= rel, (name, err.max(), rel)


def _np(t):
    return t.detach().float().numpy()


def _taps(rng, shape, widths, nan=True):
    """Per-level local taps (B, H, W1, L*K), level-major, mixing random
    reals in [-3, w + 3], exact integers, the radial pattern around a
    random center, far-outside and infinite taps and NaN taps."""
    b, h, w1, kk = shape
    cols = []
    for w in widths:
        t = rng.uniform(-3.0, w + 3.0, (b, h, w1, kk))
        t[..., 0] = np.floor(t[..., 0])                       # integers
        center = rng.uniform(-2.0, w + 1.0, (b, h, w1, 1))
        t[..., 1:4] = center + np.arange(-1, 2)               # radial
        t[0, 0, :4, -1] = [-1e6, 1e6, np.inf, -np.inf]        # far outside
        t[1, 1, 2, -1] = w - 1.0                              # last column
        t[1, 1, 3, -1] = w - 0.5                              # past the edge
        t[1, 0, 0, -1] = -0.5                                 # before it
        if nan:
            t[1, 2, 5, 2] = np.nan
        cols.append(t)
    return np.concatenate(cols, axis=-1).astype(np.float32)


def _pyramid(rng, b, h, w1, c, widths, pad=0):
    """fmap1 (B, H, W1, C) and the concatenated fmap2 pyramid (B, H, sum,
    C); with ``pad`` each level is followed by that many zero columns."""
    f1 = rng.standard_normal((b, h, w1, c)).astype(np.float32)
    levels = [np.concatenate([rng.standard_normal((b, h, w, c)),
                              np.zeros((b, h, pad, c))], axis=2)
              for w in widths]
    return f1, np.concatenate(levels, axis=2).astype(np.float32)


def _jax_flat(f1, f2):
    """The JAX package's preflattened operands (its TPU row and W1
    padding included)."""
    return jalt.preflatten_fmap1(f1), jalt.preflatten_fmap2(f2)


def _port_flat(f1, f2):
    return talt.preflatten_fmap1(f1), talt.preflatten_fmap2(f2)


CASES = {
    # name: (B, H, W1, C, real widths, taps per level, zero pad per level)
    "one_level": (2, 3, 20, 16, (17,), 7, 0),
    "three_levels": (2, 3, 20, 16, (20, 10, 5), 6, 0),
    "three_levels_padded": (2, 3, 20, 16, (20, 10, 5), 6, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fmap_dtype,out_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_lookup_matches_jax(case, fmap_dtype, out_dtype):
    """Row 3's plain version against the interpret-mode Pallas kernel."""
    b, h, w1, c, widths, kk, pad = CASES[case]
    rng = np.random.default_rng(len(widths) + pad)
    f1, f2 = _pyramid(rng, b, h, w1, c, widths, pad)
    taps = _taps(rng, (b, h, w1, kk), widths)
    pw = tuple(w + pad for w in widths)
    jdt = jnp.dtype(fmap_dtype)
    want = jalt.pallas_alt_pyramid_flat(
        *_jax_flat(jnp.asarray(f1, jdt), jnp.asarray(f2, jdt)),
        jnp.asarray(taps), pw, out_dtype=jnp.dtype(out_dtype))
    tdt = getattr(torch, fmap_dtype)
    got = talt.pallas_alt_pyramid_flat(
        *_port_flat(torch.from_numpy(f1).to(tdt),
                    torch.from_numpy(f2).to(tdt)),
        torch.from_numpy(taps), pw, out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    assert np.isnan(_np(got)[1, 2, 5, 2])
    np.testing.assert_array_equal(_np(got)[0, 0, :4, -1], 0.0)
    rel = BF16_ULP if out_dtype == "bfloat16" else 1e-5
    _close(_np(got), np.asarray(want.astype(jnp.float32)), rel)
    if pad:  # the same pyramid without its zero columns: the same result
        cut = np.concatenate([f2[:, :, o:o + w] for o, w in zip(
            np.cumsum((0,) + pw[:-1]), widths)], axis=2)
        unpadded = talt.pallas_alt_pyramid_flat(
            *_port_flat(torch.from_numpy(f1).to(tdt),
                        torch.from_numpy(cut).to(tdt)),
            torch.from_numpy(taps), widths,
            out_dtype=getattr(torch, out_dtype))
        assert torch.equal(unpadded.isnan(), got.isnan())
        assert torch.equal(unpadded.nan_to_num(), got.nan_to_num())


def test_single_level_lookup_matches_jax():
    """``pallas_alt_lookup`` on (B, H, W, C) maps, absolute taps."""
    rng = np.random.default_rng(5)
    f1 = rng.standard_normal((2, 3, 12, 32)).astype(np.float32)
    f2 = rng.standard_normal((2, 3, 15, 32)).astype(np.float32)
    taps = _taps(rng, (2, 3, 12, 9), (15,))
    want = jalt.pallas_alt_lookup(jnp.asarray(f1), jnp.asarray(f2),
                                  jnp.asarray(taps))
    got = talt.pallas_alt_lookup(torch.from_numpy(f1), torch.from_numpy(f2),
                                 torch.from_numpy(taps))
    _close(_np(got), want, 1e-5)
    assert talt.preflatten_fmap1(torch.from_numpy(f1)).shape == (6, 12, 32)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan_tap"])
def test_lookup_grads_match_jax(case, nan):
    """Row 4 (general taps): the gradients to both feature maps against
    ``jax.grad`` through ``_make_alt_pyr``'s VJP (the interpret-mode
    backward kernel); the taps' gradient is exactly zero.  A NaN tap
    poisons its pixel's df1 and its row's level in df2."""
    b, h, w1, c, widths, kk, pad = CASES[case]
    rng = np.random.default_rng(10 + len(widths) + pad)
    f1, f2 = _pyramid(rng, b, h, w1, c, widths, pad)
    taps = _taps(rng, (b, h, w1, kk), widths, nan=nan)
    cot = rng.standard_normal(taps.shape).astype(np.float32)
    pw = tuple(w + pad for w in widths)

    def jloss(a, bb, t):
        out = jalt.pallas_alt_pyramid_flat(*_jax_flat(a, bb), t, pw)
        return jnp.sum(out * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(taps))
    tf1, tf2, tt = (torch.from_numpy(a).requires_grad_(True)
                    for a in (f1, f2, taps))
    out = talt.pallas_alt_pyramid_flat(*_port_flat(tf1, tf2), tt, pw)
    (out * torch.from_numpy(cot)).sum().backward()
    for name, g, w in (("df1", tf1.grad, want[0]), ("df2", tf2.grad,
                                                     want[1])):
        w = np.asarray(w)
        scale = max(1.0, float(np.nanmax(np.abs(w))))
        _close(_np(g) / scale, w / scale, 1e-4, name)
    np.testing.assert_array_equal(_np(tt.grad), 0.0)
    np.testing.assert_array_equal(np.asarray(want[2]), 0.0)
    if nan:
        assert np.isnan(_np(tf1.grad)[1, 2, 5]).all()
        assert np.isnan(_np(tf2.grad)[1, 2, :pw[0]]).all()
        assert not np.isnan(_np(tf2.grad)[1, 1]).any()


def test_lookup_backward_kernel_contract_on_cpu():
    """The wrappers take the plain versions for CPU tensors; an infinite
    cotangent makes its pixel's df1 NaN and its row's level of df2
    non-finite (the dense hat's inf * 0), an infinite tap weights nothing;
    bf16 feature maps take their gradient in bf16 (the backward's bf16
    form, ``tests/test_torch_port_bf16_train.py``)."""
    rng = np.random.default_rng(3)
    f1, f2 = (torch.from_numpy(a).reshape(4, -1, 16)
              for a in _pyramid(rng, 2, 2, 8, 16, (8, 4), 0))
    taps = torch.from_numpy(_taps(rng, (2, 2, 8, 5), (8, 4), nan=False)
                            ).reshape(4, 8, 10)
    g = torch.ones_like(taps)
    g[3, 4, 7] = float("inf")   # level 1 of pixel 4 in row 3
    taps[0, 1, 0] = float("inf")
    df1, df2 = talt.alt_corr_taps_backward(f1, f2, taps, g, (8, 4))
    assert torch.isnan(df1[3, 4]).all() and not torch.isnan(df1[:3]).any()
    assert not torch.isfinite(df2[3, 8:]).any() and torch.isnan(df2).any()
    assert torch.isfinite(df2[3, :8]).all() and torch.isfinite(df2[:3]).all()
    out = talt.alt_corr_taps(f1, f2, taps, (8, 4))
    assert out[0, 1, 0] == 0.0
    b1 = f1.bfloat16().requires_grad_(True)
    bf = talt.pallas_alt_pyramid_flat(
        b1, f2.bfloat16(), taps.reshape(2, 2, 8, 10), (8, 4))
    bf.float().sum().backward()
    assert b1.grad.dtype == torch.bfloat16 and b1.grad.shape == b1.shape
    assert torch.isfinite(b1.grad).all()


# ------------------------------------------------------------ instance norm

def _norm_input(rng, dtype, shape=(2, 5, 6, 7)):
    """NHWC input, centred off zero, plus a plane whose values are exact
    around an exact mean (ties of the relu at x == mean)."""
    x = (rng.standard_normal(shape) * 1.7 + 0.6).astype(np.float32)
    x[1, :, :, 3] = np.resize(np.array([-1.0, 1.0, 0.0, 0.0], np.float32),
                              shape[1] * shape[2]).reshape(shape[1:3])
    return jnp.asarray(x, jnp.dtype(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
def test_instance_norm_matches_jax(dtype, relu):
    rng = np.random.default_rng(7)
    x = _norm_input(rng, dtype)
    want = np.asarray(jax_in(x, relu).astype(jnp.float32))
    xt = torch.tensor(np.asarray(x.astype(jnp.float32))).to(
        getattr(torch, dtype)).permute(0, 3, 1, 2)
    got = tnorm.instance_norm_act(xt, relu)
    assert got.dtype == xt.dtype
    rel = BF16_ULP if dtype == "bfloat16" else 1e-5
    _close(_np(got.permute(0, 2, 3, 1)), want, rel)
    mean, rstd = tnorm.in_stats(xt.contiguous())
    assert mean.dtype == rstd.dtype == torch.float32


@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
def test_instance_norm_grad_matches_jax(relu):
    """The gradient through the centred formulation, against ``jax.grad``
    of the custom VJP; with relu, the plane whose normalised values hit 0
    exactly takes jnp.maximum's 0.5 at the tie (``torch.relu``'s 0 would
    miss it)."""
    rng = np.random.default_rng(8)
    x = _norm_input(rng, "float32")
    cot = rng.standard_normal(x.shape).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda a: jnp.sum(jax_in(a, relu) * cot))(x))
    xt = torch.tensor(np.asarray(x)).permute(0, 3, 1, 2).requires_grad_(
        True)
    y = tnorm.instance_norm_act(xt, relu)
    (y * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    got = _np(xt.grad.permute(0, 2, 3, 1))
    scale = float(np.abs(want).max())
    _close(got / scale, want / scale, 1e-4)
    if relu:
        assert (_np(y)[1, 3] == 0).any()  # the tie is there
        torch_relu = xt.detach().clone().requires_grad_(True)
        z = torch.relu(tnorm._centred(torch_relu))
        (z * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
        miss = _np(torch_relu.grad.permute(0, 2, 3, 1))
        assert np.abs(miss - want).max() > 1e-4 * scale


def test_instance_norm_bf16_grad_matches_jax():
    rng = np.random.default_rng(9)
    x = _norm_input(rng, "bfloat16")
    cot = rng.standard_normal(x.shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(
        jax_in(a, True).astype(jnp.float32) * cot))(x).astype(jnp.float32))
    xt = torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16()
    xt = xt.permute(0, 3, 1, 2).requires_grad_(True)
    y = tnorm.instance_norm_act(xt, True)
    (y.float() * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    assert xt.grad.dtype == torch.bfloat16
    _close(_np(xt.grad.permute(0, 2, 3, 1)), want, BF16_ULP)
