"""Row 18 (``csrc/alt_corr_epi.cu``, the lookup with convc1 fused): its
arithmetic, on the CPU.

The kernel runs only on the card.  It takes row 1's staged tiles through
the header both share (``csrc/alt_corr_tile.cuh``), so its window sums
are row 1's, emulated in ``test_torch_port_alt_fwd.emulate`` (whose span
tests hold the tiling both kernels run).  Its own step is emulated here:
each fp32 column rounded to bf16; per pixel and output the product with
the bf16 W summed over the columns in order, one fp32 FMA each (the
products of bf16 values are exact in fp32, so each step rounds once);
the sum rounded to bf16, the bias added in bf16, relu keeping NaN.  The
emulation is held within 2 bf16 ulps of max(1, |plain|) of the plain
version (``cuda_alt.alt_corr_epi_plain``, ``chip_smoke.EPI_ULPS``) and of
the JAX package's ``_alt_pyr_radial_epi_kernel`` in interpret mode, NaN
exactly where they have NaN, on the random, smooth and jump fields (the
jump field's spans outgrow the staging buffer: the wide-span path) and
on NaN and far coordinates.  Inputs are made with numpy from a seed.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raftstereo_tpu.ops import corr as jcorr
from raftstereo_tpu_torch.ops import _build, cuda_alt
from test_torch_port_alt_fwd import (LEVELS, RADIUS, _inputs, _state,
                                     emulate, plan)
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse

EPI_ULPS = 2.0        # chip_smoke.EPI_ULPS
BF = torch.bfloat16
ULP = 2.0 ** -7


def _convc1(seed=3):
    """W (L*K, 64) and b (64), bf16-valued fp32 numpy."""
    rng = np.random.default_rng(seed)
    lk = LEVELS * (2 * RADIUS + 1)
    w = (rng.normal(size=(lk, 64)) / 6).astype(np.float32)
    b = rng.normal(scale=0.1, size=64).astype(np.float32)
    return (torch.from_numpy(w).to(BF).float().numpy(),
            torch.from_numpy(b).to(BF).float().numpy())


def emulate_epi(fmap1, f2cat, widths, x, radius, w, b):
    """``alt_corr_epi`` as the kernel computes it: row 1's emulated fp32
    columns, rounded to bf16, then per output the FMA chain over the
    columns in order, rounded, + b in bf16, relu.  -> (B, H, W1, 64)
    bf16."""
    cols = emulate(fmap1, f2cat, widths, x, radius).to(BF).float()
    wf = w.to(BF).float()
    acc = torch.zeros(cols.shape[:-1] + (wf.shape[1],))
    for j in range(wf.shape[0]):
        acc = acc + cols[..., j:j + 1] * wf[j]   # exact product, one rounding
    return torch.relu(acc.to(BF) + b.to(BF))


def _ulps(got, want):
    """Largest difference in bf16 ulps of max(1, |want|), NaN positions
    equal."""
    got, want = got.float(), want.float()
    assert torch.equal(got.isnan(), want.isnan())
    ok = ~want.isnan()
    return float(((got[ok] - want[ok]).abs()
                  / want[ok].abs().clamp_min(1.0)).max()) / ULP


EPI_CASES = ["random_w96", "smooth_w70", "jump_w320", "nan_outside_w40",
             "random_bf16_w40", "smooth_bf16_w70", "jump_bf16_w320"]


def test_epi_takes_row1_tiles():
    """Both kernels include the shared staging header and run its
    ``lookup_tile``; neither plans its own spans, so the span tests of
    ``test_torch_port_alt_fwd`` hold the tiling of both."""
    srcs = _build.sources()
    for name in ("alt_corr", "alt_corr_epi"):
        text = srcs[name].read_text()
        assert '#include "alt_corr_tile.cuh"' in text, name
        assert re.search(r"\blookup_tile<R>\(", text), name
        assert "plan_spans" not in re.sub(r"//.*", "", text), name
    assert "void plan_spans" in _build.source_text("alt_corr_epi")


@pytest.mark.parametrize("name", EPI_CASES)
def test_emulation_within_2_ulps_of_plain(name):
    """The emulated kernel against ``alt_corr_epi_plain``: within 2 bf16
    ulps, NaN at NaN pixels (the whole pixel), zeros from the relu."""
    f1, f2, x, dtype = _inputs(name)
    st = _state(f1, f2, dtype)
    w, b = (torch.from_numpy(a) for a in _convc1())
    xt = torch.from_numpy(x)
    got = emulate_epi(st.fmap1, st.f2cat, st.widths, xt, RADIUS, w, b)
    want = cuda_alt.alt_corr_epi_plain(st.fmap1, st.f2cat, st.widths, xt,
                                       RADIUS, w.to(BF), b.to(BF))
    assert got.dtype == want.dtype == BF and got.shape == x.shape + (64,)
    assert _ulps(got, want) <= EPI_ULPS
    assert torch.equal(got.isnan().all(-1), torch.from_numpy(~np.isfinite(x)))
    ok = ~got.isnan()
    assert bool((got[ok] == 0).any()) and bool((got[ok] > 0).any())


@pytest.mark.parametrize("name", ["jump_w320", "nan_outside_w40"])
def test_emulation_matches_jax(name):
    """The emulated kernel against the JAX package's fused lookup (the
    interpret-mode ``_alt_pyr_radial_epi_kernel``, reached as the model
    reaches it, through ``make_pallas_alt_corr_fn`` with a convc1
    epilogue) on the same inputs: NaN where JAX has NaN, within 2 bf16
    ulps elsewhere."""
    f1, f2, x, dtype = _inputs(name)
    w, b = _convc1()
    jdt = jnp.bfloat16 if dtype == BF else jnp.float32
    fn = jcorr.make_pallas_alt_corr_fn(
        jnp.asarray(f1), jnp.asarray(f2), LEVELS, RADIUS, dtype=jdt,
        out_dtype=jnp.bfloat16,
        epilogue={"kernel": jnp.asarray(w)[None, None],
                  "bias": jnp.asarray(b)})
    want = torch.from_numpy(
        np.array(fn(jnp.asarray(x)[..., None]).astype(jnp.float32)))
    st = _state(f1, f2, dtype)
    got = emulate_epi(st.fmap1, st.f2cat, st.widths, torch.from_numpy(x),
                      RADIUS, torch.from_numpy(w), torch.from_numpy(b))
    assert got.shape == want.shape
    assert _ulps(got, want) <= EPI_ULPS


def test_cases_cover_the_wide_span_path():
    """The jump cases' tiles take the wide-span path (their sums come from
    ``wide_dots``) and the smooth ones never do, as row 1's."""
    for name, want in (("jump_w320", True), ("jump_bf16_w320", True),
                       ("smooth_w70", False), ("smooth_bf16_w70", False)):
        f1, f2, x, dtype = _inputs(name)
        st = _state(f1, f2, dtype)
        wide = any(m == "wide" for row in x.reshape(-1, x.shape[-1])
                   for levels in plan(row, st.widths, RADIUS)
                   for m, _, _ in levels)
        assert wide == want, name
