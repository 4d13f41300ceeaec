"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: they skip without a GPU.  The machine with the
card has no JAX, so this file imports none and is run without the
repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig
from raftstereo_tpu_torch.ops import cuda_alt, cuda_gru
from raftstereo_tpu_torch.ops.corr import build_corr_state

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("radius,levels", [(4, 4), (2, 2)])
def test_alt_corr_kernel_matches_plain(dev, radius, levels):
    """Hostile shapes: odd H, levels down to width 2, taps past both
    edges, NaN coordinates."""
    rng = np.random.default_rng(0)
    b, h, w = 2, 11, 20
    st = build_corr_state(_randn(rng, b, h, w, 256).to(dev),
                          _randn(rng, b, h, w, 256).to(dev), levels)
    x = np.arange(w, dtype=np.float32) + rng.uniform(-14, 10, (b, h, w))
    x[0, 0, :3] = [-200.5, w + 200.25, 1e6]
    x[1, 3, 4] = np.nan
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    before = cuda_alt.alt_corr.launches
    got = cuda_alt.alt_corr(st.fmap1, st.f2cat, st.widths, x, radius)
    assert cuda_alt.alt_corr.launches == before + 1
    want = cuda_alt.alt_corr_plain(st.fmap1, st.f2cat, st.widths, x, radius)
    torch.cuda.synchronize()
    assert torch.isnan(got[1, 3, 4]).all()
    # fp32 dots of length 256 summed in another order: ~1e-6 of O(1).
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5,
                               equal_nan=True)


@pytest.mark.parametrize("n", [1, 3])
def test_gru_update_kernel_matches_plain(dev, n):
    cfg = RAFTStereoConfig(n_gru_layers=n, hidden_dims=(128,) * n)
    model = RAFTStereo(cfg, device=dev, seed=1)
    e = 128 if n > 1 else 0
    wpack = cuda_gru.pack_update_params(model.update_block, e)
    rng = np.random.default_rng(n)
    b, h, w = 2, 9, 13
    args = [torch.tanh(_randn(rng, b, h, w, 128)),
            torch.tanh(_randn(rng, b, h, w, e)) if e else None,
            _randn(rng, b, h, w, 36),
            torch.from_numpy(rng.uniform(-8, 2, (b, h, w, 1))
                             .astype(np.float32)),
            _randn(rng, b, h, w, 128), _randn(rng, b, h, w, 128),
            _randn(rng, b, h, w, 128)]
    args = [a if a is None else a.to(dev) for a in args]
    hk, dk = cuda_gru.gru_update(*args, wpack)
    hp, dp = cuda_gru.gru_update_plain(*args, wpack)
    torch.cuda.synchronize()
    # fp32 conv sums of up to ~3500 terms, reordered.
    torch.testing.assert_close(hk, hp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dk, dp, rtol=1e-4, atol=1e-4)


def test_wrappers_raise_instead_of_falling_back(dev):
    rng = np.random.default_rng(2)
    st = build_corr_state(_randn(rng, 1, 2, 8, 256).to(dev),
                          _randn(rng, 1, 2, 8, 256).to(dev), 2)
    x = torch.zeros((1, 2, 8), device=dev)
    with pytest.raises(ValueError):  # x on the CPU, features on the card
        cuda_alt.alt_corr(st.fmap1, st.f2cat, st.widths, x.cpu(), 2)
    with pytest.raises(ValueError):  # C=192 is not a kernel width
        cuda_alt.alt_corr(st.fmap1[..., :192].contiguous(),
                          st.f2cat[..., :192].contiguous(), st.widths, x, 2)


def test_forward_on_card_matches_cpu(dev):
    cfg = RAFTStereoConfig(n_gru_layers=3, hidden_dims=(32, 32, 32),
                           corr_levels=2, corr_radius=2)
    gpu = RAFTStereo(cfg, device=dev, seed=4)
    cpu = RAFTStereo(cfg, device="cpu", seed=4)
    rng = np.random.default_rng(3)
    imgs = [torch.from_numpy(rng.uniform(0, 255, (1, 32, 48, 3))
                             .astype(np.float32)) for _ in range(2)]
    lo_g, up_g = gpu(*(i.to(dev) for i in imgs), iters=3)
    lo_c, up_c = cpu(*imgs, iters=3)
    # The thresholds of the JAX parity tests: fp32 rounding differences
    # carried through three GRU iterations.
    torch.testing.assert_close(lo_g.cpu(), lo_c, rtol=0, atol=2e-3)
    torch.testing.assert_close(up_g.cpu(), up_c, rtol=0, atol=5e-3)
