"""Row 2's tensor-core layout and numerics, on the CPU.

The fused update kernel (``csrc/gru_update.cu``) reads each tensor-core
conv's weights as one (N, K) matrix in its reduction order (operand, tap,
128-byte channel chunk), the gate convs over the 128-channel motion
features [me, disp, 0], and in fp32 sums 3xTF32 products.  The kernel
runs only on the card; these tests hold what surrounds it: the pack
unpacks to the plain version's entries exactly; a conv in the kernel's
layout equals the plain version's sliced conv; and an emulation of the
kernel's arithmetic (TF32 rounding as ``cvt.rna``) stays within the
card's tolerance of the plain version and of the JAX reference, where a
single TF32 pass does not.  Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from raftstereo_tpu.ops import pallas_gru as jgru
from raftstereo_tpu_torch import RAFTStereoConfig
from raftstereo_tpu_torch.models.update import BasicMultiUpdateBlock
from raftstereo_tpu_torch.ops import cuda_gru
from raftstereo_tpu_torch.utils.convert import variables_to_state_dict

BF = torch.bfloat16
# chip_smoke.py's UPDATE_TOL: the kernel's fp32 update within 1e-4 of
# max(1, |plain|) of its plain version (fp32 conv sums, reordered).
UPDATE_TOL = 1e-4


def _params(rng, hd, ext, cor):
    """Update-block parameters in the JAX package's layout: kernels of
    scale 1/sqrt(fan-in), biases 0.1."""
    def convp(k, cin, cout):
        return {"kernel": (rng.normal(size=(k, k, cin, cout))
                           / np.sqrt(k * k * cin)).astype(np.float32),
                "bias": rng.normal(scale=0.1, size=cout).astype(np.float32)}
    return {
        "encoder": {"convc1": convp(1, cor, 64), "convc2": convp(3, 64, 64),
                    "convf1": convp(7, 2, 64), "convf2": convp(3, 64, 64),
                    "conv": convp(3, 128, 126)},
        "gru0": {"convzr": convp(3, hd + 128 + ext, 2 * hd),
                 "convq": convp(3, hd + 128 + ext, hd)},
        "flow_head": {"conv1": convp(3, hd, 256), "conv2": convp(3, 256, 2)},
    }


def _case(hd, ext, levels, seed, b=1, h=9, w=13):
    """JAX parameters, the port's update block loaded with them, and
    NHWC fp32 activations (disp as the model carries it)."""
    rng = np.random.default_rng(seed)
    cor = levels * 9
    params = _params(rng, hd, ext, cor)
    n = 2 if ext else 1
    cfg = RAFTStereoConfig(n_gru_layers=n, hidden_dims=(hd, ext)[:n],
                           corr_levels=levels, corr_radius=4)
    blk = BasicMultiUpdateBlock(cfg)
    sd = {k[len("update_block."):]: v for k, v in variables_to_state_dict(
        {"params": {"update": params}}).items()}
    _, unexpected = blk.load_state_dict(sd, strict=False)
    assert not unexpected

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    acts = dict(
        h=t(np.tanh(rng.normal(size=(b, h, w, hd)))),
        ext=t(np.tanh(rng.normal(size=(b, h, w, ext)))) if ext else None,
        corr=t(rng.normal(size=(b, h, w, cor))),
        disp=t(rng.uniform(-8, 2, (b, h, w, 1))),
        cz=t(rng.normal(size=(b, h, w, hd))),
        cr=t(rng.normal(size=(b, h, w, hd))),
        cq=t(rng.normal(size=(b, h, w, hd))))
    return params, blk, acts


def _padded(cin, eps):
    return -(-cin // eps) * eps


def _unpack(k, widths, eps):
    """The kernel's (N, K) matrix -> one (N, 9, cin) block per operand of
    width ``cin``; the channel padding of each tap must be zero."""
    blocks, off = [], 0
    for cin in widths:
        cp = _padded(cin, eps)
        blk = k[:, off:off + 9 * cp].reshape(k.shape[0], 9, cp)
        assert not blk[:, :, cin:].any()
        blocks.append(blk[:, :, :cin])
        off += 9 * cp
    assert off == k.shape[1]
    return blocks


def _as_plain(blk):
    """(N, 9, cin) -> the plain version's (9*cin, N)."""
    return blk.permute(1, 2, 0).reshape(-1, blk.shape[0])


def _expected(pack, hd, ext):
    """Each kernel-layout key -> (N, per-operand (width, plain entries
    along the operand's channels)).  The gate convs' mf operand is
    [wme slice (126) | disp (1) | 0]."""
    def gate(p):
        ops = [(hd, [pack[f"{p}_h"]]),
               (128, [pack[f"{p}_m"], pack[f"{p}_d"], None])]
        if ext:
            ops.append((ext, [pack[f"{p}_e"]]))
        return ops
    return {"kc2": (64, [(64, [pack["wc2"]])]),
            "kf2": (64, [(64, [pack["wf2"]])]),
            "kme": (126, [(64, [pack["wme_c"]]), (64, [pack["wme_f"]])]),
            "kzr": (2 * hd, gate("wzr")), "kq": (hd, gate("wq")),
            "kfh1": (256, [(hd, [pack["wfh1"]])])}


def test_tf32_round_is_cvt_rna():
    """Round to nearest on 10 mantissa bits, ties away from zero."""
    one = 1.0
    x = torch.tensor([one + 2.0 ** -11, -(one + 2.0 ** -11),
                      one + 2.0 ** -11 - 2.0 ** -23, one + 3 * 2.0 ** -11,
                      0.0, -0.0, 3.0e-39, 65504.0], dtype=torch.float32)
    got = cuda_gru.tf32_round(x)
    want = torch.tensor([one + 2.0 ** -10, -(one + 2.0 ** -10), one,
                         one + 2 * 2.0 ** -10, 0.0, -0.0, 3.0e-39, 65504.0],
                        dtype=torch.float32)
    assert torch.equal(got.view(torch.int32) & 0x1FFF,
                       torch.zeros(8, dtype=torch.int32))
    assert torch.equal(got[:4], want[:4]) and torch.equal(got[4:6], want[4:6])
    assert torch.signbit(got[5])
    assert got[7] == 65504.0  # 1.9990234375 * 2^15 is a TF32 value


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hd,ext", [(128, 128), (32, 0), (24, 24)],
                         ids=["hd128_ext", "hd32", "hd24_padded"])
def test_kernel_pack_unpacks_to_plain_entries(dtype, hd, ext):
    """Every ``k*`` entry is the plain version's entries, reordered to
    (operand, tap, channel), zero-padded per tap to a whole 128-byte stage
    and past the outputs: exactly the bf16 values, and in fp32 exactly
    the TF32 split hi = rna(w), lo = rna(w - hi) of the fp32 values."""
    _, blk, _ = _case(hd, ext, 4, seed=1)
    pack = cuda_gru.pack_update_params(blk, ext, dtype)
    eps = cuda_gru.stage_elems(dtype)
    assert eps == (32 if dtype == torch.float32 else 64)
    for key, (n, ops) in _expected(pack, hd, ext).items():
        k = pack[key]
        assert k.dtype == dtype
        assert tuple(k.shape) == cuda_gru.kernel_shape(key, hd, ext, dtype)
        planes = [k] if dtype == BF else [k[0], k[1]]
        n_out = k.shape[-2]
        for pi, plane in enumerate(planes):
            assert not plane[n:].any()  # outputs past N are zero
            blocks = _unpack(plane[:n], [w for w, _ in ops], eps)
            for blk_, (width, parts) in zip(blocks, ops):
                c0 = 0
                for part in parts:
                    cw = 1 if part is None else part.shape[0] // 9
                    got = blk_[:, :, c0:c0 + cw]
                    c0 += cw
                    if part is None:
                        assert not got.any()
                        continue
                    want = part
                    if dtype == torch.float32:
                        hi = cuda_gru.tf32_round(part)
                        want = hi if pi == 0 else cuda_gru.tf32_round(
                            part - hi)
                    assert torch.equal(_as_plain(got), want), key
                assert c0 == width
        assert n_out in (n, 128)


def _im2col(xs, eps):
    """NHWC operands -> (B, H, W, K) in the kernel's reduction order:
    per operand, taps ky*3 + kx of the zero-padded image, each with its
    channels zero-padded to a whole stage."""
    cols = []
    for x in xs:
        b, h, w, c = x.shape
        xp = F.pad(x, (0, _padded(c, eps) - c, 1, 1, 1, 1))
        cols += [xp[:, ky:ky + h, kx:kx + w] for ky in range(3)
                 for kx in range(3)]
    return torch.cat(cols, -1)


def _mf(me, disp):
    """The motion features the kernel stores: [me, disp, 0]."""
    return torch.cat([me, disp.to(me.dtype), torch.zeros_like(disp)
                      .to(me.dtype)], -1)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


@pytest.mark.parametrize("hd,ext,levels", [
    (128, 128, 4), (128, 0, 4), (32, 32, 2), (32, 0, 2)],
    ids=["hd128_ext_c36", "hd128_c36", "hd32_ext_c18", "hd32_c18"])
def test_merged_mf_conv_equals_sliced_conv(hd, ext, levels):
    """The gate convs over [h | mf | ext] with the merged ``kzr``/``kq``
    equal the plain version's sliced ``_conv([h, me, disp, ext], ...)``
    (bf16 weights, both summed in float64: equal to float64 rounding).
    ``me`` is the plain version's motion encoder output of the case's
    correlation (36 or 18 channels)."""
    _, blk, a = _case(hd, ext, levels, seed=2 + hd + ext)
    pack = cuda_gru.pack_update_params(blk, ext, BF)
    d = {k: v.double() for k, v in pack.items()}
    eps = cuda_gru.stage_elems(BF)
    c1 = F.relu(cuda_gru._conv([_nchw(a["corr"]).double()], [d["wc1"]],
                               d["bc1"]))
    cor = F.relu(cuda_gru._conv([c1], [d["wc2"]], d["bc2"]))
    f1 = F.relu(cuda_gru._conv([_nchw(a["disp"]).double()], [d["wf1"]],
                               d["bf1"]))
    flo = F.relu(cuda_gru._conv([f1], [d["wf2"]], d["bf2"]))
    me = F.relu(cuda_gru._conv([cor, flo], [d["wme_c"], d["wme_f"]],
                               d["bme"])).permute(0, 2, 3, 1)
    h, disp = a["h"].double(), a["disp"].double()
    xs = [h, _mf(me, disp)] + ([a["ext"].double()] if ext else [])
    sliced = [_nchw(h), _nchw(me), _nchw(disp)] + (
        [_nchw(a["ext"]).double()] if ext else [])
    for key, p in (("kzr", "wzr"), ("kq", "wq")):
        got = _im2col(xs, eps) @ d[key].T + d[f"b{p[1:]}"]
        names = [f"{p}_h", f"{p}_m", f"{p}_d"] + ([f"{p}_e"] if ext else [])
        want = cuda_gru._conv(sliced, [d[k] for k in names],
                              d[f"b{p[1:]}"]).permute(0, 2, 3, 1)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def _mma(x, k, mode):
    """The kernel's fp32 product of im2col rows ``x`` with the (2, N, K)
    (hi, lo) planes ``k``: 3xTF32 (a_lo*b_hi + a_hi*b_lo + a_hi*b_hi,
    each product exact), or a single TF32 pass (a_hi*b_hi)."""
    hi = cuda_gru.tf32_round(x)
    b_hi, b_lo = k[0].double(), k[1].double()
    out = hi.double() @ b_hi.T
    if mode == "3xtf32":
        lo = cuda_gru.tf32_round(x - hi)
        out = lo.double() @ b_hi.T + hi.double() @ b_lo.T + out
    return out.float()


def _emulated_update(a, pack, mode):
    """The kernel's dataflow in fp32 NHWC: c1, f1 and the 2-output conv as
    plain fp32 (its SIMT kernels), the six tensor-core convs through
    ``_mma``, the epilogues as written in ``finish``."""
    eps = cuda_gru.stage_elems(torch.float32)
    hd = a["h"].shape[-1]

    def tc(xs, key, bias, n=None):
        y = _mma(_im2col(xs, eps), pack[key], mode)
        return (y if n is None else y[..., :n]) + pack[bias]

    def nhwc(t):
        return t.permute(0, 2, 3, 1)

    c1 = F.relu(nhwc(cuda_gru._conv([_nchw(a["corr"])], [pack["wc1"]],
                                    pack["bc1"])))
    cor = F.relu(tc([c1], "kc2", "bc2"))
    f1 = F.relu(nhwc(cuda_gru._conv([_nchw(a["disp"])], [pack["wf1"]],
                                    pack["bf1"])))
    flo = F.relu(tc([f1], "kf2", "bf2"))
    mf = _mf(F.relu(tc([cor, flo], "kme", "bme", n=126)), a["disp"])
    ext = [a["ext"]] if a["ext"] is not None else []
    zr = tc([a["h"], mf] + ext, "kzr", "bzr")
    z = torch.sigmoid(zr[..., :hd] + a["cz"])
    r = torch.sigmoid(zr[..., hd:] + a["cr"])
    q = torch.tanh(tc([r * a["h"], mf] + ext, "kq", "bq") + a["cq"])
    hn = (1 - z) * a["h"] + z * q
    fh = F.relu(tc([hn], "kfh1", "bfh1"))
    delta = nhwc(cuda_gru._conv([_nchw(fh)], [pack["wfh2"]], pack["bfh2"]))
    return hn, delta


def _rel_err(got, want):
    """Largest |got - want| over max(1, |want|) of every output."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return err / max(1.0, *(float(w.abs().max()) for w in want))


@pytest.mark.parametrize("mode", ["3xtf32", "tf32"])
def test_gate_conv_3xtf32_within_update_tolerance(mode):
    """One ``zr`` conv at the flagship widths (K = 9 x (128 + 128 + 128),
    N = 256) on tanh-range inputs: 3xTF32 within ``UPDATE_TOL`` of the
    fp32 conv, a single TF32 pass beyond it (why the kernel takes three
    passes)."""
    _, blk, a = _case(128, 128, 4, seed=5, h=16, w=24)
    pack = cuda_gru.pack_update_params(blk, 128)
    rng = np.random.default_rng(6)
    mf = torch.from_numpy(np.tanh(rng.normal(size=a["h"].shape[:3] + (128,)))
                          .astype(np.float32))
    mf[..., 127] = 0
    xs = [a["h"], mf, a["ext"]]
    got = _mma(_im2col(xs, cuda_gru.stage_elems(torch.float32)),
               pack["kzr"], mode) + pack["bzr"]
    want = cuda_gru._conv(
        [_nchw(a["h"]), _nchw(mf[..., :126]), _nchw(mf[..., 126:127]),
         _nchw(a["ext"])],
        [pack[k] for k in ("wzr_h", "wzr_m", "wzr_d", "wzr_e")],
        pack["bzr"]).permute(0, 2, 3, 1)
    err = _rel_err([got], [want])
    if mode == "3xtf32":
        assert err <= UPDATE_TOL, err
    else:
        assert err > UPDATE_TOL, err


@pytest.mark.parametrize("mode", ["3xtf32", "tf32"])
def test_update_3xtf32_within_update_tolerance(mode):
    """The whole update at a 16x24 grid with hd = 128 (and ext 128, corr
    36): the kernel's dataflow with 3xTF32 convs stays within
    ``UPDATE_TOL`` x max(1, |plain|) of ``gru_update_plain`` and of the
    JAX ``_xla_reference_update``; with single TF32 passes it does not."""
    params, blk, a = _case(128, 128, 4, seed=7, h=16, w=24)
    pack = cuda_gru.pack_update_params(blk, 128)
    got = _emulated_update(a, pack, mode)
    plain = cuda_gru.gru_update_plain(*a.values(), pack)
    err = _rel_err(got, plain)
    if mode == "tf32":
        assert err > UPDATE_TOL, err
        return
    assert err <= UPDATE_TOL, err
    jpack = jgru.pack_update_params(params, 36, 128, jnp.float32)
    want = jgru._xla_reference_update(
        *(jnp.asarray(v.numpy()) for v in a.values()), jpack)
    jerr = _rel_err(got, [torch.from_numpy(np.asarray(w)) for w in want])
    assert jerr <= UPDATE_TOL, jerr
