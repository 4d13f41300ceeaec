"""The port's bf16 inference (``compute_dtype="bfloat16"``, the JAX
package's ``--mixed_precision``) against the JAX package on the CPU.

Inputs are made with numpy from a seed and passed to both packages.  The
JAX side runs its Pallas kernels in interpret mode (automatic off the TPU)
and its flax modules with ``dtype=bfloat16``; the port runs its plain
versions.  Tolerances are in bf16 ulps: one ulp of a value v is
2^-7 * max(1, |v|) here (bf16 keeps 8 significant bits).

Where the inputs are identical, the port rounds where JAX rounds, so the
kernels' plain versions are bitwise equal to the interpret-mode kernels
and one module step agrees but for a few 1-ulp flips (fp32 sums taken in
another order land on the other side of a bf16 rounding boundary).  The
encoders cannot be held that tightly end to end: a 3x3 conv spreads each
flip to its neighbours and instance norm to a whole channel (JAX's own
layer2 turns 0.05% of changed inputs into 18% of changed outputs), and
the random-weight GRU grows the resulting ulp noise about as fast as it
grows bf16's own rounding, so an unpinned model comparison lands as far
from JAX as JAX in fp32 does.  So the encoders are held block by block,
and the model test pins their outputs to JAX's and compares the rest of
the forward after 2 iterations, with a stated tolerance that lies below
the JAX package's own bf16-vs-fp32 gap on the same inputs.  bf16
training is held in ``test_torch_port_bf16_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_encoder_train import _seeded_variables
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse
from test_torch_port_ops import _update_params

from raftstereo_tpu import RAFTStereoConfig as JaxConfig
from raftstereo_tpu.models import RAFTStereo as JaxModel
from raftstereo_tpu.models.encoders import BasicEncoder as JaxBasicEncoder
from raftstereo_tpu.models.encoders import \
    MultiBasicEncoder as JaxMultiEncoder
from raftstereo_tpu.models.update import BasicMultiUpdateBlock as JaxUpdate
from raftstereo_tpu.ops import corr as jcorr
from raftstereo_tpu.ops import pallas_gru as jgru
from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig, ServeConfig
from raftstereo_tpu_torch.cli import serve as cli_serve
from raftstereo_tpu_torch.models.layers import conv_bf16
from raftstereo_tpu_torch.models.update import BasicMultiUpdateBlock
from raftstereo_tpu_torch.ops import cuda_alt, cuda_gru
from raftstereo_tpu_torch.ops.corr import build_corr_state, corr_lookup
from raftstereo_tpu_torch.serve.engine import BatchEngine
from raftstereo_tpu_torch.serve.server import StereoServer
from raftstereo_tpu_torch.utils.convert import variables_to_state_dict

BF = torch.bfloat16
ULP = 2.0 ** -7
TINY = dict(n_gru_layers=3, hidden_dims=(32, 32, 32), corr_levels=2,
            corr_radius=2)
BF16 = dict(compute_dtype="bfloat16", corr_dtype="bfloat16")


def _np(a) -> np.ndarray:
    """float32 numpy copy of a JAX array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf(a) -> torch.Tensor:
    """bf16 torch copy of a (bf16-valued) JAX array."""
    return torch.from_numpy(_np(a).copy()).to(BF)


def _ulps(got, want) -> np.ndarray:
    got, want = _np(got), _np(want)
    return np.abs(got - want) / np.maximum(1.0, np.abs(want)) / ULP


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


# ---------------------------------------------------------- row 1 and 18

def _lookup_inputs(nan: bool):
    """Four levels of radius 4 over 20 columns (widths 20/10/5/2), taps
    past both edges, and with ``nan`` NaN coordinates."""
    rng = np.random.default_rng(5)
    b, h, w, c = 2, 11, 20, 256
    f1 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    f2 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    x = (np.arange(w, dtype=np.float32)
         + rng.uniform(-14, 10, (b, h, w)).astype(np.float32))
    x[0, 0, :3] = [-200.5, w + 200.25, 1e6]
    if nan:
        x[1, 3, 4] = np.nan
    lk = 4 * 9
    wt = (rng.normal(size=(lk, 64)) / 6).astype(np.float32)
    bias = rng.normal(scale=0.1, size=64).astype(np.float32)
    return f1, f2, x, wt, bias


@pytest.mark.parametrize("fmap_dtype", ["float32", "bfloat16"])
def test_lookup_epi_plain_matches_jax_kernel(fmap_dtype):
    """Row 18: the plain version against the interpret-mode
    ``_alt_pyr_radial_epi_kernel`` (through ``make_pallas_alt_corr_fn``
    with a convc1 epilogue), bf16 W and b; NaN where the coordinate is
    NaN.  Measured bitwise equal; the bound is 2 ulps."""
    f1, f2, x, wt, bias = _lookup_inputs(nan=True)
    jdt = jnp.dtype(fmap_dtype)
    fn = jcorr.make_pallas_alt_corr_fn(
        jnp.asarray(f1), jnp.asarray(f2), 4, 4, dtype=jdt,
        out_dtype=jnp.bfloat16,
        epilogue={"kernel": jnp.asarray(wt)[None, None],
                  "bias": jnp.asarray(bias)})
    want = _np(fn(jnp.asarray(x)[..., None]))
    st = build_corr_state(torch.from_numpy(f1), torch.from_numpy(f2), 4,
                          corr_dtype=getattr(torch, fmap_dtype))
    got = cuda_alt.alt_corr_epi(st.fmap1, st.f2cat, st.widths,
                                torch.from_numpy(x), 4,
                                torch.from_numpy(wt).to(BF),
                                torch.from_numpy(bias).to(BF))
    assert got.dtype == BF and got.shape == x.shape + (64,)
    nan = np.isnan(x)
    assert np.isnan(_np(got)[nan]).all() and np.isnan(want[nan]).all()
    assert _ulps(_np(got)[~nan], want[~nan]).max() <= 2.0
    assert (_np(got)[~nan] > 0).any() and (_np(got)[~nan] == 0).any()


@pytest.mark.parametrize("fmap_dtype", ["float32", "bfloat16"])
def test_lookup_epi_plain_equals_module_path(fmap_dtype):
    """Row 18 against the port's own unfused path: the raw bf16 lookup,
    then convc1 in bf16 (``conv_bf16``) and relu -- the equality the JAX
    package pins with its gate on and off.  Bitwise (no NaN here: the
    CPU's 1x1 conv carries a NaN pixel into its neighbour)."""
    f1, f2, x, wt, bias = _lookup_inputs(nan=False)
    st = build_corr_state(torch.from_numpy(f1), torch.from_numpy(f2), 4,
                          corr_dtype=getattr(torch, fmap_dtype))
    xt = torch.from_numpy(x)
    fused = cuda_alt.alt_corr_epi(st.fmap1, st.f2cat, st.widths, xt, 4,
                                  torch.from_numpy(wt).to(BF),
                                  torch.from_numpy(bias).to(BF))
    raw = corr_lookup(st, xt, 4, BF)
    unfused = torch.relu(conv_bf16(_nchw(raw), torch.from_numpy(wt).t()[
        :, :, None, None], torch.from_numpy(bias)))
    assert torch.equal(fused, _nhwc(unfused))


@pytest.mark.parametrize("fmap_dtype", ["float32", "bfloat16"])
def test_lookup_bf16_plain_matches_jax_kernel(fmap_dtype):
    """Row 1's bf16 output form, from bf16 (and fp32) feature maps,
    against the interpret-mode ``_alt_pyr_radial_kernel``: the fp32
    columns rounded once.  Measured bitwise equal; the bound is 1 ulp."""
    f1, f2, x, _, _ = _lookup_inputs(nan=True)
    fn = jcorr.make_pallas_alt_corr_fn(
        jnp.asarray(f1), jnp.asarray(f2), 4, 4, dtype=jnp.dtype(fmap_dtype),
        out_dtype=jnp.bfloat16)
    want = _np(fn(jnp.asarray(x)[..., None]))
    st = build_corr_state(torch.from_numpy(f1), torch.from_numpy(f2), 4,
                          corr_dtype=getattr(torch, fmap_dtype))
    assert st.fmap1.dtype == st.f2cat.dtype == getattr(torch, fmap_dtype)
    got = corr_lookup(st, torch.from_numpy(x), 4, BF)
    assert got.dtype == BF and got.shape == want.shape == x.shape + (36,)
    nan = np.isnan(x)
    assert np.isnan(_np(got)[nan]).all() and np.isnan(want[nan]).all()
    assert _ulps(_np(got)[~nan], want[~nan]).max() <= 1.0


# ---------------------------------------------------------------- row 2

@pytest.fixture(scope="module", params=[1, 3], ids=["no_ext", "ext"])
def bf16_update_case(request):
    """The update kernel's case of ``test_torch_port_ops`` (hidden 32,
    2x9x13, with and without ext) in bf16: the JAX pack in bf16 with
    convc1 padded to the lookup's 64 channels, the port's pack in bf16."""
    n = request.param
    hd, cor = 32, 36
    ext = hd if n > 1 else 0
    rng = np.random.default_rng(10 + n)
    params = _update_params(rng, hd, ext, cor)
    blk = BasicMultiUpdateBlock(RAFTStereoConfig(
        n_gru_layers=n, hidden_dims=(hd,) * n, corr_levels=4, corr_radius=4))
    sd = {k[len("update_block."):]: v for k, v in variables_to_state_dict(
        {"params": {"update": params}}).items()}
    blk.load_state_dict(sd, strict=False)
    b, h, w = 2, 9, 13
    acts = dict(
        h=np.tanh(rng.normal(size=(b, h, w, hd))),
        ext=np.tanh(rng.normal(size=(b, h, w, ext))) if ext else None,
        corr=rng.normal(size=(b, h, w, cor)),
        disp=rng.uniform(-8, 2, (b, h, w, 1)),
        cz=rng.normal(size=(b, h, w, hd)), cr=rng.normal(size=(b, h, w, hd)),
        cq=rng.normal(size=(b, h, w, hd)))
    j = {k: None if v is None else jnp.asarray(v.astype(np.float32))
         for k, v in acts.items()}
    j = {k: v if v is None or k == "disp" else v.astype(jnp.bfloat16)
         for k, v in j.items()}
    t = {k: None if v is None else
         (torch.from_numpy(_np(v).copy()) if k == "disp" else _bf(v))
         for k, v in j.items()}
    return params, ext, blk, j, t


def test_update_bf16_plain_matches_pallas_kernel(bf16_update_case):
    """Row 2's bf16 form against the interpret-mode ``fused_update`` in
    bf16 (weights packed in bf16, the correlation zero-padded to 64
    channels): every conv an fp32 sum rounded once, the gate arithmetic
    rounded per operation.  Measured: bitwise with ext; without, 0.01%
    of h' and 2% of delta off by under an ulp (fp32 sums in another
    order).  Bounds: 1 ulp, and at least 95% of the elements equal."""
    params, ext, blk, j, t = bf16_update_case
    wpack = jgru.pack_update_params(params, 64, ext, jnp.bfloat16)
    j = dict(j, corr=jnp.pad(j["corr"], ((0, 0),) * 3 + ((0, 28),)))
    want = jgru.fused_update(*j.values(), wpack)
    got = cuda_gru.gru_update(*t.values(), cuda_gru.pack_update_params(
        blk, ext, BF))
    for g, w in zip(got, want):
        assert g.dtype == BF and tuple(g.shape) == tuple(w.shape)
        assert _ulps(g, w).max() <= 1.0
        assert np.mean(_np(g) == _np(w)) >= 0.95


def test_update_pack_keeps_dtype(bf16_update_case):
    _, ext, blk, _, _ = bf16_update_case
    p32 = cuda_gru.pack_update_params(blk, ext)
    p16 = cuda_gru.pack_update_params(blk, ext, BF)
    assert set(p32) == set(p16)
    for k in p32:
        assert p32[k].dtype == torch.float32 and p16[k].dtype == BF
        if k in cuda_gru.PLAIN_KEYS:
            assert torch.equal(p16[k], p32[k].to(BF))
        else:  # the kernel's layout: fp32 as TF32 hi and lo planes
            hd = p32["bq"].shape[0]
            for p, dt in ((p32, torch.float32), (p16, BF)):
                assert tuple(p[k].shape) == cuda_gru.kernel_shape(k, hd, ext,
                                                                  dt)


# -------------------------------------------------------------- modules

@pytest.fixture(scope="module")
def tiny_vars():
    """The TINY model's variables, made with numpy from the tree's shapes
    (cheaper than compiling ``init``)."""
    model = JaxModel(JaxConfig(fused_encoder=False, **TINY))
    return _seeded_variables(jax.eval_shape(
        lambda k: model.init(k, image_hw=(32, 48)), jax.random.key(0)))


@pytest.fixture(scope="module")
def bf16_port(tiny_vars):
    port = RAFTStereo(RAFTStereoConfig(**TINY, **BF16), device="cpu")
    port.load_state_dict(variables_to_state_dict(tiny_vars), strict=True)
    return port


def test_fp32_parameters_build_the_bf16_model(tiny_vars, bf16_port):
    """The weight bridge's fp32 state dict loads strictly into the bf16
    model, whose parameters and buffers stay fp32 (cast at use, as flax
    does), equal to the fp32 model's."""
    fp32 = RAFTStereo(RAFTStereoConfig(**TINY), device="cpu")
    fp32.load_state_dict(variables_to_state_dict(tiny_vars), strict=True)
    a, b = bf16_port.state_dict(), fp32.state_dict()
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == torch.float32 and torch.equal(a[k], b[k]), k


def _image(rng, shape):
    """A normalised image in bf16, as the model makes it: fp32 then cast."""
    x = rng.uniform(0, 255, shape).astype(np.float32)
    return jnp.asarray(2.0 * (x / 255.0) - 1.0).astype(jnp.bfloat16)


def _blocks_bitwise(enc_port, jenc, jv, x, names):
    """Each named stage of the port's encoder against the JAX one on the
    SAME bf16 input; returns the fraction of equal elements per stage."""
    out = {}
    xt = _nchw(_bf(x))
    for pname, jname in names:
        with torch.inference_mode():
            y = enc_port.get_submodule(pname)(xt)
        yj = jenc.apply(jv, x, method=lambda m, v: getattr(m, jname)(v))
        assert _ulps(_nhwc(y), yj).max() <= 3.0, pname
        out[pname] = np.mean(_np(_nhwc(y)) == _np(yj))
        x, xt = yj, _nchw(_bf(yj))
    return out


def test_encoders_bf16_match_jax(tiny_vars, bf16_port):
    """fnet (instance norm) and cnet (frozen batch norm) in bf16.  Block
    by block on the same input, the port rounds where flax rounds:
    measured 99.5-100% of the elements bitwise equal, the rest within 2.3
    ulps (conv sums in another order; a flipped mean moves a channel),
    held to 99% and 3 ulps.  The whole fnet: the flips spread (a 3x3 conv
    to its neighbours, instance norm to a channel); measured 11-20 ulps
    at most over two weight and two image seeds (16 here), held to 20,
    below JAX's own bf16-vs-fp32 gap (23-30; 27 here).  cnet's coarser
    heads, three stages further on, reach that gap, so the whole cnet is
    held block by block only."""
    rng = np.random.default_rng(0)
    img = _image(rng, (2, 32, 48, 3))
    fv = {"params": tiny_vars["params"]["fnet"]}
    jf = JaxBasicEncoder(output_dim=256, norm_fn="instance", downsample=2,
                         dtype=jnp.bfloat16, fused_stem=False)
    stem = jf.apply(fv, img, method=lambda m, v: jax.nn.relu(
        m.norm1(m.conv1(v))))
    with torch.inference_mode():
        pstem = torch.relu(bf16_port.fnet.norm1(bf16_port.fnet.conv1(
            _nchw(_bf(img)))))
    assert np.mean(_np(_nhwc(pstem)) == _np(stem)) >= 0.99
    eq = _blocks_bitwise(bf16_port.fnet, jf, fv, stem, [
        ("layer1.0", "layer1_0"), ("layer1.1", "layer1_1"),
        ("layer2.0", "layer2_0"), ("layer2.1", "layer2_1"),
        ("layer3.0", "layer3_0"), ("layer3.1", "layer3_1")])
    assert min(eq.values()) >= 0.99, eq

    cv = {"params": tiny_vars["params"]["cnet"],
          "batch_stats": tiny_vars["batch_stats"]["cnet"]}
    jc = JaxMultiEncoder(output_dims=((32,) * 3,) * 2, norm_fn="batch",
                         downsample=2, dtype=jnp.bfloat16, fused_stem=False)
    x = jc.apply(cv, img[:1], method=lambda m, v: jax.nn.relu(
        m.norm1(m.conv1(v))))
    eq = _blocks_bitwise(bf16_port.cnet, jc, cv, x, [
        ("layer1.0", "layer1_0"), ("layer2.0", "layer2_0"),
        ("layer3.0", "layer3_0"), ("layer4.0", "layer4_0")])
    assert min(eq.values()) >= 0.99, eq

    f32 = JaxBasicEncoder(output_dim=256, norm_fn="instance", downsample=2,
                          fused_stem=False)
    want = jf.apply(fv, img)
    with torch.inference_mode():
        got = _nhwc(bf16_port.fnet(_nchw(_bf(img))))
    assert got.dtype == BF
    assert _ulps(got, want).max() <= 20.0
    assert _ulps(f32.apply(fv, img.astype(jnp.float32)), want).max() > 20.0


def test_update_step_bf16_matches_jax(tiny_vars, bf16_port):
    """One bf16 module step (the three GRU levels, the motion encoder, the
    flow head) and the mask head against flax's on the same inputs.  The
    coarser levels are bitwise equal; gru08 and delta, downstream of the
    motion encoder's convs, within 1 ulp with at least 90% equal."""
    rng = np.random.default_rng(3)
    bf = jnp.bfloat16
    hw = [(8, 12), (4, 6), (2, 3)]
    net = [jnp.asarray(np.tanh(rng.normal(size=(1, h, w, 32)))).astype(bf)
           for h, w in hw]
    zqr = [tuple(jnp.asarray(rng.normal(size=(1, h, w, 32))).astype(bf)
                 for _ in range(3)) for h, w in hw]
    corr = jnp.asarray(rng.normal(size=(1, 8, 12, 10))).astype(bf)
    d = jnp.asarray(rng.uniform(-10, 0, (1, 8, 12, 1)).astype(np.float32))
    flow = jnp.concatenate([d, jnp.zeros_like(d)], -1).astype(bf)
    blk = JaxUpdate(JaxConfig(**TINY, **BF16), dtype=bf)
    uv = {"params": tiny_vars["params"]["update"]}
    jnet, _, jdelta = blk.apply(uv, net, zqr, corr, flow, with_mask=False)
    jmask = blk.apply(uv, jnet[0], method="upsample_mask")
    pb = bf16_port.update_block
    with torch.inference_mode():
        pnet, pdelta = pb([_nchw(_bf(n)) for n in net],
                          [tuple(_nchw(_bf(z)) for z in zz) for zz in zqr],
                          _nchw(_bf(corr)), _nchw(_bf(flow)))
        pmask = pb.upsample_mask(_nchw(_bf(jnet[0])))
    for lvl in (1, 2):
        assert np.array_equal(_np(_nhwc(pnet[lvl])), _np(jnet[lvl])), lvl
    for got, want in ((pnet[0], jnet[0]), (pdelta, jdelta),
                      (pmask, jmask)):
        assert got.dtype == BF
        assert _ulps(_nhwc(got), want).max() <= 1.0
        assert np.mean(_np(_nhwc(got)) == _np(want)) >= 0.9


# ---------------------------------------------------------------- model

# Largest |disparity| difference after 2 iterations (pixels; disparities
# are O(5) px), low and full resolution, with the encoders' outputs pinned
# to JAX's.  Measured over two weight seeds and two image seeds, every
# case of the tests below: 0.008-0.051 / 0.010-0.089 between the port and
# JAX in bf16, against a JAX bf16-vs-fp32 gap of 0.097-0.18 / 0.16-0.36
# on the same inputs (at the seeds used here 0.016-0.036 / 0.028-0.048
# against 0.14-0.16 / 0.22-0.28).
MODEL_TOL = (0.08, 0.12)


@pytest.fixture(scope="module")
def model_inputs(tiny_vars):
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(0, 255, (1, 32, 48, 3)).astype(np.float32)
            for _ in range(2)]
    f32 = JaxModel(JaxConfig(corr_implementation="reg", gru_backend="xla",
                             fused_encoder=False, **TINY))
    ref32 = f32.forward(tiny_vars, *(jnp.asarray(i) for i in imgs), iters=2,
                        test_mode=True)
    return imgs, [_np(r) for r in ref32]


def _pinned_port(jm, v, imgs, kw):
    """The port at ``kw`` with its encoders' outputs pinned to the JAX
    model's bf16 ones (fnet's feature maps, cnet's hidden and context
    heads).  The encoders are held block by block above; pinning them
    leaves the model's own path to compare: the context convs, the
    correlation state, every iteration and the upsampling."""
    def norm(img):
        return (2.0 * (jnp.asarray(img) / 255.0) - 1.0).astype(jnp.bfloat16)

    i1, i2 = norm(imgs[0]), norm(imgs[1])
    couts = jm.cnet.apply(jm._split_vars(v, "cnet"), i1,
                          num_layers=TINY["n_gru_layers"])
    fmaps = jm.fnet.apply(jm._split_vars(v, "fnet"),
                          jnp.concatenate([i1, i2], 0))
    port = RAFTStereo(RAFTStereoConfig(**TINY, **kw), device="cpu")
    port.load_state_dict(variables_to_state_dict(v), strict=True)
    port.cnet.forward = lambda x: [[_nchw(_bf(o)) for o in lvl]
                                   for lvl in couts]
    port.fnet.forward = lambda x: _nchw(_bf(fmaps))
    return port


def _check_forward(v, model_inputs, kw):
    imgs, ref32 = model_inputs
    jm = JaxModel(JaxConfig(fused_encoder=False, **TINY, **kw))
    want = [_np(r) for r in jm.forward(
        v, *(jnp.asarray(i) for i in imgs), iters=2, test_mode=True)]
    port = _pinned_port(jm, v, imgs, kw)
    got = port(*(torch.from_numpy(i) for i in imgs), iters=2)
    assert [g.dtype for g in got] == [torch.float32] * 2
    assert np.abs(want[0]).max() > 2.0  # a non-trivial comparison
    for g, w, r, tol in zip(got, want, ref32, MODEL_TOL):
        assert g.shape == w.shape and np.isfinite(_np(g)).all()
        assert np.abs(_np(g) - w).max() <= tol
        assert tol < np.abs(w - r).max()


@pytest.mark.parametrize("gru_backend", ["fused", "xla"])
@pytest.mark.parametrize("corr_dtype", ["bfloat16", "float32"])
def test_forward_bf16_matches_jax(tiny_vars, model_inputs, gru_backend,
                                  corr_dtype):
    """The bf16 model with ``pallas_alt``, both GRU step forms (the fused
    update kernel, or the module step behind the lookup with convc1
    fused) and both correlation dtypes, against the JAX model in bf16
    (its lookup, epilogue and update kernels in interpret mode): within
    ``MODEL_TOL``, which lies below JAX's own bf16-vs-fp32 gap on the
    same inputs, so a port that ran fp32 would fail."""
    _check_forward(tiny_vars, model_inputs, dict(
        corr_implementation="pallas_alt", compute_dtype="bfloat16",
        corr_dtype=corr_dtype, gru_backend=gru_backend))


@pytest.mark.parametrize("impl", ["reg", "alt", "pallas"])
def test_forward_bf16_other_backends_match_jax(tiny_vars, model_inputs,
                                               impl):
    """``reg``, ``alt`` and ``pallas`` (fp32 feature maps) in bf16: the
    fp32 lookup, the features cast to bf16, the module step; the same
    tolerance and gap rule."""
    _check_forward(tiny_vars, model_inputs, dict(
        corr_implementation=impl, gru_backend="xla",
        compute_dtype="bfloat16"))


# -------------------------------------------------------------- serving

def test_engine_serves_bf16_in_fp32(bf16_port):
    """``BatchEngine`` on the bf16 model: fp32 replies, bitwise equal to
    the model called directly (a 32x48 pair needs no padding)."""
    engine = BatchEngine(bf16_port, ServeConfig(
        buckets=((32, 48),), serve_iters=2, divis_by=8, bucket_multiple=16),
        device="cpu")
    rng = np.random.default_rng(4)
    left, right = (rng.uniform(0, 255, (32, 48, 3)).astype(np.float32)
                   for _ in range(2))
    (disp,) = engine.infer_batch([(left, right)])
    _, up = bf16_port(torch.from_numpy(left)[None],
                      torch.from_numpy(right)[None], iters=2)
    assert disp.dtype == np.float32
    assert np.array_equal(disp, up[0, ..., 0].numpy())


def test_cli_serve_mixed_precision(monkeypatch, capsys):
    """``--mixed_precision --corr_dtype bfloat16`` (the JAX package's
    flags) build and warm the bf16 model."""
    seen = {}

    def fake_serve_forever(self, poll_interval=0.5):
        seen["config"] = self.engine.model.config
        raise KeyboardInterrupt

    monkeypatch.setattr(StereoServer, "serve_forever", fake_serve_forever)
    rc = cli_serve.main(["--port", "0", "--device", "cpu", "--buckets",
                         "30x40", "--serve_iters", "1", "--n_gru_layers",
                         "1", "--hidden_dims", "32", "--corr_levels", "2",
                         "--corr_radius", "2", "--mixed_precision",
                         "--corr_dtype", "bfloat16", "--gru_backend", "xla"])
    assert rc == 0 and "serving" in capsys.readouterr().out
    cfg = seen["config"]
    assert (cfg.compute_dtype, cfg.corr_dtype, cfg.gru_backend) == (
        "bfloat16", "bfloat16", "xla")


# ------------------------------------------------------------- refusals

@pytest.mark.parametrize("kw,item", [
    (dict(corr_dtype="bfloat16"), "Queue 1 item 7"),
    (dict(corr_dtype="bfloat16", corr_quant=True), "Queue 1 item 7"),
    (dict(corr_implementation="pallas", corr_dtype="bfloat16"),
     "Queue 1 item 7")])
def test_unported_bf16_combination_raises(kw, item):
    """bf16 correlation at fp32 compute (with the int8 volume or the
    ``pallas`` volume too) is refused at construction; the bf16 ``pallas``
    volume, the int8 tier and the fused encoder at bf16 compute serve
    (``test_accepted_bf16_combinations_build``)."""
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        RAFTStereo(RAFTStereoConfig(**TINY, **kw), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(compute_dtype="bfloat16"),
    dict(compute_dtype="bfloat16", corr_implementation="alt"),
    dict(compute_dtype="bfloat16", corr_implementation="pallas"),
    dict(compute_dtype="bfloat16", corr_dtype="bfloat16",
         corr_implementation="reg"),
    dict(corr_implementation="pallas", **BF16),
    dict(corr_quant=True, **BF16),
    dict(compute_dtype="bfloat16", corr_quant=True),
    dict(fused_encoder=True, compute_dtype="bfloat16"),
    dict(fused_encoder=True, corr_quant=True, **BF16)])
def test_accepted_bf16_combinations_build(kw):
    RAFTStereo(RAFTStereoConfig(**TINY, **kw), device="cpu")
