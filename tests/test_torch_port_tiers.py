"""The port's accuracy tiers (certified / fast / turbo) against the JAX
package on the CPU: the tier vocabulary, the tier models, certification
and the serving engine and HTTP server.

* The vocabulary (``ops.quant``) mirrors the JAX package's
  (``tests/test_quant.py::TestTierVocabulary``), compared case by case
  with the JAX functions.
* The tier models in test mode: ``fast`` on a ``pallas`` base (the bf16
  volume pyramid and row 5's bf16 form) and ``turbo`` (row 7's bf16 form,
  then row 5's) against the JAX bf16 model with the encoders pinned,
  within ``MODEL_TOL`` of ``tests/test_torch_port_bf16.py``, which lies
  below JAX's own bf16-vs-fp32 gap.  On the CPU the JAX package resolves
  the int8 tier to its ``reg`` lookup over an fp32 volume; on its
  accelerator to ``pallas`` over a bf16 volume, the function the port
  runs.  The turbo test points the JAX model's resolution at ``pallas``
  (``raftstereo_tpu.ops.corr.resolve_implementation``, patched with
  ``monkeypatch`` for that test only), so JAX runs its Pallas lookup in
  interpret mode over its bf16 int8 volume.
* Certification (``eval.certify``) mirrors
  ``tests/test_quant.py::TestCertification``: the manifest, ``tier_ok``
  and ``resolve_tiers`` on a round trip, over bound, another
  architecture, another platform (a JAX manifest included), absent and
  corrupt manifests.
* Serving: replies without ``accuracy`` and ``certified`` replies on an
  fp32 base are bitwise the base model's; each tier's reply is bitwise a
  direct engine call in that mode (and the tier model called directly);
  an unknown tier and an unadvertised one are 400s, the second with its
  recorded reason.
"""

import dataclasses
import http.client
import json

import numpy as np
import pytest
import torch
from test_torch_port_bf16 import (  # noqa: F401 fixtures
    MODEL_TOL, TINY, _check_forward, model_inputs, tiny_vars)
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse

from raftstereo_tpu import RAFTStereoConfig as JaxConfig
from raftstereo_tpu.ops import corr as jcorr
from raftstereo_tpu.ops import quant as jquant
from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig, ServeConfig
from raftstereo_tpu_torch.cli import certify as cli_certify
from raftstereo_tpu_torch.cli import serve as cli_serve
from raftstereo_tpu_torch.eval import certify
from raftstereo_tpu_torch.ops import quant
from raftstereo_tpu_torch.serve.server import (StereoServer, build_server,
                                               decode_array, encode_array)

BF16 = dict(compute_dtype="bfloat16", corr_dtype="bfloat16")
SMALL = dict(n_gru_layers=2, hidden_dims=(32, 32), corr_levels=2,
             corr_radius=2)
HW = (32, 48)
ITERS = 2


# ------------------------------------------------------------ vocabulary

_BASES = [dict(), dict(corr_implementation="pallas"), dict(corr_quant=True),
          dict(compute_dtype="bfloat16"), dict(corr_dtype="bfloat16"),
          dict(BF16), dict(BF16, corr_quant=True),
          dict(BF16, corr_implementation="pallas", gru_backend="xla")]


@pytest.mark.parametrize("base", range(len(_BASES)))
def test_tier_vocabulary_matches_jax(base):
    """``config_for_mode`` and ``default_mode`` give the JAX package's
    numeric fields and modes on the same configs: only compute_dtype,
    corr_dtype and corr_quant move, and a config aliases onto a tier mode
    only where it is that mode's config ("base" otherwise)."""
    kw = _BASES[base]
    port, jax_cfg = RAFTStereoConfig(**kw), JaxConfig(**kw)
    assert quant.default_mode(port) == jquant.default_mode(jax_cfg)
    for mode in quant.MODES:
        p = quant.config_for_mode(port, mode)
        j = jquant.config_for_mode(jax_cfg, mode)
        assert (p.compute_dtype, p.corr_dtype, p.corr_quant) == (
            j.compute_dtype, j.corr_dtype, j.corr_quant)
        assert dataclasses.replace(
            p, compute_dtype=port.compute_dtype, corr_dtype=port.corr_dtype,
            corr_quant=port.corr_quant) == port
        assert quant.default_mode(p) == mode == jquant.default_mode(j)


def test_tier_modes_and_errors():
    assert (quant.TIERS, quant.TIER_MODES, quant.MODES) == (
        jquant.TIERS, jquant.TIER_MODES, jquant.MODES)
    for tier in quant.TIERS:
        assert quant.mode_for_accuracy(tier) == jquant.mode_for_accuracy(tier)
    with pytest.raises(ValueError, match="unknown accuracy tier"):
        quant.mode_for_accuracy("bogus")
    with pytest.raises(ValueError, match="unknown precision mode"):
        quant.config_for_mode(RAFTStereoConfig(), "fp16")


def test_serve_config_validates_tiers():
    with pytest.raises(ValueError, match="unknown accuracy tier"):
        ServeConfig(port=0, tiers=("fast", "ultra"))
    assert ServeConfig(tiers=["fast"]).tiers == ("fast",)


# ----------------------------------------------------- the tier models

def _quant_resolves_to_pallas(monkeypatch):
    """The JAX package's int8 tier as on its accelerator: ``pallas`` over
    the bf16 int8 volume (on the CPU it would take ``reg``)."""
    real = jcorr.resolve_implementation

    def resolve(implementation, quant=False):
        return "pallas" if quant else real(implementation, quant)

    monkeypatch.setattr(jcorr, "resolve_implementation", resolve)


@pytest.mark.parametrize("tier,gru", [("fast", "fused"), ("turbo", "fused"),
                                      ("turbo", "xla")])
def test_tier_model_matches_jax(tiny_vars, model_inputs, monkeypatch, tier,
                                gru):
    """``fast`` on a ``pallas`` base and ``turbo`` in test mode, both GRU
    step forms, against the JAX bf16 model with the encoders pinned
    (its Pallas lookup, int8 volume and update in interpret mode): within
    ``MODEL_TOL``, below JAX's own bf16-vs-fp32 gap."""
    if tier == "turbo":
        _quant_resolves_to_pallas(monkeypatch)
    _check_forward(tiny_vars, model_inputs, dict(
        corr_implementation="pallas", gru_backend=gru, **BF16,
        corr_quant=tier == "turbo"))


def test_train_mode_ignores_corr_quant_in_bf16():
    """bf16 training with ``corr_quant`` on the on-demand backend runs,
    bitwise equal to the same config without the flag."""
    rng = np.random.default_rng(3)
    imgs = [torch.from_numpy(rng.uniform(0, 255, (1,) + HW + (3,))
                             .astype(np.float32)) for _ in range(2)]
    outs = []
    for q in (True, False):
        m = RAFTStereo(RAFTStereoConfig(**SMALL, **BF16, corr_quant=q),
                       device="cpu", seed=1)
        outs.append(m(*imgs, iters=2, test_mode=False))
    assert torch.equal(outs[0], outs[1])


def test_train_mode_ignores_corr_quant_on_the_bf16_volume():
    """bf16 training over the bf16 ``pallas`` volume runs, and with
    ``corr_quant`` it trains on that unquantized volume, as the JAX
    package does: bitwise equal to the run without the flag, gradients
    and all."""
    rng = np.random.default_rng(4)
    imgs = [torch.from_numpy(rng.uniform(0, 255, (1,) + HW + (3,))
                             .astype(np.float32)) for _ in range(2)]
    outs = []
    for q in (True, False):
        m = RAFTStereo(RAFTStereoConfig(**SMALL, **BF16,
                                        corr_implementation="pallas",
                                        corr_quant=q), device="cpu", seed=1)
        preds = m(*imgs, iters=2, test_mode=False)
        preds.float().square().mean().backward()
        outs.append((preds, {k: p.grad for k, p in m.named_parameters()}))
    assert torch.equal(outs[0][0], outs[1][0])
    assert bool(torch.isfinite(outs[0][0]).all())
    for k, g in outs[1][1].items():
        assert torch.equal(outs[0][1][k], g), k


# --------------------------------------------------------- certification

@pytest.fixture(scope="module")
def base_model():
    return RAFTStereo(RAFTStereoConfig(**SMALL), device="cpu", seed=5)


@pytest.fixture(scope="module")
def manifest(base_model):
    """'fast' certified; 'turbo' measured with an impossible bound, so it
    is present but over bound."""
    return certify.certify_tiers(base_model, ("fast", "turbo"), hw=HW,
                                 n_pairs=2, iters=ITERS,
                                 bounds={"fast": 1e3, "turbo": -1e3})


def test_certify_tiers_manifest(manifest, base_model):
    assert manifest["platform"] == {"framework": "torch", "device": "cpu"}
    assert manifest["model"] == certify._arch_of(base_model.config)
    fast, turbo = manifest["tiers"]["fast"], manifest["tiers"]["turbo"]
    assert (fast["mode"], fast["certified"]) == ("bf16", True)
    assert (turbo["mode"], turbo["certified"]) == ("int8", False)
    assert fast["max_abs_disp_diff"] > 0 and turbo["max_abs_disp_diff"] > 0
    assert manifest["eval"]["hw"] == list(HW)


def _jax_manifest(m):
    return dict(m, platform="cpu")


@pytest.mark.parametrize("case", [
    "roundtrip", "over_bound", "absent_manifest", "absent_tier",
    "architecture", "corr_implementation", "platform_device",
    "jax_manifest", "inconsistent", "unknown_tier"])
def test_tier_ok(manifest, base_model, tmp_path, case):
    """``tier_ok`` certifies only a certified, in-bound tier of this
    architecture measured by the port on this platform; every other case
    refuses with its reason."""
    path = str(tmp_path / "cert.json")
    certify.write_manifest(manifest, path)
    m = certify.load_manifest(path)
    assert m["tiers"] == manifest["tiers"]
    cfg, dev, tier = base_model.config, "cpu", "fast"
    if case == "over_bound":
        tier = "turbo"
    elif case == "absent_manifest":
        m = None
    elif case == "absent_tier":
        m = dict(m, tiers={"turbo": m["tiers"]["turbo"]})
    elif case == "architecture":
        cfg = RAFTStereoConfig(n_gru_layers=1, hidden_dims=(32,),
                               corr_levels=2, corr_radius=2)
    elif case == "corr_implementation":
        cfg = dataclasses.replace(cfg, corr_implementation="alt")
    elif case == "platform_device":
        m = dict(m, platform={"framework": "torch", "device": "cuda",
                              "name": "NVIDIA H100 80GB HBM3"})
    elif case == "jax_manifest":
        m = _jax_manifest(m)
    elif case == "inconsistent":
        m = dict(m, tiers=dict(m["tiers"], fast=dict(
            m["tiers"]["fast"], epe_delta=2e3)))
    elif case == "unknown_tier":
        tier = "ultra"
    ok, reason = certify.tier_ok(m, tier, cfg, dev)
    assert ok == (case == "roundtrip"), reason
    want = {"roundtrip": "certified", "over_bound": "over bound",
            "absent_manifest": "no certification manifest",
            "absent_tier": "not present", "architecture": "architecture",
            "corr_implementation": "corr_implementation",
            "platform_device": "platform", "jax_manifest": "not by the port",
            "inconsistent": "inconsistent", "unknown_tier": "unknown tier"}
    assert want[case] in reason


def test_load_manifest_refuses_corrupt_files(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(ValueError, match="not valid JSON"):
        certify.load_manifest(str(bad))
    bad.write_text(json.dumps({"version": 99, "tiers": {}}))
    with pytest.raises(ValueError, match="unsupported"):
        certify.load_manifest(str(bad))


def test_resolve_tiers(manifest, base_model, tmp_path):
    """'certified' needs no manifest; without one, or with an unreadable
    one, the others are refused with the reason."""
    cfg = base_model.config
    scfg = ServeConfig(tiers=("certified", "fast", "turbo"))
    adv, ref = certify.resolve_tiers(scfg, cfg, "cpu")
    assert adv == {"certified": "fp32"}
    assert set(ref) == {"fast", "turbo"}
    assert "no certification manifest" in ref["fast"]
    adv, ref = certify.resolve_tiers(dataclasses.replace(
        scfg, cert_manifest=str(tmp_path / "missing.json")), cfg, "cpu")
    assert adv == {"certified": "fp32"} and "missing.json" in ref["fast"]
    path = str(tmp_path / "cert.json")
    certify.write_manifest(manifest, path)
    adv, ref = certify.resolve_tiers(dataclasses.replace(
        scfg, cert_manifest=path), cfg, "cpu")
    assert adv == {"certified": "fp32", "fast": "bf16"}
    assert "over bound" in ref["turbo"]
    assert certify.resolve_tiers(ServeConfig(), cfg, "cpu") == ({}, {})


# ------------------------------------------------------------- serving

def _pair(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0, 255, HW + (3,)).astype(np.float32)
                 for _ in range(2))


def _post(srv, left, right, accuracy=None):
    body = {"left": encode_array(left), "right": encode_array(right)}
    if accuracy is not None:
        body["accuracy"] = accuracy
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
    try:
        conn.request("POST", "/predict", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _scfg(path, tiers=("certified", "fast", "turbo")):
    return ServeConfig(port=0, buckets=(HW,), serve_iters=ITERS, divis_by=8,
                       bucket_multiple=16, tiers=tiers, cert_manifest=path)


@pytest.fixture(scope="module")
def tier_server(base_model, tmp_path_factory):
    """The fp32 base served with all three tiers, from a manifest that
    certifies both."""
    path = str(tmp_path_factory.mktemp("cert") / "cert.json")
    certify.write_manifest(certify.certify_tiers(
        base_model, hw=HW, n_pairs=2, iters=ITERS,
        bounds={"fast": 1e3, "turbo": 1e3}), path)
    srv = build_server(base_model, _scfg(path), device="cpu")
    srv.start()
    yield srv
    srv.shutdown()
    srv.server_close()


def _direct(model, left, right):
    _, up = model(torch.from_numpy(left)[None], torch.from_numpy(right)[None],
                  iters=ITERS)
    return up[0, ..., 0].numpy()


def test_default_and_certified_are_the_base_model(tier_server, base_model):
    """No ``accuracy`` field and ``certified`` on the fp32 base: bitwise
    the base model called directly (a 32x48 pair needs no padding)."""
    left, right = _pair(1)
    want = _direct(base_model, left, right)
    for accuracy in (None, "certified"):
        status, obj = _post(tier_server, left, right, accuracy)
        assert status == 200, obj
        np.testing.assert_array_equal(decode_array(obj["disparity"]), want)
        assert obj["meta"].get("accuracy") == accuracy
    assert tier_server.mode_of("certified") is None


@pytest.mark.parametrize("tier", ["fast", "turbo"])
def test_tier_reply_is_the_tier_model(tier_server, base_model, tier):
    """A tier's reply: bitwise a direct engine call in its mode and the
    tier's model called directly, and not the base model's."""
    left, right = _pair(2)
    status, obj = _post(tier_server, left, right, tier)
    assert status == 200, obj
    got = decode_array(obj["disparity"])
    mode = quant.TIER_MODES[tier]
    (engine,) = tier_server.engine.infer_batch([(left, right)], mode=mode)
    np.testing.assert_array_equal(got, engine)
    twin = base_model.with_numerics(
        quant.config_for_mode(base_model.config, mode))
    np.testing.assert_array_equal(got, _direct(twin, left, right))
    assert not np.array_equal(got, _direct(base_model, left, right))
    assert obj["meta"]["accuracy"] == tier


def test_engine_tier_models_share_the_base_parameters(tier_server,
                                                      base_model):
    eng = tier_server.engine
    assert eng.default_mode == "fp32" and eng.model_for(None) is base_model
    for mode in ("bf16", "int8"):
        twin = eng.model_for(mode)
        assert twin.config == quant.config_for_mode(base_model.config, mode)
        assert all(a is b for a, b in zip(twin.parameters(),
                                          base_model.parameters()))
    assert {"32x48", "32x48/bf16", "32x48/int8"} <= set(eng.stats())
    with pytest.raises(ValueError, match="unknown precision mode"):
        eng.infer_batch([_pair(0)], mode="fp16")


def test_healthz_reports_the_tiers(tier_server):
    conn = http.client.HTTPConnection("127.0.0.1", tier_server.port,
                                      timeout=30)
    try:
        conn.request("GET", "/healthz")
        obj = json.loads(conn.getresponse().read())
    finally:
        conn.close()
    assert obj["tiers"] == {"advertised": {"certified": "fp32",
                                           "fast": "bf16", "turbo": "int8"},
                            "refused": {}}


@pytest.mark.parametrize("case", ["unknown", "over_bound", "not_offered",
                                  "fused_encoder"])
def test_unadvertised_tier_is_400(tier_server, base_model, manifest,
                                  tmp_path, case):
    """An unknown tier, a tier the manifest holds over bound, a tier the
    server was not asked to offer, and a tier certified on another
    architecture (a fused-encoder base with the plain encoders' manifest:
    the fused stages are another numeric function) are 400s; the refused
    ones carry the reason recorded at startup."""
    left, right = _pair(3)
    if case == "unknown":
        status, obj = _post(tier_server, left, right, "ultra")
        assert status == 400 and "unknown accuracy tier" in obj["error"]
        return
    path = str(tmp_path / "cert.json")
    model, tiers, tier = base_model, ("certified", "turbo"), "turbo"
    m = manifest
    if case == "not_offered":
        tiers = ("certified",)
    elif case == "fused_encoder":
        model = RAFTStereo(RAFTStereoConfig(**SMALL, fused_encoder=True),
                           device="cpu")
        m = dict(m, tiers=dict(m["tiers"], turbo=dict(m["tiers"]["turbo"],
                                                      bound=1e3,
                                                      certified=True)))
    certify.write_manifest(m, path)
    srv = build_server(model, _scfg(path, tiers), device="cpu",
                       warmup=False)
    srv.start()
    try:
        status, obj = _post(srv, left, right, tier)
    finally:
        srv.shutdown()
        srv.server_close()
    assert status == 400 and "not advertised" in obj["error"]
    want = {"over_bound": "over bound", "not_offered": "not offered",
            "fused_encoder": "architecture"}
    assert want[case] in obj["error"]
    assert set(srv.tiers) == {"certified"}


def test_fused_base_serves_the_bf16_tiers(tmp_path):
    """A ``fused_encoder=True`` base certified on its own architecture
    advertises ``fast`` and ``turbo`` (their models run the fused stages'
    bf16 kernels), and serves each bitwise equal to a direct engine call
    in its mode, which is not the base's reply."""
    model = RAFTStereo(RAFTStereoConfig(**SMALL, fused_encoder=True),
                       device="cpu", seed=5)
    path = str(tmp_path / "cert.json")
    certify.write_manifest(certify.certify_tiers(
        model, hw=HW, n_pairs=2, iters=ITERS,
        bounds={"fast": 1e3, "turbo": 1e3}), path)
    srv = build_server(model, _scfg(path), device="cpu")
    assert srv.tiers == {"certified": "fp32", "fast": "bf16",
                         "turbo": "int8"}
    for mode in ("bf16", "int8"):
        cfg = srv.engine.model_for(mode).config
        assert cfg.fused_encoder is True
        assert cfg.compute_dtype == "bfloat16"
    srv.start()
    left, right = _pair(4)
    try:
        _, base = _post(srv, left, right)
        for tier in ("fast", "turbo"):
            status, obj = _post(srv, left, right, tier)
            assert status == 200, obj
            got = decode_array(obj["disparity"])
            (want,) = srv.engine.infer_batch(
                [(left, right)], mode=quant.TIER_MODES[tier])
            np.testing.assert_array_equal(got, want)
            assert not np.array_equal(got, decode_array(base["disparity"]))
    finally:
        srv.shutdown()
        srv.server_close()


def test_certified_on_a_non_tier_base_runs_fp32(tmp_path):
    """A base whose numerics match no tier (bf16 compute, fp32 feature
    maps: mode "base") answers ``certified`` with the fp32 model, never
    with its own numbers."""
    model = RAFTStereo(RAFTStereoConfig(**SMALL, compute_dtype="bfloat16"),
                       device="cpu", seed=5)
    srv = build_server(model, _scfg(None, ("certified",)), device="cpu")
    srv.start()
    try:
        left, right = _pair(4)
        _, base = _post(srv, left, right)
        _, cert = _post(srv, left, right, "certified")
    finally:
        srv.shutdown()
        srv.server_close()
    assert srv.engine.default_mode == "base"
    fp32 = model.with_numerics(quant.config_for_mode(model.config, "fp32"))
    np.testing.assert_array_equal(decode_array(cert["disparity"]),
                                  _direct(fp32, left, right))
    np.testing.assert_array_equal(decode_array(base["disparity"]),
                                  _direct(model, left, right))
    assert not np.array_equal(decode_array(cert["disparity"]),
                              decode_array(base["disparity"]))


def test_cli_certify_then_serve_tiers(monkeypatch, capsys, tmp_path):
    """``cli.certify`` writes a manifest on the CPU (exit 1 when a tier is
    over its bound); ``cli.serve --tiers ... --cert_manifest`` advertises
    what it certifies and prints the decision."""
    path = str(tmp_path / "cert.json")
    flags = ["--device", "cpu", "--n_gru_layers", "1", "--hidden_dims",
             "32", "--corr_levels", "2", "--corr_radius", "2"]
    rc = cli_certify.main(flags + [
        "--out", path, "--cert_height", "32", "--cert_width", "48",
        "--cert_pairs", "1", "--cert_iters", "1", "--bound", "fast=1000",
        "turbo=-1000"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and line["manifest"] == path
    assert line["tiers"]["fast"]["certified"] is True
    assert line["tiers"]["turbo"]["certified"] is False
    seen = {}

    def fake_serve_forever(self, poll_interval=0.5):
        seen["tiers"] = (self.tiers, self.tier_reasons)
        raise KeyboardInterrupt

    monkeypatch.setattr(StereoServer, "serve_forever", fake_serve_forever)
    rc = cli_serve.main(flags + ["--port", "0", "--buckets", "32x48",
                                 "--serve_iters", "1", "--tiers",
                                 "certified", "fast", "turbo",
                                 "--cert_manifest", path])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert line["tiers"]["advertised"] == {"certified": "fp32",
                                           "fast": "bf16"}
    assert "over bound" in line["tiers"]["refused"]["turbo"]
    assert seen["tiers"][0] == line["tiers"]["advertised"]


def test_cli_certify_defaults_to_cuda():
    """Without a GPU, ``cli.certify``'s default device raises instead of
    certifying the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_certify.main(["--out", "unused.json", "--n_gru_layers", "1",
                          "--hidden_dims", "32", "--corr_levels", "2",
                          "--corr_radius", "2"])
