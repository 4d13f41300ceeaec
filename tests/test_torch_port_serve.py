"""The port's serving path on the CPU: ``BatchEngine`` and ``/predict``
over real HTTP are bitwise equal to the port's model called directly;
malformed bodies are 400s; entry points default to CUDA and refuse to
fall back to the CPU."""

import base64
import http.client
import json

import numpy as np
import pytest
import torch

from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig, ServeConfig
from raftstereo_tpu_torch.cli import serve as cli_serve
from raftstereo_tpu_torch.ops.image import BucketPadder
from raftstereo_tpu_torch.serve.engine import BatchEngine
from raftstereo_tpu_torch.serve.server import (StereoServer, build_server,
                                               decode_array, encode_array)

TINY = RAFTStereoConfig(n_gru_layers=2, hidden_dims=(32, 32),
                        corr_levels=2, corr_radius=2)
SCFG = ServeConfig(port=0, buckets=((60, 90),), serve_iters=2)
HW = (60, 90)


@pytest.fixture(scope="module")
def model():
    return RAFTStereo(TINY, device="cpu", seed=3)


@pytest.fixture(scope="module")
def server(model):
    srv = build_server(model, SCFG, device="cpu")
    srv.start()
    yield srv
    srv.shutdown()
    srv.server_close()


def _pair(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0, 255, HW + (3,)).astype(np.float32)
                 for _ in range(2))


def _post(srv, body, path="/predict"):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _direct(model, left, right, iters):
    """The model called directly on the engine's padding."""
    p = BucketPadder(left.shape, divis_by=SCFG.divis_by,
                     bucket_multiple=SCFG.bucket_multiple)
    l_t, r_t = p.pad(torch.from_numpy(left)[None],
                     torch.from_numpy(right)[None])
    _, up = model(l_t, r_t, iters=iters)
    return p.unpad(up)[0, ..., 0].numpy()


def test_engine_bitwise_equals_model(model):
    eng = BatchEngine(model, SCFG, device="cpu")
    left, right = _pair(0)
    (got,) = eng.infer_batch([(left, right)])
    assert got.shape == HW and got.dtype == np.float32
    np.testing.assert_array_equal(got, _direct(model, left, right, 2))
    st = eng.stats()["64x128"]
    assert st["batches"] == 1 and st["pairs"] == 1


@pytest.mark.parametrize("dialect", ["b64", "list"])
def test_predict_bitwise_equals_model(server, model, dialect):
    left, right = _pair(1)
    enc = encode_array if dialect == "b64" else (lambda a: a.tolist())
    status, obj = _post(server, json.dumps(
        {"left": enc(left), "right": enc(right), "iters": 2}))
    assert status == 200, obj
    disp = decode_array(obj["disparity"])
    assert np.isfinite(disp).all()
    np.testing.assert_array_equal(disp, _direct(model, left, right, 2))
    assert obj["meta"]["iters"] == 2 and obj["meta"]["bucket"] == [64, 128]


def _arr(a):
    return encode_array(np.asarray(a, np.float32))


@pytest.mark.parametrize("body", [
    b"not json",
    json.dumps({"left": _arr(np.zeros((60, 90, 3)))}).encode(),
    json.dumps({"left": _arr(np.zeros((60, 90, 3))),
                "right": _arr(np.zeros((60, 91, 3)))}).encode(),
    json.dumps({"left": _arr(np.zeros((60, 90))),
                "right": _arr(np.zeros((60, 90)))}).encode(),
    json.dumps({"left": {"shape": [2], "dtype": "float32",
                         "data_b64": "@@"},
                "right": _arr(np.zeros((60, 90, 3)))}).encode(),
    json.dumps({"left": _arr(np.zeros((60, 90, 3))),
                "right": _arr(np.zeros((60, 90, 3))), "iters": 7}).encode(),
], ids=["not-json", "no-right", "shape-mismatch", "not-rgb", "bad-b64",
        "unserved-iters"])
def test_malformed_predict_is_400(server, body):
    status, obj = _post(server, body)
    assert status == 400 and "error" in obj


def test_healthz_and_unknown_path(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    try:
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        obj = json.loads(r.read())
        assert r.status == 200 and obj["buckets"] == [[64, 128]]
        assert obj["device"] == "cpu" and obj["serve_iters"] == 2
    finally:
        conn.close()
    assert _post(server, b"{}", path="/nope")[0] == 404


def test_decode_array_roundtrip():
    a = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    obj = json.loads(json.dumps(encode_array(a)))
    np.testing.assert_array_equal(decode_array(obj), a)
    raw = base64.b64encode(a.astype(np.float64).tobytes()).decode()
    got = decode_array({"shape": [2, 2, 3], "dtype": "float64",
                        "data_b64": raw})
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("entry", ["engine", "build_server", "cli"])
def test_entry_points_default_to_cuda(model, entry):
    """Without a GPU the default device raises instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "engine":
            BatchEngine(model, SCFG)
        elif entry == "build_server":
            build_server(model, SCFG, warmup=False)
        else:
            cli_serve.main(["--port", "0", "--n_gru_layers", "1",
                            "--hidden_dims", "32", "--corr_levels", "2",
                            "--corr_radius", "2"])


def test_cli_serves_on_cpu(monkeypatch, capsys):
    """The CLI on device='cpu': warms, prints its address, serves."""
    served = {}

    def fake_serve_forever(self, poll_interval=0.5):
        served["port"] = self.port
        raise KeyboardInterrupt

    monkeypatch.setattr(StereoServer, "serve_forever", fake_serve_forever)
    rc = cli_serve.main(["--port", "0", "--device", "cpu", "--buckets",
                         "30x40", "--serve_iters", "1", "--n_gru_layers",
                         "1", "--hidden_dims", "32", "--corr_levels", "2",
                         "--corr_radius", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["serving"].endswith(f":{served['port']}")
    assert line["buckets"] == [[64, 64]]
