"""The CPU engine test's own first forward in a fresh process: does the
engine give the bits of the model called directly, and is the process's
first ``torch.tanh`` equal to a later one on the same input?

Each of ``--runs`` fresh processes, one after another, does what
``tests/test_torch_port_serve.py::test_engine_bitwise_equals_model`` does
on a model whose first forward is not spent: it builds the tiny serving
model (seed 3), runs ``BatchEngine.infer_batch`` on the seed-0 60x90 pair
(the process's first forward) and then the model directly on the same
bucket padding, and compares the two disparities.  ``torch.tanh`` is
wrapped to keep its first call's input and output (the forward's first
tanh, on cnet's first output at the 64x128 bucket), which is then
recomputed.  On an MKL build torch's CPU tanh splits the tensor into
chunks of 2048 elements over its OpenMP threads and runs MKL VML's
``vmsTanh`` on each, asking for high accuracy (HA).

The script prints, for each process where either comparison differs, the
largest difference of the two disparities, the torch and MKL thread
counts at each call, and for the chunks of the first tanh that differ
from the recomputation their largest error against a float64 tanh and
whether they equal ``vmsTanh`` in its HA or its enhanced-performance (EP)
mode; then the counts.

    python3 scripts/cpu_first_call.py [--runs 60]

CPU only; a process takes a few seconds.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 2048  # torch's grain for its VML-backed unary kernels


def child() -> dict:
    """One fresh process: the engine test's two calls, the first tanh
    kept and recomputed."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig, ServeConfig
    from raftstereo_tpu_torch.ops.image import BucketPadder
    from raftstereo_tpu_torch.serve.engine import BatchEngine

    lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                                   "libtorch_cpu.so"))

    def threads():
        return [torch.get_num_threads(), lib.mkl_get_max_threads()]

    real, first = torch.tanh, []

    def tanh(x):
        y = real(x)
        if not first:
            first.append((x.clone(), y.clone()))
        return y

    torch.tanh = tanh
    cfg = RAFTStereoConfig(n_gru_layers=2, hidden_dims=(32, 32),
                           corr_levels=2, corr_radius=2)
    scfg = ServeConfig(port=0, buckets=((60, 90),), serve_iters=2)
    model = RAFTStereo(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(0)
    left, right = (rng.uniform(0, 255, (60, 90, 3)).astype(np.float32)
                   for _ in range(2))
    res = {"threads_engine": threads()}
    (got,) = BatchEngine(model, scfg, device="cpu").infer_batch(
        [(left, right)])
    res["threads_direct"] = threads()
    p = BucketPadder(left.shape, divis_by=scfg.divis_by,
                     bucket_multiple=scfg.bucket_multiple)
    l_t, r_t = p.pad(torch.from_numpy(left)[None],
                     torch.from_numpy(right)[None])
    _, up = model(l_t, r_t, iters=2)
    want = p.unpad(up)[0, ..., 0].numpy()
    x, y1 = first[0]
    y2 = real(x)
    res.update(engine_equal=bool(np.array_equal(got, want)),
               engine_max_diff=float(np.abs(got - want).max()),
               tanh_equal=bool(torch.equal(y1, y2)))
    if res["engine_equal"] and res["tanh_equal"]:
        return res
    x, y1, y2 = (t.flatten().numpy() for t in (x, y1, y2))
    ref = np.tanh(x.astype(np.float64))
    vms = lib.vmsTanh
    vms.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_ulonglong]
    chunks = []
    for c in range(0, x.size, CHUNK):
        s = slice(c, c + CHUNK)
        row = {"chunk": c // CHUNK,
               "first_err": float(np.abs(y1[s] - ref[s]).max()),
               "second_err": float(np.abs(y2[s] - ref[s]).max()),
               "differ": int((y1[s] != y2[s]).sum())}
        if row["differ"]:
            xs = np.ascontiguousarray(x[s])
            for name, mode in (("HA", 0x2), ("EP", 0x3)):
                out = np.empty_like(xs)
                # | VML_FTZDAZ_OFF | VML_ERRMODE_IGNORE, as torch asks
                vms(xs.size, xs.ctypes.data, out.ctypes.data,
                    mode | 0x140000 | 0x100)
                row[f"first_equals_{name}"] = int((out == y1[s]).sum())
                row[f"second_equals_{name}"] = int((out == y2[s]).sum())
            chunks.append(row)
    res["tanh_numel"] = int(x.size)
    res["chunks_differing"] = chunks
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=60)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child()))
        return 0
    engine_differs = tanh_differs = both = 0
    largest = 0.0
    for _ in range(args.runs):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child"], capture_output=True, text=True,
                             check=True)
        res = json.loads(out.stdout.strip().splitlines()[-1])
        engine_differs += not res["engine_equal"]
        tanh_differs += not res["tanh_equal"]
        both += not (res["engine_equal"] or res["tanh_equal"])
        largest = max(largest, res["engine_max_diff"])
        if not (res["engine_equal"] and res["tanh_equal"]):
            print(json.dumps(res), flush=True)
    print(json.dumps({"runs": args.runs, "engine_differs": engine_differs,
                      "first_tanh_differs": tanh_differs, "both": both,
                      "largest_engine_diff": largest}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
