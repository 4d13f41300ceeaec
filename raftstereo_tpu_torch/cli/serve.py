"""Serve the port over HTTP.

    python -m raftstereo_tpu_torch.cli.serve --port 8080 --buckets 540x960 \
        --serve_iters 32 [--corr_implementation pallas] [--corr_quant] \
        [--gru_backend fused] [--mixed_precision [--corr_dtype bfloat16]] \
        [--tiers certified fast turbo --cert_manifest certification.json] \
        [--device cuda] [--restore_ckpt PATH | --weights_npz PATH]

``--mixed_precision`` serves in bf16 (``compute_dtype="bfloat16"``, the
JAX package's flag); ``--corr_dtype bfloat16`` also stores the on-demand
lookup's feature maps in bf16.  Replies are fp32 either way.

``--tiers`` offers accuracy tiers on ``/predict``'s ``accuracy`` field
("certified": fp32, "fast": bf16, "turbo": bf16 with the int8 volume);
"fast" and "turbo" are advertised only where ``--cert_manifest`` (written
by ``python -m raftstereo_tpu_torch.cli.certify`` on the same platform
and architecture) certifies them, and each advertised tier is warmed at
startup.

Without ``--restore_ckpt`` or ``--weights_npz`` the model has seeded
random weights.  ``--restore_ckpt`` takes an upstream ``.pth``, the
port's ``save_weights`` file or a flattened JAX ``.npz``
(``cli.common.load_weights_any``); ``--weights_npz`` is a flattened JAX
``variables`` tree (``utils.convert.flatten_variables`` saved with
``np.savez``), loaded through the weight bridge.  Prints one JSON line
``{"serving": "http://host:port", ...}`` once warm, then serves until
interrupted.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
from typing import Optional, Sequence

from ..config import CORR_IMPLEMENTATIONS, RAFTStereoConfig, ServeConfig
from ..models import RAFTStereo
from ..serve.server import build_server
from ..utils.convert import load_weights_npz
from .common import load_weights_any


def _bucket(text: str):
    try:
        h, w = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(f"bucket {text!r} is not HxW")
    return h, w


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    d, m = ServeConfig(), RAFTStereoConfig()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--host", default=d.host)
    p.add_argument("--port", type=int, default=d.port,
                   help="0 binds a free port")
    p.add_argument("--buckets", nargs="+", type=_bucket,
                   default=list(d.buckets), metavar="HxW",
                   help="image shapes warmed at startup")
    p.add_argument("--serve_iters", type=int, default=d.serve_iters)
    p.add_argument("--divis_by", type=int, default=d.divis_by)
    p.add_argument("--bucket_multiple", type=int, default=d.bucket_multiple)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a GPU) or 'cpu'")
    p.add_argument("--tiers", nargs="+", default=list(d.tiers),
                   choices=["certified", "fast", "turbo"], metavar="TIER",
                   help="accuracy tiers offered on /predict's 'accuracy' "
                        "field; fast/turbo also need a --cert_manifest "
                        "certifying their EPE delta")
    p.add_argument("--cert_manifest", default=d.cert_manifest,
                   help="certification manifest written by 'python -m "
                        "raftstereo_tpu_torch.cli.certify'")
    w = p.add_mutually_exclusive_group()
    w.add_argument("--restore_ckpt", default=None,
                   help=".pth, save_weights file or flattened JAX .npz")
    w.add_argument("--weights_npz", default=None)
    g = p.add_argument_group("model (defaults: the flagship config)")
    g.add_argument("--corr_levels", type=int, default=m.corr_levels)
    g.add_argument("--corr_radius", type=int, default=m.corr_radius)
    g.add_argument("--n_gru_layers", type=int, default=m.n_gru_layers)
    g.add_argument("--hidden_dims", nargs="+", type=int,
                   default=list(m.hidden_dims))
    g.add_argument("--corr_implementation", default=m.corr_implementation,
                   choices=CORR_IMPLEMENTATIONS,
                   help="correlation backend; 'auto' = the on-demand "
                        "lookup kernel (pallas_alt)")
    g.add_argument("--corr_quant", action="store_true",
                   help="int8-quantized correlation volume, looked up by "
                        "the pallas backend")
    g.add_argument("--gru_backend", default=m.gru_backend,
                   choices=["auto", "fused", "xla"],
                   help="test-mode GRU step: 'auto' = the fused update "
                        "kernel")
    g.add_argument("--mixed_precision", action="store_true",
                   help="bfloat16 compute for encoders and GRUs")
    g.add_argument("--corr_dtype", choices=["float32", "bfloat16"],
                   default=m.corr_dtype,
                   help="storage dtype of the correlation lookup's "
                        "feature maps")
    return p.parse_args(argv)


def _interrupt(signum, frame):
    """SIGTERM ends the serve loop as Ctrl-C does."""
    raise KeyboardInterrupt


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    cfg = RAFTStereoConfig(
        corr_levels=args.corr_levels, corr_radius=args.corr_radius,
        n_gru_layers=args.n_gru_layers, hidden_dims=tuple(args.hidden_dims),
        corr_implementation=args.corr_implementation,
        corr_quant=args.corr_quant, gru_backend=args.gru_backend,
        compute_dtype="bfloat16" if args.mixed_precision else "float32",
        corr_dtype=args.corr_dtype)
    scfg = ServeConfig(host=args.host, port=args.port,
                       divis_by=args.divis_by,
                       bucket_multiple=args.bucket_multiple,
                       buckets=tuple(args.buckets),
                       serve_iters=args.serve_iters, tiers=tuple(args.tiers),
                       cert_manifest=args.cert_manifest)
    model = RAFTStereo(cfg, device=args.device)
    if args.restore_ckpt:
        load_weights_any(args.restore_ckpt, model)
    elif args.weights_npz:
        load_weights_npz(model, args.weights_npz)
    server = build_server(model, scfg, device=args.device)
    previous = signal.signal(signal.SIGTERM, _interrupt)
    line = {"serving": f"http://{args.host}:{server.port}",
            "device": str(server.engine.device),
            "buckets": [list(server.engine.bucket_of(b))
                        for b in scfg.buckets]}
    if scfg.tiers:
        line["tiers"] = {"advertised": server.tiers,
                         "refused": server.tier_reasons}
    print(json.dumps(line), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        signal.signal(signal.SIGTERM, previous)
    return 0


if __name__ == "__main__":
    sys.exit(main())
