"""How far the bf16 fused encoders on the card lie from the CPU's, beside
how far the CPU's plain bf16 encoders lie from the fused ones: the
readings behind ``chip_smoke.py``'s ``FUSED_TRUNK_TOL``,
``FUSED_FMAP_CARD_ULPS`` and ``FUSED_ENC_CARD_ULPS``.

    python3 scripts/fused_enc_readings.py [--seeds 3]

Builds the flagship ``RAFTStereoConfig(fused_encoder=True,
compute_dtype="bfloat16", corr_dtype="bfloat16")`` at ``n_downsample`` 2
and 3 with seeded weights on the card and a copy on the CPU.  For each
seeded 64x96 pair (the smoke's card-vs-CPU shape) it prints, per
encoder, the fused trunk (stem + layer1 + layer2, what the encoder
kernels compute) of the card and of the CPU's plain encoders
(``fused_stem=False``) against the CPU's fused trunk
(``chip_smoke.fused_trunk_readings``), then the same for the whole
encoders' outputs (fnet's ``fmap``, cnet's ``net`` and ``inp`` heads per
level): the largest difference in bf16 ulps of max(1, |cpu|) and the
share of elements equal.  Needs the card.
"""

from __future__ import annotations

import argparse
import copy
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig  # noqa: E402


def _reading(got, cpu) -> str:
    return (f"{cs.ulps(got, cpu):.3f} ulps "
            f"{float((got == cpu).float().mean()):.4f} equal")


def _plain(enc, x):
    """``enc``'s output with the plain bf16 stem, layer1 and layer2."""
    fused, enc.fused_stem = enc.fused_stem, False
    try:
        return enc(x)
    finally:
        enc.fused_stem = fused


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(cs.CARD)
    for ds in (2, 3):
        cfg = RAFTStereoConfig(fused_encoder=True, compute_dtype="bfloat16",
                               corr_dtype="bfloat16", n_downsample=ds)
        model = RAFTStereo(cfg, device="cuda", seed=0).eval()
        cpu = copy.deepcopy(model).to("cpu")
        for seed in range(args.seeds):
            rng = np.random.default_rng(seed)
            i1, i2 = (torch.from_numpy(rng.uniform(0, 255, (1, 64, 96, 3))
                                       .astype(np.float32)) for _ in range(2))
            tag = f"ds{ds} seed{seed}"
            for name, (u, eq, pu, peq) in cs.fused_trunk_readings(
                    model, cpu, i1, i2, torch).items():
                print(f"{tag} trunk {name}: card {u:.3f} ulps {eq:.4f} equal"
                      f" | plain {pu:.3f} ulps {peq:.4f} equal")
            a, b = cs._norm_bf16(i1, torch), cs._norm_bf16(i2, torch)
            x = torch.cat([a, b]).contiguous()
            a = a.contiguous()
            with torch.inference_mode():
                fmap = (model.fnet(x.cuda()).cpu(), cpu.fnet(x),
                        _plain(cpu.fnet, x))
                ctx = (model.cnet(a.cuda()), cpu.cnet(a), _plain(cpu.cnet, a))
            print(f"{tag} whole fmap: card {_reading(fmap[0], fmap[1])} | "
                  f"plain {_reading(fmap[2], fmap[1])}")
            for lvl in range(len(ctx[1])):
                for k in range(2):
                    g, c, q = (ctx[i][lvl][k].cpu() for i in range(3))
                    print(f"{tag} whole cnet{lvl}.{k}: card {_reading(g, c)}"
                          f" | plain {_reading(q, c)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
