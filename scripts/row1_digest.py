"""SHA-256 digests of row 1's outputs (``alt_corr``, the on-demand lookup)
of one checkout of the PyTorch port, on the card, on the inputs of
``tests/test_torch_port_cuda.py::row1_digest_cases``:

    python3 scripts/row1_digest.py ROOT

ROOT is a checkout (or ``git archive``) holding ``raftstereo_tpu_torch``;
its kernels build under ROOT, the cases come from this script's checkout.
Prints one line per tree: ``ROW1_DIGESTS = {...}``, the dict that test
holds a tree's row 1 to; equal lines from two trees mean bitwise equal
lookups.
"""

from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import torch

    from raftstereo_tpu_torch.ops import _build, cuda_alt

    if not cuda_alt.__file__.startswith(root):
        raise RuntimeError(f"{cuda_alt.__file__} is not under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    _build.build_all()
    spec = importlib.util.spec_from_file_location(
        "card_tests", os.path.join(HERE, "tests", "test_torch_port_cuda.py"))
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
    got = {cid: tests.sha256(fn())
           for cid, fn in tests.row1_digest_cases(torch.device("cuda"))}
    print(f"{root} [{torch.cuda.get_device_name(0)}] ROW1_DIGESTS = {got}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
