"""Evaluation: the inference runner, tiled inference and the benchmark
validators."""

from .runner import Evaluator  # noqa: F401
from .tiled import plan_tiles, tile_weight, tiled_infer  # noqa: F401
from .validate import (  # noqa: F401
    VALIDATORS,
    validate,
    validate_eth3d,
    validate_kitti,
    validate_middlebury,
    validate_things,
)
