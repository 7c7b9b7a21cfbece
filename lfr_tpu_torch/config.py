"""Geometry constants and per-method settings, copied from lfr_tpu.config."""

from __future__ import annotations

import dataclasses
from typing import Dict

#: Side length of the square patches fed to the flow CNN.
PATCH_SIZE: int = 33

#: One displacement unit predicted by the CNN corresponds to this many pixels.
DISPLACEMENT_UNIT_PX: float = 16.0

#: The fine refinement samples the flow on a 3x3 grid of +-GRID_OFFSET_PX
#: pixel offsets around each keypoint.
GRID_OFFSET_PX: float = 8.0

#: Default CNN minibatch (matches per chunk).
DEFAULT_BATCH_SIZE: int = 1024

#: Matches are flushed to a ``.part.N`` file every this many pairs.
DUMP_INTERVAL: int = 5000

# Multi-view solver constants (reference: multi-view-refinement/solve.cc).

#: Box bound on refined positions, in displacement units (= +-16 px).
SOLVE_BOUND: float = 1.0

#: Cauchy robust-loss scale for intra-track edges.
CAUCHY_SCALE: float = 0.25

#: Tukey robust-loss scale for inter-track edges.
TUKEY_SCALE: float = 0.0625

#: Integer scale applied to similarity weights before the normalized min-cut.
CUT_WEIGHT_SCALE: float = 100.0

#: Levenberg-Marquardt stopping rules mirroring the Ceres options.
LM_MAX_ITERATIONS: int = 100
LM_FUNCTION_TOLERANCE: float = 1e-4
LM_GRADIENT_TOLERANCE: float = 1e-8
LM_PARAMETER_TOLERANCE: float = 1e-4


@dataclasses.dataclass(frozen=True)
class MethodConfig:
    """Extraction resolution caps and matcher settings for one feature type."""

    name: str
    #: Maximum image edge at feature-extraction octave 0.
    max_edge: int
    #: Maximum sum of image edges at feature-extraction octave 0.
    max_sum_edges: int
    #: Either "similarity" or "ratio".
    matcher: str
    #: Similarity threshold or Lowe's ratio threshold.
    threshold: float


METHODS: Dict[str, MethodConfig] = {
    m.name: m
    for m in [
        MethodConfig("sift", 1600, 3200, "ratio", 0.8),
        MethodConfig("surf", 1600, 3200, "ratio", 0.8),
        MethodConfig("doh", 1600, 3200, "ratio", 0.8),
        MethodConfig("d2-net", 1600, 2800, "similarity", 0.8),
        MethodConfig("keynet", 1600, 3200, "ratio", 0.9),
        MethodConfig("r2d2", 1600, 3200, "similarity", 0.9),
        MethodConfig("superpoint", 1600, 2800, "similarity", 0.755),
    ]
}


def get_method(name: str) -> MethodConfig:
    try:
        return METHODS[name]
    except KeyError:
        raise ValueError(
            f"Method {name!r} is unknown; known methods: {sorted(METHODS)}. "
            "Register a MethodConfig in lfr_tpu_torch.config.METHODS."
        ) from None


def downscale_factor(height: int, width: int, max_edge: int, max_sum_edges: int) -> float:
    """Image downscale factor used before matching and refinement:
    max(1, max edge / max_edge, sum of edges / max_sum_edges)."""
    return max(1.0, max(height, width) / max_edge, (height + width) / max_sum_edges)
