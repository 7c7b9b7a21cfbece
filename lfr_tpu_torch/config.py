"""Geometry constants of the refinement path, copied from lfr_tpu.config."""

#: Side length of the square patches fed to the flow CNN.
PATCH_SIZE: int = 33

#: One displacement unit predicted by the CNN corresponds to this many pixels.
DISPLACEMENT_UNIT_PX: float = 16.0

#: The fine refinement samples the flow on a 3x3 grid of +-GRID_OFFSET_PX
#: pixel offsets around each keypoint.
GRID_OFFSET_PX: float = 8.0

#: Default CNN minibatch (matches per chunk).
DEFAULT_BATCH_SIZE: int = 1024
