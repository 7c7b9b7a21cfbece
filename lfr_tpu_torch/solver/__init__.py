"""lfr_tpu_torch.solver: the multi-view solve (MatchingFile -> SolutionFile).

Host stages (graph, tracks, partition, packing) are numpy and scipy; the
batched Levenberg-Marquardt solve (``lm``) runs in torch on the device.
"""
