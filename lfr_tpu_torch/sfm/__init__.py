"""lfr_tpu_torch.sfm: two-view verification and fixed-pose triangulation.

Camera models are numpy on the host; the geometry, the batched RANSAC and
the batched DLT + Gauss-Newton run in torch on the device.
"""
