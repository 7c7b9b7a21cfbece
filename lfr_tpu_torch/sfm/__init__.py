"""lfr_tpu_torch.sfm: two-view verification, fixed-pose triangulation and
incremental SfM (bundle adjustment, PnP, the mapper).

Camera models and the mapper's bookkeeping are numpy on the host; the
geometry, the batched RANSAC, the batched DLT + Gauss-Newton, PnP and the
bundle adjustment run in torch on the device.
"""
