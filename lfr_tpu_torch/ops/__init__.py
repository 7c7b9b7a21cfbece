"""lfr_tpu_torch.ops."""
