"""lfr_tpu_torch.utils."""
