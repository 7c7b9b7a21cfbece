"""lfr_tpu_torch.models."""
