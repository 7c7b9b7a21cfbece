"""lfr_tpu_torch.pipelines."""
