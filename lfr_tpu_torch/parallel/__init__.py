"""lfr_tpu_torch.parallel: several processes, one device each, on
``torch.distributed`` (port of lfr_tpu/parallel).

- ``distributed``: the process group (``initialize`` / ``shutdown``) and the
  backend rule (NCCL where each rank owns its card, gloo on the CPU or for
  ranks that share one);
- ``mesh``: the ("dp", "mp") mesh over the ranks, its collectives, and the
  tensor-parallel placement of PANet's state;
- ``sharded``: the sharded train step, component solve and bundle
  adjustment;
- ``multiprocess``: the launcher of worker processes and the rank spawner.
"""
