#!/usr/bin/env python3
"""The train phase's loss gate on the CPU: chip_smoke.py's training run
(train(num_steps=256, batch_size=64, corpus="synthetic", seed=0) in bf16)
and its learning-rate-0 control, run by the port on the CPU.  Prints one
JSON line per run: seconds, the mean loss of the first and of the last 16
steps and their ratio, which sets chip_smoke.py's TRAIN_LOSS_DROP, and
the SHA-256 of the initial variables for seed 0, which chip_smoke.py's
train phase prints on the card (the same seed must give the same weights).

    python3 scripts/train_torch_loss_drop.py [--threads 4]

About three minutes a run on four CPU threads.
"""

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lfr_tpu_torch.models import checkpoint, panet, train  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--threads", type=int, default=4)
    args = parser.parse_args()
    torch.set_num_threads(args.threads)
    init = checkpoint.dumps(panet.init_variables(0))
    print(json.dumps({"init_sha256": hashlib.sha256(init).hexdigest()}), flush=True)
    for lr in (1e-3, 0.0):
        timing = {}
        t0 = time.perf_counter()
        train.train(num_steps=256, batch_size=64, corpus="synthetic", seed=0, learning_rate=lr,
                    compute_dtype=torch.bfloat16, device="cpu", log_every=64, timing=timing)
        losses = np.asarray(timing["losses"])
        print(json.dumps({"learning_rate": lr, "seconds": time.perf_counter() - t0,
                          "loss_first16": float(losses[:16].mean()),
                          "loss_last16": float(losses[-16:].mean()),
                          "loss_drop": float(losses[:16].mean() / losses[-16:].mean()),
                          "torch": torch.__version__, "threads": args.threads}), flush=True)


if __name__ == "__main__":
    main()
