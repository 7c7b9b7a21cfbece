"""Import the reference's PANet checkpoints (torch ``checkpoint.pth``).

Port of lfr_tpu/models/torch_import.py.  The reference's state dict
(reference: two-view-refinement/model.py:12-43) becomes a variable tree in
the JAX package's layout, so that ``checkpoint.load_any``,
``panet.fold_bn_variables`` and ``panet.from_jax_variables`` serve both
formats:

  conv weight (O, I, kh, kw)   -> kernel (kh, kw, I, O)
  linear weight (O, I)         -> kernel (I, O)
  batchnorm weight / bias      -> scale / bias; running stats -> batch_stats
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

#: torch nn.Sequential indices of the reference modules (model.py:12-41):
#: backbone convs at 0, 2, 5, 7 (max-pool at 4), refine convs at 0, 3, 6, 9
#: with BatchNorm at 1, 4, 7, 10, the predictor at 0.
_BACKBONE_CONVS = {"conv1_1": 0, "conv1_2": 2, "conv2_1": 5, "conv2_2": 7}
_REFINE_CONVS = {"conv0": 0, "conv1": 3, "conv2": 6, "conv3": 9}
_REFINE_BNS = {"bn0": 1, "bn1": 4, "bn2": 7, "bn3": 10}


def _array(sd: Dict, key: str) -> np.ndarray:
    value = sd[key]
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value, dtype=np.float32)


def _conv(sd: Dict, prefix: str) -> Dict:
    return {"kernel": _array(sd, f"{prefix}.weight").transpose(2, 3, 1, 0),
            "bias": _array(sd, f"{prefix}.bias")}


def variables_from_torch_state_dict(state_dict: Dict) -> Dict:
    """A reference-layout torch state dict -> PANet variables in the JAX
    layout ({"params": ..., "batch_stats": ...})."""
    params: Dict = {"backbone": {}, "refine": {}}
    batch_stats: Dict = {"refine": {}}
    for name, idx in _BACKBONE_CONVS.items():
        params["backbone"][name] = _conv(state_dict, f"backbone.{idx}")
    for name, idx in _REFINE_CONVS.items():
        params["refine"][name] = _conv(state_dict, f"refine_net.{idx}")
    for name, idx in _REFINE_BNS.items():
        prefix = f"refine_net.{idx}"
        params["refine"][name] = {"scale": _array(state_dict, f"{prefix}.weight"),
                                  "bias": _array(state_dict, f"{prefix}.bias")}
        batch_stats["refine"][name] = {"mean": _array(state_dict, f"{prefix}.running_mean"),
                                       "var": _array(state_dict, f"{prefix}.running_var")}
    params["predict"] = {"kernel": _array(state_dict, "predict_net.0.weight").T,
                         "bias": _array(state_dict, "predict_net.0.bias")}
    return {"params": params, "batch_stats": batch_stats}


def load_checkpoint(path: str) -> Dict:
    """Read a torch ``checkpoint.pth`` (its state dict under ``model``, as
    the reference saves it, or bare) with ``weights_only=True`` and convert
    it to the JAX layout."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return variables_from_torch_state_dict(ckpt.get("model", ckpt))
