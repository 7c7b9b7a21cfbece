"""Patch-alignment flow network (PANet), BN-folded inference form, in PyTorch.

Port of lfr_tpu/models/panet.py with ``folded=True``: a VGG backbone
(conv1_1..conv2_2 with a 3x3/2 max-pool, 33x33 -> 17x17x128), per-position
L2 normalisation, the 289x289 correlation volume (``ops.correlation``, the
CUDA kernels on the card), a refine head of four unpadded 5x5 convs
289->128->128->64->64 with the eval-mode BatchNorm folded into them, and
Linear(64 -> 2).  Every conv is :class:`FoldedConv`, which rounds once, as
the JAX ``_FoldedConv`` does.

Public functions keep the JAX layouts: patches (B, 33, 33, 3) NHWC, feature
maps (B, 17, 17, 128), flows (B, 2).  Inside, the CNN runs on NCHW tensors in
``channels_last`` memory, so an NHWC tensor is a view of its NCHW form and
the correlation volume (B, 289 ref, 289 tgt) is the head's input (B, 289 tgt
channels, 17, 17 ref positions) without a copy.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.correlation import corr_views

#: ImageNet normalisation.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

PATCH = 33
FMAP = PATCH // 2 + 1  # 17


def l2_normalize(x: torch.Tensor, dim: int, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), the norm taken in f32, result in x's type."""
    norm = torch.linalg.vector_norm(x.float(), dim=dim, keepdim=True)
    return (x / norm.clamp_min(eps)).to(x.dtype)


#: The conv layers of the main path as the refiner runs them: (name, in
#: channels, out channels, input size, kernel, padding).  The backbone runs
#: at the coarse patch size (33) and, in the fine pass's crop mode, at 65.
MAIN_PATH_CONVS = (
    ("conv1_1 coarse", 3, 64, 33, 3, 1),
    ("conv1_2 coarse", 64, 64, 33, 3, 1),
    ("conv2_1 coarse", 64, 128, 17, 3, 1),
    ("conv2_2 coarse", 128, 128, 17, 3, 1),
    ("conv1_1 crop", 3, 64, 65, 3, 1),
    ("conv1_2 crop", 64, 64, 65, 3, 1),
    ("conv2_1 crop", 64, 128, 33, 3, 1),
    ("conv2_2 crop", 128, 128, 33, 3, 1),
    ("head conv0", 289, 128, 17, 5, 0),
    ("head conv1", 128, 128, 13, 5, 0),
    ("head conv2", 128, 64, 9, 5, 0),
    ("head conv3", 64, 64, 5, 5, 0),
)


def pad_channels(x: torch.Tensor, multiple: int = 8) -> torch.Tensor:
    """(N, C, H, W) -> (N, C', H, W) channels_last with C' the next multiple
    of ``multiple`` and the new channels zero."""
    extra = -x.shape[1] % multiple
    return F.pad(x.permute(0, 2, 3, 1), (0, extra)).permute(0, 3, 1, 2)


class FoldedConv(nn.Module):
    """Conv, f32 bias, ReLU, rounded once: the JAX ``_FoldedConv``.

    In the input's type t, the result is t(max(conv_f32(x, w_t) + bias, 0)),
    with the conv of t-typed operands summed in f32.  On the card a bf16
    conv is cuDNN's fused conv + f32 bias + ReLU
    (``torch.cudnn_convolution_relu``), which rounds once in its epilogue;
    where the input channels are no multiple of 8 (conv1_1's 3, head conv0's
    289) zero channels pad input and weight first, which changes no sum:
    without them cuDNN has no engine for conv1_1 at the crop size and takes
    1.5 s on head conv0.  scripts/probe_torch_conv_epilogue.py chose this
    for each of the main path's conv shapes (PERF.md, Findings).  A shape
    cuDNN refuses raises.  Elsewhere (the CPU, f32) the conv runs on the
    operands widened to f32 and ``torch.add`` of the f32 bias writes t
    directly, so the only rounding is that store; ReLU commutes with it."""

    def __init__(self, cin: int, cout: int, kernel: int, padding: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        if x.is_cuda and x.dtype == torch.bfloat16:
            if x.shape[1] % 8:
                x, w = pad_channels(x), pad_channels(w)
            p = self.padding
            w = w.contiguous(memory_format=torch.channels_last)
            return torch.cudnn_convolution_relu(x, w, self.bias, (1, 1), (p, p), (1, 1), 1)
        y = F.conv2d(x.float(), w.float(), padding=self.padding)
        out = torch.empty_like(y, dtype=x.dtype)
        return torch.add(y, self.bias.view(1, -1, 1, 1), out=out).relu_()


class Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1_1 = FoldedConv(3, 64, 3, 1)
        self.conv1_2 = FoldedConv(64, 64, 3, 1)
        self.conv2_1 = FoldedConv(64, 128, 3, 1)
        self.conv2_2 = FoldedConv(128, 128, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1_2(self.conv1_1(x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf
        return self.conv2_2(self.conv2_1(x))


class RefineHead(nn.Module):
    """Four unpadded 5x5 folded convs, 17x17 -> 1x1."""

    def __init__(self):
        super().__init__()
        chans = [FMAP * FMAP, 128, 128, 64, 64]
        for i in range(4):
            self.add_module(f"conv{i}", FoldedConv(chans[i], chans[i + 1], 5, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = getattr(self, f"conv{i}")(x)
        return x


class PANet(nn.Module):
    """Two-view patch-alignment flow network (folded inference form).

    ``compute_dtype`` is the type of the convolutions (bf16 on the card).
    On a CUDA device the correlation runs in the bf16 CUDA kernels, so the
    feature maps are cast to bf16 before it whatever ``compute_dtype`` is."""

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.backbone = Backbone()
        self.refine = RefineHead()
        self.predict = nn.Linear(64, 2)

    def features(self, patches: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H//2+1, W//2+1, 128), L2-normalised over channels."""
        x = patches.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        f = self.backbone(x).permute(0, 2, 3, 1).contiguous()
        return l2_normalize(f, dim=-1)

    def _corr_views(self, f_ref: torch.Tensor, f_tgt: torch.Tensor, sym: bool):
        b = f_ref.shape[0]
        fr = f_ref.reshape(b, FMAP * FMAP, -1)
        ft = f_tgt.reshape(b, FMAP * FMAP, -1)
        if fr.is_cuda:
            fr = fr.to(torch.bfloat16).contiguous()
            ft = ft.to(torch.bfloat16).contiguous()
        return corr_views(fr, ft, sym=sym)

    def _head(self, corr: torch.Tensor) -> torch.Tensor:
        """corr: (B, 289, 289) normalised volume, rows = the source positions
        of the head's 17x17 grid, columns = its 289 channels."""
        b = corr.shape[0]
        x = corr.to(self.compute_dtype).view(b, FMAP, FMAP, FMAP * FMAP)
        x = self.refine(x.permute(0, 3, 1, 2))
        return self.predict(x.reshape(b, -1).float())

    def flow_from_features(self, f_ref: torch.Tensor, f_tgt: torch.Tensor) -> torch.Tensor:
        """Correlation + head over (B, 17, 17, C) normalised feature maps -> (B, 2)."""
        return self._head(self._corr_views(f_ref, f_tgt, sym=False))

    def forward(self, reference: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Displacement of target w.r.t. reference: (B, 33, 33, 3) x2 -> (B, 2)."""
        b = reference.shape[0]
        feats = self.features(torch.cat([reference, target], dim=0))
        return self.flow_from_features(feats[:b], feats[b:])

    def forward_sym(
        self, reference: torch.Tensor, target: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both directions from one correlation launch -> ((B, 2), (B, 2))."""
        b = reference.shape[0]
        feats = self.features(torch.cat([reference, target], dim=0))
        c12, c21 = self._corr_views(feats[:b], feats[b:], sym=True)
        disp = self._head(torch.cat([c12, c21], dim=0))
        return disp[:b], disp[b:]


def fold_normalize_variables(variables: Dict) -> Dict:
    """Fold the ImageNet input normalisation into conv1_1 (numpy tree in the
    JAX layout); the returned tree expects raw [0, 255] patches."""
    params = dict(variables["params"])
    bb = dict(params["backbone"])
    conv = dict(bb["conv1_1"])
    kernel = np.asarray(conv["kernel"], np.float32)  # (3, 3, 3, 64) HWIO
    bias = np.asarray(conv["bias"], np.float32)
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    scale = np.float32(1.0) / (np.float32(255.0) * std)
    shift = mean / std
    conv["kernel"] = kernel * scale[None, None, :, None]
    conv["bias"] = bias - np.einsum("hwco,c->o", kernel, shift)
    bb["conv1_1"] = conv
    params["backbone"] = bb
    out = dict(variables)
    out["params"] = params
    return out


def fold_bn_variables(variables: Dict, eps: float = 1e-5) -> Dict:
    """Fold the eval-mode BatchNorm of the refine head into its convs (numpy
    tree in the JAX layout); ``batch_stats`` is dropped."""
    params = variables["params"]
    refine = params["refine"]
    stats = variables["batch_stats"]["refine"]
    folded = {}
    for i in range(4):
        kernel = np.asarray(refine[f"conv{i}"]["kernel"], np.float32)
        bias = np.asarray(refine[f"conv{i}"]["bias"], np.float32)
        bn = refine[f"bn{i}"]
        mean = np.asarray(stats[f"bn{i}"]["mean"], np.float32)
        var = np.asarray(stats[f"bn{i}"]["var"], np.float32)
        s = np.asarray(bn["scale"], np.float32) / np.sqrt(var + np.float32(eps))
        folded[f"conv{i}"] = {
            "kernel": kernel * s,
            "bias": (bias - mean) * s + np.asarray(bn["bias"], np.float32),
        }
    new_params = dict(params)
    new_params["refine"] = folded
    return {"params": new_params}


def from_jax_variables(variables: Dict) -> Dict[str, torch.Tensor]:
    """Folded JAX variable tree -> :class:`PANet` state dict.

    Conv kernels go HWIO -> OIHW, the Dense kernel (in, out) -> (out, in)."""
    params = variables["params"]
    if "batch_stats" in variables or "bn0" in params["refine"]:
        raise ValueError("fold the BatchNorm first (fold_bn_variables)")
    sd = {}
    convs = [("backbone", n) for n in ("conv1_1", "conv1_2", "conv2_1", "conv2_2")]
    convs += [("refine", f"conv{i}") for i in range(4)]
    for group, name in convs:
        leaf = params[group][name]
        kernel = np.asarray(leaf["kernel"], np.float32)
        sd[f"{group}.{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))
        )
        sd[f"{group}.{name}.bias"] = torch.from_numpy(np.asarray(leaf["bias"], np.float32))
    pred = params["predict"]
    sd["predict.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(pred["kernel"], np.float32).T)
    )
    sd["predict.bias"] = torch.from_numpy(np.asarray(pred["bias"], np.float32))
    return sd
