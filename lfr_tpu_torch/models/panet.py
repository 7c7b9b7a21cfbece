"""Patch-alignment flow network (PANet) in PyTorch, folded and unfolded.

Port of lfr_tpu/models/panet.py: a VGG backbone (conv1_1..conv2_2 with a
3x3/2 max-pool, 33x33 -> 17x17x128), per-position L2 normalisation, the
289x289 correlation volume, a refine head of four unpadded 5x5 convs
289->128->128->64->64, and Linear(64 -> 2).

``PANet(folded=True)`` is the inference form: the eval-mode BatchNorm is
folded into the head's convs and every conv is :class:`FoldedConv`, which
rounds once, as the JAX ``_FoldedConv`` does.  ``PANet(folded=False)`` is
the trainable form (JAX's ``Backbone(fast=False)`` and
``RefineHead(folded=False)``): :class:`Conv` layers as flax's
``nn.Conv(dtype=...)`` and, in the head, :class:`BatchNorm` in f32 with
flax's statistics.  In train mode the correlation is the plain
differentiable version (``ops.correlation.correlation_reference``), as the
JAX package's training takes its jnp path (lfr_tpu/models/panet.py:200); in
eval mode it is ``ops.correlation.corr_views``, the CUDA kernels on the card.

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

from ..ops.correlation import corr_views, correlation_reference

#: ImageNet normalisation.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

PATCH = 33
FMAP = PATCH // 2 + 1  # 17


def normalize_patches(patches: torch.Tensor) -> torch.Tensor:
    """[0, 255] NHWC patches -> ImageNet-normalised f32 (the unfolded model's
    input; the folded one takes raw patches, see fold_normalize_variables)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=patches.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=patches.device)
    return (patches.float() / 255.0 - mean) / std


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


class Conv(nn.Conv2d):
    """flax ``nn.Conv(dtype=t)`` with t the input's type: the f32 parameters
    are cast to t, the conv is summed in f32 and written in t, then the bias
    is added in t (two roundings where t is bf16).  Gradients reach the f32
    parameters through the casts."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding)
        return y + self.bias.to(x.dtype).view(1, -1, 1, 1)


#: flax's BatchNorm momentum: running = 0.9 * running + 0.1 * batch.
BN_MOMENTUM = 0.9


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=f32)`` over N, H
    and W of an f32 input.  Train mode normalises with the biased batch
    statistics, the variance as flax's E[x^2] - E[x]^2 clipped at 0, and
    updates the running statistics with those same values (torch's own
    update would use the unbiased variance and the other momentum
    convention); eval mode uses the running statistics."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
        if train:
            mean = x.mean((0, 2, 3))
            var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


class Backbone(nn.Module):
    """conv1_1, conv1_2, 3x3/2 max-pool, conv2_1, conv2_2, each conv with a
    ReLU: :class:`FoldedConv` when ``folded``, else :class:`Conv` + ReLU."""

    def __init__(self, folded: bool = True):
        super().__init__()
        self.folded = folded
        for name, cin, cout in (("conv1_1", 3, 64), ("conv1_2", 64, 64),
                                ("conv2_1", 64, 128), ("conv2_2", 128, 128)):
            conv = FoldedConv(cin, cout, 3, 1) if folded else Conv(cin, cout, 3, padding=1)
            self.add_module(name, conv)

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = getattr(self, name)(x)
        return y if self.folded else F.relu(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._conv("conv1_2", self._conv("conv1_1", x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf
        return self._conv("conv2_2", self._conv("conv2_1", x))


class RefineHead(nn.Module):
    """Four unpadded 5x5 stages, 17x17 -> 1x1: folded convs, or conv ->
    BatchNorm in f32 -> ReLU -> the compute type (lfr_tpu/models/panet.py:138-149)."""

    def __init__(self, folded: bool = True):
        super().__init__()
        self.folded = folded
        chans = [FMAP * FMAP, 128, 128, 64, 64]
        for i in range(4):
            if folded:
                self.add_module(f"conv{i}", FoldedConv(chans[i], chans[i + 1], 5, 0))
            else:
                self.add_module(f"conv{i}", Conv(chans[i], chans[i + 1], 5))
                self.add_module(f"bn{i}", BatchNorm(chans[i + 1]))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.folded and train:
            raise ValueError("the folded head is inference-only")
        for i in range(4):
            y = getattr(self, f"conv{i}")(x)
            if not self.folded:
                y = F.relu(getattr(self, f"bn{i}")(y, train)).to(x.dtype)
            x = y
        return x


class PANet(nn.Module):
    """Two-view patch-alignment flow network.

    ``compute_dtype`` is the type of the convolutions (bf16 on the card).
    ``folded`` picks the inference form (weights from fold_bn_variables)
    or the trainable one.  In eval mode on a CUDA device the correlation
    runs in the bf16 CUDA kernels, so the feature maps are cast to bf16
    before it whatever ``compute_dtype`` is."""

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16, folded: bool = True):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.folded = folded
        self.backbone = Backbone(folded)
        self.refine = RefineHead(folded)
        self.predict = nn.Linear(64, 2)

    def _check_mode(self, train: bool) -> None:
        if train and self.folded:
            raise ValueError("the folded PANet is inference-only")

    def features(self, patches: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H//2+1, W//2+1, 128), L2-normalised over channels."""
        x = patches.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        f = self.backbone(x).permute(0, 2, 3, 1).contiguous()
        return l2_normalize(f, dim=-1)

    def _corr_views(self, f_ref: torch.Tensor, f_tgt: torch.Tensor, sym: bool,
                    train: bool = False):
        b = f_ref.shape[0]
        fr = f_ref.reshape(b, FMAP * FMAP, -1)
        ft = f_tgt.reshape(b, FMAP * FMAP, -1)
        if train:
            return correlation_reference(fr, ft, sym=sym)
        if fr.is_cuda:
            fr = fr.to(torch.bfloat16).contiguous()
            ft = ft.to(torch.bfloat16).contiguous()
        return corr_views(fr, ft, sym=sym)

    def _head(self, corr: torch.Tensor, train: bool = False) -> torch.Tensor:
        """corr: (B, 289, 289) normalised volume, rows = the source positions
        of the head's 17x17 grid, columns = its 289 channels."""
        b = corr.shape[0]
        x = corr.to(self.compute_dtype).view(b, FMAP, FMAP, FMAP * FMAP)
        x = self.refine(x.permute(0, 3, 1, 2), train)
        return self.predict(x.reshape(b, -1).float())

    def flow_from_features(
        self, f_ref: torch.Tensor, f_tgt: torch.Tensor, train: bool = False
    ) -> torch.Tensor:
        """Correlation + head over (B, 17, 17, C) normalised feature maps -> (B, 2)."""
        return self._head(self._corr_views(f_ref, f_tgt, sym=False, train=train), train)

    def forward(
        self, reference: torch.Tensor, target: torch.Tensor, train: bool = False
    ) -> torch.Tensor:
        """Displacement of target w.r.t. reference: (B, 33, 33, 3) x2 -> (B, 2)."""
        self._check_mode(train)
        b = reference.shape[0]
        feats = self.features(torch.cat([reference, target], dim=0))
        return self.flow_from_features(feats[:b], feats[b:], train)

    def forward_sym(
        self, reference: torch.Tensor, target: torch.Tensor, train: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both directions from one correlation volume -> ((B, 2), (B, 2)).
        The head sees both at once, so train-mode batch statistics cover 2B
        rows (lfr_tpu/models/panet.py:234-235)."""
        self._check_mode(train)
        b = reference.shape[0]
        feats = self.features(torch.cat([reference, target], dim=0))
        c12, c21 = self._corr_views(feats[:b], feats[b:], sym=True, train=train)
        disp = self._head(torch.cat([c12, c21], dim=0), train)
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


_BACKBONE = ("conv1_1", "conv1_2", "conv2_1", "conv2_2")
_HEAD = tuple(f"conv{i}" for i in range(4))
_BNS = tuple(f"bn{i}" for i in range(4))


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def from_jax_variables(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX variable tree -> :class:`PANet` state dict: a folded tree for
    ``PANet(folded=True)``, an unfolded one (with ``batch_stats``) for
    ``PANet(folded=False)``; a strict ``load_state_dict`` refuses the other.

    Conv kernels go HWIO -> OIHW, the Dense kernel (in, out) -> (out, in),
    BatchNorm scale / bias -> weight / bias and mean / var -> running_mean /
    running_var."""
    params = variables["params"]
    unfolded = "bn0" in params["refine"]
    if unfolded != ("batch_stats" in variables):
        raise ValueError("an unfolded tree has batch_stats and a folded one has none")
    sd = {}
    for group, names in (("backbone", _BACKBONE), ("refine", _HEAD)):
        for name in names:
            leaf = params[group][name]
            sd[f"{group}.{name}.weight"] = _tensor(np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1))
            sd[f"{group}.{name}.bias"] = _tensor(leaf["bias"])
    if unfolded:
        stats = variables["batch_stats"]["refine"]
        for name in _BNS:
            sd[f"refine.{name}.weight"] = _tensor(params["refine"][name]["scale"])
            sd[f"refine.{name}.bias"] = _tensor(params["refine"][name]["bias"])
            sd[f"refine.{name}.running_mean"] = _tensor(stats[name]["mean"])
            sd[f"refine.{name}.running_var"] = _tensor(stats[name]["var"])
    pred = params["predict"]
    sd["predict.weight"] = _tensor(np.asarray(pred["kernel"]).T)
    sd["predict.bias"] = _tensor(pred["bias"])
    return sd


def to_jax_variables(model: "PANet") -> Dict:
    """An unfolded :class:`PANet`'s state -> the JAX package's nested numpy
    tree (f32; conv kernels HWIO, the Dense kernel (in, out)), in the key
    order of the JAX package's training snapshots: {"params", "batch_stats"}
    at the top, every level below sorted (as ``jax.tree_util`` rebuilds
    dicts), so that ``checkpoint.dumps`` writes the bytes flax writes."""
    if model.folded:
        raise ValueError("to_jax_variables takes the unfolded PANet")
    sd = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}

    def conv(prefix):
        return {"bias": sd[f"{prefix}.bias"],
                "kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].transpose(2, 3, 1, 0))}

    refine = {name: {"bias": sd[f"refine.{name}.bias"], "scale": sd[f"refine.{name}.weight"]}
              for name in _BNS}
    refine.update({name: conv(f"refine.{name}") for name in _HEAD})
    params = {
        "backbone": {name: conv(f"backbone.{name}") for name in _BACKBONE},
        "predict": {"bias": sd["predict.bias"],
                    "kernel": np.ascontiguousarray(sd["predict.weight"].T)},
        "refine": dict(sorted(refine.items())),
    }
    stats = {name: {"mean": sd[f"refine.{name}.running_mean"],
                    "var": sd[f"refine.{name}.running_var"]} for name in _BNS}
    return {"params": params, "batch_stats": {"refine": stats}}


#: flax's lecun_normal: a normal truncated at two standard deviations, its
#: scale corrected so that the truncated draw has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(shape, gen: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] by the inverse CDF of uniform f64
    draws, as ``jax.random.truncated_normal`` draws it.  Only ``torch.rand``
    touches the generator, so a seed gives the same values on any torch
    version (``nn.init.trunc_normal_`` changed its sampler between
    versions)."""
    lo, hi = torch.special.ndtr(torch.tensor([-2.0, 2.0], dtype=torch.float64))
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    return torch.special.ndtri(lo + u * (hi - lo)).clamp_(-2.0, 2.0).float()


def init_variables(seed: int = 0) -> Dict:
    """Fresh unfolded PANet variables in the JAX layout, drawn from a CPU
    ``torch.Generator`` seeded with ``seed``, with the distributions of
    flax's initialisers: conv and Dense kernels lecun_normal (fan_in =
    kh * kw * in), biases 0, BatchNorm scale 1, bias 0, mean 0, var 1.  The
    draws are not JAX's (``jax.random`` cannot be reproduced in torch)."""
    gen = torch.Generator().manual_seed(int(seed))
    model = PANet(torch.float32, folded=False)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                std = (1.0 / module.weight[0].numel()) ** 0.5 / _TRUNC_STD
                module.weight.copy_(_truncated_normal(module.weight.shape, gen) * std)
                module.bias.zero_()
            elif isinstance(module, BatchNorm):
                module.reset_parameters()
    return to_jax_variables(model)
