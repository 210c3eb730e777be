"""Fully convolutional grasp Q-networks, the port's counterpart of the JAX
package's learn/networks.py (Flax linen there).

Capability parity with the reference's Modules.py:
  * perception module (:159-194): 4-ch RGB-D input -> 64 feature conv, two
    2x2 max-pools, ResNet basic blocks 64 -> 128 -> 256 -> 512, so a
    200x200 input becomes a 50x50x512 feature map;
  * single-rotation head (:196-241) -> ``resnet()``, and the softmax
    ``policy_resnet()`` (:300-308);
  * multidiscrete head (:243-298): 512 -> 256 -> 128 -> 2x bilinear
    upsample -> 64 -> 2x upsample -> 1x1 conv -> 6 rotation channels, a
    dense (H, W) x 6 grasp map whose flat argmax is the action (flat =
    rot * H*W + y * W + x, Grasping_Agent_multidiscrete.py:254,381-386).

The modules keep the JAX package's public layout and Flax's names:
  * input (B, H, W, C), output (B, rotations, H, W) in float32; inside,
    NCHW (the NHWC input permuted, which is channels-last in memory);
  * submodules ``perception.stem``, ``perception.stem_bn``,
    ``perception.block1.conv1`` ... ``grasping.head``, so that carrying a
    Flax parameter tree across is a rename (carry.agent_from_arrays);
  * Flax's layer defaults: ``SAME`` padding, only the 1x1 ``head`` with a
    bias, 2x2 max-pools with stride 2 and ``VALID`` padding, lecun-normal
    (truncated) conv kernels, and Flax's BatchNorm (``BatchNorm`` below);
  * ``dtype="bfloat16"`` keeps float32 parameters and runs the forward
    under bfloat16 autocast, as Flax's ``dtype``/``param_dtype`` split does;
    BatchNorm's statistics are taken in float32 either way;
  * ``train`` is an argument of every call, as in Flax; a call with
    ``train=True`` updates the BatchNorm running statistics in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(dtype) -> torch.dtype:
    return DTYPES[dtype] if isinstance(dtype, str) else dtype


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` over the channels of an NCHW tensor.

    ``torch.nn.BatchNorm2d`` updates its running variance with the unbiased
    batch variance; Flax normalises with the biased one,
    ``max(E[x^2] - E[x]^2, 0)`` taken in float32, and keeps those same
    statistics: ``ra = momentum * ra + (1 - momentum) * batch``
    (flax linen/normalization.py). The output is
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in the input's
    dtype (the statistics in float32 at least). Parameters
    ``weight``/``bias`` are Flax's ``scale``/``bias``, buffers
    ``running_mean``/``running_var`` its ``mean``/``var``."""

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def batch_moments(self, xf: torch.Tensor):
        """The training-mode moments: the per-channel mean and mean of
        squares over the batch and the pixels."""
        return xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            mean, msq = self.batch_moments(xf)
            var = (msq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


def conv(cin: int, cout: int, kernel: int, bias: bool = False) -> nn.Conv2d:
    """Flax's ``nn.Conv`` (stride 1, ``padding="SAME"``) for an odd
    ``kernel``: (kernel - 1) / 2 of padding on each side."""
    return nn.Conv2d(cin, cout, kernel, padding=(kernel - 1) // 2, bias=bias)


class BasicBlock(nn.Module):
    """ResNet-v1 basic block (3x3 + 3x3, identity or 1x1-projected skip),
    the capability of Modules.py:92-143 (every caller's stride is 1)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = conv(cin, features, 3)
        self.bn1 = BatchNorm(features)
        self.conv2 = conv(features, features, 3)
        self.bn2 = BatchNorm(features)
        if cin != features:
            self.proj = conv(cin, features, 1)
            self.bn_proj = BatchNorm(features)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        if self.proj is not None:
            x = self.bn_proj(self.proj(x), train)
        return F.relu(y + x)


def _pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


class PerceptionModule(nn.Module):
    """C-channel RGB-D -> 512-channel feature map at 1/4 resolution
    (Modules.py:159-194): conv(C->64) + pool, blocks 64->128 (pool)
    ->256->512."""

    def __init__(self, in_channels: int = 4,
                 widths: tuple = (64, 128, 256, 512)):
        super().__init__()
        w = widths
        self.stem = conv(in_channels, w[0], 3)
        self.stem_bn = BatchNorm(w[0])
        self.block1 = BasicBlock(w[0], w[1])
        self.block2 = BasicBlock(w[1], w[2])
        self.block3 = BasicBlock(w[2], w[3])

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = _pool(F.relu(self.stem_bn(self.stem(x), train)))
        x = _pool(self.block1(x, train))
        return self.block3(self.block2(x, train), train)


def _resize2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of an NCHW tensor: ``jax.image.resize(...,
    "bilinear")`` at twice the size, half-pixel centres, edges clamped."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class GraspingHead(nn.Module):
    """512 -> 256 -> 128 -> up2x -> 64 -> up2x -> 1x1 conv -> ``out``
    channels (Modules.py:243-298 with out=6, :196-241 with out=1)."""

    def __init__(self, out: int = 6, cin: int = 512):
        super().__init__()
        self.block1 = BasicBlock(cin, 256)
        self.block2 = BasicBlock(256, 128)
        self.block3 = BasicBlock(128, 64)
        self.head = conv(64, out, 1, bias=True)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = _resize2x(self.block2(self.block1(x, train), train))
        x = _resize2x(self.block3(x, train))
        return self.head(x)


class MultidiscreteResnet(nn.Module):
    """Dense per-pixel-per-rotation grasp-Q network.

    ``net(x (B, H, W, C), train)`` -> logits (B, rotations, H, W) in f32
    (the input cast to the parameters' dtype, as Flax casts it), so
    ``logits.reshape(B, -1)`` is the flat action layout
    rot * H*W + y * W + x (Grasping_Agent_multidiscrete.py:381-386).
    ``sigmoid=True`` applies the reference's in-network sigmoid
    (Modules.py:284); the agent pairs logits with BCE-with-logits."""

    def __init__(self, rotations: int = 6, dtype="bfloat16",
                 sigmoid: bool = False, in_channels: int = 4):
        super().__init__()
        self.rotations, self.sigmoid = rotations, sigmoid
        self.dtype = _dtype(dtype)
        self.perception = PerceptionModule(in_channels)
        self.grasping = GraspingHead(out=rotations)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.grasping.head.weight.dtype).permute(0, 3, 1, 2)
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            q = self.grasping(self.perception(x, train), train)
        q = q.float()
        return torch.sigmoid(q) if self.sigmoid else q


def multidiscrete_resnet(number_rotations: int = 6,
                         dtype="bfloat16") -> MultidiscreteResnet:
    """Factory, parity with MULTIDISCRETE_RESNET(n) (Modules.py:310-311)."""
    return MultidiscreteResnet(rotations=number_rotations, dtype=dtype)


def resnet(dtype="bfloat16") -> MultidiscreteResnet:
    """Single-channel Q-map factory (Modules.py:300-304 RESNET)."""
    return MultidiscreteResnet(rotations=1, dtype=dtype)


class PolicyResnet(nn.Module):
    """Softmax-over-all-pixels policy head (Modules.py:306-308)."""

    def __init__(self, dtype="bfloat16"):
        super().__init__()
        self.net = MultidiscreteResnet(rotations=1, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        q = self.net(x, train)
        return torch.softmax(q.reshape(q.shape[0], -1), dim=-1)


def policy_resnet(dtype="bfloat16") -> PolicyResnet:
    return PolicyResnet(dtype=dtype)


def count_parameters(model: nn.Module) -> int:
    """Total trainable parameter count (Modules.py:314-325); the BatchNorm
    running statistics are buffers, as Flax keeps them out of ``params``."""
    return sum(p.numel() for p in model.parameters())


def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's initialisation, drawn from ``generator`` (on the CPU): conv
    kernels lecun-normal (fan-in variance, truncated at two standard
    deviations, rescaled as ``variance_scaling`` does), the head's bias
    zero, BatchNorm scale 1, bias 0, running mean 0 and variance 1.
    Returns ``model``, its tensors set in place on their device."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                w = mod.weight
                std = math.sqrt(1.0 / (w[0].numel())) / .87962566103423978
                t = torch.empty(w.shape)
                nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                w.copy_(t)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
    return model
