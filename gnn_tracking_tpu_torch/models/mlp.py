"""Fully-connected building blocks (counterpart of the JAX ``models/mlp.py``).

Parameters are stored in PyTorch's ``[out, in]`` layout and initialised with
the JAX package's formulas: ``TorchLinear`` uses torch's Linear default
(uniform +-1/sqrt(fan_in) on weight and bias), ``NormalLinear`` draws both
from N(0, var). Every constructor takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F


def _uniform(shape, bound, generator):
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class TorchLinear(nn.Module):
    """Dense layer with torch's default initialisation."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(_uniform((out_features, in_features), bound, generator))
        self.bias = (
            nn.Parameter(_uniform((out_features,), bound, generator)) if bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class NormalLinear(nn.Module):
    """Dense layer with N(0, var) init on all parameters."""

    def __init__(self, in_features: int, out_features: int, var: float,
                 bias: bool = True, *, generator: torch.Generator | None = None):
        super().__init__()
        std = math.sqrt(var)
        self.weight = nn.Parameter(
            torch.randn((out_features, in_features), generator=generator) * std
        )
        self.bias = (
            nn.Parameter(torch.randn((out_features,), generator=generator) * std)
            if bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class MLP(nn.Module):
    """ReLU multi-layer perceptron: ``L`` linear layers in total (at least
    two, as in the reference). ``hidden_dim=None`` selects
    ``max(input_size, output_size)``."""

    def __init__(self, input_size: int, output_size: int,
                 hidden_dim: int | None = None, L: int = 3, bias: bool = True,
                 include_last_activation: bool = False,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        if hidden_dim is None:
            hidden_dim = max(input_size, output_size)
        dims = [input_size] + [hidden_dim] * max(L - 1, 1) + [output_size]
        self.linears = nn.ModuleList(
            TorchLinear(a, b, bias, generator=generator)
            for a, b in zip(dims[:-1], dims[1:])
        )
        self.include_last_activation = include_last_activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin in self.linears[:-1]:
            x = torch.relu(lin(x))
        x = self.linears[-1](x)
        return torch.relu(x) if self.include_last_activation else x


class ResFCNN(nn.Module):
    """Residual FCNN with L2-normalised input: 1 encoder layer, ``depth-1``
    residual hidden layers, 1 decoder."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int, depth: int,
                 alpha: float = 0.6, bias: bool = True,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        if depth < 1:
            msg = "Depth must be at least 1"
            raise ValueError(msg)
        self.alpha = alpha
        layers = [NormalLinear(in_dim, hidden_dim, 1.0 / in_dim, bias, generator=generator)]
        layers += [
            NormalLinear(hidden_dim, hidden_dim, 2.0 / hidden_dim, bias, generator=generator)
            for _ in range(depth - 1)
        ]
        layers.append(
            NormalLinear(hidden_dim, out_dim, 2.0 / hidden_dim, bias, generator=generator)
        )
        self.linears = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        x = self.linears[0](x / torch.clamp(norm, min=1e-12))
        for lin in self.linears[1:-1]:
            x = math.sqrt(self.alpha) * x + math.sqrt(1 - self.alpha) * lin(torch.relu(x))
        return self.linears[-1](torch.relu(x))


def get_pixel_mask(layer: torch.Tensor) -> torch.Tensor:
    """Pixel detector hits: layers 0-17 (JAX ``mlp.get_pixel_mask``)."""
    return (layer >= 0) & (layer < 18)


class HeterogeneousResFCNN(nn.Module):
    """Separate ``ResFCNN`` towers for pixel and strip hits (JAX
    ``mlp.py:154-187``). As in JAX, both towers run densely over all nodes
    and each node takes its tower's row, so the hits need no order."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int, depth: int,
                 alpha: float = 0.6, bias: bool = True,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        self.pixel_fcnn = ResFCNN(in_dim, out_dim, hidden_dim, depth, alpha, bias, generator=generator)
        self.strip_fcnn = ResFCNN(in_dim, out_dim, hidden_dim, depth, alpha, bias, generator=generator)

    def forward(self, x: torch.Tensor, layer: torch.Tensor) -> torch.Tensor:
        pixel = get_pixel_mask(layer)[:, None]
        return torch.where(pixel, self.pixel_fcnn(x), self.strip_fcnn(x))
