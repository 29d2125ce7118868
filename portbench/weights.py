"""The configurations' weights, made on the device from the run's seed in
one draw: every parameter uniform in ``+-1 / sqrt(fan_in)`` (PyTorch's
``Linear`` initialisation), the constants (fan-in 0) at 1. Both the program
and the reference are handed these tensors.

At that initialisation a head's outputs barely spread: every edge weight
sits within float32 steps of 0.5 and every hit's condensation likelihood
within 1e-3 of the others, so no EC cut, condensation point or cluster is
defined past rounding. :func:`standardize` then sets a head's last layer so
that its outputs on the pool's first event have the configuration's mean
and spread (``head_targets``), as a trained model's do: an affine map of
the outputs, ``a * out + c``, put into the weight and bias."""

from __future__ import annotations

import math

import numpy as np
import torch


def seed_of(seed: int, stream: str) -> int:
    """A 63-bit seed for one random stream of a run."""
    words = [int(seed), *stream.encode()]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint32).view(np.uint64)[0] >> 1)


def make_weights(specs, seed: int, device) -> dict[str, torch.Tensor]:
    """``name -> float32 tensor`` for every ``(name, shape, fan_in)`` of
    ``specs``."""
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, "weights"))
    total = sum(math.prod(shape) for _, shape, _ in specs)
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32) * 2.0 - 1.0
    out, off = {}, 0
    for name, shape, fan_in in specs:
        n = math.prod(shape)
        if fan_in == 0:
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = u[off:off + n].reshape(shape) / math.sqrt(fan_in)
        off += n
    return out


@torch.no_grad()
def standardize(weights: dict[str, torch.Tensor], layer: str, out: torch.Tensor, mean: float, std: float) -> None:
    """Set ``layer``'s weight and bias so that its outputs ``out`` ([rows] or
    [rows, features], computed with the present weights) get ``mean`` and
    ``std`` in every feature."""
    out = out.reshape(out.shape[0], -1).double()
    a = std / out.std(dim=0)
    c = mean - a * out.mean(dim=0)
    w, b = weights[f"{layer}.weight"], weights[f"{layer}.bias"]
    w.mul_(a[:, None].to(w.dtype))
    b.copy_((a * b.double() + c).to(b.dtype))
