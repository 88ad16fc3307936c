"""Seeded weights for both sides: one state dict drawn on the device from
the run's seed, handed to the system under test and, made again from the
same seed, to the reference.

One standard-normal draw fills every parameter at once (a single call on
the card's generator, in ``named_parameters`` order of the reference
module); each leaf is then scaled in place by its kind:

* dense and conv weights: N(0, 1 / fan_in);
* norm scales and ``Ds``: 1 + 0.1 N(0, 1); biases: 0.02 N(0, 1);
* ``A_logs``: log(1..N) per row (S4D-real), with 0.05 N(0, 1) on top;
* ``dt_projs_bias``: the inverse softplus of dt = exp(U(ln 1e-3, ln 0.1));
* the blenders' ``mix_factor``: 0.5 N(0, 1).

So activations keep unit scale through the depth, the scan sees its usual
range of decays, and a fault that drops a bias or a norm scale shows.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def seed64(seed: int, salt: int = 0) -> int:
    """A 63-bit generator seed from the run's seed (any size) and a salt."""
    return (int(seed) * 6364136223846793005 + salt * 1442695040888963407 + 1) % (2 ** 63)


def generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed64(seed, salt))


@torch.no_grad()
def _shape_leaf(name: str, v: torch.Tensor) -> None:
    """Turn the standard-normal view ``v`` into leaf ``name``'s values."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "A_logs":
        n = v.shape[-1]
        base = torch.log(torch.arange(1, n + 1, dtype=v.dtype, device=v.device))
        v.mul_(0.05).add_(base)
    elif leaf == "dt_projs_bias":
        u = 0.5 * (1.0 + torch.erf(v * 2 ** -0.5))          # U(0, 1)
        lo, hi = math.log(1e-3), math.log(0.1)
        dt = torch.exp(u * (hi - lo) + lo).clamp_min(1e-4)
        v.copy_(dt + torch.log(-torch.expm1(-dt)))
    elif leaf in ("x_proj_weight", "dt_projs_weight"):   # (K, out, in)
        v.mul_(v.shape[-1] ** -0.5)
    elif leaf == "mix_factor":
        v.mul_(0.5)
    elif leaf == "Ds" or (leaf == "weight" and v.ndim == 1):
        v.mul_(0.1).add_(1.0)
    elif leaf == "bias":
        v.mul_(0.02)
    else:                        # dense / conv / projection weights
        v.mul_(v[0].numel() ** -0.5 if v.ndim > 1 else 1.0)


@torch.no_grad()
def seeded_state(module: torch.nn.Module, seed: int, device, salt: int = 0
                 ) -> Dict[str, torch.Tensor]:
    """name -> fp32 tensor on ``device`` for every parameter of ``module``
    (which may live on the meta device); the tensors are views of one flat
    buffer."""
    names = [(n, p.shape) for n, p in module.named_parameters()]
    total = sum(math.prod(s) for _, s in names)
    flat = torch.randn(total, generator=generator(seed, salt, device),
                       device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape in names:
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        _shape_leaf(name, v)
        out[name] = v
        off += n
    return out
