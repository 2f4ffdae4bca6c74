"""Nyx-like synthetic fields made on the device from a seed, in torch.

The statistics of the repository's numpy generator (``data/synthetic.py``,
paper Table 1): a Gaussian random field with a power-law spectrum
``k**power`` (unit variance), then the named field's transform.  The bits
differ from the numpy generator's (another random stream, cuFFT); one seed
gives one field on one device.
"""
from __future__ import annotations

import math

import torch

FIELDS = ("temperature", "dark_matter_density", "baryon_density", "velocity_x")


def gaussian_random_field(shape, power: float, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    white = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    f = torch.fft.rfftn(white)
    del white
    ks = torch.meshgrid(*[torch.fft.fftfreq(n, device=dev) for n in shape[:-1]],
                        torch.fft.rfftfreq(shape[-1], device=dev), indexing="ij")
    k2 = sum(k * k for k in ks)
    del ks
    k2[(0,) * len(shape)] = 1.0
    amp = k2 ** (power / 4.0)  # sqrt(k) ** (power / 2)
    amp[(0,) * len(shape)] = 0.0
    f *= amp
    del amp, k2
    g = torch.fft.irfftn(f, s=shape)
    del f
    g /= g.std() + 1e-12
    return g.to(torch.float32)


def field(shape, name: str, seed: int, device) -> torch.Tensor:
    """The named field of ``shape`` from ``seed`` (any non-negative integer)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    g = gaussian_random_field(tuple(shape), -2.4, gen)
    if name == "temperature":
        fine = gaussian_random_field(tuple(shape), -1.2, gen)
        lnT = 0.6 * g + 0.18 * fine + 1.4 * torch.clamp(g - 1.1, min=0) ** 2
        del fine
        lo, hi = math.log(2281.0), math.log(4.78e6)
        mn, mx = torch.aminmax(lnT)
        return torch.exp(lo + (lnT - mn) * (hi - lo) / (mx - mn + 1e-9)).to(torch.float32)
    if name == "dark_matter_density":
        fine = gaussian_random_field(tuple(shape), -1.2, gen)
        x = torch.exp(2.2 * g + 0.4 * fine)
        return (x / x.mean()).to(torch.float32)
    if name == "baryon_density":
        x = torch.exp(1.4 * g)
        return (x / x.mean()).to(torch.float32)
    if name == "velocity_x":
        return (g * 2.3e7).to(torch.float32)
    raise ValueError(f"unknown field {name!r}")
