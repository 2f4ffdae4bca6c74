"""Synthetic Nyx-like fields (numpy copy of ``repro/data/synthetic.py``).

The same seed gives the same bits as the reference, so the two packages
can be fed one input without sharing code.
"""
from __future__ import annotations

import numpy as np

NYX_FIELDS = ("temperature", "dark_matter_density", "baryon_density", "velocity_x")


def gaussian_random_field(shape, power: float = -3.0, seed: int = 0) -> np.ndarray:
    """Isotropic GRF with power-law spectrum k**power (unit variance)."""
    rng = np.random.default_rng(seed)
    white = rng.standard_normal(shape).astype(np.float32)
    f = np.fft.rfftn(white)
    ks = np.meshgrid(
        *[np.fft.fftfreq(n) for n in shape[:-1]],
        np.fft.rfftfreq(shape[-1]),
        indexing="ij",
    )
    k = np.sqrt(sum(x * x for x in ks))
    k[tuple(0 for _ in shape)] = 1.0
    amp = k ** (power / 2.0)
    amp[tuple(0 for _ in shape)] = 0.0
    g = np.fft.irfftn(f * amp, s=shape, axes=tuple(range(len(shape)))).astype(np.float32)
    g /= g.std() + 1e-12
    return g


def nyx_like_field(shape=(64, 64, 64), field: str = "temperature", seed: int = 0) -> np.ndarray:
    """A 3D field mimicking the named Nyx field's distribution (Table 1 of
    the paper: temperature min 2281 / max ~4.8e6, heavily skewed)."""
    g = gaussian_random_field(shape, power=-2.4, seed=seed)
    if field == "temperature":
        fine = gaussian_random_field(shape, power=-1.2, seed=seed + 101)
        lnT = 0.6 * g + 0.18 * fine + 1.4 * np.clip(g - 1.1, 0, None) ** 2
        lo, hi = np.log(2281.0), np.log(4.78e6)
        lnT = lo + (lnT - lnT.min()) * (hi - lo) / (lnT.max() - lnT.min() + 1e-9)
        return np.exp(lnT).astype(np.float32)
    if field == "dark_matter_density":
        fine = gaussian_random_field(shape, power=-1.2, seed=seed + 103)
        x = np.exp(2.2 * g + 0.4 * fine)
        x = x / x.mean()
        return x.astype(np.float32)
    if field == "baryon_density":
        x = np.exp(1.4 * g)
        return (x / x.mean()).astype(np.float32)
    if field == "velocity_x":
        return (g * 2.3e7).astype(np.float32)
    raise ValueError(f"unknown field {field!r}")
