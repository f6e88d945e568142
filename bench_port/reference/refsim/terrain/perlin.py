"""Fractal Perlin-noise heightfield generation (numpy, build time).

Behavioral equivalent of the reference's TerrainPerlin generator
(ref mqe/utils/terrain/perlin.py:33-72): same gradient-noise construction and
fractal-octave stacking, written against numpy Generator PRNG so terrain is
deterministic under a seed.

The numpy path of `mqe_tpu/terrain/perlin.py`; that module can hand the
interpolation to a host C++ library, which computes the same numbers.
"""
from __future__ import annotations

import numpy as np


def perlin_noise_2d(rng: np.random.Generator, shape, res):
    """Single-octave gradient noise in [0, 1], shape divisible by res."""
    angles = 2 * np.pi * rng.random((res[0] + 1, res[1] + 1))

    def fade(t):
        return 6 * t**5 - 15 * t**4 + 10 * t**3

    delta = (res[0] / shape[0], res[1] / shape[1])
    d = (shape[0] // res[0], shape[1] // res[1])
    grid = np.mgrid[0 : res[0] : delta[0], 0 : res[1] : delta[1]].transpose(1, 2, 0) % 1
    gradients = np.dstack((np.cos(angles), np.sin(angles)))
    g00 = gradients[:-1, :-1].repeat(d[0], 0).repeat(d[1], 1)
    g10 = gradients[1:, :-1].repeat(d[0], 0).repeat(d[1], 1)
    g01 = gradients[:-1, 1:].repeat(d[0], 0).repeat(d[1], 1)
    g11 = gradients[1:, 1:].repeat(d[0], 0).repeat(d[1], 1)
    n00 = np.sum(grid * g00, 2)
    n10 = np.sum(np.dstack((grid[:, :, 0] - 1, grid[:, :, 1])) * g10, 2)
    n01 = np.sum(np.dstack((grid[:, :, 0], grid[:, :, 1] - 1)) * g01, 2)
    n11 = np.sum(np.dstack((grid[:, :, 0] - 1, grid[:, :, 1] - 1)) * g11, 2)
    t = fade(grid)
    n0 = n00 * (1 - t[:, :, 0]) + t[:, :, 0] * n10
    n1 = n01 * (1 - t[:, :, 0]) + t[:, :, 0] * n11
    return np.sqrt(2) * ((1 - t[:, :, 1]) * n0 + t[:, :, 1] * n1) * 0.5 + 0.5


def fractal_noise_2d(
    rng: np.random.Generator,
    xSize=20.0,
    ySize=20.0,
    xSamples=1600,
    ySamples=1600,
    frequency=10,
    fractalOctaves=2,
    fractalLacunarity=2.0,
    fractalGain=0.25,
    zScale=0.23,
):
    """Fractal noise heightfield in METERS, shape (xSamples, ySamples)."""
    xScale = int(frequency * xSize)
    yScale = int(frequency * ySize)
    amplitude = 1.0
    noise = np.zeros((xSamples, ySamples))
    for _ in range(fractalOctaves):
        xScale = max(1, xScale)
        yScale = max(1, yScale)
        # pad shape up so it divides res, then crop (reference requires exact
        # divisibility; we are tolerant to arbitrary sample counts)
        sx = int(np.ceil(xSamples / xScale) * xScale)
        sy = int(np.ceil(ySamples / yScale) * yScale)
        n = perlin_noise_2d(rng, (sx, sy), (xScale, yScale))[:xSamples, :ySamples]
        noise += amplitude * n * zScale
        amplitude *= fractalGain
        xScale = int(fractalLacunarity * xScale)
        yScale = int(fractalLacunarity * yScale)
    return noise
