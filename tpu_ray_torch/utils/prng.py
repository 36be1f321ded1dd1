"""The threefry-2x32 counter hash and `uniform` draws from it, bit for bit
the values `jax.random.uniform(jax.random.PRNGKey(seed), shape, dtype)`
gives (the render's jitter is specified as that draw).

The layout is the partitionable one (`jax_threefry_partitionable`, JAX's
default): element i of the draw, in row-major order, hashes the 64-bit
counter i, split as (i >> 32, i & 0xFFFFFFFF), with the key (seed >> 32,
seed & 0xFFFFFFFF). A float32 value takes the two output words xor'ed, a
float64 value the pair as (hi << 32) | lo; the top mantissa bits of that
form a float in [1, 2), minus 1. So any run of elements is computed from
its flat indices alone, with no state: `uniform` draws a slice of the
flat sequence.

The words are held in int64 tensors (values below 2**32, masked after
every add and shift), which integer tensor ops on every device compute
exactly.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key_from_seed(seed: int) -> tuple:
    """The threefry key of an integer seed: its high and low 32-bit words."""
    return (seed >> 32) & MASK, seed & MASK


def threefry2x32(key: tuple, x0: torch.Tensor, x1: torch.Tensor) -> tuple:
    """The 20-round threefry-2x32 hash of the counter words (x0, x1), each
    an int64 tensor of values below 2**32 -> two such tensors."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def uniform(seed: int, start: int, count: int, dtype=torch.float32,
            device="cpu") -> torch.Tensor:
    """Elements start .. start + count - 1 (flat, row-major) of
    jax.random.uniform(PRNGKey(seed), shape, dtype) for any shape holding
    them: a (count,) tensor in [0, 1)."""
    i = torch.arange(start, start + count, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key_from_seed(seed), i >> 32, i & MASK)
    if dtype == torch.float32:
        bits = ((b0 ^ b1) >> 9) | 0x3F800000  # 23 mantissa bits, exponent 0
        return bits.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        # ((b0 << 32) | b1) >> 12: 52 mantissa bits
        bits = (b0 << 20) | (b1 >> 12) | 0x3FF0000000000000
        return bits.view(torch.float64) - 1.0
    raise TypeError(f"uniform draws float32 or float64, not {dtype}")
