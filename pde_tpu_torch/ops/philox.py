"""Philox4x32-10 and the increment laws on PyTorch tensors.

The plain version of the noise stream that the in-kernel SDE window
(``csrc/philox.cuh``, kernel ``sde_kernel_noise_2d``) draws. It replaces the
TPU kernel's hardware generator (``_make_kernel_noise_gen`` in
:mod:`pde_tpu.ops.pallas_cartesian`), which a GPU does not have.

The stream is a pure function of the global cell: one Philox4x32-10 call,
keyed by the two seed words of the window, with the counter
``(global step, global row, global column, 0)``, gives the four 32-bit words
of one increment. Every tile that recomputes a halo cell therefore adds the
same increment, whatever the tile size and the steps per pass.

Words are uint32 values carried in ``torch.int64`` tensors. A 32 x 32-bit
product does not fit a signed 64-bit integer, so the multiplier's operand is
split into 16-bit halves (no partial product exceeds 2^48).

From words to floats, the same in both files, in the working dtype ``T``
(float32 or float64):

- a uniform is ``T(w >> 8) * 2^-24``: the top 24 bits, exact in both dtypes
  (the TPU kernel's 24-bit mantissa trick; float64 uses the same 24 bits);
- ``normal``: Box-Muller on words 0 and 1,
  ``sqrt(-2 log(max(u0, 2^-24))) * cos(2 pi u1)``;
- ``irwin4``: ``(((u0 + u1) + u2) + u3 - 2) * sqrt(3)``, summed in that order;
- ``rademacher``: ``1 - 2 * (w0 >> 31)``.

The increment added to a cell is that unit value times the scale
``sqrt(dt * var / cell_volume)``, rounded to ``T`` first.

Seeds: :func:`seed_words` gives a window's two key words, and
:func:`step_seed` the torch generator seed of one step of a window (the
staged stream's counterpart of ``jax.random.fold_in``).
"""

from __future__ import annotations

import math

import torch

#: the Philox4x32 round multipliers and Weyl key increments (Random123)
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF
ROUNDS = 10
#: 2^-24, the step of the 24-bit uniforms
TWO_M24 = 2.0**-24
LAWS = ("normal", "irwin4", "rademacher")


def _mulhilo(multiplier: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``multiplier * x`` for uint32 values in int64."""
    p_lo = multiplier * (x & 0xFFFF)  # < 2^48
    p_hi = multiplier * (x >> 16)  # < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & MASK32


def philox4x32_10(counter, key: tuple[int, int]) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 of the counter words (broadcastable int64 tensors or
    ints holding uint32 values) under a key of two uint32 ints; returns the
    four output words."""
    device = next((c.device for c in counter if isinstance(c, torch.Tensor)), None)
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *[torch.as_tensor(c, dtype=torch.int64, device=device) for c in counter]
    )
    k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform24(word: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The top 24 bits of a word as a uniform in [0, 1)."""
    return (word >> 8).to(dtype) * TWO_M24


def unit_increments(words, law: str, dtype: torch.dtype) -> torch.Tensor:
    """Unit-variance increments of one law from Philox output words."""
    if law == "normal":
        u1 = torch.clamp_min(uniform24(words[0], dtype), TWO_M24)
        u2 = uniform24(words[1], dtype)
        return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    if law == "irwin4":
        total = uniform24(words[0], dtype) + uniform24(words[1], dtype)
        total = total + uniform24(words[2], dtype)
        total = total + uniform24(words[3], dtype)
        return (total - 2.0) * math.sqrt(3.0)
    if law == "rademacher":
        return 1.0 - 2.0 * (words[0] >> 31).to(dtype)
    raise ValueError(f"Unknown increment law {law!r} (expected one of {LAWS})")


def splitmix64(x: int) -> int:
    """The splitmix64 finaliser: a bijection of 64-bit ints that mixes every
    input bit into every output bit."""
    z = (int(x) + 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def step_seed(window_seed: int, step: int) -> int:
    """Seed of a torch generator for step `step` of a window: a function of
    (window seed, step) only, distinct for distinct pairs of 32-bit values,
    with well-mixed low bits (the CPU generator reads 32 of them)."""
    return splitmix64(((int(window_seed) & MASK32) << 32) | (int(step) & MASK32))


def seed_words(window_seed: int) -> tuple[int, int]:
    """The two Philox key words of a window."""
    z = splitmix64(int(window_seed) & MASK32)
    return z & MASK32, z >> 32


def cell_increments(
    law: str, key: tuple[int, int], step: int, rows: torch.Tensor, cols: torch.Tensor,
    dtype: torch.dtype, scale: float,
) -> torch.Tensor:
    """Scaled increments of global step `step` at the cells ``rows x cols``
    (1D tensors of global indices, already wrapped on periodic axes)."""
    words = philox4x32_10(
        (int(step) & MASK32, rows.to(torch.int64)[:, None], cols.to(torch.int64)[None, :], 0),
        key,
    )
    return unit_increments(words, law, dtype) * torch.tensor(scale, dtype=dtype, device=rows.device)
