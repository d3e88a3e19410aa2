"""Branch-free uint64 arithmetic on (hi, lo) uint32 pairs.

JAX runs here with 32-bit integers (x64 disabled), so a uint64 is a pair
of uint32 arrays ``(hi, lo)`` with exactly the operations the rendering
RNG stack needs: add, full 64x64->low-64 multiply, xor, and logical shifts.

These back the bit-exact ports of the reference's deterministic random
streams (pcg32: /root/reference/include/kazen/pcg32.h, MurmurHash64A/MixBits:
/root/reference/include/kazen/hash.h). Everything is pure and vectorizes over
leading array dimensions.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

U64 = Tuple[jnp.ndarray, jnp.ndarray]  # (hi, lo), both uint32

_U32 = jnp.uint32


def u64(hi, lo) -> U64:
    return (jnp.asarray(hi, _U32), jnp.asarray(lo, _U32))


def from_int(v: int) -> U64:
    """Build a (hi, lo) constant from a Python int (taken mod 2**64)."""
    v &= (1 << 64) - 1
    return (jnp.asarray(v >> 32, _U32), jnp.asarray(v & 0xFFFFFFFF, _U32))


def to_int(x: U64) -> int:
    """Host-side readback (for tests)."""
    return (int(x[0]) << 32) | int(x[1])


def add(x: U64, y: U64) -> U64:
    lo = x[1] + y[1]
    carry = (lo < x[1]).astype(_U32)
    return (x[0] + y[0] + carry, lo)


def add_u32(x: U64, y) -> U64:
    y = jnp.asarray(y, _U32)
    lo = x[1] + y
    carry = (lo < y).astype(_U32)
    return (x[0] + carry, lo)


def mul32_full(a, b) -> U64:
    """Full 32x32 -> 64 bit multiply of uint32 operands."""
    a = jnp.asarray(a, _U32)
    b = jnp.asarray(b, _U32)
    a0 = a & 0xFFFF
    a1 = a >> 16
    b0 = b & 0xFFFF
    b1 = b >> 16
    lo = a * b
    t = a1 * b0 + ((a0 * b0) >> 16)
    t2 = a0 * b1 + (t & 0xFFFF)
    hi = a1 * b1 + (t >> 16) + (t2 >> 16)
    return (hi, lo)


def mul(x: U64, y: U64) -> U64:
    """Low 64 bits of a 64x64 multiply."""
    hi, lo = mul32_full(x[1], y[1])
    hi = hi + x[1] * y[0] + x[0] * y[1]
    return (hi, lo)


def xor(x: U64, y: U64) -> U64:
    return (x[0] ^ y[0], x[1] ^ y[1])


def shr(x: U64, n: int) -> U64:
    """Logical right shift by a static amount."""
    if n == 0:
        return x
    if n >= 64:
        z = jnp.zeros_like(x[0])
        return (z, z)
    if n >= 32:
        return (jnp.zeros_like(x[0]), x[0] >> (n - 32))
    return (x[0] >> n, (x[1] >> n) | (x[0] << (32 - n)))


def shl(x: U64, n: int) -> U64:
    """Logical left shift by a static amount."""
    if n == 0:
        return x
    if n >= 64:
        z = jnp.zeros_like(x[0])
        return (z, z)
    if n >= 32:
        return (x[1] << (n - 32), jnp.zeros_like(x[1]))
    return ((x[0] << n) | (x[1] >> (32 - n)), x[1] << n)


def or_(x: U64, y: U64) -> U64:
    return (x[0] | y[0], x[1] | y[1])


def broadcast_to(x: U64, shape) -> U64:
    return (jnp.broadcast_to(x[0], shape), jnp.broadcast_to(x[1], shape))
