"""Counter-based deterministic random streams (bit-exact pcg32/Murmur port).

The reference keys every random stream by ``Hash(pixel, seed)`` +
``pcg32.advance(sampleIdx*65536 + dim)`` (sampler.cpp:43-46), which is already
counter-based and order-independent -- the property that lets a wavefront
regenerate the identical stream for any pixel shard on any chip.

This module ports, bit-exactly and branch-free over uint32 lanes:

* MurmurHash64A / MixBits / Hash(...)   (hash.h:15-113)
* pcg32 seed/nextUInt/nextFloat         (pcg32.h:42-176)
* pcg32.advance(delta) as a *static affine jump*: for a compile-time delta,
  ``state' = A_d * state + S_d * inc`` where (A_d, S_d) are host-precomputed
  from Brown's algorithm (pcg32.h advance), because acc_plus is linear in inc.
  One u64 multiply-add per lane instead of a 64-step loop.
* Kensler's ``permute(i, l, p)`` cycle-walking permutation (common.cpp:316-344)
* sampleTEA32                           (common.cpp:304-314)

All functions are pure jnp over arbitrary leading batch dims.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from . import u64
from .u64 import U64

_U32 = jnp.uint32

PCG32_MULT = 0x5851F42D4C957F2D
_MURMUR_M = 0xC6A4A7935BD1E995
_MASK64 = (1 << 64) - 1

# ---------------------------------------------------------------------------
# MurmurHash64A (hash.h:15-65) for the two fixed key layouts the samplers use.
# ---------------------------------------------------------------------------


def _murmur_round(h: U64, k: U64) -> U64:
    m = u64.from_int(_MURMUR_M)
    k = u64.mul(k, m)
    k = u64.xor(k, u64.shr(k, 47))
    k = u64.mul(k, m)
    h = u64.xor(h, k)
    return u64.mul(h, m)


def _murmur_finalize(h: U64) -> U64:
    m = u64.from_int(_MURMUR_M)
    h = u64.xor(h, u64.shr(h, 47))
    h = u64.mul(h, m)
    return u64.xor(h, u64.shr(h, 47))


def hash_pixel_seed(px, py, seed: int) -> U64:
    """Hash(Point2i p, uint64 seed) -- 16-byte key (hash.h:106-113).

    Little-endian buffer [px, py, seed] -> blocks (py<<32|px), seed.
    """
    px = jnp.asarray(px, _U32)
    py = jnp.asarray(py, _U32)
    h = u64.broadcast_to(u64.from_int((16 * _MURMUR_M) & _MASK64), px.shape)
    h = _murmur_round(h, (py, px))
    h = _murmur_round(h, u64.broadcast_to(u64.from_int(seed), px.shape))
    return _murmur_finalize(h)


def hash_pixel_dim_seed(px, py, dim: int, seed: int) -> U64:
    """Hash(Point2i p, uint32 dim, uint64 seed) -- 20-byte key.

    Blocks: (py<<32|px), (seed_lo<<32|dim); 4-byte tail = seed_hi.
    """
    px = jnp.asarray(px, _U32)
    py = jnp.asarray(py, _U32)
    seed &= _MASK64
    seed_lo = seed & 0xFFFFFFFF
    seed_hi = seed >> 32
    h = u64.broadcast_to(u64.from_int((20 * _MURMUR_M) & _MASK64), px.shape)
    h = _murmur_round(h, (py, px))
    k2 = u64.broadcast_to(
        u64.from_int(((seed_lo << 32) | (dim & 0xFFFFFFFF)) & _MASK64), px.shape
    )
    h = _murmur_round(h, k2)
    # Tail (len & 7 == 4): h ^= remaining 4 bytes; h *= m.
    h = u64.xor(h, u64.broadcast_to(u64.from_int(seed_hi), px.shape))
    h = u64.mul(h, u64.from_int(_MURMUR_M))
    return _murmur_finalize(h)


def hash_pixel_dim_seed_dyn(px, py, dim, seed: int) -> U64:
    """Same key layout as hash_pixel_dim_seed but with a traced uint32 dim."""
    px = jnp.asarray(px, _U32)
    py = jnp.asarray(py, _U32)
    dim = jnp.asarray(dim, _U32)
    seed &= _MASK64
    seed_lo = seed & 0xFFFFFFFF
    seed_hi = seed >> 32
    h = u64.broadcast_to(u64.from_int((20 * _MURMUR_M) & _MASK64), px.shape)
    h = _murmur_round(h, (py, px))
    k2 = (jnp.broadcast_to(jnp.asarray(seed_lo, _U32), dim.shape), dim)
    h = _murmur_round(h, k2)
    h = u64.xor(h, u64.broadcast_to(u64.from_int(seed_hi), px.shape))
    h = u64.mul(h, u64.from_int(_MURMUR_M))
    return _murmur_finalize(h)


def hash_float(h: U64) -> jnp.ndarray:
    """HashFloat (hash.h:110-113): low 32 bits of a Hash as [0,1) float."""
    return h[1].astype(jnp.float32) * jnp.float32(2.0**-32)


def mix_bits(v: U64) -> U64:
    """MixBits (hash.h:72-79)."""
    v = u64.xor(v, u64.shr(v, 31))
    v = u64.mul(v, u64.from_int(0x7FB5D329728EA185))
    v = u64.xor(v, u64.shr(v, 27))
    v = u64.mul(v, u64.from_int(0x81DADEF4BC2DD44D))
    return u64.xor(v, u64.shr(v, 33))


# ---------------------------------------------------------------------------
# pcg32 (pcg32.h)
# ---------------------------------------------------------------------------

PCGState = Tuple[U64, U64]  # (state, inc)


def pcg_seed_full(initstate: U64, initseq: U64) -> PCGState:
    """pcg32::seed(initstate, initseq) (pcg32.h:57-63), closed form."""
    one = u64.broadcast_to(u64.from_int(1), initseq[0].shape)
    inc = u64.or_(u64.shl(initseq, 1), one)
    mult = u64.from_int(PCG32_MULT)
    state = u64.add(u64.mul(u64.add(inc, initstate), mult), inc)
    return (state, inc)


def pcg_seed(h: U64) -> PCGState:
    """pcg32::seed(initseq) = seed(MixBits(h), h) (pcg32.h:65-67)."""
    return pcg_seed_full(mix_bits(h), h)


def pcg_next_uint(st: PCGState) -> Tuple[PCGState, jnp.ndarray]:
    """One LCG step + PCG output permutation (pcg32.h:70-76)."""
    state, inc = st
    old = state
    state = u64.add(u64.mul(old, u64.from_int(PCG32_MULT)), inc)
    x = u64.xor(u64.shr(old, 18), old)
    xorshifted = u64.shr(x, 27)[1]
    rot = u64.shr(old, 59)[1]
    out = (xorshifted >> rot) | (xorshifted << ((~rot + _U32(1)) & _U32(31)))
    return (state, inc), out


def uint_to_float(u: jnp.ndarray) -> jnp.ndarray:
    """[1,2) mantissa trick -> [0,1) float (pcg32.h:118-127)."""
    bits = (u >> 9) | _U32(0x3F800000)
    return jax.lax.bitcast_convert_type(bits, jnp.float32) - 1.0


def pcg_next_float(st: PCGState) -> Tuple[PCGState, jnp.ndarray]:
    st, u = pcg_next_uint(st)
    return st, uint_to_float(u)


def advance_constants(delta: int) -> Tuple[int, int]:
    """Host-side Brown jump-ahead (pcg32.h:137-160): returns (A_d, S_d) with
    ``state' = A_d*state + S_d*inc mod 2^64`` (S_d computed with inc:=1; valid
    because acc_plus is linear homogeneous in inc)."""
    delta &= _MASK64
    acc_mult, acc_plus = 1, 0
    cur_mult, cur_plus = PCG32_MULT, 1
    while delta > 0:
        if delta & 1:
            acc_mult = (acc_mult * cur_mult) & _MASK64
            acc_plus = (acc_plus * cur_mult + cur_plus) & _MASK64
        cur_plus = ((cur_mult + 1) * cur_plus) & _MASK64
        cur_mult = (cur_mult * cur_mult) & _MASK64
        delta >>= 1
    return acc_mult, acc_plus


def pcg_advance_static(st: PCGState, delta: int) -> PCGState:
    """pcg32::advance(delta) for a compile-time delta."""
    a, s = advance_constants(delta)
    state, inc = st
    state = u64.add(u64.mul(state, u64.from_int(a)), u64.mul(inc, u64.from_int(s)))
    return (state, inc)


def pcg_advance_jump(st: PCGState, a: u64.U64, s: u64.U64) -> PCGState:
    """pcg32::advance with traced jump constants (from advance_constants on
    the host, passed as u64 scalars) -- lets one jitted render pass serve
    every sample index without recompiling."""
    state, inc = st
    a = u64.broadcast_to(a, state[0].shape)
    s = u64.broadcast_to(s, state[0].shape)
    state = u64.add(u64.mul(state, a), u64.mul(inc, s))
    return (state, inc)


def sampler_state(px, py, seed: int, sample_index: int, dim: int = 0) -> PCGState:
    """generateSample(pixel, sampleIndex, dim) (sampler.cpp:43-46):
    seed(Hash(p, seed)); advance(sampleIndex*65536 + dim)."""
    st = pcg_seed(hash_pixel_seed(px, py, seed))
    return pcg_advance_static(st, sample_index * 65536 + dim)


# ---------------------------------------------------------------------------
# Kensler permute (common.cpp:316-344)
# ---------------------------------------------------------------------------


def _permute_hash_round(i, w, p):
    i = i ^ p
    i = i * _U32(0xE170893D)
    i = i ^ (p >> 16)
    i = i ^ ((i & w) >> 4)
    i = i ^ (p >> 8)
    i = i * _U32(0x0929EB3F)
    i = i ^ (p >> 23)
    i = i ^ ((i & w) >> 1)
    i = i * (_U32(1) | (p >> 27))
    i = i * _U32(0x6935FA69)
    i = i ^ ((i & w) >> 11)
    i = i * _U32(0x74DCB303)
    i = i ^ ((i & w) >> 2)
    i = i * _U32(0x9E501CC3)
    i = i ^ ((i & w) >> 2)
    i = i * _U32(0xC860A3DF)
    i = i & w
    i = i ^ (i >> 5)
    return i


def permute(i, l, p):
    """Cycle-walking hash permutation of [0, l) (common.cpp:316-344).

    ``l`` may be a Python int or a uint32 array; ``i``/``p`` are uint32 arrays.
    """
    i = jnp.asarray(i, _U32)
    p = jnp.asarray(p, _U32)
    l = jnp.asarray(l, _U32)
    i, p, l = jnp.broadcast_arrays(i, p, l)
    w = l - _U32(1)
    for s in (1, 2, 4, 8, 16):
        w = w | (w >> s)

    # do-while: always one round, then walk rejected lanes until accepted.
    # The accept mask is carried as uint32 0/1 (not bool): this loop also
    # runs inside Pallas kernels, and Mosaic cannot yield i1 vectors from
    # scf.while state.
    first = _permute_hash_round(i, w, p)
    one = jnp.ones_like(first)
    zero = jnp.zeros_like(first)
    ok = jnp.where(first < l, one, zero)

    def cond(carry):
        _, ok = carry
        return ~jnp.all(ok > 0)

    def body(carry):
        cur, ok = carry
        okb = ok > 0
        nxt = _permute_hash_round(cur, w, p)
        new = jnp.where(okb, cur, nxt)
        return new, jnp.where(okb | (nxt < l), one, zero)

    out, _ = jax.lax.while_loop(cond, body, (first, ok))
    return (out + p) % l


def sample_tea32(v0, v1, rounds: int = 4):
    """TEA-32 hash (common.cpp:304-314); returns (hi, lo) = (v1, v0)."""
    v0 = jnp.asarray(v0, _U32)
    v1 = jnp.asarray(v1, _U32)
    total = _U32(0)
    for _ in range(rounds):
        total = total + _U32(0x9E3779B9)
        v0 = v0 + (
            ((v1 << 4) + _U32(0xA341316C))
            ^ (v1 + total)
            ^ ((v1 >> 5) + _U32(0xC8013EA4))
        )
        v1 = v1 + (
            ((v0 << 4) + _U32(0xAD90777D))
            ^ (v0 + total)
            ^ ((v0 >> 5) + _U32(0x7E95761E))
        )
    return (v1, v0)
