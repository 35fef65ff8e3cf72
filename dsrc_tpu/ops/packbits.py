"""Fixed-width bit packing kernels.

The reference's DnaModelerBasicB2 packs <=4-symbol DNA at 2 bits/base inside
its bit-writer loop (DnaModelerBasicB2.h:34-60); here packing is a reshape +
weighted sum over byte groups — pure elementwise work.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@jax.jit
def pack2(syms: jnp.ndarray) -> jnp.ndarray:
    """[n*4] 2-bit symbols -> [n] bytes (little-endian within byte)."""
    n = syms.shape[0]
    assert n % 4 == 0
    s = syms.astype(jnp.int32).reshape(-1, 4)
    w = jnp.asarray([1, 4, 16, 64], jnp.int32)
    return (s * w).sum(1).astype(jnp.uint8)


@jax.jit
def unpack2(packed: jnp.ndarray) -> jnp.ndarray:
    """[n] bytes -> [n*4] 2-bit symbols."""
    b = packed.astype(jnp.int32)[:, None]
    shifts = jnp.asarray([0, 2, 4, 6], jnp.int32)
    return ((b >> shifts) & 3).reshape(-1)


@functools.partial(jax.jit, static_argnames=("width",))
def pack_fixed(values: jnp.ndarray, width: int) -> jnp.ndarray:
    """Pack [n] ints of `width` bits (1..16) into bytes via a u32 lane trick:
    groups of 8 values -> width bytes."""
    n = values.shape[0]
    assert n % 8 == 0
    v = values.astype(jnp.uint32).reshape(-1, 8)
    # accumulate 8*width bits as `width` bytes per group
    bit_idx = jnp.arange(8, dtype=jnp.uint32) * width
    out_bytes = []
    for byte_i in range(width):
        base = byte_i * 8
        acc = jnp.zeros(v.shape[:1], jnp.uint32)
        for j in range(8):
            lo = int(bit_idx[j])
            # bits of value j that land in byte byte_i
            shift = base - lo
            if -width < shift < 8:
                part = (v[:, j] << shift) if shift >= 0 else \
                    (v[:, j] >> (-shift))
                acc = acc | (part & 0xFF)
        out_bytes.append(acc.astype(jnp.uint8))
    return jnp.stack(out_bytes, axis=1).reshape(-1)


@functools.partial(jax.jit, static_argnames=("width",))
def unpack_fixed(packed: jnp.ndarray, width: int) -> jnp.ndarray:
    """Inverse of pack_fixed: [n_groups*width] bytes -> [n_groups*8] ints."""
    b = packed.astype(jnp.uint32).reshape(-1, width)
    outs = []
    for j in range(8):
        lo = j * width
        acc = jnp.zeros(b.shape[:1], jnp.uint32)
        for byte_i in range(width):
            base = byte_i * 8
            shift = base - lo
            if -width < shift < 8:
                part = (b[:, byte_i] >> shift) if shift >= 0 else \
                    (b[:, byte_i] << (-shift))
                acc = acc | part
        outs.append(acc & ((1 << width) - 1))
    return jnp.stack(outs, axis=1).reshape(-1).astype(jnp.int32)
