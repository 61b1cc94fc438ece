"""Bit-exact GPTQ pack/unpack of the on-disk checkpoint tensors (NumPy, host side).

The port's own copy of the JAX package's ``ops/packing.py`` (the port imports
nothing from that package). Layout of a GPTQ checkpoint:

  * ``qweight``: ``int32[K * bits / 32, N]`` — quantized weights packed
    little-endian along the K (input-feature) axis. For bits in {2, 4, 8}
    each int32 word holds ``32 // bits`` consecutive K values. For 3-bit,
    32 values are interleaved across 3 words (10 + split + 10 + split + 10).
  * ``qzeros``: ``int32[ceil(K / group_size), N * bits / 32]`` — per-group
    zero points **minus one** (a historical quirk of the format), packed
    along the N (output-feature) axis with the same bit layout.
  * ``scales``: ``fp16[ceil(K / group_size), N]``.
  * ``g_idx``:  ``int32[K]`` — group index of each input feature (non-trivial
    when quantized with activation reordering / ``desc_act``).

Dequantization: ``W[k, n] = scales[g_idx[k], n] * (w_q[k, n] - zero[g_idx[k], n])``
where ``zero = (unpacked_qzeros + 1) & maxq`` for bits in {2, 4, 8} and
``zero = (unpacked_qzeros & 0x7) + 1`` (no re-mask) for 3-bit.
"""

from __future__ import annotations

import numpy as np

SUPPORTED_BITS = (2, 3, 4, 8)


def _check_bits(bits: int) -> None:
    if bits not in SUPPORTED_BITS:
        raise NotImplementedError(f"Only {SUPPORTED_BITS} bits are supported, got {bits}.")


def _pack_cols_pow2(values: np.ndarray, bits: int) -> np.ndarray:
    """Pack ``values`` [K, ...] (K % (32 // bits) == 0) along axis 0 for bits
    in {2, 4, 8} -> [K * bits / 32, ...] uint32."""
    pack = 32 // bits
    k = values.shape[0]
    if k % pack:
        raise ValueError(f"axis length {k} not divisible by {pack}")
    v = values.reshape(k // pack, pack, *values.shape[1:]).astype(np.uint32)
    shifts = (bits * np.arange(pack, dtype=np.uint32)).reshape(
        (1, pack) + (1,) * (values.ndim - 1)
    )
    return np.bitwise_or.reduce(v << shifts, axis=1)


def _unpack_cols_pow2(packed: np.ndarray, bits: int) -> np.ndarray:
    pack = 32 // bits
    r = packed.shape[0]
    shifts = (bits * np.arange(pack, dtype=np.uint32)).reshape(
        (1, pack) + (1,) * (packed.ndim - 1)
    )
    mask = np.uint32((1 << bits) - 1)
    vals = (packed.astype(np.uint32)[:, None] >> shifts) & mask
    return vals.reshape(r * pack, *packed.shape[1:])


def _pack_cols_3bit(values: np.ndarray) -> np.ndarray:
    """3-bit packing: 32 values -> 3 uint32 words.

    word0: v0..v9 at bits 0,3,..,27; v10 bits[1:0] at 30..31
    word1: v10 bit[2] at 0; v11..v20 at bits 1,4,..,28; v21 bit[0] at 31
    word2: v21 bits[2:1] at 0..1; v22..v31 at bits 2,5,..,29
    """
    k = values.shape[0]
    if k % 32:
        raise ValueError(f"axis length {k} not divisible by 32")
    v = values.reshape(k // 32, 32, *values.shape[1:]).astype(np.uint32) & np.uint32(7)
    out = np.zeros((k // 32, 3) + values.shape[1:], dtype=np.uint32)
    for j in range(10):
        out[:, 0] |= v[:, j] << np.uint32(3 * j)
    out[:, 0] |= v[:, 10] << np.uint32(30)
    out[:, 1] |= v[:, 10] >> np.uint32(2)
    for j in range(10):
        out[:, 1] |= v[:, 11 + j] << np.uint32(3 * j + 1)
    out[:, 1] |= v[:, 21] << np.uint32(31)
    out[:, 2] |= (v[:, 21] >> np.uint32(1)) & np.uint32(0x3)
    for j in range(10):
        out[:, 2] |= v[:, 22 + j] << np.uint32(3 * j + 2)
    return out.reshape((k // 32 * 3,) + values.shape[1:])


def _unpack_cols_3bit(packed: np.ndarray) -> np.ndarray:
    r = packed.shape[0]
    if r % 3:
        raise ValueError(f"3-bit packed axis length {r} not divisible by 3")
    w = packed.astype(np.uint32).reshape(r // 3, 3, *packed.shape[1:])
    v = np.zeros((r // 3, 32) + packed.shape[1:], dtype=np.uint32)
    for j in range(10):
        v[:, j] = (w[:, 0] >> np.uint32(3 * j)) & np.uint32(7)
    v[:, 10] = ((w[:, 0] >> np.uint32(30)) | (w[:, 1] << np.uint32(2))) & np.uint32(7)
    for j in range(10):
        v[:, 11 + j] = (w[:, 1] >> np.uint32(3 * j + 1)) & np.uint32(7)
    v[:, 21] = ((w[:, 1] >> np.uint32(31)) | (w[:, 2] << np.uint32(1))) & np.uint32(7)
    for j in range(10):
        v[:, 22 + j] = (w[:, 2] >> np.uint32(3 * j + 2)) & np.uint32(7)
    return v.reshape((r // 3 * 32,) + packed.shape[1:])


def pack_along_axis0(values: np.ndarray, bits: int) -> np.ndarray:
    _check_bits(bits)
    if bits == 3:
        return _pack_cols_3bit(values)
    return _pack_cols_pow2(values, bits)


def unpack_along_axis0(packed: np.ndarray, bits: int) -> np.ndarray:
    _check_bits(bits)
    if bits == 3:
        return _unpack_cols_3bit(packed)
    return _unpack_cols_pow2(packed, bits)


def pack_qweight(intweight: np.ndarray, bits: int) -> np.ndarray:
    """Pack integer weights ``intweight[K, N]`` (values in [0, 2^bits)) into
    ``qweight int32[K * bits / 32, N]``."""
    _check_bits(bits)
    if intweight.ndim != 2:
        raise ValueError(f"intweight must be 2-D [K, N], got {intweight.shape}")
    return pack_along_axis0(intweight.astype(np.uint32), bits).view(np.int32)


def unpack_qweight(qweight: np.ndarray, bits: int) -> np.ndarray:
    """Unpack ``qweight int32[K * bits / 32, N]`` to ``uint32[K, N]``."""
    _check_bits(bits)
    return unpack_along_axis0(np.ascontiguousarray(qweight).view(np.uint32), bits)


def pack_qzeros(zeros: np.ndarray, bits: int) -> np.ndarray:
    """Pack per-group zero points ``zeros[G, N]`` into
    ``qzeros int32[G, N * bits / 32]``. Stores ``zeros - 1`` (format quirk)."""
    _check_bits(bits)
    if zeros.ndim != 2:
        raise ValueError(f"zeros must be 2-D [G, N], got {zeros.shape}")
    stored = (zeros.astype(np.int64) - 1).astype(np.uint32)  # wraps for zero == 0
    packed = pack_along_axis0(stored.T, bits).T
    return np.ascontiguousarray(packed).view(np.int32)


def unpack_qzeros(qzeros: np.ndarray, bits: int) -> np.ndarray:
    """Unpack ``qzeros`` to effective zero points ``uint32[G, N]``: for
    2/4/8-bit the +1 is applied then masked to ``bits``; for 3-bit the +1 is
    not re-masked."""
    _check_bits(bits)
    stored = unpack_along_axis0(np.ascontiguousarray(qzeros).view(np.uint32).T, bits).T
    if bits == 3:
        return (stored & np.uint32(7)) + np.uint32(1)
    maxq = np.uint32((1 << bits) - 1)
    return (stored + np.uint32(1)) & maxq


def dequantize(
    qweight: np.ndarray,
    qzeros: np.ndarray,
    scales: np.ndarray,
    g_idx: np.ndarray | None,
    bits: int,
    dtype=np.float32,
) -> np.ndarray:
    """Golden dequantization of checkpoint tensors: ``W[K, N]`` such that
    ``y = x @ W``."""
    w_q = unpack_qweight(qweight, bits).astype(np.int64)
    zeros = unpack_qzeros(qzeros, bits).astype(np.int64)
    k = w_q.shape[0]
    if g_idx is None:
        group_size = k // scales.shape[0] if scales.shape[0] else k
        g_idx = np.arange(k) // group_size
    g_idx = np.asarray(g_idx).astype(np.int64)
    s = scales.astype(np.float64)[g_idx]
    z = zeros[g_idx]
    return (s * (w_q - z)).astype(dtype)


def quantize_weight_rtn(
    w: np.ndarray, scales: np.ndarray, zeros: np.ndarray, g_idx: np.ndarray, bits: int
) -> np.ndarray:
    """Round ``w[K, N]`` to the integer grid given per-group params:
    ``intweight = clip(rint(w / scale + zero), 0, 2^bits - 1)``, in float64."""
    maxq = (1 << bits) - 1
    s = scales.astype(np.float64)[g_idx]
    z = zeros.astype(np.float64)[g_idx]
    q = np.rint(w.astype(np.float64) / s + z)
    return np.clip(q, 0, maxq).astype(np.uint32)


def pack_layer(
    w: np.ndarray,
    scales: np.ndarray,
    zeros: np.ndarray,
    g_idx: np.ndarray | None,
    bits: int,
    group_size: int,
) -> dict:
    """Full layer pack: fp weights ``w[K, N]`` + solver outputs -> checkpoint
    tensors. ``scales``/``zeros`` are [G, N]; returns a dict of np arrays."""
    k, n = w.shape
    if g_idx is None:
        gs = group_size if group_size != -1 else k
        g_idx = (np.arange(k) // gs).astype(np.int32)
    intweight = quantize_weight_rtn(w, scales, zeros, g_idx, bits)
    return {
        "qweight": pack_qweight(intweight, bits),
        "qzeros": pack_qzeros(np.rint(zeros).astype(np.int64), bits),
        "scales": scales.astype(np.float16),
        "g_idx": np.asarray(g_idx, dtype=np.int32),
    }


__all__ = [
    "SUPPORTED_BITS",
    "quantize_weight_rtn",
    "pack_layer",
    "pack_qweight",
    "unpack_qweight",
    "pack_qzeros",
    "unpack_qzeros",
    "dequantize",
    "pack_along_axis0",
    "unpack_along_axis0",
]
