"""N-gram fingerprint functions, vectorized with numpy.

Bit-for-bit compatible with the reference hashes (cldutil_shared.cc:107-386):
the scoring tables in the artifact are keyed by these exact fingerprints, so
parity is mandatory. All functions take a span byte buffer plus arrays of
(pos, len) and return fingerprints for every gram at once.

Buffer contract (getonescriptspan.cc:678,1016-1021): spans start with one
space and end with "   \\0", so pos-1 and pos+len are always readable and
32-bit loads may overshoot up to 3 bytes past a gram.
"""
from __future__ import annotations

import numpy as np

_PRE_SPACE = np.uint32(0x00004444)   # cldutil_shared.cc:41
_POST_SPACE = np.uint32(0x44440000)  # cldutil_shared.cc:42

# Little-endian masks for 0..24 bytes picked up as uint32s (kWordMask0)
_WORD_MASK = np.array([0xFFFFFFFF, 0x000000FF, 0x0000FFFF, 0x00FFFFFF],
                      dtype=np.uint32)


def _load32(buf: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Unaligned little-endian 32-bit load at each pos (port.h semantics)."""
    b = buf.astype(np.uint32)
    return (b[pos] | (b[pos + 1] << np.uint32(8)) |
            (b[pos + 2] << np.uint32(16)) | (b[pos + 3] << np.uint32(24)))


def _prepost(buf: np.ndarray, pos: np.ndarray, length: np.ndarray) -> np.ndarray:
    """Word-boundary indicator bits from surrounding spaces."""
    pre = np.where(buf[pos - 1] == 0x20, _PRE_SPACE, np.uint32(0))
    post = np.where(buf[pos + length] == 0x20, _POST_SPACE, np.uint32(0))
    return pre | post


def quad_hash_v2(buf: np.ndarray, pos: np.ndarray,
                 length: np.ndarray) -> np.ndarray:
    """QuadHashV2 (cldutil_shared.cc:196): 1-12 bytes -> 32-bit fingerprint."""
    pos = np.asarray(pos, dtype=np.int64)
    length = np.asarray(length, dtype=np.int64)
    prepost = _prepost(buf, pos, length)
    mask = _WORD_MASK[length & 3]

    w0_a = _load32(buf, pos) & mask                    # 1..4 bytes
    w0_a ^= w0_a >> np.uint32(3)

    w0_b = _load32(buf, pos)                           # 5..8 bytes
    w0_b ^= w0_b >> np.uint32(3)
    w1_b = _load32(buf, pos + 4) & mask
    w1_b ^= w1_b << np.uint32(4)

    w1_c = _load32(buf, pos + 4)                       # 9..12 bytes
    w1_c ^= w1_c << np.uint32(4)
    w2_c = _load32(buf, pos + 8) & mask
    w2_c ^= w2_c << np.uint32(2)

    h4 = w0_a ^ prepost
    h8 = (w0_b ^ prepost) + w1_b
    h12 = (w0_b ^ prepost) + w1_c + w2_c
    out = np.where(length <= 4, h4, np.where(length <= 8, h8, h12))
    return np.where(length == 0, np.uint32(0), out)


# Per-4-byte-group mixing for OctaHash40 (cldutil_shared.cc:234-333):
# group g of the word is xor-shifted by these (negative = left shift).
_OCTA_SHIFTS = (3, -4, -2, 8, 4, 6)


def octa_hash40(buf: np.ndarray, pos: np.ndarray,
                length: np.ndarray) -> np.ndarray:
    """OctaHash40 (cldutil_shared.cc:348): 1-24 bytes -> 40-bit fingerprint.

    Low 32ish bits are the mixed word; bits 32-39 are a byte-sum checksum.
    Accumulation is 64-bit (the reference uses uint64 intermediates).
    """
    pos = np.asarray(pos, dtype=np.int64)
    length = np.asarray(length, dtype=np.int64)
    n = len(pos)
    prepost = _prepost(buf, pos, length).astype(np.uint64)
    mask = _WORD_MASK[length & 3].astype(np.uint64)
    ngroups = ((length - 1) >> 2).clip(0, 5)  # switch arm; >=21 bytes cap

    word0 = np.zeros(n, dtype=np.uint64)
    csum = np.zeros(n, dtype=np.uint64)
    for g, shift in enumerate(_OCTA_SHIFTS):
        active = ngroups >= g
        last = ngroups == g
        # Groups beyond the gram are discarded; clip their loads so short
        # test buffers without the full span tail pad stay in bounds.
        gpos = np.minimum(pos + 4 * g, len(buf) - 4)
        w = _load32(buf, gpos).astype(np.uint64)
        w = np.where(last, w & mask, w)
        csum = np.where(active, csum + w, csum)
        if shift > 0:
            mixed = w ^ (w >> np.uint64(shift))
        else:
            mixed = w ^ (w << np.uint64(-shift))
        word0 = np.where(active, word0 + mixed, word0)

    csum = csum + (csum >> np.uint64(17))
    csum = csum + (csum >> np.uint64(9))
    csum = (csum & np.uint64(0xFF)) << np.uint64(32)
    out = (word0 ^ prepost) + csum
    return np.where(length == 0, np.uint64(0), out)


def bi_hash_v2(buf: np.ndarray, pos: np.ndarray,
               length: np.ndarray) -> np.ndarray:
    """BiHashV2 (cldutil_shared.cc:107): CJK bigram, 1-8 bytes, no pre/post."""
    pos = np.asarray(pos, dtype=np.int64)
    length = np.asarray(length, dtype=np.int64)
    mask = _WORD_MASK[length & 3]

    w0_a = _load32(buf, pos) & mask
    w0_a ^= w0_a >> np.uint32(3)

    w0_b = _load32(buf, pos)
    w0_b ^= w0_b >> np.uint32(3)
    w1_b = _load32(buf, pos + 4) & mask
    w1_b ^= w1_b << np.uint32(18)

    out = np.where(length <= 4, w0_a, w0_b + w1_b)
    return np.where(length == 0, np.uint32(0), out)


def pair_hash(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """PairHash (cldutil_shared.cc:384): rotate(A,13) + B for word pairs."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    return ((a >> np.uint64(13)) | (a << np.uint64(51))) + b


def quad_subscript_key(fp: np.ndarray, keymask: int,
                       bucketcount: int) -> tuple[np.ndarray, np.ndarray]:
    """32-bit FP -> (bucket subscript, key) (cldutil_shared.h:380-386)."""
    fp = np.asarray(fp, dtype=np.uint32)
    sub = (fp + (fp >> np.uint32(12))) & np.uint32(bucketcount - 1)
    return sub, fp & np.uint32(keymask)


def octa_subscript_key(fp: np.ndarray, keymask: int,
                       bucketcount: int) -> tuple[np.ndarray, np.ndarray]:
    """40-bit FP -> (bucket subscript, key) (cldutil_shared.h:389-397)."""
    fp = np.asarray(fp, dtype=np.uint64)
    sub = ((fp + (fp >> np.uint64(12))) &
           np.uint64(bucketcount - 1)).astype(np.uint32)
    key = (fp >> np.uint64(4)).astype(np.uint32) & np.uint32(keymask)
    return sub, key
