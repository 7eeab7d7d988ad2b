"""Anti-spam text squeezing: drop repetitive or space-heavy chunks.

Re-implements the reference's cheap predictor pipeline
(compact_lang_det_impl.cc:541-971): a 12-bit rolling-hash character
predictor drives three operations on span buffers:

  - cheap_squeeze_trigger_test: should the whole document be re-scanned
    with squeezing on? (>=25% spaces or >=67% predicted in first 256B)
  - cheap_squeeze: drop 48-byte chunks that are >=25% spaces or >=40%
    predicted, splicing at spaces.
  - cheap_rep_words: drop words with more than half their bytes predicted.

These guard the scoring tables from boilerplate/spam; they run on the host
(inherently sequential prediction state) ahead of device scoring.
"""
from __future__ import annotations

import numpy as np

PREDICTION_TABLE_SIZE = 4096      # 12-bit hash (kPredictionTableSize)
CHUNK_SIZE = 48                   # kChunksizeDefault
SPACES_THRESH_PERCENT = 25        # kSpacesThreshPercent
PREDICT_THRESH_PERCENT = 40       # kPredictThreshPercent
SPACES_TRIGGER_PERCENT = 25       # kSpacesTriggerPercent
PREDICT_TRIGGER_PERCENT = 67      # kPredictTriggerPercent
TEST_LEN = 256                    # kCheapSqueezeTestLen
TEST_THRESH = 4096                # kCheapSqueezeTestThresh


def count_predicted_bytes(buf: bytes, start: int, length: int,
                          hash_state: list, tbl: np.ndarray) -> int:
    """Bytes whose UTF-8 character was correctly predicted by the rolling
    12-bit-hash table (CountPredictedBytes, compact_lang_det_impl.cc:541)."""
    p_count = 0
    h = hash_state[0]
    i = start
    limit = start + length
    while i < limit:
        c = buf[i]
        incr = 1
        if c < 0xC0:
            pass
        elif (c & 0xE0) == 0xC0:
            c = (c << 8) | buf[i + 1]
            incr = 2
        elif (c & 0xF0) == 0xE0:
            c = (c << 16) | (buf[i + 1] << 8) | buf[i + 2]
            incr = 3
        else:
            c = (c << 24) | (buf[i + 1] << 16) | (buf[i + 2] << 8) | buf[i + 3]
            incr = 4
        i += incr
        if tbl[h] == c:
            p_count += incr
        tbl[h] = c
        h = ((h << 4) ^ c) & 0xFFF
    hash_state[0] = h
    return p_count


def count_spaces4(buf: bytes, start: int, length: int) -> int:
    """Space count over 4-byte groups, ignoring the odd tail
    (CountSpaces4, compact_lang_det_impl.cc:586)."""
    n = length & ~3
    a = np.frombuffer(buf[start:start + n], dtype=np.uint8)
    return int((a == 0x20).sum())


def cheap_squeeze_trigger_test(buf: bytes, src_len: int,
                               testsize: int = TEST_LEN) -> bool:
    """CheapSqueezeTriggerTest (compact_lang_det_impl.cc:952)."""
    if src_len < testsize:
        return False
    space_thresh = (testsize * SPACES_TRIGGER_PERCENT) // 100
    predict_thresh = (testsize * PREDICT_TRIGGER_PERCENT) // 100
    if count_spaces4(buf, 0, testsize) >= space_thresh:
        return True
    tbl = np.zeros(PREDICTION_TABLE_SIZE, dtype=np.int64)
    return count_predicted_bytes(buf, 0, testsize, [0], tbl) >= predict_thresh


MAX_SPACE_SCAN = 32  # kMaxSpaceScan


def _backscan_to_space(b: bytearray, dst: int) -> int:
    """BackscanToSpace (compact_lang_det_impl.cc:491-503)."""
    limit = min(dst, MAX_SPACE_SCAN)
    for n in range(limit):
        if b[dst - n - 1] == 0x20:
            return n
    for n in range(limit):
        if (b[dst - n] & 0xC0) != 0x80:
            return n
    return 0


def _forwardscan_to_space(b: bytearray, src: int, limit: int) -> int:
    """ForwardscanToSpace (compact_lang_det_impl.cc:509-521)."""
    limit = min(limit, MAX_SPACE_SCAN)
    for n in range(limit):
        if b[src + n] == 0x20:
            return n + 1
    for n in range(limit):
        if (b[src + n] & 0xC0) != 0x80:
            return n
    return 0


def cheap_squeeze(buf: bytes, src_len: int,
                  chunksize: int = CHUNK_SIZE) -> bytes:
    """Drop space-heavy / well-predicted chunks in place
    (CheapSqueezeInplace, compact_lang_det_impl.cc:785-865).

    buf must extend at least 4 bytes past src_len (span tail pad).
    Returns the squeezed text bytes (length == new text_bytes). Pointer
    arithmetic mirrors the reference's in-place dst<=src compaction so the
    no-space backscan fallback reads the same bytes."""
    b = bytearray(buf[:src_len + 4])
    hash_state = [0]
    tbl = np.zeros(PREDICTION_TABLE_SIZE, dtype=np.int64)
    space_thresh = (chunksize * SPACES_THRESH_PERCENT) // 100
    predict_thresh = (chunksize * PREDICT_THRESH_PERCENT) // 100
    skipping = False
    src = 0
    dst = 0
    while src < src_len:
        length = min(chunksize, src_len - src)
        while (b[src + length] & 0xC0) == 0x80:  # UTF-8 boundary
            length += 1
        space_n = count_spaces4(b, src, length)
        predb_n = count_predicted_bytes(b, src, length, hash_state, tbl)
        if space_n >= space_thresh or predb_n >= predict_thresh:
            if not skipping:
                # keep->skip transition: back up to a space
                dst -= _backscan_to_space(b, dst)
                if dst == 0:
                    b[0] = 0x20  # force a leading space
                    dst = 1
                skipping = True
        else:
            take_from = src
            take_len = length
            if skipping:
                # skip->keep transition: forward to a space
                n = _forwardscan_to_space(b, src, length)
                take_from += n
                take_len -= n
                skipping = False
            if take_len > 0:
                b[dst:dst + take_len] = b[take_from:take_from + take_len]
                dst += take_len
        src += length
    return bytes(b[:dst])


def cheap_squeeze_overwrite(buf: bytes, src_len: int,
                            chunksize: int = CHUNK_SIZE) -> bytes:
    """Length-preserving squeeze: overwrite dropped chunks with '.' instead
    of compacting, so span-buffer offsets still map back to the original
    text for the result-chunk vector (CheapSqueezeInplaceOverwrite,
    compact_lang_det_impl.cc:869-940)."""
    b = bytearray(buf[:src_len + 4])
    hash_state = [0]
    tbl = np.zeros(PREDICTION_TABLE_SIZE, dtype=np.int64)
    space_thresh = (chunksize * SPACES_THRESH_PERCENT) // 100
    predict_thresh = (chunksize * PREDICT_THRESH_PERCENT) // 100
    skipping = False
    src = 1  # always keep the leading space
    while src < src_len:
        length = min(chunksize, src_len - src)
        while (b[src + length] & 0xC0) == 0x80:  # UTF-8 boundary
            length += 1
        space_n = count_spaces4(b, src, length)
        predb_n = count_predicted_bytes(b, src, length, hash_state, tbl)
        if space_n >= space_thresh or predb_n >= predict_thresh:
            if not skipping:
                # keep->skip transition: dot back to a space
                n = _backscan_to_space(b, src)
                b[src - n:src] = b"." * n
                skipping = True
            b[src:src + length] = b"." * length
            b[src + length - 1] = 0x20
        elif skipping:
            # skip->keep transition: dot forward to a space
            n = _forwardscan_to_space(b, src, length)
            if n > 1:
                b[src:src + n - 1] = b"." * (n - 1)
            skipping = False
        src += length
    return bytes(b[:src_len])


def cheap_rep_words(buf: bytes, src_len: int, hash_state: list,
                    tbl: np.ndarray) -> bytes:
    """Drop words with more than half their bytes predicted
    (CheapRepWordsInplace, compact_lang_det_impl.cc:610-692). The hash and
    prediction table persist across spans of one document."""
    dst = bytearray()
    h = hash_state[0]
    word_dst = 0           # index in dst of current word start
    good_predict = 0
    word_len = 0
    src = 0
    while src < src_len:
        c = buf[src]
        dst.append(c)
        if c == 0x20:
            if good_predict * 2 > word_len:
                del dst[word_dst:]
            word_dst = len(dst)
            good_predict = 0
            word_len = 0
        incr = 1
        if c < 0xC0:
            pass
        elif (c & 0xE0) == 0xC0:
            dst.append(buf[src + 1])
            c = (c << 8) | buf[src + 1]
            incr = 2
        elif (c & 0xF0) == 0xE0:
            dst.extend(buf[src + 1:src + 3])
            c = (c << 16) | (buf[src + 1] << 8) | buf[src + 2]
            incr = 3
        else:
            dst.extend(buf[src + 1:src + 4])
            c = ((c << 24) | (buf[src + 1] << 16) | (buf[src + 2] << 8) |
                 buf[src + 3])
            incr = 4
        src += incr
        word_len += incr
        if tbl[h] == c:
            good_predict += incr
        tbl[h] = c
        h = ((h << 4) ^ c) & 0xFFF
    hash_state[0] = h
    return bytes(dst)


def cheap_rep_words_overwrite(buf: bytes, src_len: int, hash_state: list,
                              tbl: np.ndarray) -> bytes:
    """Length-preserving variant: overwrite well-predicted words with '.'
    so result-vector offset maps survive (CheapRepWordsInplaceOverwrite,
    compact_lang_det_impl.cc:696-770)."""
    b = bytearray(buf[:src_len])
    h = hash_state[0]
    word_start = 0
    good_predict = 0
    word_len = 0
    src = 0
    while src < src_len:
        c = b[src]
        if c == 0x20:
            if good_predict * 2 > word_len:
                b[word_start:src] = b"." * (src - word_start)
            word_start = src + 1
            good_predict = 0
            word_len = 0
        incr = 1
        if c < 0xC0:
            pass
        elif (c & 0xE0) == 0xC0:
            c = (c << 8) | b[src + 1]
            incr = 2
        elif (c & 0xF0) == 0xE0:
            c = (c << 16) | (b[src + 1] << 8) | b[src + 2]
            incr = 3
        else:
            c = ((c << 24) | (b[src + 1] << 16) | (b[src + 2] << 8) |
                 b[src + 3])
            incr = 4
        src += incr
        word_len += incr
        if tbl[h] == c:
            good_predict += incr
        tbl[h] = c
        h = ((h << 4) ^ c) & 0xFFF
    hash_state[0] = h
    return bytes(b)
