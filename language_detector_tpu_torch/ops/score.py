"""Batched device scoring: resolved hits -> per-chunk summaries.

The numeric core of detection (ScoreOneChunk totes + top-2 + reliability,
scoreonescriptspan.cc:208-302, cldutil.cc:553-605) over the chunk-major
flat wire the native packer builds (packer.cc ldt_pack_flat_begin/finish):
langprob decode, chunk totes over 256 per-script languages, group-in-use
top-2, and the reliability formulas, packed into one u32 word per chunk.

This module is the plain PyTorch version of that step: tensor ops that run
on any device, bit-identical to the reference package's XLA program
(language_detector_tpu/ops/score.py score_chunks_impl). The engine serves
through the CUDA kernel in ops/kernels.py; this version is what the kernel
is held against, and what ops.kernels.score_chunks runs for CPU tensors.

Types: torch's uint32 support is partial, so u32 wire planes travel as
int32 tensors holding the same bits, u16 planes as int16; every bit
operation widens to int64 first. Out-of-range gathers clamp explicitly,
as XLA clamps them.

The per-document epilogue runs on the host in native/epilogue.cc.
"""
from __future__ import annotations

import numpy as np
import torch

from .device_tables import DeviceTables

# keep in sync with packer.cc kHintBase / native HINT_BASE: wire idx
# values at or above this address the per-batch hint_lp window
HINT_BASE = 40960

# cmeta bit layout (keep in sync with packer.cc pack_resolve_one_doc):
#   cbytes(16) | grams(12) << 16 | side << 28 | real << 29
CM2_GRAMS_SHIFT = 16
CM2_SIDE_SHIFT = 28
CM2_REAL_SHIFT = 29
# output word: lang1(10) | s1(14) << 10 | rel(7) << 24 | real << 31
OUTW_S1_SHIFT = 10
OUTW_REL_SHIFT = 24
OUTW_REAL_SHIFT = 31
# second output word (result-vector batches only):
#   lang2(10) | rd(7) << 10 | rs(7) << 17
OUTW2_RD_SHIFT = 10
OUTW2_RS_SHIFT = 17

# wire planes that go to the device, with the torch dtype that carries
# their bits (u16 -> int16, u32 -> int32); k_iota only carries K
_WIRE_DTYPES = {np.dtype(np.uint16): np.int16,
                np.dtype(np.uint32): np.int32}


def wire_to_device(wire: dict, device) -> dict:
    """numpy flat wire (pack_chunks_native) -> dict of tensors on device.
    Unsigned planes keep their bits in the signed type of their width;
    k_iota is replaced by the plain int K (its length is all it says).

    On a CUDA device every plane copies asynchronously on the caller's
    current stream: planes that are pinned already (a staging lease's
    arrays) copy straight from their pages, the others through a pinned
    copy that PyTorch's host allocator keeps until the transfer has read
    it. The dict then also holds "copied", a CUDA event recorded after
    the last copy: the host arrays may be written again only once it has
    completed (native.StagingLease.release waits for it). On the CPU
    the tensors share the arrays' memory."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    out = {}
    for name, a in wire.items():
        if name == "k_iota":
            out["K"] = int(np.asarray(a).shape[0])
            continue
        a = np.ascontiguousarray(a)
        view = _WIRE_DTYPES.get(a.dtype)
        if view is not None:
            a = a.view(view)
        t = torch.from_numpy(a)
        if cuda:
            if not t.is_pinned():
                t = t.pin_memory()
            out[name] = t.to(device, non_blocking=True)
        else:
            out[name] = t.to(device)
    if cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        out["copied"] = ev
    return out


def _u(t: torch.Tensor, bits: int) -> torch.Tensor:
    """Signed carrier of an unsigned plane -> its unsigned value, int64."""
    return t.to(torch.int64) & ((1 << bits) - 1)


def chunk_starts(cnsl: torch.Tensor) -> torch.Tensor:
    """[D, Gs] u8 slot counts -> flat [G] int64 chunk starts: the
    exclusive cumsum over each shard row (slots concatenate in chunk
    order), as the reference program derives them."""
    c = cnsl.to(torch.int64)
    return (torch.cumsum(c, dim=-1) - c).reshape(-1)


def _reliability_delta(s1, s2, grams):
    """cldutil.cc:553-570, integer math."""
    maxp = torch.where(grams < 8, 12 * grams, torch.full_like(grams, 100))
    thresh = torch.clamp((grams * 5) >> 3, 3, 16)
    delta = s1 - s2
    pct = torch.where(
        delta >= thresh, maxp,
        torch.where(delta <= 0, torch.zeros_like(delta),
                    torch.minimum(maxp,
                                  torch.div(100 * delta, thresh,
                                            rounding_mode="floor"))))
    return pct


def _reliability_expected(actual, expected):
    """cldutil.cc:587-605. f32 ratio math mirroring the scalar engine:
    every intermediate rounds to float32, the int cast truncates."""
    hi = torch.maximum(actual, expected).to(torch.float32)
    lo = torch.minimum(actual, expected).to(torch.float32)
    ratio = hi / torch.clamp(lo, min=1.0)
    pct = (torch.tensor(100.0, dtype=torch.float32) *
           (torch.tensor(4.0, dtype=torch.float32) - ratio) /
           torch.tensor(2.5, dtype=torch.float32)).to(torch.int64)
    c100 = torch.full_like(pct, 100)
    pct = torch.where(ratio <= 1.5, c100,
                      torch.where(ratio > 4.0, torch.zeros_like(pct), pct))
    pct = torch.where(expected == 0, c100, pct)
    return torch.where(actual == 0,
                       torch.where(expected == 0, c100,
                                   torch.zeros_like(pct)),
                       pct)


def _lscript4(script):
    return torch.where(
        script == 1, 0,
        torch.where(script == 3, 1, torch.where(script == 6, 2, 3)))


def _clip_index(i: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(i, 0, n - 1)


def _chunk_out_word(dt: DeviceTables, scores, cbytes, grams, side, real,
                    script, group_scores=None, full_out=False,
                    prior=None):
    """[G, 256] int64 chunk totes + chunk meta -> packed chunk words:
    group-in-use top-2 (tote.cc:30-100), reliability (cldutil.cc:
    553-605), output word OUTW_* layout. Returns [G] int64 word1, or
    [G, 2] when full_out.

    group_scores: pre-whack scores for the group-in-use mask (the scalar
    tote marks groups in use at ADD time; a hint whack zeroes the score
    without retiring the group). prior: optional [G, 256] hint-prior
    plane added to languages the chunk already scored, post-whack and
    pre-top-2."""
    G = scores.shape[0]
    dev = scores.device
    iota256 = torch.arange(256, dtype=torch.int64, device=dev)
    if group_scores is None:
        group_scores = scores
    if prior is not None:
        scores = torch.where(scores > 0, scores + prior, scores)
    groups = (group_scores > 0).reshape(G, 64, 4).any(dim=-1)
    slot_in_use = groups.repeat_interleave(4, dim=-1)
    neg1 = torch.full_like(scores, -1)
    sortkey = torch.where(slot_in_use, scores * 256 + (255 - iota256), neg1)
    # max then first index of it == jnp.argmax (first occurrence)
    top1 = sortkey.max(dim=-1).values
    k1 = (sortkey == top1[:, None]).to(torch.int64).argmax(dim=-1)
    sortkey2 = torch.where(iota256[None, :] == k1[:, None], neg1, sortkey)
    top2 = sortkey2.max(dim=-1).values
    k2 = (sortkey2 == top2[:, None]).to(torch.int64).argmax(dim=-1)
    zero = torch.zeros_like(top1)
    s1 = torch.where(top1 >= 0, top1 >> 8, zero)
    s2 = torch.where(top2 >= 0, top2 >> 8, zero)
    k1 = torch.where(top1 >= 0, k1, zero)
    k2 = torch.where(top2 >= 0, k2, zero)

    p2l = dt.plang_to_lang.to(torch.int64)
    lang1 = p2l[side, k1]
    lang2 = p2l[side, k2]

    actual_kb = torch.where(
        cbytes > 0,
        torch.div(s1 << 10, torch.clamp(cbytes, min=1),
                  rounding_mode="floor"),
        zero)
    exp = dt.expected_score.to(torch.int64)
    expected_kb = exp[_clip_index(lang1, exp.shape[0]), _lscript4(script)]
    rd = _reliability_delta(s1, s2, grams)
    close = dt.close_set.to(torch.int64)
    c1 = close[_clip_index(lang1, close.shape[0])]
    c2 = close[_clip_index(lang2, close.shape[0])]
    rd = torch.where((c1 != 0) & (c1 == c2), torch.full_like(rd, 100), rd)
    rs = _reliability_expected(actual_kb, expected_kb)
    crel = torch.minimum(rd, rs)

    m32 = 0xFFFFFFFF
    word1 = ((lang1 & m32) |
             (torch.clamp(s1, 0, 0x3FFF) << OUTW_S1_SHIFT) |
             (torch.clamp(crel, 0, 127) << OUTW_REL_SHIFT) |
             ((real & m32) << OUTW_REAL_SHIFT)) & m32
    if not full_out:
        return word1
    word2 = ((lang2 & m32) |
             (torch.clamp(rd, 0, 127) << OUTW2_RD_SHIFT) |
             (torch.clamp(rs, 0, 127) << OUTW2_RS_SHIFT)) & m32
    return torch.stack([word1, word2], dim=-1)


def score_chunks_plain(dt: DeviceTables, p: dict,
                       full_out: bool = False) -> torch.Tensor:
    """Score a chunk-major flat wire (wire_to_device layout) into packed
    chunk words: [G] int32 word1, or [G, 2] int32 when full_out (the u32
    bits in int32; read them back with .numpy().view(np.uint32)).

    p:
      idx       [D, N] or [N]  u16 bits  cat_ind2 index per slot; values
                                         >= HINT_BASE address hint_lp
      cnsl      [D, Gs]        u8        chunk slot counts
      cmeta     [G]            u32 bits  chunk meta (CM2_* layout)
      cscript   [G]            u8        chunk ULScript
      cwhack    [G] or [.., 1] u16 bits  whack row, or a 1-wide dummy
      hint_lp   [H]            u32 bits  hint-prior langprob window
      whack_tbl [W, 2, 256]    u8        close-set whack masks per side
      K         int                      chunk row width (slot bucket)
      cprior    [G]            u16 bits  OPTIONAL prior_tbl row per chunk
      prior_tbl [P, 2, 256]    u8        OPTIONAL per-doc prior planes
    """
    dev = dt.device
    idxf = _u(p["idx"].reshape(-1), 16)
    N = idxf.shape[0]
    cstart = chunk_starts(p["cnsl"])
    cnsl = p["cnsl"].reshape(-1).to(torch.int64)
    cmeta = _u(p["cmeta"].reshape(-1), 32)
    G = cstart.shape[0]
    K = int(p["K"])

    ki = torch.arange(K, dtype=torch.int64, device=dev)
    valid = ki[None, :] < cnsl[:, None]
    gidx = torch.clamp(cstart[:, None] + ki[None, :], 0, N - 1)
    raw = idxf[gidx]
    hint_lp = _u(p["hint_lp"].reshape(-1), 32)
    H = hint_lp.shape[0]
    cat_ind2 = _u(dt.cat_ind2, 32)
    lp_tbl = cat_ind2[torch.clamp(raw, 0, cat_ind2.shape[0] - 1)]
    lp_hint = hint_lp[torch.clamp(raw - HINT_BASE, 0, H - 1)]
    lp = torch.where(valid,
                     torch.where(raw >= HINT_BASE, lp_hint, lp_tbl),
                     torch.zeros_like(raw))

    # decode + chunk totes: three (pslang, qprob) planes per slot,
    # summed per language with an integer scatter-add (exact, any order)
    ps = torch.stack([(lp >> 8) & 0xFF, (lp >> 16) & 0xFF,
                      (lp >> 24) & 0xFF], dim=-1)              # [G, K, 3]
    row = lp & 0xFF
    lg3 = dt.lg_prob3.to(torch.int64)
    q = lg3[torch.clamp(row, 0, lg3.shape[0] - 1)]             # [G, K, 3]
    contrib = torch.where(valid[..., None] & (ps > 0), q,
                          torch.zeros_like(q))
    scores = torch.zeros((G, 256), dtype=torch.int64, device=dev)
    scores.scatter_add_(1, ps.reshape(G, -1), contrib.reshape(G, -1))

    cbytes = cmeta & 0xFFFF
    grams = (cmeta >> CM2_GRAMS_SHIFT) & 0xFFF
    side = (cmeta >> CM2_SIDE_SHIFT) & 1
    real = (cmeta >> CM2_REAL_SHIFT) & 1
    script = p["cscript"].reshape(-1).to(torch.int64)

    # close-set whacks (ZeroPSLang, scoreonescriptspan.cc:144-151):
    # zero hinted-out rival languages AFTER all tote adds; hint-free
    # batches ship a 1-wide dummy whack lane and skip the gather
    if p["cwhack"].shape[-1] == 1:
        whacked = scores
    else:
        cwhack = _u(p["cwhack"].reshape(-1), 16)
        wt = p["whack_tbl"]
        wmask = wt[torch.clamp(cwhack, 0, wt.shape[0] - 1), side]
        whacked = torch.where(wmask > 0, torch.zeros_like(scores), scores)
    if "cprior" in p:
        cprior = _u(p["cprior"].reshape(-1), 16)
        pt = p["prior_tbl"]
        prior = pt[torch.clamp(cprior, 0, pt.shape[0] - 1),
                   side].to(torch.int64)
    else:
        prior = None
    out = _chunk_out_word(dt, whacked, cbytes, grams, side, real, script,
                          group_scores=scores, full_out=full_out,
                          prior=prior)
    # u32 bits -> int32 carrier
    return (out - ((out >> 31) << 32)).to(torch.int32)


def words_to_numpy(out: torch.Tensor) -> np.ndarray:
    """int32 word tensor (any device) -> host np.uint32 array."""
    return out.cpu().numpy().view(np.uint32)


def unpack_chunks_out2(out2: np.ndarray) -> np.ndarray:
    """Second output word [G] u32 -> [G, 3] int32 (lang2, rd, rs)."""
    out2 = np.asarray(out2).reshape(-1)
    lang2 = (out2 & 0x3FF).astype(np.int32)
    rd = ((out2 >> OUTW2_RD_SHIFT) & 0x7F).astype(np.int32)
    rs = ((out2 >> OUTW2_RS_SHIFT) & 0x7F).astype(np.int32)
    return np.stack([lang2, rd, rs], axis=-1)


def unpack_chunks_out(out: np.ndarray, cmeta: np.ndarray) -> np.ndarray:
    """Device output [G] u32 + host chunk meta -> the flat [G, 5] int32
    chunk-summary layout the flat epilogue consumes."""
    out = np.asarray(out).reshape(-1)
    cmeta = cmeta.reshape(-1)
    lang1 = (out & 0x3FF).astype(np.int32)
    s1 = ((out >> OUTW_S1_SHIFT) & 0x3FFF).astype(np.int32)
    rel = ((out >> OUTW_REL_SHIFT) & 0x7F).astype(np.int32)
    real = ((out >> OUTW_REAL_SHIFT) & 1).astype(np.int32)
    cbytes = (cmeta & 0xFFFF).astype(np.int32)
    return np.stack([lang1, cbytes, s1, rel, real], axis=-1)
