"""Device-resident scoring tables: the model weights as torch tensors.

Uploaded once per engine to one device (they are small: ~2MB total).
All seven n-gram tables are concatenated into ONE bucket array and ONE
indirect array; the packer resolves every probe on the host, so the
device step reads only `cat_ind2` (the resolved-slot langprobs) and the
small decode/epilogue planes — see ops/score.py and ops/kernels.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..registry import Registry
from ..tables import ScoringTables

# Kind ids (keep in sync with preprocess/pack.py)
PAD, SEED, QUAD, UNI, DELTA_OCTA, DISTINCT_OCTA, BI_DELTA, BI_DISTINCT = \
    range(8)

# kind -> probed table (None = no hash probe; UNI resolves its direct
# payload through cjkcompat's indirect array)
_KIND_TABLE = {QUAD: "quadgram", DELTA_OCTA: "deltaocta",
               DISTINCT_OCTA: "distinctocta", BI_DELTA: "cjkdeltabi",
               BI_DISTINCT: "distinctbi", UNI: "cjkcompat"}


@dataclasses.dataclass(frozen=True)
class Quad2Static:
    """Dual quadgram table geometry (host-side scalars)."""
    bucket_off: int
    size: int
    keymask: int
    ind_off: int
    size_one: int


@dataclasses.dataclass
class HostTables:
    """Host-side (numpy) view of the concatenated tables + geometry, shared
    by DeviceTables.from_host and the native resolver (packer.cc
    ldt_init_tables). cat_ind2 = cat_ind ++ per-script seed langprobs, so a
    u16 wire index addresses every possible tote add, seeds included."""
    cat_buckets: np.ndarray        # [rows, 4] u32
    cat_ind: np.ndarray            # [n] u32
    cat_ind2: np.ndarray           # [n + num_scripts] u32
    bucket_off: np.ndarray         # [8] i64 per-kind first bucket row
    size: np.ndarray               # [8] u32
    keymask: np.ndarray            # [8] u32
    ind_off: np.ndarray            # [8] i32
    size_one: np.ndarray           # [8] i32
    probes: np.ndarray             # [8] u8
    q2: "Quad2Static" = None
    q2_enabled: bool = False
    seed_ind_base: int = 0


_host_tables_cache: list = []  # [(tables, reg, HostTables)] single slot


def _pad128(n: int) -> int:
    """Round a table row count up to the SIMD width (128 lanes)."""
    return -(-n // 128) * 128


def host_tables(t: ScoringTables, reg: Registry) -> HostTables:
    if _host_tables_cache and _host_tables_cache[0][0] is t \
            and _host_tables_cache[0][1] is reg:
        return _host_tables_cache[0][2]
    tables = [t.quadgram, t.quadgram2, t.deltaocta, t.distinctocta,
              t.cjkdeltabi, t.distinctbi, t.cjkcompat]
    names = ["quadgram", "quadgram2", "deltaocta", "distinctocta",
             "cjkdeltabi", "distinctbi", "cjkcompat"]
    bucket_off, ind_off = {}, {}
    b_parts, i_parts = [], []
    row, ent = 0, 0
    for name, tbl in zip(names, tables):
        bucket_off[name] = row
        ind_off[name] = ent
        b_parts.append(tbl.buckets.reshape(-1, 4))
        i_parts.append(tbl.ind)
        row += tbl.buckets.reshape(-1, 4).shape[0]
        ent += len(tbl.ind)
    cat_buckets = np.ascontiguousarray(
        np.concatenate(b_parts, axis=0).astype(np.uint32))
    cat_ind = np.ascontiguousarray(np.concatenate(i_parts).astype(np.uint32))

    # seed block: the per-script default-language langprob the packer's
    # SEED records used to carry inline (LinearizeAll's weight-1 seed,
    # scoreonescriptspan.cc:936-964)
    from ..registry import ULSCRIPT_LATIN
    seeds = np.zeros(reg.num_scripts, np.uint32)
    for s in range(reg.num_scripts):
        seeds[s] = np.uint32(
            reg.per_script_number(ULSCRIPT_LATIN, reg.default_language(s))
            << 8)
    cat_ind2 = np.ascontiguousarray(np.concatenate([cat_ind, seeds]))
    if len(cat_ind2) > 0xFFFF:
        raise ValueError(
            f"concatenated indirect arrays ({len(cat_ind2)} entries) "
            "exceed the u16 resolved-wire index; shrink the tables or "
            "widen the wire lane")

    ko = np.zeros(8, np.int64)
    ks = np.ones(8, np.uint32)
    km = np.full(8, 0xFFFFFFFF, np.uint32)
    ki = np.zeros(8, np.int32)
    k1 = np.zeros(8, np.int32)
    kp = np.zeros(8, np.uint8)
    for kind, name in _KIND_TABLE.items():
        tbl = dict(zip(names, tables))[name]
        ko[kind] = bucket_off[name]
        ks[kind] = tbl.size
        km[kind] = tbl.keymask
        ki[kind] = ind_off[name]
        k1[kind] = tbl.size_one
        kp[kind] = kind != UNI
    q2 = t.quadgram2
    ht = HostTables(
        cat_buckets=cat_buckets, cat_ind=cat_ind, cat_ind2=cat_ind2,
        bucket_off=ko, size=ks, keymask=km, ind_off=ki, size_one=k1,
        probes=kp,
        q2=Quad2Static(bucket_off=bucket_off["quadgram2"],
                       size=int(q2.size), keymask=int(q2.keymask),
                       ind_off=ind_off["quadgram2"],
                       size_one=int(q2.size_one)),
        q2_enabled=not q2.empty and q2.size != 0,
        seed_ind_base=len(cat_ind),
    )
    _host_tables_cache.clear()
    _host_tables_cache.append((t, reg, ht))
    return ht


# The tensor planes of DeviceTables in the reference package's pytree
# leaf order (its field order, with the nested KindTables' six planes in
# place of `kind_tbl`), so index i of fingerprint() names the same plane
# in both packages.
PLANES = ("cat_buckets", "cat_ind", "cat_ind2",
          "kind_bucket_off", "kind_size", "kind_keymask", "kind_ind_off",
          "kind_size_one", "kind_probes",
          "lg_prob3", "expected_score", "lg_prob3_pad",
          "expected_score_pad", "close_set_pad", "plang_to_lang",
          "lang_rtype_default", "close_set", "closest_alt", "is_figs")

# u32 planes travel as int32 tensors (torch's uint32 support is partial):
# the bits are identical, and to_numpy() views them back as u32
_U32_PLANES = ("cat_buckets", "cat_ind", "cat_ind2", "kind_size",
               "kind_keymask")


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(a.copy()).to(device)


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    cat_buckets: torch.Tensor       # [sum sizes, 4] u32 bits (int32)
    cat_ind: torch.Tensor           # [sum inds] u32 bits (int32)
    cat_ind2: torch.Tensor          # cat_ind ++ per-script seed langprobs
    kind_bucket_off: torch.Tensor   # [8] i32 table's first row
    kind_size: torch.Tensor         # [8] u32 bits bucket count
    kind_keymask: torch.Tensor      # [8] u32 bits
    kind_ind_off: torch.Tensor      # [8] i32
    kind_size_one: torch.Tensor     # [8] i32
    kind_probes: torch.Tensor       # [8] bool
    lg_prob3: torch.Tensor          # [240, 3] uint8: 3-entry qprob decode
    expected_score: torch.Tensor    # [614, 4] int32
    # padded companions kept for plane-for-plane parity with the
    # reference tables (rows >= 240 of lg_prob3_pad replicate the clamp
    # row; the others pad with zeros)
    lg_prob3_pad: torch.Tensor      # [256, 3] uint8
    expected_score_pad: torch.Tensor  # [640, 4] int32
    close_set_pad: torch.Tensor     # [640] int32
    plang_to_lang: torch.Tensor     # [2, 256] int32 (latn, othr)
    lang_rtype_default: torch.Tensor  # [102, 2] int32 (rtype, default)
    close_set: torch.Tensor         # [614] int32 close-set id
    closest_alt: torch.Tensor       # [614] int32 closest alternate (or 26)
    is_figs: torch.Tensor           # [614] bool
    kind_tbl2: Quad2Static = None
    quad2_enabled: bool = False

    @property
    def device(self) -> torch.device:
        return self.cat_ind2.device

    @classmethod
    def from_host(cls, t: ScoringTables, reg: Registry,
                  device) -> "DeviceTables":
        ht = host_tables(t, reg)
        _validate_qprobs(t, ht.cat_ind)

        close = np.zeros(reg.num_languages, np.int32)
        for lang in range(reg.num_languages):
            close[lang] = reg.close_set(lang)
        alt = np.full(reg.num_languages, 26, np.int32)  # 26 = UNKNOWN
        alt[:len(reg.closest_alt_lang)] = reg.closest_alt_lang
        figs = np.zeros(reg.num_languages, bool)
        for code in ("fr", "it", "de", "es"):
            figs[reg.code_to_lang[code]] = True
        rd = np.stack([reg.ulscript_rtype.astype(np.int32),
                       reg.ulscript_default_lang.astype(np.int32)], axis=1)

        lg3 = np.asarray(t.lg_prob[:, 5:8], dtype=np.uint8)
        lg3_pad = np.empty((256, 3), np.uint8)
        lg3_pad[:len(lg3)] = lg3
        lg3_pad[len(lg3):] = lg3[-1]               # the clamp row
        exp = t.avg_delta_octa_score.astype(np.int32)
        exp_pad = np.zeros((_pad128(exp.shape[0]), 4), np.int32)
        exp_pad[:exp.shape[0]] = exp
        close_pad = np.zeros(exp_pad.shape[0], np.int32)
        close_pad[:len(close)] = close
        planes = dict(
            cat_buckets=ht.cat_buckets, cat_ind=ht.cat_ind,
            cat_ind2=ht.cat_ind2,
            kind_bucket_off=ht.bucket_off.astype(np.int32),
            kind_size=ht.size, kind_keymask=ht.keymask,
            kind_ind_off=ht.ind_off, kind_size_one=ht.size_one,
            kind_probes=ht.probes.astype(bool),
            lg_prob3=lg3, expected_score=exp,
            lg_prob3_pad=lg3_pad, expected_score_pad=exp_pad,
            close_set_pad=close_pad,
            plang_to_lang=np.stack([
                reg.plang_to_lang_latn.astype(np.int32),
                reg.plang_to_lang_othr.astype(np.int32)]),
            lang_rtype_default=rd, close_set=close, closest_alt=alt,
            is_figs=figs)
        return device_tables_from_numpy(planes, device,
                                        kind_tbl2=ht.q2,
                                        quad2_enabled=ht.q2_enabled)

    def to_numpy(self) -> dict:
        """Plane name -> host numpy copy, u32 planes viewed back as u32."""
        out = {}
        for name in PLANES:
            a = getattr(self, name).cpu().numpy()
            out[name] = a.view(np.uint32) if name in _U32_PLANES else a
        return out


# the reference package's names for the six KindTables planes
_KIND_FIELDS = {"kind_bucket_off": "bucket_off", "kind_size": "size",
                "kind_keymask": "keymask", "kind_ind_off": "ind_off",
                "kind_size_one": "size_one", "kind_probes": "probes"}


def device_tables_from_numpy(planes: dict, device,
                             kind_tbl2: Quad2Static | None = None,
                             quad2_enabled: bool = False) -> DeviceTables:
    """Build DeviceTables from numpy planes keyed by PLANES names — or by
    the reference package's own field names (a `kind_tbl` entry holding
    the six KindTables planes as attributes or a dict), so tables read
    out of the reference with np.asarray load byte for byte."""
    flat = dict(planes)
    kt = flat.pop("kind_tbl", None)
    if kt is not None:
        for ours, theirs in _KIND_FIELDS.items():
            flat[ours] = (kt[theirs] if isinstance(kt, dict)
                          else getattr(kt, theirs))
    missing = [n for n in PLANES if n not in flat]
    if missing:
        raise KeyError(f"table planes missing: {missing}")
    return DeviceTables(
        **{n: _to_tensor(np.asarray(flat[n]), device) for n in PLANES},
        kind_tbl2=kind_tbl2, quad2_enabled=quad2_enabled)


def digest_arrays(dt: DeviceTables) -> list:
    """The dt planes the integrity fold digests, in PLANES order (the
    reference package's pytree leaf order), as host numpy arrays."""
    host = dt.to_numpy()
    return [host[n] for n in PLANES]


def fold_host(a) -> int:
    """Host (numpy) digest fold: normalize the plane to u32 words, weight
    each word by its position (mod-65521 stride so a swap of equal words
    still changes the sum), and wrap-sum mod 2^32."""
    v = np.asarray(a)
    if v.dtype == bool:
        v = v.astype(np.uint8)
    if v.dtype.itemsize == 1:
        w = v.astype(np.uint32)
    elif v.dtype.itemsize == 2:
        w = v.view(np.uint16).astype(np.uint32)
    else:
        w = v.view(np.uint32)
    w = w.ravel()
    weights = (np.arange(w.size, dtype=np.uint32) % 65521) + 1
    return int((w * weights).sum(dtype=np.uint32))


def fingerprint(dt: DeviceTables) -> tuple:
    """Per-plane digest tuple of an uploaded table set (reads back the
    actual device bytes, so it covers the upload itself)."""
    return tuple(fold_host(a) for a in digest_arrays(dt))


def _validate_qprobs(t: ScoringTables, cat_ind: np.ndarray) -> None:
    """Assert the group-in-use invariant the device scorer relies on:
    every packed langprob with a nonzero pslang decodes to qprob >= 1, so
    'Tote group in use' == 'some language in the group scored > 0'
    (ops/score.py). Holds for the reference tables and by construction
    for trained ones; a table violating it would silently change top-2
    tie-breaking, so fail loudly at load.

    Also keeps the reference package's int16 tote bound: a chunk tote
    for one language is at most K(256) slots x 3 planes x qprob_max,
    which must stay below 2^15 (the CUDA kernel accumulates in int32,
    but the two packages must accept the same tables)."""
    lg3 = np.asarray(t.lg_prob[:, 5:8])
    qmax = int(lg3.max()) if lg3.size else 0
    if 256 * 3 * qmax > 0x7FFF:
        raise ValueError(
            f"table qprob_max={qmax} breaks the fused kernels' int16 "
            f"tote bound (256 slots x 3 planes x qprob must stay "
            f"< 32768); retrain or rescale lg_prob")
    lps = np.unique(cat_ind)
    rows = lps & 0xFF
    ok_rows = rows < len(lg3)
    q = lg3[np.minimum(rows, len(lg3) - 1)]       # [n, 3]
    for j, shift in enumerate((8, 16, 24)):
        ps = (lps >> shift) & 0xFF
        bad = ok_rows & (ps > 0) & (q[:, j] == 0)
        if bad.any():
            raise ValueError(
                f"table payload violates qprob>=1 invariant: "
                f"langprob {hex(int(lps[np.argmax(bad)]))}")
