"""Single-file mmap model artifact.

The TPU rebuild of the reference's dynamic-data format
(cld2_dynamic_data.h:23-110, loader cld2_dynamic_data_loader.cc:164):
one little-endian file = fixed header + per-array descriptors + 64-byte
aligned data blobs, reconstructed at load time as zero-copy views over a
single mmap — no parsing, no decompression, no per-array allocation.
The npz artifacts remain the interchange format (tools/artifact_tool.py
converts with --pack); this is the serving format.

Layout (all little-endian):
  0   u32  magic "LDTA" (0x4154444C)
  4   u32  format version
  8   u32  n_arrays
  12  u32  flags (bit 0: digest footer present; was reserved=0, so
             pre-footer artifacts read as flags=0 and still load)
  16  u64  header_bytes (end of the descriptor table)
  24  u64  total_bytes  (file size; load-time truncation check)
  32  n_arrays x 108-byte packed descriptors:
      48s  name (NUL-padded UTF-8)
      8s   numpy dtype string, e.g. "<u4" (NUL-padded)
      u32  ndim (<= 4)
      4xu64 shape (unused dims 0)
      u64  offset (file-relative), u64 nbytes
  blobs: each 64-byte aligned.
  footer (when flags bit 0 is set, included in total_bytes):
      u32  footer magic "LDTD" (0x4454444C)
      u32  n_arrays (must match the header)
      n_arrays x u32  zlib.crc32 of each blob, descriptor order

The fixed flat layout is deliberately C-parsable so a native host can
mmap the same file (the cgo seam's table story).
"""
from __future__ import annotations

import mmap
import os
import struct
import zlib
from pathlib import Path

import numpy as np


MAGIC = 0x4154444C  # "LDTA"
FOOT_MAGIC = 0x4454444C  # "LDTD"
VERSION = 1
ALIGN = 64
FLAG_DIGESTS = 0x1
_HDR = struct.Struct("<IIII QQ")
_DESC = struct.Struct("<48s8sI 4Q QQ")
_FOOT = struct.Struct("<II")

# pinned artifact geometry: a drive-by field edit must fail at import,
# not invalidate every packed model.ldta in the field
# (tools/lint/layout_registry.py declares the same widths)
assert _HDR.size == 32
assert _DESC.size == 108
assert _FOOT.size == 8


class ArtifactError(ValueError):
    """A corrupt, truncated, or wrong-version artifact file. Subclasses
    ValueError so every pre-existing `except ValueError` load guard
    still catches it; new code should catch ArtifactError and let the
    message (which names the file, the failure, and the fix) reach the
    operator — startup fails loud and /readyz stays false."""


class ArtifactIntegrityError(ArtifactError):
    """A structurally valid artifact whose blob bytes do not match the
    digest footer: bit rot, a torn copy, or deliberate tampering. Kept
    distinct from ArtifactError so the swap path can refuse a corrupt
    standby (ldt_swap_total{result="integrity_refused"}) while still
    treating structural damage as a plain abort."""


def write_artifact(arrays: dict, path: str | Path) -> None:
    """Write name->ndarray as one aligned little-endian artifact file."""
    items = []
    for name, a in arrays.items():
        a = np.asarray(a)
        # note: ascontiguousarray would promote 0-d arrays to 1-d, so
        # shape/ndim come from the original and only the BYTES go
        # through a contiguous copy
        buf = a if a.flags.c_contiguous else np.ascontiguousarray(a)
        if len(name.encode()) > 47:
            raise ValueError(f"array name too long: {name!r}")
        if a.ndim > 4:
            raise ValueError(f"{name}: ndim {a.ndim} > 4")
        if a.dtype.hasobject:
            raise ValueError(f"{name}: object arrays not supported")
        items.append((name, a, buf))

    header_bytes = _HDR.size + len(items) * _DESC.size
    pos = -(-header_bytes // ALIGN) * ALIGN
    descs = []
    for name, a, _ in items:
        shape = list(a.shape) + [0] * (4 - a.ndim)
        descs.append((name.encode(), a.dtype.str.encode(), a.ndim,
                      shape, pos, a.nbytes))
        pos += -(-max(a.nbytes, 1) // ALIGN) * ALIGN
    foot_off = pos
    total = pos + _FOOT.size + 4 * len(items)

    with open(path, "wb") as f:
        f.write(_HDR.pack(MAGIC, VERSION, len(items), FLAG_DIGESTS,
                          header_bytes, total))
        for (name, dt, ndim, shape, off, nb) in descs:
            f.write(_DESC.pack(name, dt, ndim, *shape, off, nb))
        crcs = []
        for (name, a, buf), (_, _, _, _, off, nb) in zip(items, descs):
            f.seek(off)
            # buf is C-contiguous: its buffer writes zero-copy
            f.write(buf.data if buf.size else b"")
            crcs.append(zlib.crc32(buf.data) if buf.size else 0)
        f.seek(foot_off)
        f.write(_FOOT.pack(FOOT_MAGIC, len(items)))
        f.write(struct.pack(f"<{len(crcs)}I", *crcs) if crcs else b"")
        f.truncate(total)


def load_artifact(path: str | Path) -> dict:
    """mmap the artifact and return name -> zero-copy ndarray views.
    The mapping stays alive as long as any view does (numpy holds the
    buffer reference).

    Every load failure — including open/mmap OS errors and a
    half-written file (ENOSPC mid-pack, a swap drill racing the
    packer) — surfaces as a typed ArtifactError with an actionable
    message, so ScoringTables.load_mmap callers (startup, hot swap)
    abort cleanly on the old tables instead of dying on a raw OSError."""
    try:
        f = open(path, "rb")
    except OSError as e:
        raise ArtifactError(
            f"{path}: cannot open artifact ({e.strerror or e}) — check "
            "the path/permissions or re-pack with "
            "tools/artifact_tool.py --pack") from e
    with f:
        # size-vs-header validation BEFORE the mapping exists: a
        # truncated or still-being-written file must produce a typed,
        # actionable error here, not a raw mmap ValueError/OSError or
        # a SIGBUS past the end of a short mapping later
        size = os.fstat(f.fileno()).st_size
        if size < _HDR.size:
            raise ArtifactError(
                f"{path}: {size}-byte file is shorter than the header "
                f"({_HDR.size} bytes; empty or half-written artifact) "
                "— re-pack with tools/artifact_tool.py --pack")
        pre_magic, _pv, _pn, _pr, _phb, pre_total = \
            _HDR.unpack(f.read(_HDR.size))
        if pre_magic == MAGIC and pre_total != size:
            raise ArtifactError(
                f"{path}: file is {size} bytes but the header records "
                f"{pre_total} (truncated or corrupt — half-written "
                "pack: packer died or disk filled mid-write) — restore "
                "it from source or re-pack with tools/artifact_tool.py "
                "--pack")
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (OSError, ValueError) as e:
            raise ArtifactError(
                f"{path}: cannot mmap artifact ({e}) — the file must "
                "be a regular, readable, non-empty LDTA pack; re-pack "
                "with tools/artifact_tool.py --pack") from e
    try:
        if len(mm) < _HDR.size:
            raise ArtifactError(
                f"{path}: not an LDTA artifact (file shorter than the "
                "header) — re-pack it with tools/artifact_tool.py --pack")
        magic, version, n, flags, header_bytes, total = \
            _HDR.unpack_from(mm, 0)
        if magic != MAGIC:
            raise ArtifactError(
                f"{path}: bad magic {magic:#x} (want {MAGIC:#x} 'LDTA') "
                "— this is not a packed artifact; re-pack the npz with "
                "tools/artifact_tool.py --pack")
        if version != VERSION:
            raise ArtifactError(
                f"{path}: format version {version}, this build reads "
                f"version {VERSION} — re-pack with a matching "
                "tools/artifact_tool.py --pack")
        if total != len(mm):
            raise ArtifactError(
                f"{path}: file is {len(mm)} bytes but the header "
                f"records {total} (truncated or corrupt) — restore it "
                "from source or re-pack with tools/artifact_tool.py "
                "--pack")
        # a corrupted n_arrays/header_bytes must fail the ArtifactError
        # contract, not crash struct.unpack past the mapping
        if header_bytes != _HDR.size + n * _DESC.size or \
                header_bytes > total:
            raise ArtifactError(
                f"{path}: header_bytes {header_bytes} inconsistent "
                f"with {n} descriptors (corrupt header) — re-pack with "
                "tools/artifact_tool.py --pack")
        data_start = -(-header_bytes // ALIGN) * ALIGN
        crcs = None
        if flags & FLAG_DIGESTS:
            foot_off = total - (_FOOT.size + 4 * n)
            if foot_off < data_start:
                raise ArtifactError(
                    f"{path}: digest footer overlaps the data region "
                    "(corrupt header) — re-pack with "
                    "tools/artifact_tool.py --pack")
            fmagic, fn = _FOOT.unpack_from(mm, foot_off)
            if fmagic != FOOT_MAGIC or fn != n:
                raise ArtifactIntegrityError(
                    f"{path}: digest footer corrupt (magic {fmagic:#x}"
                    f", {fn} entries for {n} arrays) — restore the "
                    "file from source or re-pack with "
                    "tools/artifact_tool.py --pack")
            crcs = struct.unpack_from(f"<{n}I", mm,
                                      foot_off + _FOOT.size)
        out: dict = {}
        buf = memoryview(mm)
        for i in range(n):
            name_b, dt_b, ndim, s0, s1, s2, s3, off, nb = \
                _DESC.unpack_from(mm, _HDR.size + i * _DESC.size)
            name = name_b.rstrip(b"\0").decode()
            try:
                dtype = np.dtype(dt_b.rstrip(b"\0").decode())
            except TypeError as e:
                raise ArtifactError(
                    f"{path}: array {name!r} has an unreadable dtype "
                    f"({e}) — corrupt descriptor; re-pack with "
                    "tools/artifact_tool.py --pack") from None
            shape = (s0, s1, s2, s3)[:ndim]
            # offsets must land in the data region: a corrupt descriptor
            # must not alias array views over the header/descriptor table
            if ndim > 4 or off < data_start or off + nb > total:
                raise ArtifactError(
                    f"{path}: array {name!r} descriptor out of bounds "
                    "(corrupt) — re-pack with tools/artifact_tool.py "
                    "--pack")
            count = 1
            for s in shape:
                count *= s
            if nb != count * dtype.itemsize:
                raise ArtifactError(
                    f"{path}: array {name!r} records {nb} bytes but "
                    f"shape {shape} x itemsize {dtype.itemsize} "
                    "disagrees (corrupt descriptor) — re-pack with "
                    "tools/artifact_tool.py --pack")
            if crcs is not None and \
                    zlib.crc32(buf[off:off + nb]) != crcs[i]:
                raise ArtifactIntegrityError(
                    f"{path}: array {name!r} fails its digest "
                    "(bit rot, a torn copy, or tampering) — restore "
                    "the file from source or re-pack with "
                    "tools/artifact_tool.py --pack")
            a = np.frombuffer(buf[off:off + nb], dtype=dtype)
            out[name] = a.reshape(shape)
    except BaseException:
        # no view escaped: close the mapping instead of leaking it (a
        # successful return keeps mm alive via the views' buffer refs).
        # Partially-built views and the memoryview must drop first or
        # their live buffer exports would block the close.
        try:  # a: loop-local view of the last successfully parsed
            # array before the corrupt descriptor
            del a
        except NameError:
            pass
        try:
            del out, buf
        except NameError:
            pass
        try:
            mm.close()
        except BufferError:  # an export still alive: GC reclaims later
            pass
        raise
    return out


def artifact_digest(path: str | Path) -> str | None:
    """Cheap whole-artifact identity: the hex crc32 of the digest
    footer bytes (header-only reads — no blob I/O). None for a
    pre-footer artifact. The result-cache epoch and swap telemetry use
    this as the artifact generation key."""
    try:
        with open(path, "rb") as f:
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                return None
            magic, _ver, n, flags, _hb, total = _HDR.unpack(hdr)
            if magic != MAGIC or not flags & FLAG_DIGESTS:
                return None
            foot_size = _FOOT.size + 4 * n
            if total < foot_size:
                return None
            f.seek(total - foot_size)
            foot = f.read(foot_size)
            if len(foot) < foot_size:
                return None
            return "%08x" % zlib.crc32(foot)
    except OSError:
        return None


def verify_artifact(path: str | Path) -> str | None:
    """Full read-only verification: structural checks plus every blob
    digest (load_artifact does both). Returns the artifact digest (or
    None for a pre-footer file); raises ArtifactIntegrityError on a
    digest mismatch, ArtifactError on structural damage. The swap path
    runs this against a standby artifact BEFORE cutover."""
    arrays = load_artifact(path)
    del arrays  # views drop -> the mapping closes with them
    return artifact_digest(path)
