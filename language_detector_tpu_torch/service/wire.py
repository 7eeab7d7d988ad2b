"""Shared wire fast path for both HTTP fronts + the unix-socket lane.

The engine sustains ~112k docs/sec but the fronts burned their budget
on per-request ``json.loads``/``json.dumps`` of whole batch bodies.
This module takes the host off the request path three ways:

  1. ``fast_parse_texts``: a single-pass scanner that recognizes the
     strict common request shape ``{"request": [{"text": <string>},
     ...]}`` and slices each text straight out of the request bytes
     (one str decode per doc, zero intermediate dicts/lists-of-dicts).
     ANY deviation — extra keys, non-string values, escapes that need
     exact JSON semantics, truncation, trailing bytes — bails to the
     ``json.loads`` path, so the contract (parse result, 400s, metric
     increments) is byte-identical by construction.
  2. ``post_detect``/``assemble_response``: batch responses assembled
     as a writev-style buffer list over per-code fragments cached in a
     ``FragmentCache`` (previously private to the sync front), so
     neither front builds an O(body) concatenation.
  3. A length-prefixed unix-domain-socket frame protocol
     (``LDT_UNIX_SOCKET``) for co-located callers that skips HTTP
     parsing entirely; the threaded front's ``UnixFrameServer`` lives
     here and reuses one grow-only receive buffer per connection.

Both fronts (service/server.py, service/aioserver.py) import the
contract pieces from here; server.py re-exports the moved names for
backward compatibility.
"""
from __future__ import annotations

import json
import re
import socket
import struct
import threading
import time
import zlib
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np

from .. import faults, knobs, telemetry
from ..locks import make_lock
from .admission import DeadlineExceeded, DeviceUnavailable

BODY_LIMIT_BYTES = 1_000_000            # main.go:59

# single source of the contract's error payloads (both fronts + UDS)
CT_ERROR_BODY = json.dumps(
    {"error": "Content-Type must be set to application/json"}).encode()
PARSE_ERROR_BODY = json.dumps(
    {"error": "Unable to parse request - invalid JSON detected"}).encode()
OVERSIZE_BODY = json.dumps(
    {"error": "Request body exceeds 1MB limit"}).encode()
TIMEOUT_BODY = json.dumps(
    {"error": "Frame read timed out "
              "(LDT_FRAME_READ_TIMEOUT_SEC)"}).encode()
CRC_ERROR_BODY = json.dumps(
    {"error": "Frame body failed CRC32 integrity check"}).encode()
_MISSING_TEXT_FRAG = b'{"error": "Missing text key"}'

RESP_OPEN = b'{"response": ['
RESP_SEP = b", "
RESP_CLOSE = b']}'

_WS = b" \t\n\r"                        # JSON whitespace, exactly
# a raw byte < 0x20 inside a string literal is invalid JSON; the fast
# path must 400 it (via fallback), not decode it
_CTRL_RE = re.compile(rb"[\x00-\x1f]")


def strip_extras(text: str) -> str:
    """Remove @mentions and links, which skew detection
    (StripExtras, handlers.go:198-210; note the trailing space the
    word-join loop leaves behind). Texts without '@' or 'http' pass
    through untouched: the split/join also collapses whitespace, but
    the engine maps every non-letter run to one space during
    segmentation, so detection output is identical — and the scan-only
    fast path saves ~6us/doc of the single core."""
    if "@" not in text and "http" not in text:
        return text
    kept = [w for w in text.split()
            if not (w.startswith("@") or w.startswith("http"))]
    return "".join(w + " " for w in kept)


# -- request side -----------------------------------------------------------


def parse_post_body(m, content_type: str | None, body: bytes):
    """Content-Type + JSON validation (GetRequests, handlers.go:33-69).
    Returns (doc, None) on success or (None, (status, payload_bytes))
    for the error response — single source of the contract's error
    strings and metric increments for both servers."""
    if content_type != "application/json":
        m.inc("augmentation_invalid_requests_total")
        m.inc("augmentation_errors_logged_total")
        m.inc_object("unsuccessful")
        return None, (400, CT_ERROR_BODY)
    try:
        return json.loads(body), None
    except json.JSONDecodeError:
        m.inc("augmentation_invalid_requests_total")
        m.inc("augmentation_errors_logged_total")
        m.inc_object("unsuccessful")
        return None, (400, PARSE_ERROR_BODY)


def pre_detect(svc, doc):
    """Parsed request body -> (texts, slots, responses, status), or None
    when the body is not the {"request": [...]} shape (caller answers
    400). Per-item "Missing text key" errors keep the batch going with
    overall HTTP 400 (handlers.go:133-150)."""
    m = svc.metrics
    if not isinstance(doc, dict) or "request" not in doc:
        m.inc("augmentation_invalid_requests_total")
        return None
    requests = doc["request"]
    if not isinstance(requests, list):
        requests = []
    status = 200
    responses: list = []
    texts: list = []
    slots: list = []
    # fast path: every item is a {"text": ...} dict (the overwhelmingly
    # common shape) — one comprehension instead of a per-item branch loop
    try:
        texts = [strip_extras(str(item["text"])) for item in requests]
    except (TypeError, KeyError):
        pass
    else:
        return texts, range(len(texts)), [None] * len(texts), status
    texts = []
    for i, item in enumerate(requests):
        if not isinstance(item, dict) or "text" not in item:
            m.inc_object("unsuccessful")
            responses.append(_MISSING_TEXT_FRAG)
            status = 400
            continue
        texts.append(strip_extras(str(item["text"])))
        slots.append(i)
        responses.append(None)
    return texts, slots, responses, status


def _skip_ws(b, i: int, n: int) -> int:
    while i < n and b[i] in _WS:
        i += 1
    return i


def fast_parse_texts(body, n: int | None = None):
    """Zero-copy scan of the strict common shape
    ``{"request": [{"text": <string>}, ...]}`` -> list of raw text
    strings, or None to fall back to ``json.loads``.

    ``body`` is bytes, a (reused) bytearray, or an mmap (shm ring
    slots); ``n`` bounds the scan so a UDS or shm frame can parse in
    place inside a larger buffer. Strings
    without a backslash decode straight off a memoryview slice (after
    rejecting raw control bytes, which json would 400); strings WITH a
    backslash hand just the quoted token to ``json.loads`` for exact
    escape / surrogate-pair semantics — this keeps ensure_ascii bodies
    (every non-ASCII char \\uXXXX-escaped) on the fast path. Anything
    else — duplicate/extra keys, non-string values, truncation,
    trailing bytes, undecodable UTF-8 — returns None, and the fallback
    reproduces today's behavior exactly."""
    if n is None:
        n = len(body)
    mv = memoryview(body)
    i = _skip_ws(body, 0, n)
    if i >= n or body[i] != 0x7B:                       # {
        return None
    i = _skip_ws(body, i + 1, n)
    # slice-compare instead of startswith: mmap objects (the shm ring
    # lane parses frames in place off the shared mapping) have no
    # startswith, and the bound check keeps the scan inside n
    if i + 9 > n or mv[i:i + 9] != b'"request"':
        return None
    i = _skip_ws(body, i + 9, n)
    if i >= n or body[i] != 0x3A:                       # :
        return None
    i = _skip_ws(body, i + 1, n)
    if i >= n or body[i] != 0x5B:                       # [
        return None
    i = _skip_ws(body, i + 1, n)
    texts: list = []
    if i < n and body[i] == 0x5D:                       # ] (empty list)
        i += 1
    else:
        while True:
            if i >= n or body[i] != 0x7B:               # {
                return None
            i = _skip_ws(body, i + 1, n)
            if i + 6 > n or mv[i:i + 6] != b'"text"':
                return None
            i = _skip_ws(body, i + 6, n)
            if i >= n or body[i] != 0x3A:               # :
                return None
            i = _skip_ws(body, i + 1, n)
            if i >= n or body[i] != 0x22:               # opening "
                return None
            start = i + 1
            # find the closing quote: a quote preceded by an even run
            # of backslashes
            j = body.find(b'"', start, n)
            while j != -1:
                k = j - 1
                while k >= start and body[k] == 0x5C:
                    k -= 1
                if (j - k) % 2 == 1:
                    break
                j = body.find(b'"', j + 1, n)
            if j == -1:
                return None
            if body.find(b"\\", start, j) != -1:
                try:
                    s = json.loads(bytes(mv[i:j + 1]))
                except (ValueError, UnicodeDecodeError):
                    return None
            else:
                if _CTRL_RE.search(body, start, j):
                    return None
                try:
                    s = str(mv[start:j], "utf-8")
                except UnicodeDecodeError:
                    return None
            texts.append(s)
            i = _skip_ws(body, j + 1, n)
            if i >= n or body[i] != 0x7D:               # }
                return None
            i = _skip_ws(body, i + 1, n)
            if i < n and body[i] == 0x2C:               # ,
                i = _skip_ws(body, i + 1, n)
                continue
            if i < n and body[i] == 0x5D:               # ]
                i += 1
                break
            return None
    i = _skip_ws(body, i, n)
    if i >= n or body[i] != 0x7D:                       # }
        return None
    i = _skip_ws(body, i + 1, n)
    if i != n:                                          # trailing bytes
        return None
    return texts


def parse_request(svc, content_type: str | None, body, nbytes=None):
    """Single request-parsing entry point for every lane (sync front,
    asyncio front, UDS). Returns (pre, err), exactly one non-None:

        pre = (texts, slots, responses, status)   — pre_detect shape
        err = (status, payload_bytes)             — ready to send

    The fast scanner handles the strict common shape; any deviation
    falls back to the json.loads path, so responses, status codes and
    metric increments match the pre-wire fronts byte for byte."""
    m = svc.metrics
    reg = telemetry.REGISTRY
    t0 = time.monotonic()
    try:
        if content_type != "application/json":
            m.inc("augmentation_invalid_requests_total")
            m.inc("augmentation_errors_logged_total")
            m.inc_object("unsuccessful")
            return None, (400, CT_ERROR_BODY)
        if knobs.get_bool("LDT_WIRE_FASTPATH"):
            texts = fast_parse_texts(body, nbytes)
            if texts is not None:
                reg.counter_inc("ldt_http_parse_fast_total",
                                result="hit")
                texts = [strip_extras(t) for t in texts]
                return (texts, range(len(texts)),
                        [None] * len(texts), 200), None
            reg.counter_inc("ldt_http_parse_fast_total", result="miss")
        raw = body if nbytes is None else bytes(memoryview(body)[:nbytes])
        doc, err = parse_post_body(m, content_type, raw)
        if err is not None:
            return None, err
        pre = pre_detect(svc, doc)
        if pre is None:
            m.inc("augmentation_errors_logged_total")
            return None, (400, PARSE_ERROR_BODY)
        return pre, None
    finally:
        reg.histogram("ldt_http_parse_ms").observe(
            (time.monotonic() - t0) * 1e3)


# -- response side ----------------------------------------------------------


class FragmentCache:
    """Per-code pre-serialized ``{"iso6391code": ..., "name": ...}``
    fragments, shared by both fronts (previously a private dict on the
    sync front). The value for a key is a pure function of the key, so
    a racing double-compute stores the same bytes; dict get/set are
    GIL-atomic — no lock (see tools/lint/ownership.py)."""

    __slots__ = ("_frags", "_known")

    def __init__(self, known: dict):
        self._frags: dict = {}
        self._known = known

    def entry(self, code: str):
        """code -> (fragment_bytes, display_name, unknown?)."""
        ent = self._frags.get(code)
        if ent is None:
            name = self._known.get(code)
            unknown = name is None
            if unknown:
                name = "Unknown"
            ent = (json.dumps({"iso6391code": code,
                               "name": name}).encode(), name, unknown)
            self._frags[code] = ent
        return ent


def assemble_response(fragments) -> list:
    """Per-item fragments -> writev-style buffer list for the batch
    envelope. ``b"".join(result)`` is byte-identical to the old single
    concatenated payload, but the list lets both fronts emit via
    writelines/sendmsg without building an O(body) copy."""
    out = [RESP_OPEN]
    append = out.append
    first = True
    for frag in fragments:
        if first:
            first = False
        else:
            append(RESP_SEP)
        append(frag)
    append(RESP_CLOSE)
    return out


def post_detect(svc, codes: list, slots, responses: list, status: int,
                spans: list | None = None):
    """Detected codes -> (status, writev-style buffer list) + metrics.
    Unknown code answers name "Unknown" with HTTP 203
    (handlers.go:151-166). The buffers concatenate to bytes identical
    to the json.dumps they replace (fragments are built BY json.dumps,
    once per distinct code). spans (LDT_SPANS requests only): per-item
    span record lists, spliced into each cached fragment as a "spans"
    key — the span lane is low-volume, so the per-item dumps is off
    the main path and span-less responses stay byte-identical."""
    m = svc.metrics
    t0 = time.monotonic()
    lang_counts: dict = {}
    entry = svc._frag_cache.entry
    for pos, (i, code) in enumerate(zip(slots, codes)):
        frag, name, unknown = entry(code)
        if unknown and status == 200:
            status = 203
        if spans is not None:
            frag = (frag[:-1] + b', "spans": ' +
                    json.dumps([list(s) for s in spans[pos] or []],
                               separators=(",", ":")).encode() + b"}")
        responses[i] = frag
        lang_counts[name] = lang_counts.get(name, 0) + 1
    if codes:
        m.add_languages(lang_counts)
        m.inc_object("successful", len(codes))
        svc.log_processed(len(codes))
    buffers = assemble_response(responses)
    telemetry.REGISTRY.histogram("ldt_http_serialize_ms").observe(
        (time.monotonic() - t0) * 1e3)
    return status, buffers


# -- unix-domain-socket lane ------------------------------------------------
#
# Frame contract (both fronts):
#     v1 request  = !I  body_len        | body (same JSON as POST /)
#     v2 request  = !I  (V2|body_len)   | !BHI flags tenant_len deadline_ms
#                   | tenant (latin-1)  | body
#     response    = !IH body_len status | body
# The v2 bit lives in the length word's MSB — the body contract caps
# body_len at 1 MB, so no v1 client can ever emit it, which makes v1
# frames byte-compatible on a v2 server. The ext header carries what
# the HTTP front reads from X-LDT-Tenant / X-LDT-Priority /
# X-LDT-Deadline-Ms: flags bit0 = priority, tenant_len sizes the
# tenant id that follows (0 = default tenant), deadline_ms is the
# request budget (0 = absent, server default applies). The response
# body is byte-identical to the TCP front's HTTP payload for the same
# batch — pinned by tests and the ci wire smoke.

FRAME_HEADER = struct.Struct("!I")
FRAME_RESP_HEADER = struct.Struct("!IH")
FRAME_V2_FLAG = 0x80000000
FRAME_EXT_HEADER = struct.Struct("!BHI")   # flags, tenant_len, deadline_ms
FRAME_PRIORITY = 0x01                      # flags bit0
FRAME_REQID = 0x02                         # flags bit1: 1-byte id length
#                                            + id bytes follow the tenant
FRAME_CRC = 0x04                           # flags bit2: u32 crc32(body)
#                                            follows the reqid bytes
FRAME_SPANS = 0x08                         # flags bit3: request per-span
#                                            verdicts (LDT_SPANS=1 server
#                                            side; ignored when off, so
#                                            responses stay byte-identical)
FRAME_CRC_WORD = struct.Struct("!I")

# pinned v1/v2 wire widths: a drive-by field edit must fail at import,
# not desync every deployed client mid-stream
# (tools/lint/layout_registry.py declares the same widths)
assert FRAME_HEADER.size == 4
assert FRAME_RESP_HEADER.size == 6
assert FRAME_EXT_HEADER.size == 7
assert FRAME_CRC_WORD.size == 4

REQUEST_ID_HEADER = "X-LDT-Request-Id"
_REQID_RE = re.compile(r"[A-Za-z0-9._\-]{1,64}\Z")


def gen_request_id() -> str:
    """Server-generated correlation id for a request that arrived
    without one: 8 hex chars, the same shape a shm slot's u32 carrier
    renders to, so every lane's ids look alike in /tracez."""
    import os
    return os.urandom(4).hex()


def clean_request_id(raw) -> str | None:
    """Validate a caller-supplied correlation id (header or frame
    field): 1-64 chars of [A-Za-z0-9._-], else rejected to None so a
    hostile id can't smuggle header/JSON syntax back out through the
    echo."""
    if not raw:
        return None
    if isinstance(raw, bytes):
        try:
            raw = raw.decode("ascii")
        except UnicodeDecodeError:
            return None
    return raw if _REQID_RE.match(raw) else None


def pack_frame(body: bytes, tenant: str | None = None,
               deadline_ms: int | None = None,
               priority: bool = False,
               request_id: str | None = None,
               crc: bool | None = None,
               spans: bool = False) -> bytes:
    """Client-side frame builder. With no admission fields set this
    emits a plain v1 frame, so existing callers (and the parity tests'
    baseline) are untouched; any field promotes the frame to v2. A
    request_id rides as flags bit1 + 1-byte length + id bytes after
    the tenant, and the server echoes it on the response frame. crc
    (default: the LDT_WIRE_CRC knob) appends a u32 crc32(body) guard
    word after the reqid bytes; the server refuses a frame whose body
    arrives not matching it with a 400 instead of parsing garbage."""
    if crc is None:
        crc = bool(knobs.get_bool("LDT_WIRE_CRC"))
    if tenant is None and deadline_ms is None and not priority \
            and request_id is None and not crc and not spans:
        return FRAME_HEADER.pack(len(body)) + body
    tb = (tenant or "").encode("latin-1")
    flags = FRAME_PRIORITY if priority else 0
    if spans:
        flags |= FRAME_SPANS
    rb = b""
    if request_id is not None:
        rb = request_id.encode("ascii")
        if len(rb) > 255:
            raise ValueError("request_id exceeds 255 bytes")
        flags |= FRAME_REQID
        rb = bytes([len(rb)]) + rb
    cb = b""
    if crc:
        flags |= FRAME_CRC
        cb = FRAME_CRC_WORD.pack(zlib.crc32(body))
    ext = FRAME_EXT_HEADER.pack(flags, len(tb),
                                min(deadline_ms or 0, 0xFFFFFFFF))
    return FRAME_HEADER.pack(FRAME_V2_FLAG | len(body)) \
        + ext + tb + rb + cb + body

_IOV_BATCH = 512  # sendmsg segments per call, safely under IOV_MAX


def send_frame(sock, status: int, buffers: list,
               request_id: str | None = None) -> None:
    """Emit one response frame writev-style: header + fragment buffers
    go to sendmsg as-is (no join); a short write re-enters with the
    remaining tail. A request_id (echoed only when the CLIENT supplied
    one, so v1 responses stay byte-identical) sets the length word's
    MSB and prefixes the body with 1-byte id length + id bytes."""
    total = 0
    for b in buffers:
        total += len(b)
    if request_id is not None:
        rb = request_id.encode("ascii")
        iov = [FRAME_RESP_HEADER.pack(FRAME_V2_FLAG | total, status),
               bytes([len(rb)]) + rb]
    else:
        iov = [FRAME_RESP_HEADER.pack(total, status)]
    iov += buffers
    i = 0
    while i < len(iov):
        chunk = iov[i:i + _IOV_BATCH]
        try:
            sent = sock.sendmsg(chunk)
        except AttributeError:      # platform without sendmsg
            sock.sendall(b"".join(iov[i:]))
            return
        for b in chunk:
            blen = len(b)
            if sent >= blen:
                sent -= blen
                i += 1
            else:
                iov[i] = memoryview(b)[sent:]
                break


def recv_response_frame(sock):
    """Client-side response reader -> (status, request_id, body).
    Understands both the plain response header and the id-echo form
    (MSB of the length word set, 1-byte id length + id before the
    body)."""
    hdr = bytearray(FRAME_RESP_HEADER.size)
    if not _recv_exact_into(sock, memoryview(hdr), len(hdr)):
        raise ConnectionError("EOF reading response frame header")
    length, status = FRAME_RESP_HEADER.unpack(hdr)
    request_id = None
    if length & FRAME_V2_FLAG:
        length &= ~FRAME_V2_FLAG
        one = bytearray(1)
        if not _recv_exact_into(sock, memoryview(one), 1):
            raise ConnectionError("EOF reading response id length")
        rb = bytearray(one[0])
        if rb and not _recv_exact_into(sock, memoryview(rb), len(rb)):
            raise ConnectionError("EOF reading response id")
        request_id = rb.decode("ascii")
    body = bytearray(length)
    if length and not _recv_exact_into(sock, memoryview(body), length):
        raise ConnectionError("EOF reading response body")
    return status, request_id, bytes(body)


def _recv_exact_into(sock, view, n: int) -> bool:
    """Fill exactly n bytes of view from sock; False on EOF mid-read."""
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            return False
        got += r
    return True


def handle_frame(svc, body, detect=None, nbytes=None, lane="uds",
                 tenant=None, deadline_ms=None, priority=False,
                 request_id=None, want_spans=False):
    """One UDS request body through the shared wire path ->
    (status, buffer list). Mirrors the HTTP fronts' POST flow
    (admission, degrade ladder, typed errors) minus header parsing;
    tenant/deadline_ms/priority/request_id come from a v2 frame's ext
    header and feed the same per-tenant quota, deadline, brownout, and
    correlation decisions as the HTTP headers they mirror. The
    concatenated buffers are identical to the TCP payload for the same
    batch. want_spans (FRAME_SPANS ext flag) asks for per-span
    verdicts; honored only when LDT_SPANS=1 AND the request is not on
    a degrade path (spans drop to plain codes under brownout), so a
    span-less server answers byte-identical v1/v2 responses."""
    from .. import flightrec
    m = svc.metrics
    m.inc("augmentation_requests_total")
    telemetry.REGISTRY.counter_inc("ldt_http_requests_total", lane=lane)
    trace = telemetry.Trace()
    # correlate even id-less callers: the recorder/trace id is server-
    # generated then, just never echoed on the wire (v1 byte-compat)
    trace.request_id = request_id or gen_request_id()
    flightrec.emit_event("request_start", request_id=trace.request_id,
                         lane=lane)
    t = trace.t0
    if detect is None:
        detect = svc.detect_codes
    # completion-meta base shared by every finish_request exit: the
    # capture plane records request shape (bytes -> size bucket,
    # priority flag) alongside the outcome
    base = {"front": lane,
            "bytes": int(nbytes) if nbytes is not None else len(body),
            "priority": bool(priority)}
    pre, err = parse_request(svc, "application/json", body, nbytes=nbytes)
    if err is not None:
        telemetry.finish_request(trace, meta=dict(base, status=err[0]))
        return err[0], [err[1]]
    t = telemetry.observe_stage("parse", t, trace=trace)
    texts, slots, responses, status = pre
    adm = svc.admission
    admit = None
    if texts:
        admit = adm.try_admit(texts, priority=priority, tenant=tenant)
        # tenant before the shed branch: sheds must carry the
        # throttled tenant's identity into SLO/capture
        trace.tenant = admit.tenant
        if admit.shed:
            m.inc("augmentation_errors_logged_total")
            telemetry.finish_request(
                trace, meta=dict(base, docs=len(texts),
                                 status=admit.status,
                                 shed=admit.reason))
            return admit.status, [json.dumps(
                {"error": admit.message}).encode()]
        trace.deadline = adm.deadline_from_header(deadline_ms)
        if admit.level >= 1 and not admit.probe:
            trace.no_retry = True
    spans_list = None
    try:
        if admit is not None and admit.degrade:
            codes = svc.detect_codes_degraded(texts, trace=trace)
        elif want_spans and knobs.get_bool("LDT_SPANS"):
            pairs = svc.detect_spans_codes(texts, trace=trace) \
                if texts else []
            codes = [c for c, _ in pairs]
            spans_list = [s for _, s in pairs]
        else:
            codes = detect(texts, trace=trace) if texts else []
    except DeadlineExceeded:
        m.inc("augmentation_errors_logged_total")
        telemetry.finish_request(
            trace, meta=dict(base, docs=len(texts), status=504))
        return 504, [b'{"error":"deadline expired before dispatch"}']
    except DeviceUnavailable as e:
        m.inc("augmentation_errors_logged_total")
        telemetry.finish_request(
            trace, meta=dict(base, docs=len(texts), status=e.status))
        return e.status, [e.body]
    except (TimeoutError, FuturesTimeout):
        m.inc("augmentation_errors_logged_total")
        telemetry.finish_request(
            trace, meta=dict(base, docs=len(texts), status=504,
                             timeout="flush"))
        return 504, [b'{"error":"detection timed out"}']
    except Exception as e:  # noqa: BLE001 — typed 500, never a cut frame
        print(json.dumps({"msg": "detect failed",
                          "error": repr(e)}), flush=True)
        m.inc("augmentation_errors_logged_total")
        telemetry.finish_request(
            trace, meta=dict(base, docs=len(texts), status=500))
        return 500, [b'{"error":"internal error"}']
    finally:
        if admit is not None:
            adm.release(admit)
    t = telemetry.observe_stage("detect", t, trace=trace)
    status, buffers = post_detect(svc, codes, slots, responses, status,
                                  spans=spans_list)
    telemetry.observe_stage("encode", t, trace=trace)
    telemetry.finish_request(
        trace, meta=dict(base, docs=len(texts), status=status))
    return status, buffers


class UnixFrameServer:
    """Length-prefixed unix-domain-socket ingest lane for the threaded
    front (LDT_UNIX_SOCKET). One daemon accept thread, one daemon
    thread per connection; each connection reuses a grow-only receive
    buffer, so steady-state ingest allocates nothing per frame. A
    frame declaring more than the 1 MB body contract answers a 413
    frame and closes (length-prefix streams cannot resync). close()
    stops accepting, waits for in-flight frames up to drain_sec (the
    SIGTERM drain contract), then closes lingering connections."""

    def __init__(self, svc, path: str, detect=None):
        self.svc = svc
        self.path = path
        self._detect = detect
        self._lock = make_lock("wire.uds")
        self._conns: set = set()
        self._inflight = 0
        self._closing = False
        self._sock: socket.socket | None = None

    def start(self) -> None:
        import os
        try:
            os.unlink(self.path)
        except OSError:
            pass
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.bind(self.path)
        s.listen(128)
        self._sock = s
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="ldt-uds-accept").start()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return          # listener closed: shutdown signal
            with self._lock:
                if self._closing:
                    conn.close()
                    continue
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="ldt-uds-conn").start()

    def _serve_conn(self, conn) -> None:
        svc = self.svc
        hdr = bytearray(FRAME_HEADER.size)
        hview = memoryview(hdr)
        ext = bytearray(FRAME_EXT_HEADER.size)
        eview = memoryview(ext)
        buf = bytearray(65536)
        try:
            while True:
                # the FIRST byte of a frame may wait forever (idle
                # keep-alive between frames is legal); once it arrives
                # the rest of the header and body must land within the
                # slow-loris budget or the connection answers a 408
                # frame and closes — a stalled writer cannot hold its
                # thread and grow-only buffer open indefinitely
                first = conn.recv(1)
                if not first:
                    return      # clean EOF
                hdr[0:1] = first
                tmo = knobs.get_float("LDT_FRAME_READ_TIMEOUT_SEC")
                if tmo:
                    conn.settimeout(tmo)
                try:
                    if not _recv_exact_into(conn, hview[1:],
                                            len(hdr) - 1):
                        return  # truncated header
                    (length,) = FRAME_HEADER.unpack(hdr)
                    tenant = None
                    deadline_ms = None
                    priority = False
                    request_id = None
                    crc = None
                    want_spans = False
                    if length & FRAME_V2_FLAG:
                        length &= ~FRAME_V2_FLAG
                        if not _recv_exact_into(conn, eview, len(ext)):
                            return  # truncated ext header
                        flags, tlen, dl = FRAME_EXT_HEADER.unpack(ext)
                        priority = bool(flags & FRAME_PRIORITY)
                        want_spans = bool(flags & FRAME_SPANS)
                        if dl:
                            deadline_ms = dl
                        if tlen:
                            tbuf = bytearray(tlen)
                            if not _recv_exact_into(
                                    conn, memoryview(tbuf), tlen):
                                return
                            tenant = tbuf.decode("latin-1")
                        if flags & FRAME_REQID:
                            one = bytearray(1)
                            if not _recv_exact_into(
                                    conn, memoryview(one), 1):
                                return
                            rbuf = bytearray(one[0])
                            if rbuf and not _recv_exact_into(
                                    conn, memoryview(rbuf), len(rbuf)):
                                return
                            request_id = clean_request_id(bytes(rbuf))
                        if flags & FRAME_CRC:
                            cw = bytearray(FRAME_CRC_WORD.size)
                            if not _recv_exact_into(
                                    conn, memoryview(cw), len(cw)):
                                return
                            (crc,) = FRAME_CRC_WORD.unpack(cw)
                    if length > BODY_LIMIT_BYTES:
                        m = svc.metrics
                        m.inc("augmentation_requests_total")
                        m.inc("augmentation_invalid_requests_total")
                        m.inc_object("unsuccessful")
                        telemetry.REGISTRY.counter_inc(
                            "ldt_http_requests_total", lane="uds")
                        send_frame(conn, 413, [OVERSIZE_BODY],
                                   request_id=request_id)
                        return
                    if length > len(buf):
                        buf = bytearray(length)
                    if not _recv_exact_into(
                            conn, memoryview(buf)[:length], length):
                        return  # truncated frame: no resync possible
                except socket.timeout:
                    # best-effort explicit refusal, then close (the
                    # stream cannot resync mid-frame either way)
                    send_frame(conn, 408, [TIMEOUT_BODY])
                    return
                if tmo:
                    conn.settimeout(None)
                if crc is not None:
                    if faults.ACTIVE is not None:
                        seed = faults.corruption("frame_payload")
                        if seed is not None and length:
                            bad = faults.corrupt_buffer(
                                np.frombuffer(
                                    bytes(buf[:length]),
                                    dtype=np.uint8), seed)
                            buf[:length] = bad.tobytes()
                    ok = zlib.crc32(
                        memoryview(buf)[:length]) == crc
                    telemetry.REGISTRY.counter_inc(
                        "ldt_integrity_crc_total", lane="uds",
                        result="ok" if ok else "mismatch")
                    if not ok:
                        # the full body was consumed, so the stream
                        # is still framed: refuse THIS frame and keep
                        # the connection — never parse garbage
                        telemetry.REGISTRY.counter_inc(
                            "ldt_integrity_detected_total",
                            kind="frame_crc", lane="uds")
                        m = svc.metrics
                        m.inc("augmentation_requests_total")
                        m.inc("augmentation_invalid_requests_total")
                        m.inc_object("unsuccessful")
                        telemetry.REGISTRY.counter_inc(
                            "ldt_http_requests_total", lane="uds")
                        send_frame(conn, 400, [CRC_ERROR_BODY],
                                   request_id=request_id)
                        continue
                with self._lock:
                    self._inflight += 1
                try:
                    status, buffers = handle_frame(
                        svc, buf, detect=self._detect, nbytes=length,
                        tenant=tenant, deadline_ms=deadline_ms,
                        priority=priority, request_id=request_id,
                        want_spans=want_spans)
                    send_frame(conn, status, buffers,
                               request_id=request_id)
                finally:
                    with self._lock:
                        self._inflight -= 1
        except OSError:
            return              # peer reset / closed under us
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def close(self, drain_sec: float | None = None) -> None:
        import os
        with self._lock:
            self._closing = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        try:
            os.unlink(self.path)
        except OSError:
            pass
        deadline = time.monotonic() + (drain_sec or 0.0)
        while time.monotonic() < deadline:
            with self._lock:
                if self._inflight == 0:
                    break
            time.sleep(0.02)
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
