#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (language_detector_tpu_torch).

    python3 chip_smoke.py [--seed N] [--docs N]
    python3 chip_smoke.py --kernel-times [--port-root DIR]

Needs one CUDA card; exits non-zero on the first failed phase. Phases,
each printing one line:

  device    the card (nvidia-smi name and power limit, torch's name)
  build     nvcc builds csrc/fused_tote.cu for sm_90a from the checkout;
            the kernel's resident blocks per SM and the card's SM count
  parity    the fused-tote kernel against its plain PyTorch version on the
            card, word1 and full output, bit for bit: adversarial grids
            (ADVERSARIAL), real packer wires of every K bucket the corpus
            produces, the timing wire and the mixed batch's wire
  main      detect_codes over >= 4,096 documents built from
            eval_corpus.tsv (short slices, corpus documents, 10-50 KB
            concatenations, CJK runs, dense CJK runs), one call per K
            bucket, through the engine's stream scheduler at its
            defaults (pipeline depth 2, the long-doc lane off); the
            kernel must have launched once per device dispatch, at
            every K of 32 ... 256, and the answers
            must equal the port's own CPU run and detect_scalar on a
            256-document sample; the same documents as one shuffled
            batch must answer the same
  times     the kernel alone (a prepared launch), its wrapper
            (score_chunks_cuda: checks, output allocation, one launch) and
            the plain version on the card (CUDA events, median of reps)
            at the main path's dispatch shape (and the kernel on that grid
            with every row emptied), the kernel and wrapper on
            the mixed batch's own wire (all documents packed as one slice,
            K = 256), the device time of one trivial launch (the floor
            under any kernel's time), the bound for that work, and
            end-to-end documents per second per K bucket and as one
            shuffled batch
  breakdown host-clock pack / device / epilogue split of the first pass,
            one K group a dispatch, serially
  trace     torch.profiler over one pass of each: the device's busy share
            of the wall time (partial when the trace lost kernel
            records), the fused_tote launches the trace saw, and
            every other kernel it saw (check_trace: every launch a launch
            call in the trace, no other kernel, at least one fused_tote
            event and no more than the launches)
  accuracy_parity
            the engine's other paths on the same mix, run on the CPU
            (device="cpu") in worker processes while the scalar engine
            answers their samples: spans (detect_spans over
            span_subset: the 10-50 KB concatenations and 1,024 other
            documents; and a SPLIT_BUDGET engine over the
            concatenations),
            chunk vectors (detect_batch(return_chunks=True): want_ranges
            wires, full output), hinted plain text (one CLDHints a call,
            hint_groups; hint priors off and on: prior planes and whack
            rows) and HTML pages (html_pages); then the kernel against
            its plain version on the card, word1 and full output, bit
            for bit, on every wire those runs sent, and timed with its
            bound on each path's largest wire
  accuracy  each of those paths once on the card, under torch.profiler
            and a host-clock split (host_split): one launch a dispatch,
            [G, 2] outputs on the chunk path only, prior planes on the
            priors-on wires only, no other kernel in the trace, wires
            and answers equal to the CPU run's on every document, and
            answers equal to the scalar engine's on a seeded sample of
            256 (scalar_agrees); documents per second, the split and
            the documents the scalar engine resolved (engine_counts)
  scheduler detect_codes and detect_many through the stream scheduler
            (dedup, tier lanes, long-doc lane, retry lane) on the mix and
            on a duplicate-heavy copy of it (30% of positions copies), at
            pipeline depths 1, 2 and 3 with the long-doc lane on (the
            reference's default) and off (the port's): answers
            identical across configurations and equal to the port's
            CPU run (a spawned worker), launches
            equal to device dispatches on every call, no retried document
            off its tier, staging-ring hits at depth >= 2 and no release
            under a copy in flight; docs/s (median of 5 alternating
            passes), lane counters, overlap ratio and ring counters per
            configuration; one depth-2 pass under torch.profiler
            (check_trace); the kernel against its plain version on the
            largest long-doc and retry-lane wires; the card's part under
            60 s
  service   the service fronts on the card: the asyncio front (serve)
            and the threaded front (make_server) over DetectorService()
            (default device: CUDA), each with its unix-socket lane,
            answer the mix as requests of 1 ... 256 items (plus 65 and
            256) from 16 concurrent clients a lane, then every
            WIRE_CASES body (tests/test_wire.py's adversarial corpus)
            with the fast scanner on and off; every (status, request
            id, payload bytes) must equal the same traffic through the
            port's fronts on the CPU (a spawned worker), the kernel must
            have launched once per device dispatch, the breaker stayed
            closed, the scalar engine answered nothing, and the card's
            run took under 60 s; then one request with duplicates
            (dup_request) a front, whose answers must equal the main
            path's, after which each front's /metrics must show the
            scheduler's mixed-tier and dedup series above 0; docs/s,
            p50/p99 latency, flushes and their mean size per lane beside
            the card's name and power

--kernel-times runs only device, build and the kernel and wrapper times
on the timing and mixed wires (phase kernel_times). With --port-root it
imports language_detector_tpu_torch from another checkout (an earlier
commit unpacked with git archive), so two versions of the kernel can be
timed in turns on one card.

The last two lines are the kernel table as JSON (its launches count the
main path's, every accuracy path's, the scheduler phase's and the
service phase's) and the run's verdict,
{"ok": true, "device": {...}}. Imports torch, numpy and the port only.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
import multiprocessing
import os
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "build"

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, and the
# float32 rate outside the tensor cores. The data sheet lists no int32
# rate; this kernel's integer adds and compares are held to the float32
# rate, which Hopper's int32 units do not reach, so the operations bound
# is optimistic.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

HINT_BASE = 40960
K_BUCKETS = (32, 64, 128, 256)
H_WINDOW, N_WHACK, N_PRIOR = 64, 5, 4


def phase(name: str, **fields) -> None:
    print(f"phase {name}: " + json.dumps(fields, sort_keys=True),
          flush=True)


# -- adversarial grids (the same generator the CPU parity tests use) ------


def _langprob(rng, n):
    row = rng.integers(0, 256, n, dtype=np.uint32)
    ps = rng.integers(0, 256, (n, 3), dtype=np.uint32)
    ps[rng.random((n, 3)) < 0.3] = 0
    return (row | (ps[:, 0] << 8) | (ps[:, 1] << 16)
            | (ps[:, 2] << 24)).astype(np.uint32)


def synthetic_wire(rng, G, K, hint_frac=0.0, whack=True, empty_frac=0.0,
                   scripts=(1, 3, 6, 9), prior=False):
    cnsl = rng.integers(0, min(K, 255) + 1, G).astype(np.int64)
    if empty_frac:
        cnsl[rng.random(G) < empty_frac] = 0
    N = G * min(K, 255)
    idx = rng.integers(0, 4096, N).astype(np.uint16)
    if hint_frac:
        hints = rng.random(N) < hint_frac
        idx[hints] = (HINT_BASE + rng.integers(0, H_WINDOW,
                                               int(hints.sum()))
                      ).astype(np.uint16)
    cmeta = (rng.integers(0, 1500, G).astype(np.uint32)
             | (rng.integers(0, 600, G).astype(np.uint32) << 16)
             | (rng.integers(0, 2, G).astype(np.uint32) << 28)
             | (rng.integers(0, 2, G).astype(np.uint32) << 29))
    wire = {
        "idx": idx, "cnsl": cnsl.astype(np.uint8).reshape(1, G),
        "cmeta": cmeta.astype(np.uint32),
        "cscript": rng.choice(np.array(scripts, np.uint8), G),
        "cwhack": (rng.integers(0, N_WHACK, G).astype(np.uint16) if whack
                   else np.zeros(1, np.uint16)),
        "hint_lp": _langprob(rng, H_WINDOW),
        "whack_tbl": (rng.random((N_WHACK, 2, 256)) < 0.1
                      ).astype(np.uint8),
        "k_iota": np.arange(K, dtype=np.uint8),
    }
    if prior:
        tbl = rng.integers(0, 13, (N_PRIOR, 2, 256)).astype(np.uint8)
        tbl[rng.random((N_PRIOR, 2, 256)) < 0.7] = 0
        tbl[0] = 0
        wire["cprior"] = rng.integers(0, N_PRIOR, G).astype(np.uint16)
        wire["prior_tbl"] = tbl
    return wire


# (name, synthetic_wire arguments), each drawn from its own seed
_SYNTHETIC_CASES = [
    ("random-hints-whacks", dict(G=24, K=24, hint_frac=0.15,
                                 empty_frac=0.1)),
    ("whack-absent-dummy", dict(G=12, K=16, whack=False)),
    ("hint-window-only", dict(G=12, K=16, hint_frac=1.0, whack=False)),
    ("prior-planes", dict(G=24, K=24, hint_frac=0.1, prior=True)),
    ("prior-no-whack", dict(G=12, K=16, whack=False, prior=True)),
    ("script-latn", dict(G=12, K=16, scripts=(1,))),
    ("script-hani", dict(G=12, K=16, scripts=(3,))),
    ("script-arab", dict(G=12, K=16, scripts=(6,))),
    ("script-other", dict(G=12, K=16, scripts=(9,))),
    ("large-k32", dict(G=8192, K=32, hint_frac=0.05, prior=True)),
    ("large-k64", dict(G=8192, K=64, hint_frac=0.05)),
    ("large-k128", dict(G=4096, K=128, whack=False)),
    ("large-k256", dict(G=2048, K=256, hint_frac=0.1, prior=True)),
]

# every grid adversarial_wires returns, in its order
ADVERSARIAL = tuple(n for n, _ in _SYNTHETIC_CASES) + (
    "all-empty", "fat-rows-k256", "out-of-range-clamps",
    # the kernel's geometry: 8 rows per block, a persistent grid whose
    # blocks walk multi-row ranges, chunk starts restarting per shard row
    # (and, past 256 rows a block, in several scan tiles)
    "rows-8193-k64", "rows-65536-k32", "two-shard", "empty-end-shards",
    "tiles-3-shards-k8")


def adversarial_wires(seed: int) -> list:
    out = []
    for i, (name, kw) in enumerate(_SYNTHETIC_CASES):
        out.append((name, synthetic_wire(np.random.default_rng(seed + i),
                                         **kw)))
    rng = np.random.default_rng(seed + 100)
    empty = synthetic_wire(rng, G=16, K=8)
    empty["cnsl"][:] = 0
    empty["idx"] = empty["idx"][:1]
    out.append(("all-empty", empty))
    fat = synthetic_wire(rng, G=64, K=256, hint_frac=0.1)
    fat["cnsl"][:] = 255
    out.append(("fat-rows-k256", fat))
    clamp = synthetic_wire(rng, G=64, K=16, prior=True)
    clamp["idx"][::3] = 40000
    clamp["idx"][1::5] = 0xFFFF
    clamp["cwhack"][::2] = 999
    clamp["cprior"][1::2] = 999
    out.append(("out-of-range-clamps", clamp))

    rng = np.random.default_rng(seed + 200)
    out.append(("rows-8193-k64", synthetic_wire(
        rng, G=8193, K=64, hint_frac=0.05, prior=True)))
    out.append(("rows-65536-k32", synthetic_wire(
        rng, G=65536, K=32, hint_frac=0.05, empty_frac=0.1)))
    two = synthetic_wire(rng, G=2 * 2048, K=64, hint_frac=0.05, prior=True)
    two["cnsl"] = two["cnsl"].reshape(2, 2048)
    two["idx"] = two["idx"].reshape(2, -1)
    out.append(("two-shard", two))
    ends = synthetic_wire(rng, G=4 * 2051, K=32, hint_frac=0.05)
    ends["cnsl"] = ends["cnsl"].reshape(4, 2051)
    ends["cnsl"][0] = 0
    ends["cnsl"][-1] = 0
    ends["idx"] = ends["idx"].reshape(4, -1)
    out.append(("empty-end-shards", ends))
    tiles = synthetic_wire(rng, G=3 * 100_000, K=8, empty_frac=0.2)
    tiles["cnsl"] = tiles["cnsl"].reshape(3, 100_000)
    out.append(("tiles-3-shards-k8", tiles))
    assert tuple(n for n, _ in out) == ADVERSARIAL
    return out


def s1_clip_case(dt):
    """Doctored qprob rows push chunk totes past the 14-bit s1 clip."""
    import dataclasses
    lg3 = dt.lg_prob3.cpu().numpy().copy()
    lg3[100], lg3[101] = 255, 63
    doctored = dataclasses.replace(
        dt, lg_prob3=torch.from_numpy(lg3).to(dt.device))
    mk = lambda row, n: np.full(n, row | (37 << 8), np.uint32)  # noqa: E731
    hint_lp = np.concatenate([
        mk(100, 100), np.zeros(28, np.uint32),
        mk(100, 64), mk(101, 1), np.zeros(63, np.uint32),
        mk(100, 64), np.zeros(64, np.uint32)])
    G, K = 3, 128
    wire = {
        "idx": (HINT_BASE + np.arange(G * K)).astype(np.uint16),
        "cnsl": np.full((1, G), K, np.uint8),
        "cmeta": np.full(G, 500 | (100 << 16) | (1 << 29), np.uint32),
        "cscript": np.full(G, 1, np.uint8),
        "cwhack": np.zeros(1, np.uint16), "hint_lp": hint_lp,
        "whack_tbl": np.zeros((1, 2, 256), np.uint8),
        "k_iota": np.arange(K, dtype=np.uint8),
    }
    return doctored, wire


# -- documents --------------------------------------------------------------


def build_docs(corpus: list, seed: int, n: int) -> list:
    """Short slices, corpus documents and their concatenations, 10-50 KB
    concatenations, CJK runs and dense CJK runs, made from the eval
    corpus with `seed`. The dense runs draw from the first 256 unified
    ideographs, whose unigram and bigram hits fill chunks past 128 slots,
    so the mix reaches every K bucket (32 ... 256)."""
    rng = random.Random(seed)
    docs = []
    n_long, n_cjk, n_dense = 48, 96, 128
    n_rest = n - n_long - n_cjk - n_dense
    for _ in range(n_rest * 2 // 3):
        t = rng.choice(corpus)
        lo = rng.randrange(max(1, len(t) - 10))
        docs.append(t[lo:lo + rng.randint(8, 300)])
    while len(docs) < n_rest:
        docs.append(" ".join(rng.choice(corpus)
                             for _ in range(rng.randint(1, 5))))
    for _ in range(n_long):
        target = rng.randint(10_000, 50_000)
        parts, size = [], 0
        while size < target:
            parts.append(rng.choice(corpus))
            size += len(parts[-1]) + 1
        docs.append(" ".join(parts))
    for _ in range(n_cjk):
        docs.append("".join(chr(rng.randrange(0x4E00, 0x9FFF))
                            for _ in range(rng.randint(300, 3000))))
    for _ in range(n_dense):
        docs.append("".join(chr(rng.randrange(0x4E00, 0x4F00))
                            for _ in range(rng.randint(1500, 4000))))
    rng.shuffle(docs)
    return docs


def k_of(native, docs, tables, reg) -> int:
    return int(native.pack_chunks_native(docs, tables, reg)
               .wire["k_iota"].shape[0])


def group_by_k(docs, native, tables, reg, min_group: int) -> dict:
    """Split docs by the K bucket each one packs into alone; a group too
    small for the device path (<= min_group docs) joins the next wider
    one, and the widest, if too small, takes in the next narrower one
    (a group packs at its widest document's K)."""
    by_k: dict = {}
    for d in docs:
        by_k.setdefault(k_of(native, [d], tables, reg), []).append(d)
    ks = sorted(by_k)
    for i, k in enumerate(ks[:-1]):
        if len(by_k[k]) <= min_group:
            by_k[ks[i + 1]] = by_k.pop(k) + by_k[ks[i + 1]]
    ks = sorted(by_k)
    if len(ks) > 1 and len(by_k[ks[-1]]) <= min_group:
        by_k[ks[-1]] += by_k.pop(ks[-2])
    return dict(sorted(by_k.items()))


def timing_wire(pool, native, tables, reg, seed: int):
    """A wire of the main path's dispatch shape: docs that pack at
    K <= 64, added until the slot lane reaches the 163,840 bucket."""
    rng = random.Random(seed)
    docs: list = []
    while True:
        docs.extend(rng.choice(pool) for _ in range(256))
        cb = native.pack_chunks_native(docs, tables, reg)
        if int(cb.n_slots.sum()) > 131072:
            return cb, len(docs)


# -- measurement ------------------------------------------------------------


def device_ms(fn, reps: int, inner: int) -> float:
    """Median device time of one fn() call: the stream is held by a
    sleep kernel while `inner` calls are enqueued, so the events bracket
    device work only (not the host's launch overhead)."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(dt, p: dict, full_out: bool) -> tuple:
    """Least time for this call's work on the card: bytes (each input
    read once — slots this data uses, row planes, the tables — each
    output written once) over HBM bandwidth, against operations (3 tote
    adds per used slot; whack, prior, group test and two max passes per
    language per row) over the peak rate. Returns (ms, bound_by, bytes,
    operations)."""
    cnsl = p["cnsl"].reshape(-1).to(torch.int64).clamp(max=p["K"])
    slots = int(cnsl.sum())
    G = cnsl.numel()
    nbytes = slots * 2 + G * (1 + 4 + 1)              # idx, cnsl/cmeta/script
    nbytes += p["hint_lp"].numel() * 4
    if p["cwhack"].shape[-1] != 1:
        nbytes += G * 2 + p["whack_tbl"].numel()
    if "cprior" in p:
        nbytes += G * 2 + p["prior_tbl"].numel()
    for t in (dt.cat_ind2, dt.lg_prob3, dt.plang_to_lang,
              dt.expected_score, dt.close_set):
        nbytes += t.numel() * t.element_size()
    nbytes += G * 4 * (2 if full_out else 1)
    ops = 3 * slots + G * 256 * 5
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, ops
    return t_ops, "operations", nbytes, ops


def device_busy(fn, count=None) -> dict:
    """Run fn() once under torch.profiler and read the device's share of
    the wall time from the trace: the union of its kernel, copy and
    memset intervals over the host-clock seconds of the call (the
    profiler's own host cost is inside that wall time). Also the trace's
    fused_tote kernel count and device time, and the count and names of
    every other kernel it holds. Busy fields are None when the trace
    holds no device events; when it holds fewer fused_tote records than
    launches, the busy time it does hold goes under partial_busy_s /
    partial_busy_share instead, as a lower bound. count: a launch
    counter read just inside the traced window, at its start and after
    the device is idle, so "launches" counts what the trace could see;
    "launch_calls" counts the trace's kernel-launch API records (every
    launch in the window, whoever made it)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n0 = count() if count else None
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = count() - n0 if count else None
    BUILD.mkdir(parents=True, exist_ok=True)
    path = BUILD / f"chip_smoke_trace.{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink()
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("ph") == "X" and e.get("cat") in
                   ("kernel", "gpu_memcpy", "gpu_memset"))
    kernel_events = [e for e in events if e.get("ph") == "X"
                     and e.get("cat") == "kernel"]
    ours = [e.get("dur", 0) for e in kernel_events
            if "fused_tote_kernel" in e.get("name", "")]
    others = sorted({e.get("name", "") for e in kernel_events
                     if "fused_tote_kernel" not in e.get("name", "")})
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    busy = busy_us / 1e6 if spans else None
    # a trace that lost kernel records understates the device's part:
    # its busy time is reported only as partial
    complete = n_launch is None or len(ours) == n_launch
    return {"wall_s": wall, "device_events": len(spans),
            "device_busy_s": busy if complete else None,
            "device_busy_share":
                busy / wall if complete and spans else None,
            "partial_busy_s": None if complete else busy,
            "partial_busy_share":
                None if complete or not spans else busy / wall,
            "fused_tote_traced": len(ours),
            "fused_tote_traced_ms": sum(ours) / 1e3,
            "other_kernels": len(kernel_events) - len(ours),
            "other_kernel_names": others, "launches": n_launch,
            "launch_calls": sum(
                1 for e in events if e.get("ph") == "X" and
                e.get("cat") in ("cuda_runtime", "cuda_driver") and
                "LaunchKernel" in e.get("name", ""))}


def check_trace(name: str, t: dict) -> None:
    """Every launch of a traced window is in its trace as a launch call,
    no other kernel ran, and the trace holds at least one and at most
    that many fused_tote kernel events (a multi-threaded window may lose
    the device records of its first launches; PERF.md section 7)."""
    if not (t["launches"] == t["launch_calls"] > 0 and
            0 < t["fused_tote_traced"] <= t["launches"]) or \
            t["other_kernels"]:
        raise AssertionError(
            f"{name}: {t['launches']} launches, {t['launch_calls']} launch "
            f"calls, {t['fused_tote_traced']} traced fused_tote launches "
            f"and {t['other_kernels']} other kernels "
            f"{t['other_kernel_names']}; want one launch a dispatch, each "
            "traced")


def quiesce(kernels, still_s: float = 0.2, limit_s: float = 10.0) -> None:
    """Wait until no kernel has launched for still_s seconds (at most
    limit_s) and the device is idle: a flush still running from earlier
    traffic must not straddle a traced window's start."""
    t_end = time.monotonic() + limit_s
    n = kernels.launches
    while time.monotonic() < t_end:
        time.sleep(still_s)
        if kernels.launches == n:
            break
        n = kernels.launches
    torch.cuda.synchronize()


def kernel_and_wrapper_ms(kernels, dt, p: dict) -> dict:
    """Device time of the kernel alone (a prepared launch) and through its
    wrapper (score_chunks_cuda) on one wire, in turns: kernel, wrapper,
    wrapper, kernel."""
    call = kernels.prepare(dt, p)
    alone = lambda: kernels.launch(call)                      # noqa: E731
    wrapped = lambda: kernels.score_chunks_cuda(dt, p)        # noqa: E731
    k1 = device_ms(alone, 30, 20)
    w1 = device_ms(wrapped, 30, 20)
    w2 = device_ms(wrapped, 30, 20)
    k2 = device_ms(alone, 30, 20)
    return {"kernel_ms": [k1, k2], "wrapper_ms": [w1, w2]}


def wire_shape(cb) -> dict:
    """G, K and slot counts of a packed wire: slots the packer resolved
    and slots the kernel reads (each row's count, capped at K)."""
    return {**wire_shape_of(cb.wire), "slots": int(cb.n_slots.sum())}


def wire_shape_of(wire: dict) -> dict:
    """G, K, N and the slots the kernel reads (each row's count, capped
    at K) of a wire."""
    cnsl = wire["cnsl"].astype(np.int64)
    K = int(wire["k_iota"].shape[0])
    return {"G": int(cnsl.size), "K": K, "N": int(wire["idx"].size),
            "row_slots": int(np.minimum(cnsl, K).sum())}


def first_pass_breakdown(eng, groups: dict, native) -> dict:
    """Host-clock split of the main path's first pass, one K group a
    dispatch, serially (no scheduler, no gate retry): pack, device (wire
    copy + kernel + readback) and epilogue seconds, summed over the K
    groups, and the retry pass's share of the docs."""
    t = {"pack_s": 0.0, "device_s": 0.0, "epilogue_s": 0.0}
    retry = 0
    for g in groups.values():
        t0 = time.monotonic()
        cb = eng._pack(g)
        t1 = time.monotonic()
        rows = eng._fetch_rows(cb, eng._launch(cb))
        t2 = time.monotonic()
        ep = native.epilogue_flat_native(rows, cb, eng.flags, eng.reg)
        t3 = time.monotonic()
        t["pack_s"] += t1 - t0
        t["device_s"] += t2 - t1
        t["epilogue_s"] += t3 - t2
        retry += int(ep[:len(g), 12].sum())
    t["retry_docs"] = retry
    return t


# -- the accuracy paths: hinted, HTML, chunk vectors, spans -----------------

HINT_TLDS = ("fr", "jp", "ru", "id", "br", "de", "my", "rs")
HINT_ENCODINGS = ("CHINESE_GB", "JAPANESE_EUC_JP", "KOREAN_EUC_KR",
                  "RUSSIAN_CP1251", "MSFT_CP1252")
SPLIT_BUDGET = 64            # the small-budget span engine's sub-doc slots
SPAN_SHORT_DOCS = 1024       # shorter documents on the span path


def hint_groups(groups: dict, answer: dict, labels: list, reg, seed: int,
                size: int = 256) -> list:
    """The mix as hinted calls, one hint object per call (the API applies
    one to a whole call): each K bucket's documents sorted by their plain
    answer and cut into runs of `size`. Run i takes, by i mod 6:
    content-language set to the run's most common answer (right for most
    of its docs); content-language set to a corpus label drawn at random
    (wrong for most); a TLD; an encoding; an explicit language (a random
    label); or several at once. Returns [(CLDHints keyword arguments,
    docs)]."""
    rng = random.Random(seed)
    out = []
    for g in groups.values():
        ordered = sorted(g, key=lambda d: answer[d])
        for s in range(0, len(ordered), size):
            run = ordered[s:s + size]
            common = statistics.mode(answer[d] for d in run)
            label = rng.choice(labels)
            kind = len(out) % 6
            if kind == 0:
                kw = {"content_language_hint": common}
            elif kind == 1:
                kw = {"content_language_hint": label}
            elif kind == 2:
                kw = {"tld_hint": rng.choice(HINT_TLDS)}
            elif kind == 3:
                kw = {"encoding_hint": rng.choice(HINT_ENCODINGS)}
            elif kind == 4:
                kw = {"language_hint": reg.code_to_lang[label]}
            else:
                kw = {"content_language_hint": f"{common},{label}",
                      "tld_hint": rng.choice(HINT_TLDS),
                      "encoding_hint": rng.choice(HINT_ENCODINGS)}
            out.append((kw, run))
    return out


def html_pages(docs: list, answer: dict, labels: list, seed: int) -> list:
    """Each document as a web page: a lang= attribute (its plain answer
    on half the pages, a random corpus label, mostly wrong, on a quarter,
    none on the rest), a <style> and a <script> block holding words of
    another document, and entities around the escaped body."""
    rng = random.Random(seed)
    out = []
    for d in docs:
        r = rng.random()
        lang = (answer[d] if r < 0.5 else
                rng.choice(labels) if r < 0.75 else None)
        attr = f' lang="{lang}"' if lang else ""
        other = rng.choice(docs)[:60].replace("<", " ").replace('"', " ")
        body = d.replace("&", "&amp;").replace("<", "&lt;")
        out.append(f"<!DOCTYPE html><html{attr}><head><title>{body[:40]}"
                   f"</title><style>p {{ font-family: \"{other}\" }}"
                   f"</style><script>var s = \"{other}\";</script></head>"
                   f"<body><p>{body}</p><p>&copy; 2026 &mdash; caf&eacute;"
                   " &#8364;5 &amp; more</p></body></html>")
    return out


def answer_rows(results) -> list:
    """One comparable tuple a result: summary fields, chunk records and
    span records."""
    return [(int(r.summary_lang), tuple(r.language3), tuple(r.percent3),
             tuple(r.normalized_score3), int(r.text_bytes),
             bool(r.is_reliable),
             tuple((c.offset, c.bytes, c.lang1) for c in r.chunks or ()),
             tuple(tuple(x) for x in r.spans or ())) for r in results]


def span_subset(docs: list, seed: int) -> list:
    """The span path's documents: every 10-50 KB concatenation and a
    seeded SPAN_SHORT_DOCS of the rest, in mix order. The span path
    resolves the long documents' exceptions in the scalar engine once
    unsplit and once more split, which took it past 60 s on the whole
    mix; the cut keeps what splits."""
    short = [i for i, d in enumerate(docs) if len(d) < 10_000]
    keep = set(random.Random(seed).sample(short, SPAN_SHORT_DOCS))
    return [d for i, d in enumerate(docs) if len(d) >= 10_000 or i in keep]


def accuracy_paths(docs: list, span_docs: list, long_docs: list,
                   hgroups: list, html: list, CLDHints) -> dict:
    """name -> (run, n_docs): run(engines) drives one path through the
    engines' public entry points (engines: "plain", "priors" with hint
    priors on, "small" with the SPLIT_BUDGET span budget) and returns its
    answer_rows in a fixed order."""
    def spans(E):
        return (answer_rows(E["plain"].detect_spans(span_docs)) +
                answer_rows(E["small"].detect_spans(long_docs)))

    def chunks(E):
        return answer_rows(E["plain"].detect_batch(docs, return_chunks=True))

    def hinted(key):
        def run(E):
            out = []
            for kw, g in hgroups:
                out += answer_rows(E[key].detect_batch(
                    g, hints=CLDHints(**kw)))
            return out
        return run

    def html_run(E):
        return answer_rows(E["plain"].detect_batch(html,
                                                   is_plain_text=False))

    n_hinted = sum(len(g) for _, g in hgroups)
    return {"spans": (spans, len(span_docs) + len(long_docs)),
            "chunks": (chunks, len(docs)),
            "hinted_priors_off": (hinted("plain"), n_hinted),
            "hinted_priors_on": (hinted("priors"), n_hinted),
            "html": (html_run, len(html))}


def cjk_run(text: str) -> bool:
    """A document of unified ideographs only (the mix's CJK runs)."""
    return bool(text) and all("\u4e00" <= c <= "\u9fff" for c in text)


def scalar_agrees(got: tuple, want: tuple, base_doc: str) -> bool:
    """An engine answer row against the scalar engine's. On CJK runs the
    reference's packer may give one character to the neighbouring chunk
    where the scalar engine does not (the JAX engine does the same;
    ROADMAP queue C): the tote scores are equal but chunk bytes, and so
    reliability, percentages and normalized scores, may differ. There
    only the summary language and the span boundaries and codes must
    agree; everywhere else the whole row."""
    if got == want:
        return True
    return cjk_run(base_doc) and got[0] == want[0] and \
        [x[:3] for x in got[7]] == [x[:3] for x in want[7]]


def scalar_oracles(docs: list, span_docs: list, long_docs: list,
                   hgroups: list, html: list, tables, reg, CLDHints,
                   budget: int) -> dict:
    """name -> (oracle, base docs): oracle(i) is the scalar engine's
    answer for item i of the path's answer list and base docs[i] the
    plain document behind it; None where the scalar engine has no
    counterpart (hint priors exist only on the device path)."""
    from language_detector_tpu_torch.engine_scalar import (
        detect_scalar, detect_scalar_spans)
    hinted = [(kw, d) for kw, g in hgroups for d in g]

    def spans(i):
        if i < len(span_docs):
            return detect_scalar_spans(span_docs[i], tables, reg, 0,
                                       budget)
        return detect_scalar_spans(long_docs[i - len(span_docs)], tables,
                                   reg, 0, SPLIT_BUDGET)

    def hint(i):
        kw, d = hinted[i]
        return detect_scalar(d, tables, reg, hints=CLDHints(**kw))

    return {"spans": (spans, span_docs + long_docs),
            "chunks": (lambda i: detect_scalar(docs[i], tables, reg,
                                               want_chunks=True), docs),
            "hinted_priors_off": (hint, [d for _, d in hinted]),
            "hinted_priors_on": None,
            "html": (lambda i: detect_scalar(html[i], tables, reg,
                                             is_plain_text=False), docs)}


def engine_set(tables, reg, device) -> dict:
    """The accuracy paths' engines on one device: "plain" (hint priors
    off, span budget 1024), "priors" (hint priors on) and "small" (span
    budget SPLIT_BUDGET)."""
    from language_detector_tpu_torch.models.ngram import NgramBatchEngine
    return {"plain": NgramBatchEngine(tables, reg, device=device,
                                      hint_priors=False,
                                      longdoc_chunk_slots=1024),
            "priors": NgramBatchEngine(tables, reg, device=device,
                                       hint_priors=True,
                                       longdoc_chunk_slots=1024),
            "small": NgramBatchEngine(tables, reg, device=device,
                                      hint_priors=False,
                                      longdoc_chunk_slots=SPLIT_BUDGET)}


def engine_counts(engines) -> dict:
    """The engines' counters, summed: device dispatches, and documents
    resolved by the scalar engine (packer fallbacks; gate failures). On
    the span path they count whole documents only, not sub-documents."""
    snaps = [e.stats_snapshot() for e in engines]
    return {k: sum(s[k] for s in snaps) for k in (
        "device_dispatches", "fallback_docs", "scalar_recursion_docs")}


def scalar_samples(paths: dict, n_span_docs: int, seed: int) -> dict:
    """name -> the seeded sample of items held against the scalar engine
    (256 a path, and 4 of the small-budget span items besides)."""
    out = {}
    for name, (_, n_items) in paths.items():
        if name == "hinted_priors_on":   # priors exist only on the device
            continue
        rng = random.Random(seed)
        out[name] = rng.sample(range(n_items), 256)
        if name == "spans":
            out[name] += rng.sample(range(n_span_docs, n_items), 4)
    return out


def cpu_reference(name: str, inputs: tuple) -> tuple:
    """Worker process: one accuracy path on the CPU (device="cpu", the
    plain scorer); returns its answers and the dispatches it made."""
    torch.set_num_threads(2)
    from language_detector_tpu_torch.hints import CLDHints
    from language_detector_tpu_torch.registry import registry as reg
    from language_detector_tpu_torch.tables import load_tables
    run, _ = accuracy_paths(*inputs, CLDHints)[name]
    engines = engine_set(load_tables(), reg, "cpu")
    with DispatchRecorder(engines.values()) as rec:
        answers = run(engines)
    return answers, rec.sorted_records()


def scalar_reference(samples: dict, inputs: tuple) -> dict:
    """Worker process: the scalar engine's answers for the samples,
    name -> [(item, answer row, the plain document behind it)]."""
    from language_detector_tpu_torch.hints import CLDHints
    from language_detector_tpu_torch.registry import registry as reg
    from language_detector_tpu_torch.tables import load_tables
    oracles = scalar_oracles(*inputs, load_tables(), reg, CLDHints, 1024)
    out = {}
    for name, items in samples.items():
        oracle, base = oracles[name]
        out[name] = [(i, answer_rows([oracle(i)])[0], base[i])
                     for i in items]
    return out


def wires_equal(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def wire_digest(wire: dict) -> str:
    """A digest of a wire's planes (names, types, shapes, bytes): the
    order in which two runs' dispatches are compared, since the
    scheduler's worker threads launch in no fixed order."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    for k in sorted(wire):
        a = np.ascontiguousarray(wire[k])
        h.update(f"{k}:{a.dtype}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


class DispatchRecorder:
    """Records every dispatch the engines make inside the block: a copy
    of the wire (numpy, as packed: its staging lease is reused once the
    dispatch retires), its lane, whether full output was asked for, and
    the output's shape. `records` is in launch order; `sorted_records`
    in wire-digest order, for comparing two runs."""

    def __init__(self, engines):
        self.engines = list(engines)
        self.records: list = []

    def __enter__(self):
        for eng in self.engines:
            def launch(cb, lane="main", full_out=False, _orig=eng._launch):
                wire = {k: np.array(v) for k, v in cb.wire.items()}
                fut = _orig(cb, lane, full_out)
                self.records.append({"wire": wire, "lane": lane,
                                     "full_out": full_out,
                                     "out_shape": tuple(fut.out.shape)})
                return fut
            eng._launch = launch
        return self

    def sorted_records(self) -> list:
        return sorted(self.records, key=lambda r: (wire_digest(r["wire"]),
                                                   r["full_out"]))

    def __exit__(self, *exc):
        for eng in self.engines:
            del eng._launch
        return False


@contextlib.contextmanager
def host_split(ngram):
    """Host-clock split of the engine calls made inside the block, by
    wrapping the names models/ngram.py calls: pack, device (wire copy
    and launch, then the wait and readback), epilogue, input preparation
    (hints, prior planes, HTML cleaning), host records (result-vector
    records and merges, span splits and records) and scalar resolution.
    Yields the dict of seconds it fills."""
    acc: dict = {}
    keys = {"pack_s": [(ngram.NgramBatchEngine, "_pack")],
            "device_s": [(ngram.NgramBatchEngine, "_launch"),
                         (ngram.DeviceResult, "__array__")],
            "epilogue_s": [(ngram.native, "epilogue_flat_native")],
            "prep_s": [(ngram, "apply_hints"), (ngram, "prior_vector"),
                       (ngram, "clean_html")],
            "host_records_s": [(ngram, "build_doc_records"),
                               (ngram, "chunks_for_doc"),
                               (ngram, "merge_longdoc_chunks"),
                               (ngram, "split_for_spans"),
                               (ngram, "span_coverage_records")],
            "scalar_s": [(ngram, "detect_scalar"),
                         (ngram, "detect_scalar_spans")]}
    patched = []

    def timed(fn, key):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
        return call

    try:
        for key, owners in keys.items():
            acc[key] = 0.0
            for owner, name in owners:
                fn = owner.__dict__[name] if isinstance(owner, type) \
                    else getattr(owner, name)
                patched.append((owner, name, fn))
                setattr(owner, name, timed(fn, key))
        yield acc
    finally:
        for owner, name, fn in reversed(patched):
            setattr(owner, name, fn)


# -- service fronts ----------------------------------------------------------

# tests/test_wire.py's adversarial request bodies, copied (the port's
# tests hold this copy equal to that list)
_WIRE_BIG_BODY = json.dumps(
    {"request": [{"text": f"document number {i} with some text"}
                 for i in range(1500)]}).encode()
_WIRE_LONG_DOC = json.dumps({"request": [{"text": "word " * 10000}]}).encode()
WIRE_CASES = [
    b'{"request": [{"text": "hello world"}]}',
    b'{"request":[{"text":"compact"}]}',
    b'{ "request" : [ { "text" : "spaced" } ] }',
    b'{\n\t"request": [\r\n{"text": "ws"}\n]\n}',
    b'{"request": []}',
    b'{"request": [{"text": ""}]}',
    b'{"request": [{"text": "a"}, {"text": "b"}, {"text": "c"}]}',
    b'{"request": [{"text": "a"} , {"text": "b"}]}',
    json.dumps({"request": [{"text": "café 中文"}]}).encode(),
    json.dumps({"request": [{"text": "café 中文"}]},
               ensure_ascii=False).encode(),
    json.dumps({"request": [{"text": "emoji \U0001f600 end"}]}).encode(),
    json.dumps({"request": [{"text": "emoji \U0001f600 end"}]},
               ensure_ascii=False).encode(),
    b'{"request": [{"text": "esc \\" q \\\\ b \\n nl \\u0041"}]}',
    b'{"request": [{"text": "ends in backslash \\\\"}]}',
    b'{"request": [{"text": "\\ud83d\\ude00"}]}',
    b'{"request": [{"text": "dup", "text": "dup2"}]}',
    b'{"request": [{"text": "x", "extra": 1}]}',
    b'{"request": [{"other": "x"}]}',
    b'{"request": [{"text": 5}]}',
    b'{"request": [{"text": null}]}',
    b'{"request": [{"text": ["a"]}]}',
    b'{"request": [{"text": {"deep": {"er": 1}}}]}',
    b'{"request": ["nope"]}',
    b'{"request": [17]}',
    b'{"request": "nope"}',
    b'{"request": 5}',
    b'{"request": [{"text": NaN}]}',
    b'{"other": []}',
    b'{}',
    b'[]',
    b'5',
    b'',
    b'{"request": [{"text": "a"}]} trailing',
    b'{"request": [{"text": "a"}]',
    b'{"request": [{"text": "a"',
    b'{"request": [{"text": "unterminated',
    b'{"request": [{"text"',
    b'{"request": [{',
    b'{"request',
    b'{',
    b'not json{{',
    b'{"request": [{"text": "ctrl \x01 char"}]}',
    b'{"request": [{"text": "tab\ttab"}]}',
    json.dumps({"request": [{"text": "line sep"}]},
               ensure_ascii=False).encode(),
    b'{"request": [{"text": "hi @user see http://x.com now"}]}',
    _WIRE_BIG_BODY,
    _WIRE_LONG_DOC,
]

SERVICE_CLIENTS = 16         # concurrent clients per front and lane
SERVICE_MAX_ITEMS = 256      # request sizes are drawn from 1 ... this
SERVICE_FIXED = (65, 65, 256, 256)   # fixed request sizes besides
SERVICE_LANES = ("aio-http", "aio-uds", "threaded-http", "threaded-uds")
SERVICE_BODY_BYTES = 1_000_000   # under the fronts' 1 MB body limit


def service_requests(docs: list, seed: int) -> list:
    """Request bodies over the mix: sizes drawn from 1 ... 256 with the
    seed until every document (shuffled) is used, then the fixed sizes
    (65 and 256 items, of documents under 2,000 chars). Bodies alternate
    between \\u-escaped and raw UTF-8 JSON; a draw whose body would
    pass the 1 MB body limit takes fewer documents."""
    rng = random.Random(seed)
    order = list(range(len(docs)))
    rng.shuffle(order)

    def body(texts, k):
        return json.dumps({"request": [{"text": t} for t in texts]},
                          ensure_ascii=k % 2 == 0).encode()

    out, i = [], 0
    while i < len(order):
        n = rng.randint(1, SERVICE_MAX_ITEMS)
        while True:
            b = body([docs[j] for j in order[i:i + n]], len(out))
            if len(b) <= SERVICE_BODY_BYTES or n == 1:
                break
            n = max(1, n * SERVICE_BODY_BYTES // len(b))
        out.append(b)
        i += n
    fixed = [d for d in docs if len(d) < 2000]
    for n in SERVICE_FIXED:
        out.append(body(rng.sample(fixed, n), len(out)))
    return out


class Fronts:
    """Both fronts of one package in this process on ephemeral ports,
    each with its unix-socket lane: the asyncio front (`serve`, its lane
    opened through LDT_UNIX_SOCKET) on a thread of its own, and the
    threaded front (`make_server` plus `wire.UnixFrameServer`). The
    package is the port here; the tests also pass the reference.
    make_service(server module, threaded) builds each front's
    DetectorService."""

    def __init__(self, package: str, make_service, sock_dir: str):
        import asyncio
        import importlib
        import threading
        server, aioserver, wire = (
            importlib.import_module(f"{package}.service.{m}")
            for m in ("server", "aioserver", "wire"))
        self.wire = wire
        os.makedirs(sock_dir, exist_ok=True)
        self.uds = {"aio": os.path.join(sock_dir, "aio.sock"),
                    "threaded": os.path.join(sock_dir, "thr.sock")}
        self.svc = {"threaded": make_service(server, True),
                    "aio": make_service(server, False)}
        self.httpd, self.metricsd, _ = server.make_server(
            0, 0, service=self.svc["threaded"])
        self._threads = [threading.Thread(target=s.serve_forever,
                                          daemon=True)
                         for s in (self.httpd, self.metricsd)]
        for t in self._threads:
            t.start()
        self.uds_server = wire.UnixFrameServer(self.svc["threaded"],
                                               self.uds["threaded"])
        self.uds_server.start()
        box: dict = {}
        started = threading.Event()

        async def run():
            loop = asyncio.get_running_loop()
            ready = loop.create_future()
            box["loop"] = loop
            box["task"] = loop.create_task(aioserver.serve(
                0, 0, svc=self.svc["aio"], ready=ready))
            box["ports"] = await ready
            started.set()
            with contextlib.suppress(asyncio.CancelledError):
                await box["task"]

        old = os.environ.get("LDT_UNIX_SOCKET")
        os.environ["LDT_UNIX_SOCKET"] = self.uds["aio"]
        try:
            self._aio = threading.Thread(target=asyncio.run, args=(run(),),
                                         daemon=True)
            self._aio.start()
            if not started.wait(120):
                raise RuntimeError("the asyncio front did not start")
        finally:
            if old is None:
                os.environ.pop("LDT_UNIX_SOCKET", None)
            else:
                os.environ["LDT_UNIX_SOCKET"] = old
        self._box = box
        self.port = {"aio": box["ports"][0],
                     "threaded": self.httpd.server_address[1]}
        self.metrics_port = {"aio": box["ports"][1],
                             "threaded": self.metricsd.server_address[1]}

    def close(self) -> None:
        box = self._box
        box["loop"].call_soon_threadsafe(box["task"].cancel)
        self._aio.join(30)
        self.uds_server.close()
        self.httpd.shutdown()
        self.metricsd.shutdown()
        self.httpd.server_close()
        self.metricsd.server_close()
        self.svc["threaded"].batcher.close()


class ServiceClient:
    """One client's connections to a front: HTTP/1.1 keep-alive and a
    unix-socket frame connection, each reopened after the server closes
    it. Answers are (status, echoed request id, payload bytes)."""

    def __init__(self, fronts: Fronts, front: str):
        import http.client
        self.fronts, self.front = fronts, front
        self.http = http.client.HTTPConnection(
            "127.0.0.1", fronts.port[front], timeout=120)
        self.sock = None

    def post(self, body: bytes, request_id: str | None) -> tuple:
        hdrs = {"Content-Type": "application/json"}
        if request_id is not None:
            hdrs["X-LDT-Request-Id"] = request_id
        self.http.request("POST", "/", body, hdrs)
        r = self.http.getresponse()
        payload = r.read()
        return r.status, r.getheader("X-LDT-Request-Id"), payload

    def frame(self, body: bytes, request_id: str | None) -> tuple:
        """A v2 frame carrying the request id, or a v1 frame without."""
        import socket
        wire = self.fronts.wire
        if self.sock is None:
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self.sock.settimeout(120)
            self.sock.connect(self.fronts.uds[self.front])
        self.sock.sendall(wire.pack_frame(body, request_id=request_id))
        status, rid, payload = wire.recv_response_frame(self.sock)
        if status == 413:        # the lane closes after an oversize frame
            self.close_socket()
        return status, rid, payload

    def close_socket(self) -> None:
        if self.sock is not None:
            self.sock.close()
            self.sock = None

    def close(self) -> None:
        self.http.close()
        self.close_socket()


def drive_lane(fronts: Fronts, lane: str, bodies: list,
               clients: int = SERVICE_CLIENTS) -> tuple:
    """Send every body once through one front's lane ("aio-http", ...)
    from `clients` concurrent clients. Request i carries the id
    "<lane>-<i>": as a header over HTTP, over the socket in a v2 frame
    for even i and in a v1 frame (no id) for odd i. Returns (answers
    in request order, per-request seconds, wall seconds)."""
    import threading
    front, kind = lane.rsplit("-", 1)
    answers: list = [None] * len(bodies)
    secs: list = [0.0] * len(bodies)
    nxt = iter(range(len(bodies)))
    lock = threading.Lock()
    errors: list = []

    def client():
        c = ServiceClient(fronts, front)
        try:
            while True:
                with lock:
                    i = next(nxt, None)
                if i is None:
                    return
                rid = f"{lane}-{i}"
                t0 = time.perf_counter()
                if kind == "http":
                    answers[i] = c.post(bodies[i], rid)
                else:
                    answers[i] = c.frame(bodies[i],
                                         rid if i % 2 == 0 else None)
                secs[i] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 - reported after the join
            errors.append(e)
        finally:
            c.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"{lane}: client failed: {errors[:3]}")
    return answers, secs, wall


def wire_case_answers(fronts: Fronts) -> dict:
    """Every WIRE_CASES body through every lane of both fronts, with the
    fast request scanner on and off (LDT_WIRE_FASTPATH 1, 0), one client
    each: {"<lane>/fast=<flag>": answers}."""
    out = {}
    old = os.environ.get("LDT_WIRE_FASTPATH")
    try:
        for flag in ("1", "0"):
            os.environ["LDT_WIRE_FASTPATH"] = flag
            for lane in SERVICE_LANES:
                out[f"{lane}/fast={flag}"] = drive_lane(
                    fronts, lane, WIRE_CASES, clients=1)[0]
    finally:
        if old is None:
            os.environ.pop("LDT_WIRE_FASTPATH", None)
        else:
            os.environ["LDT_WIRE_FASTPATH"] = old
    return out


def port_service(server, threaded: bool, device=None):
    """The port's DetectorService for one front (the asyncio front
    brings its own batcher)."""
    return server.DetectorService(start_batcher=threaded, device=device)


def service_reference(bodies: list, sock_dir: str) -> dict:
    """Worker process: the same traffic through the port's fronts on the
    CPU (device="cpu", the plain scorer): {lane: answers} for the mix
    and {"<lane>/fast=<flag>": answers} for WIRE_CASES."""
    import functools
    torch.set_num_threads(2)
    fronts = Fronts("language_detector_tpu_torch",
                    functools.partial(port_service, device="cpu"),
                    sock_dir)
    try:
        out = {lane: drive_lane(fronts, lane, bodies)[0]
               for lane in SERVICE_LANES}
        out.update(wire_case_answers(fronts))
    finally:
        fronts.close()
    return out


def stage_totals(telemetry) -> dict:
    """{stage: (count, ms)} over the ldt_stage_latency_ms histograms:
    per request parse, detect (the wait for its flush) and encode; per
    flush c_path, pack, dispatch (the device wait), epilogue and
    retry_lane; scalar_detect."""
    return {k: (v["count"], v["count"] * v["mean"])
            for k, v in telemetry.REGISTRY.stage_percentiles().items()}


def percentile(xs: list, q: float) -> float:
    """The q-th percentile (0-100) of xs by the nearest rank."""
    ys = sorted(xs)
    return ys[min(len(ys) - 1, max(0, math.ceil(len(ys) * q / 100) - 1))]


def dup_request(docs: list, seed: int) -> list:
    """One request's documents with duplicates: 100 of the mix's
    documents under 2,000 chars, each three times, shuffled with the
    seed (one flush of 300 documents, 200 answered by dedup)."""
    rng = random.Random(seed + 7)
    texts = rng.sample([d for d in docs if len(d) < 2000], 100) * 3
    rng.shuffle(texts)
    return texts


def metric_value(text: str, series: str) -> float:
    """The value of one series line (name and labels as rendered) of a
    Prometheus exposition; 0 when absent."""
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def service_phase(seed: int, docs: list, kernels, smi: str,
                  answer: dict | None = None, device=None) -> int:
    """Phase `service`: the asyncio and threaded fronts over
    DetectorService() on the card (the default device), each with its
    unix-socket lane, answer the mix (service_requests: 1 ... 256 items
    a request, plus 65 and 256) from SERVICE_CLIENTS concurrent clients
    a lane, then every WIRE_CASES body with the fast scanner on and
    off, and the asyncio HTTP lane once more under torch.profiler (the
    device's busy share). Every (status, request id, payload) must
    equal the port's fronts on the CPU (a spawned worker, run first);
    the kernel must have launched once per device dispatch, every launch
    of the traced lane must be in its trace's launch calls with no other
    launch or kernel, the
    breaker must have stayed closed,
    no request was answered by the scalar engine, and the card's run
    took under 60 s. Returns the kernel launches it made. device: the
    fronts' engine device (None: the card; a CPU rehearsal passes
    "cpu" and fails at the launch check)."""
    import functools
    import tempfile

    from language_detector_tpu_torch import telemetry
    from language_detector_tpu_torch.service.admission import \
        BREAKER_STATE_NAMES
    bodies = service_requests(docs, seed)
    sock_dir = tempfile.mkdtemp(prefix="ldt-smoke-")
    t0 = time.monotonic()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
        want = pool.submit(service_reference, bodies,
                           os.path.join(sock_dir, "cpu")).result()
    ref_s = time.monotonic() - t0

    t_phase = time.monotonic()
    fronts = Fronts("language_detector_tpu_torch",
                    functools.partial(port_service, device=device),
                    os.path.join(sock_dir, "cuda"))
    engines = {f: svc._engine for f, svc in fronts.svc.items()}
    flushes: list = []

    def counted(eng):
        detect = eng.detect_codes

        def call(texts, *a, **k):
            flushes.append(len(texts))
            return detect(texts, *a, **k)
        return call

    for eng in engines.values():
        eng.detect_codes = counted(eng)
    before = {f: e.stats_snapshot() for f, e in engines.items()}
    stages0 = stage_totals(telemetry)
    kernels.launches = 0
    lanes = {}
    got = {}
    try:
        for lane in SERVICE_LANES:
            got[lane], secs, wall = drive_lane(fronts, lane, bodies)
            n_docs = sum(len(json.loads(b)["request"]) for b in bodies)
            lanes[lane] = {"requests": len(bodies), "docs": n_docs,
                           "wall_s": wall, "docs_per_s": n_docs / wall,
                           "p50_ms": percentile(secs, 50) * 1e3,
                           "p99_ms": percentile(secs, 99) * 1e3}
        got.update(wire_case_answers(fronts))
        # a request with duplicates through each front, then each
        # front's /metrics: the scheduler's tier and dedup series
        sched_metrics = {}
        dups = dup_request(docs, seed)
        for front in ("aio", "threaded"):
            c = ServiceClient(fronts, front)
            try:
                status, _, payload = c.post(json.dumps(
                    {"request": [{"text": t} for t in dups]}).encode(),
                    None)
            finally:
                c.close()
            codes = [r.get("iso6391code") for r in
                     json.loads(payload)["response"]]
            import urllib.request
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{fronts.metrics_port[front]}"
                    "/metrics", timeout=30) as r:
                text = r.read().decode()
            sched_metrics[front] = {
                "status": status,
                "answers_equal": answer is None or
                codes == [answer[t] for t in dups],
                "tier_mixed": metric_value(
                    text, 'ldt_tier_dispatches_total{tier="mixed"}'),
                "dedup": metric_value(text, "ldt_dedup_documents_total")}
        quiesce(kernels)
        traced = device_busy(lambda: drive_lane(fronts, "aio-http", bodies),
                             count=lambda: kernels.launches)
        n_launch = kernels.launches
        phase_s = time.monotonic() - t_phase
        after = {f: e.stats_snapshot() for f, e in engines.items()}
        breaker = {f: BREAKER_STATE_NAMES[
            svc.admission.breaker.stats()["state"]]
            for f, svc in fronts.svc.items()}
    finally:
        fronts.close()
    stages1 = stage_totals(telemetry)
    stage_ms = {k: {"count": n - stages0.get(k, (0, 0.0))[0],
                    "sum_ms": ms - stages0.get(k, (0, 0.0))[1]}
                for k, (n, ms) in stages1.items()
                if n > stages0.get(k, (0, 0.0))[0]}
    scalar_n = stage_ms.get("scalar_detect", {}).get("count", 0)
    stats = {k: sum(after[f][k] - before[f][k] for f in engines)
             for k in after["aio"]}
    diffs = {key: [i for i, (a, b) in enumerate(zip(got[key], want[key]))
                   if a != b] for key in want}
    bad = {k: v[:5] for k, v in diffs.items()
           if v or len(got[k]) != len(want[k])}
    big = [n for n in flushes if n > 64]
    phase("service", card=smi, lanes=lanes,
          wire_cases=len(WIRE_CASES),
          requests_compared=sum(len(v) for v in want.values()),
          cpu_equal=not bad, cpu_reference_s=ref_s, phase_s=phase_s,
          flushes=len(flushes), mean_flush_docs=statistics.mean(flushes),
          flushes_over_64=len(big),
          device_flush_docs=sum(big), c_path_docs=stats["c_path_docs"],
          launches=n_launch, device_dispatches=stats["device_dispatches"],
          engine=stats, breaker=breaker, scalar_answered=scalar_n,
          stage_ms=stage_ms, scheduler_metrics=sched_metrics,
          traced_aio_http=traced)
    if bad:
        raise AssertionError(f"service answers differ from the CPU "
                             f"fronts' at {bad}")
    if not (n_launch > 0 and n_launch == stats["device_dispatches"]):
        raise AssertionError(f"service: {n_launch} kernel launches over "
                             f"{stats['device_dispatches']} device "
                             "dispatches; want one launch a dispatch")
    check_trace("service trace", traced)
    # 203: a document whose language has no name (handlers.go rule)
    if any(m["status"] not in (200, 203) or not m["answers_equal"] or
           m["tier_mixed"] <= 0 or m["dedup"] < 200
           for m in sched_metrics.values()):
        raise AssertionError(f"service: the duplicate request or the "
                             f"scheduler series: {sched_metrics}")
    if any(b != "closed" for b in breaker.values()) or scalar_n:
        raise AssertionError(f"service: breaker {breaker}, {scalar_n} "
                             "requests answered by the scalar engine")
    if phase_s >= 60:
        raise AssertionError(f"service phase took {phase_s:.1f} s")
    return n_launch


# -- the engine's stream scheduler ---------------------------------------------

SCHED_DEPTHS = (1, 2, 3)
SCHED_LONGDOC = ("on", "off")   # on: 1024-slot sub-packs (the reference)
SCHED_PASSES = 5             # timed passes a configuration, alternating
SCHED_DUP_SHARE = 0.3        # positions the duplicate-heavy input copies
SCHED_KEYS = ("tier_short_dispatches", "tier_mid_dispatches",
              "tier_long_dispatches", "tier_mixed_dispatches",
              "tier_longdoc_dispatches", "dedup_docs", "longdoc_split_docs",
              "longdoc_subdocs", "retry_lane_dispatches",
              "retry_offtier_docs", "device_dispatches")


def scheduler_inputs(docs: list, seed: int) -> dict:
    """The mix, and the mix with a seeded SCHED_DUP_SHARE of its
    positions replaced by copies of other documents."""
    rng = random.Random(seed + 5)
    dup = list(docs)
    for p in rng.sample(range(len(docs)), int(len(docs) * SCHED_DUP_SHARE)):
        dup[p] = docs[rng.randrange(len(docs))]
    return {"mix": docs, "dup_heavy": dup}


def scheduler_reference(inputs: dict) -> dict:
    """Worker process: detect_codes answers and detect_many rows of the
    port's engine on the CPU (device="cpu", the plain scorer; the
    default depth and long-doc lane) for each scheduler input."""
    torch.set_num_threads(2)
    from language_detector_tpu_torch.models.ngram import NgramBatchEngine
    eng = NgramBatchEngine(device="cpu")
    return {name: (eng.detect_codes(d), answer_rows(eng.detect_many(d)))
            for name, d in inputs.items()}


class LaneWires:
    """Keeps a copy of the largest wire (by chunk rows) each lane of the
    engines launched inside the block."""

    def __init__(self, engines):
        self.engines = list(engines)
        self.largest: dict = {}

    def __enter__(self):
        for eng in self.engines:
            def launch(cb, lane="main", full_out=False, _orig=eng._launch):
                best = self.largest.get(lane)
                if best is None or cb.wire["cnsl"].size > \
                        best["cnsl"].size:
                    self.largest[lane] = {k: np.array(v)
                                          for k, v in cb.wire.items()}
                return _orig(cb, lane, full_out)
            eng._launch = launch
        return self

    def __exit__(self, *exc):
        for eng in self.engines:
            del eng._launch
        return False


def pipe_counts(eng) -> dict:
    """The engine's cumulative pipeline and staging-ring counters."""
    pl, ring = eng.pipeline_stats(), eng.staging_stats()
    return {"pack_ms_total": pl["pack_ms_total"],
            "pack_ms_overlapped": pl["pack_ms_overlapped"],
            "longdoc_chunks": pl["longdoc_chunks"], "hits": ring["hits"],
            "misses": ring["misses"],
            "pending_releases": ring["pending_releases"]}


def scheduler_phase(inputs: dict, want: dict, kernels, dt, dev, smi: str,
                    tables, reg) -> tuple:
    """Phase `scheduler`: detect_codes and detect_many through the
    engine's stream scheduler on the card, for each input at depths
    SCHED_DEPTHS with the long-doc lane on (the reference's default;
    the port's is off) and off. Answers
    must be identical across every configuration and equal to the CPU
    reference (`want`, from scheduler_reference); each call's kernel
    launches must equal its device dispatches; retry_offtier_docs and
    the staging ring's pending-event releases must be 0, its hits above
    0 at depth >= 2. Docs/s is the median of SCHED_PASSES detect_codes
    passes a configuration, the configurations taking turns; the
    pack-overlap ratio and the ring's hits and misses count those
    passes of each input alone. One
    depth-2 pass runs under torch.profiler (check_trace), and the kernel
    is held against its plain version on the largest long-doc and
    retry-lane wires, word1 and full output, bit for bit. The card's
    part must take under 60 s. Returns (kernel launches made, the
    largest |kernel - plain| difference)."""
    from language_detector_tpu_torch.models.ngram import NgramBatchEngine
    from language_detector_tpu_torch.ops.score import (score_chunks_plain,
                                                       wire_to_device)
    t_phase = time.monotonic()
    configs = [(d, ld) for d in SCHED_DEPTHS for ld in SCHED_LONGDOC]
    engines = {c: NgramBatchEngine(
        tables, reg, device=dev, pipeline_depth=c[0],
        longdoc_chunk_slots=1024 if c[1] == "on" else 0)
        for c in configs}
    n_launch = 0
    out: dict = {}
    times: dict = {}
    pipe: dict = {}
    bad: list = []
    with LaneWires(engines.values()) as lanes:
        # round 0 is also the check: answers, counters, detect_many
        for rnd in range(SCHED_PASSES):
            for name, docs in inputs.items():
                for c, eng in engines.items():
                    key = f"{name}/depth{c[0]}/longdoc-{c[1]}"
                    before = eng.stats_snapshot()
                    pipe0 = pipe_counts(eng)
                    kernels.launches = 0
                    t0 = time.perf_counter()
                    codes = eng.detect_codes(docs)
                    torch.cuda.synchronize()
                    times.setdefault(key, []).append(
                        time.perf_counter() - t0)
                    launched = kernels.launches
                    n_launch += launched
                    after = eng.stats_snapshot()
                    counts = {k: after[k] - before[k] for k in SCHED_KEYS}
                    acc = pipe.setdefault(key, dict.fromkeys(pipe0, 0))
                    for k, v in pipe_counts(eng).items():
                        acc[k] += v - pipe0[k]
                    if launched != counts["device_dispatches"] or \
                            counts["retry_offtier_docs"]:
                        bad.append((key, rnd, launched, counts))
                    if rnd:
                        continue
                    kernels.launches = 0
                    rows = answer_rows(eng.detect_many(docs))
                    n_launch += kernels.launches
                    if codes != want[name][0] or rows != want[name][1]:
                        bad.append((key, "answers"))
                    out[key] = {"launches": launched, **counts}
    for key, ts in times.items():
        name, depth, ld = key.split("/")
        c = (int(depth[5:]), ld[8:])
        pl = engines[c].pipeline_stats()
        ring = engines[c].staging_stats()
        # this input's detect_codes passes only (an engine serves both)
        acc = pipe[key]
        out[key].update(
            docs_per_s=len(inputs[name]) / statistics.median(ts),
            pass_s=ts, overlap_ratio=round(
                acc["pack_ms_overlapped"] / acc["pack_ms_total"], 4)
            if acc["pack_ms_total"] else 0.0,
            pack_ms_total=round(acc["pack_ms_total"], 3),
            longdoc_chunks=acc["longdoc_chunks"],
            staging_hits=acc["hits"], staging_misses=acc["misses"],
            pending_releases=acc["pending_releases"],
            inflight=pl["inflight"], staging_occupancy=ring["occupancy"])
        if acc["pending_releases"] or ring["pending_releases"] or \
                pl["inflight"] or ring["occupancy"] or \
                (c[0] >= 2 and not acc["hits"]):
            bad.append((key, "ring", acc, ring, pl["inflight"]))
    eng2 = engines[(2, "on")]
    quiesce(kernels)
    traced = device_busy(lambda: eng2.detect_codes(inputs["mix"]),
                         count=lambda: kernels.launches)
    n_launch += traced["launches"]
    phase_s = time.monotonic() - t_phase
    # the kernel against its plain version on the new wires
    err = 0
    held = {}
    for lane in ("longdoc", "retry"):
        wire = lanes.largest.get(lane)
        if wire is None:
            bad.append((lane, "no wire"))
            continue
        w = wire_to_device(wire, dev)
        for full in (False, True):
            got = kernels.score_chunks(dt, w, full_out=full)
            ref = score_chunks_plain(dt, w, full_out=full)
            torch.cuda.synchronize()
            if got.numel():
                err = max(err, int((got.to(torch.int64) -
                                    ref.to(torch.int64)).abs().max()))
            if not torch.equal(got, ref):
                bad.append((lane, "kernel != plain", full))
        held[lane] = wire_shape_of(wire)
    phase("scheduler", card=smi, docs={k: len(v) for k, v in inputs.items()},
          unique_docs={k: len(set(v)) for k, v in inputs.items()},
          configs=out, cpu_equal=not any(b[-1] == "answers" for b in bad),
          held_wires=held, max_abs_err=err, phase_s=phase_s,
          traced_depth2_mix=traced)
    if bad:
        raise AssertionError(f"scheduler: {bad[:6]}")
    check_trace("scheduler trace", traced)
    if phase_s >= 60:
        raise AssertionError(f"scheduler phase took {phase_s:.1f} s")
    return n_launch, err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--docs", type=int, default=4200,
                    help="documents on the main path (>= 4096)")
    ap.add_argument("--kernel-times", action="store_true",
                    help="only time the kernel alone and through its "
                    "wrapper on the timing and mixed wires, then exit")
    ap.add_argument("--port-root", type=Path, default=ROOT,
                    help="checkout to import language_detector_tpu_torch "
                    "from (default: this one)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.port_root.resolve()))
    from language_detector_tpu_torch import native
    from language_detector_tpu_torch.engine_scalar import detect_scalar
    from language_detector_tpu_torch.models.ngram import NgramBatchEngine
    from language_detector_tpu_torch.ops import kernels
    from language_detector_tpu_torch.ops.device_tables import DeviceTables
    from language_detector_tpu_torch.ops.score import (score_chunks_plain,
                                                       wire_to_device)
    from language_detector_tpu_torch.registry import registry as reg
    from language_detector_tpu_torch.tables import DATA_DIR, load_tables

    # -- device ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(smi, flush=True)
    phase("device", nvidia_smi=smi, torch_name=kind,
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    # -- build ----------------------------------------------------------------
    t0 = time.monotonic()
    kernels.build(verbose=True)
    build_s = time.monotonic() - t0
    t0 = time.monotonic()
    if not native.available():
        raise RuntimeError("native packer failed to build")
    occ = {}
    if hasattr(kernels, "occupancy"):
        per_sm, sms = kernels.occupancy(dev)
        occ = {"blocks_per_sm": per_sm, "sms": sms}
    phase("build", kernel_s=round(build_s, 3),
          packer_s=round(time.monotonic() - t0, 3), lib=str(kernels.LIB),
          **occ)

    tables = load_tables()
    dt = DeviceTables.from_host(tables, reg, dev)

    # -- parity: kernel vs plain on the card ------------------------------------
    corpus = [ln.split("\t", 1)[1].rstrip("\n") for ln in
              open(DATA_DIR / "eval_corpus.tsv", encoding="utf-8")]
    docs = build_docs(corpus, args.seed, args.docs)
    groups = group_by_k(docs, native, tables, reg,
                        NgramBatchEngine.TINY_BATCH_C_PATH)
    pool = [d for k, g in groups.items() if k <= 64 for d in g]
    tcb, n_timing_docs = timing_wire(pool, native, tables, reg, args.seed)
    # the mixed batch's own wire: every document packed as one slice
    mcb = native.pack_chunks_native(docs, tables, reg)
    if args.kernel_times:
        out = {}
        for name, cb in (("timing", tcb), ("mixed", mcb)):
            out[name] = {**wire_shape(cb), **kernel_and_wrapper_ms(
                kernels, dt, wire_to_device(cb.wire, dev))}
        phase("kernel_times", port_root=str(args.port_root), **out)
        return 0

    cases = [(n, w, dt) for n, w in adversarial_wires(args.seed)]
    doctored, clip_wire = s1_clip_case(dt)
    cases.append(("s1-clip", clip_wire, doctored))
    for k, g in groups.items():
        cases.append((f"real-k{k}", native.pack_chunks_native(
            g, tables, reg).wire, dt))
    cases.append(("real-timing-wire", tcb.wire, dt))
    cases.append(("real-mixed-wire", mcb.wire, dt))
    max_err = 0
    checked = []
    for name, wire, tdt in cases:
        w = wire_to_device(wire, dev)
        for full in (False, True):
            got = kernels.score_chunks(tdt, w, full_out=full)
            want = score_chunks_plain(tdt, w, full_out=full)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64))
                      .abs().max()) if got.numel() else 0
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"kernel != plain on {name} (full={full}): "
                    f"{int((got != want).sum())} words differ")
        checked.append(f"{name}:D{np.shape(wire['cnsl'])[0]}:G"
                       f"{wire['cnsl'].size}:K{wire['k_iota'].shape[0]}")
    real_k = {int(w["k_iota"].shape[0]) for n, w, _ in cases
              if n.startswith("real-")}
    if real_k != set(K_BUCKETS):
        raise AssertionError(f"real wires cover K {sorted(real_k)}, want "
                             f"{list(K_BUCKETS)}")
    phase("parity", cases=len(cases), max_abs_err=max_err,
          grids=checked)

    # -- main path ------------------------------------------------------------
    eng = NgramBatchEngine(tables, reg, device="cuda")
    launch_k: list = []
    engine_launch = eng._launch

    def recorded_launch(cb, *a, **k):
        launch_k.append(int(cb.wire["k_iota"].shape[0]))
        return engine_launch(cb, *a, **k)

    eng._launch = recorded_launch
    kernels.launches = 0
    t0 = time.monotonic()
    codes = {k: eng.detect_codes(g) for k, g in groups.items()}
    main_s = time.monotonic() - t0
    launches = kernels.launches
    eng._launch = engine_launch
    n_docs = sum(len(g) for g in groups.values())
    if n_docs < 4096:
        raise AssertionError(f"main path drove {n_docs} docs, want 4096")
    if launches <= 0:
        raise AssertionError("main path never launched the kernel")
    stats = eng.stats_snapshot()
    if launches != len(launch_k) or set(launch_k) != set(K_BUCKETS) or \
            launches != stats["device_dispatches"]:
        raise AssertionError(f"{launches} kernel launches over "
                             f"{stats['device_dispatches']} dispatches "
                             f"at K {launch_k}, want one per dispatch and "
                             f"every K of {list(K_BUCKETS)}")

    cpu = NgramBatchEngine(tables, reg, device="cpu")
    for k, g in groups.items():
        want = cpu.detect_codes(g)
        bad = [i for i, (a, b) in enumerate(zip(codes[k], want)) if a != b]
        if bad or len(want) != len(codes[k]):
            raise AssertionError(f"K={k}: {len(bad)} answers differ from "
                                 f"the CPU run, first {bad[:5]}")
    flat = [(d, c) for k, g in groups.items()
            for d, c in zip(g, codes[k])]
    sample = random.Random(args.seed).sample(flat, 256)
    for d, c in sample:
        want = reg.code(detect_scalar(d, tables, reg).summary_lang)
        if want != c:
            raise AssertionError(f"detect_scalar says {want}, device {c}:"
                                 f" {d[:60]!r}")
    phase("main", docs=n_docs, chars=sum(len(d) for d, _ in flat),
          groups={str(k): len(g) for k, g in groups.items()},
          launch_k=launch_k, launches=launches, stats=stats,
          pipeline=eng.pipeline_stats(), staging=eng.staging_stats(),
          cpu_equal=True, scalar_sample_equal=len(sample),
          first_run_s=round(main_s, 3))

    # the same documents as one shuffled batch, as a user sends them: it
    # packs each slice at its widest document's K
    by_doc = dict(flat)
    mixed = eng.detect_codes(docs)
    bad = [i for i, (d, c) in enumerate(zip(docs, mixed)) if by_doc[d] != c]
    if bad or len(mixed) != len(docs):
        raise AssertionError(f"mixed batch: {len(bad)} answers differ from "
                             f"the per-bucket run, first {bad[:5]}")

    # -- times ----------------------------------------------------------------
    p = wire_to_device(tcb.wire, dev)
    pm = wire_to_device(mcb.wire, dev)
    G, K = p["cnsl"].numel(), p["K"]
    floor = lambda: torch.cuda._sleep(1)                      # noqa: E731
    lms = device_ms(floor, 30, 20)
    kw = kernel_and_wrapper_ms(kernels, dt, p)
    pms = device_ms(lambda: score_chunks_plain(dt, p), 10, 3)
    kw_mixed = kernel_and_wrapper_ms(kernels, dt, pm)
    # the same grid with every row empty: scan, row bodies and tails
    # without a slot gathered
    empty_call = kernels.prepare(dt, {**p, "cnsl": torch.zeros_like(
        p["cnsl"])})
    ems = device_ms(lambda: kernels.launch(empty_call), 30, 20)
    pms2 = device_ms(lambda: score_chunks_plain(dt, p), 10, 3)
    lms2 = device_ms(floor, 30, 20)
    bms, bound_by, bound_bytes, bound_ops = bound_ms(dt, p, False)
    mbms, mbound_by, _, _ = bound_ms(dt, pm, False)

    def run_groups():
        for g in groups.values():
            eng.detect_codes(g)

    def run_mixed():
        eng.detect_codes(docs)

    e2e, e2e_mixed = [], []
    for _ in range(5):
        for fn, acc in ((run_groups, e2e), (run_mixed, e2e_mixed)):
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            acc.append(time.monotonic() - t0)
    phase("times", G=G, K=K, N=int(p["idx"].numel()),
          slots=int(tcb.n_slots.sum()), timing_docs=n_timing_docs,
          kernel_ms=kw["kernel_ms"], wrapper_ms=kw["wrapper_ms"],
          plain_ms=[pms, pms2], launch_floor_ms=[lms, lms2],
          kernel_empty_rows_ms=ems,
          mixed={**wire_shape(mcb), **kw_mixed, "bound_ms": mbms,
                 "bound_by": mbound_by},
          bound_ms=bms, bound_by=bound_by,
          bound_bytes=bound_bytes, bound_ops=bound_ops,
          bytes_ms=bound_bytes / PEAK_BYTES_PER_S * 1e3,
          e2e_s=e2e, e2e_docs_per_s=n_docs / statistics.median(e2e),
          e2e_mixed_s=e2e_mixed,
          e2e_mixed_docs_per_s=len(docs) / statistics.median(e2e_mixed))
    phase("breakdown", **first_pass_breakdown(eng, groups, native))
    count = lambda: kernels.launches                          # noqa: E731
    traced = {"per_bucket": device_busy(run_groups, count),
              "mixed": device_busy(run_mixed, count)}
    phase("trace", **traced)
    for name, t in traced.items():
        check_trace(f"{name} trace", t)

    # -- accuracy paths: hinted, HTML, chunk vectors, spans ------------------
    from language_detector_tpu_torch.hints import CLDHints
    from language_detector_tpu_torch.models import ngram
    labels = sorted({ln.split("\t", 1)[0] for ln in
                     open(DATA_DIR / "eval_corpus.tsv", encoding="utf-8")})
    answer = dict(flat)
    long_docs = [d for d in docs if len(d) >= 10_000]
    span_docs = span_subset(docs, args.seed)
    inputs = (docs, span_docs, long_docs,
              hint_groups(groups, answer, labels, reg, args.seed),
              html_pages(docs, answer, labels, args.seed))
    paths = accuracy_paths(*inputs, CLDHints)
    samples = scalar_samples(paths, len(span_docs), args.seed)
    # the CPU run of every path and the scalar engine's answers for the
    # samples, in worker processes: host work that no timing reads
    # (and the scheduler phase's CPU answers)
    sched_inputs = scheduler_inputs(docs, args.seed)
    t0 = time.monotonic()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(len(paths) + 2,
                                                mp_context=ctx) as pool:
        cpu_futs = {name: pool.submit(cpu_reference, name, inputs)
                    for name in paths}
        scalar_fut = pool.submit(scalar_reference, samples, inputs)
        sched_fut = pool.submit(scheduler_reference, sched_inputs)
        cpu_ref = {name: f.result() for name, f in cpu_futs.items()}
        scalar_ref = scalar_fut.result()
        sched_ref = sched_fut.result()
    cpu_s = time.monotonic() - t0

    # the kernel against its plain version on every wire those paths sent
    acc_err = 0
    par = {}
    for name, (_, recs) in cpu_ref.items():
        for r in recs:
            w = wire_to_device(r["wire"], dev)
            for full in (False, True):
                got = kernels.score_chunks(dt, w, full_out=full)
                want = score_chunks_plain(dt, w, full_out=full)
                torch.cuda.synchronize()
                if got.numel():
                    acc_err = max(acc_err, int(
                        (got.to(torch.int64) - want.to(torch.int64))
                        .abs().max()))
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"kernel != plain on a {name} wire (full={full}, "
                        f"K={w['K']}): {int((got != want).sum())} words "
                        "differ")
        big = max(recs, key=lambda r: r["wire"]["cnsl"].size)
        p = wire_to_device(big["wire"], dev)
        full = big["full_out"]
        call = kernels.prepare(dt, p, full)
        kms = device_ms(lambda: kernels.launch(call), 30, 20)
        plain_ms = device_ms(lambda: score_chunks_plain(dt, p, full), 5, 2)
        b_ms, b_by, _, _ = bound_ms(dt, p, full)
        par[name] = {
            "wires": len(recs),
            "K": sorted({int(r["wire"]["k_iota"].shape[0]) for r in recs}),
            "prior_wires": sum("cprior" in r["wire"] for r in recs),
            "whack_wires": sum(r["wire"]["cwhack"].shape[-1] > 1
                               for r in recs),
            "full_out_wires": sum(r["full_out"] for r in recs),
            "largest": {**wire_shape_of(big["wire"]), "full_out": full,
                        "prior": "cprior" in big["wire"],
                        "kernel_ms": kms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by}}
    if not par["hinted_priors_on"]["prior_wires"] or any(
            par[n]["prior_wires"] for n in par if n != "hinted_priors_on"):
        raise AssertionError(f"prior planes on the wrong wires: {par}")
    if par["chunks"]["full_out_wires"] != par["chunks"]["wires"]:
        raise AssertionError("the chunk path asked for word1 only")
    phase("accuracy_parity", max_abs_err=acc_err, cpu_reference_s=cpu_s,
          paths=par)
    max_err = max(max_err, acc_err)

    # each path once on the card, traced, with its host-clock split
    e_dev = engine_set(tables, reg, dev)
    dev_answers: dict = {}
    for name, (run, n_items) in paths.items():
        before = engine_counts(e_dev.values())
        box: dict = {}
        kernels.launches = 0
        with host_split(ngram) as split, \
                DispatchRecorder(e_dev.values()) as rec:
            tr = device_busy(lambda: box.setdefault("got", run(e_dev)))
        n_launch = kernels.launches
        launches += n_launch
        got = dev_answers[name] = box["got"]
        after = engine_counts(e_dev.values())
        counts = {k: after[k] - before[k] for k in after}
        dispatches = counts.pop("device_dispatches")
        if not (n_launch == len(rec.records) == dispatches ==
                tr["fused_tote_traced"] > 0) or tr["other_kernels"]:
            raise AssertionError(
                f"{name}: {n_launch} launches, {len(rec.records)} recorded "
                f"and {dispatches} counted dispatches, "
                f"{tr['fused_tote_traced']} traced fused_tote launches and "
                f"{tr['other_kernels']} other kernels "
                f"{tr['other_kernel_names']}; want one launch a dispatch")
        want_2d = name == "chunks"
        if any((len(r["out_shape"]) == 2) != want_2d for r in rec.records):
            raise AssertionError(f"{name}: output shapes "
                                 f"{[r['out_shape'] for r in rec.records]}")
        cpu_answers, cpu_recs = cpu_ref[name]
        if len(cpu_recs) != len(rec.records) or any(
                not wires_equal(a["wire"], b["wire"])
                for a, b in zip(cpu_recs, rec.sorted_records())):
            raise AssertionError(f"{name}: the card's wires differ from the "
                                 "CPU run's")
        bad = [i for i, (a, b) in enumerate(zip(got, cpu_answers))
               if a != b]
        if bad or not len(got) == len(cpu_answers) == n_items:
            raise AssertionError(f"{name}: {len(bad)} answers differ from "
                                 f"the CPU run, first {bad[:5]}")
        cjk_rows_differ = 0
        for i, want_i, base in scalar_ref.get(name, ()):
            if not scalar_agrees(got[i], want_i, base):
                raise AssertionError(f"{name}: the scalar engine disagrees "
                                     f"on item {i}")
            cjk_rows_differ += got[i] != want_i
        split = {**split, "other_s": tr["wall_s"] - sum(split.values())}
        phase("accuracy", path=name, docs=n_items, launches=n_launch,
              dispatches=dispatches, exception_docs=counts,
              launch_k=[int(r["wire"]["k_iota"].shape[0])
                        for r in rec.records],
              out_shapes=sorted({str(r["out_shape"]) for r in rec.records}),
              prior_wires=sum("cprior" in r["wire"] for r in rec.records),
              cpu_equal=True,
              differ_from_priors_off=(sum(
                  a != b for a, b in zip(got, dev_answers[
                      "hinted_priors_off"]))
                  if name == "hinted_priors_on" else None),
              scalar_sample=len(scalar_ref.get(name, ())) or None,
              scalar_cjk_rows_differ=cjk_rows_differ,
              docs_per_s=n_items / tr["wall_s"], split=split, trace=tr)

    # -- scheduler: dedup, tier lanes, long-doc lane, retry lane, depth -----
    n_sched, sched_err = scheduler_phase(sched_inputs, sched_ref, kernels, dt,
                                         dev, smi, tables, reg)
    launches += n_sched
    max_err = max(max_err, sched_err)

    # -- service: both fronts on the card, HTTP and unix-socket lanes --------
    launches += service_phase(args.seed, docs, kernels, smi, answer)

    print(json.dumps({"kernels": [{
        "name": "fused_tote",
        "route": "cuda",
        "source": "language_detector_tpu_torch/csrc/fused_tote.cu",
        "replaces": "language_detector_tpu/ops/kernels.py:226",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": statistics.median(kw["kernel_ms"]),
        "plain_ms": statistics.median([pms, pms2]),
        "bound_ms": bms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
