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
  trace     torch.profiler over one pass of each, in a freshly spawned
            process (run_fresh): the device's busy share of the wall
            time, the fused_tote launches the trace saw, and every other
            kernel it saw (check_trace: every launch in the trace as a
            launch call and a fused_tote kernel record, no other kernel)
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
            configuration; one depth-2 pass under torch.profiler in a
            fresh process (check_trace); the kernel against its plain
            version on the
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
            the card's name and power; the threaded HTTP lane's p99
            must stay under 1 s; the traced asyncio HTTP lane runs
            through fronts started in a fresh process
  pool      POOL_LANES (4) simulated device-pool lanes on the card: the mix
            through detect_codes answers as the pool-less engine, clean,
            under a lane_lost rule (redispatches) and, with a 2 ms hedge
            floor, a lane_stall rule (hedges); launches = the pool's
            launches = dispatches + hedges + redispatches on every call,
            0 pending staging releases; the threaded front with a pooled
            engine renders the ldt_pool_* gauges
  shards    meshes of 2 and 4 shards on the one card: answers equal the
            unsharded engine's, launches = shards x dispatches, the
            kernel == plain on every shard's wire (a mesh over several
            cards only where the machine has them)
  integrity the device table digest == fold_host on every plane; on a
            2-lane pooled engine a seeded bit-flip of one lane's tables
            on the card is detected by the scrub, quarantined (capacity
            1 of 2), healed and readmitted by a served batch, and a
            canary-only fault (scores wrong, digest matching) is caught
            by the canary; the scrub cycle's ms and its overhead at a
            60 s interval
  eval      the eval scorecard (evalsuite.run_eval) on the card equals
            the CPU worker's key for key and clears check_floor
  shm       one threaded front's service on the card with its
            unix-socket lane and its shared-memory ring lane: the service
            bodies through the socket (one frame in flight) and through a
            RingClient pipelining over 8 slots, 2 alternating passes a
            lane, each cycling through the bodies for 2.5 s; every
            response equal to the socket lane's and to the
            CPU front's, zero non-2xx, launches == dispatches; under a
            poison_doc:error rule a 32-document frame with one poison
            document quarantines exactly that one, the other 31 answer
            as the main path did; shm and UDS docs/s, shm p99
  supervisor
            python -m language_detector_tpu_torch.service.supervisor runs
            one asyncio front on the card; a SIGHUP blue/green drill
            under 16 HTTP clients: the standby warms on the card, the old
            generation drains, zero non-2xx and zero failed requests,
            payloads equal the CPU front's, exit 0; the standby's
            warmup_ms and the cut-over time
  fleet     LDT_FLEET_WORKERS=2 members of the asyncio front on the one
            card (compute mode Default, else the phase fails), with
            per-slot LDT_SHM_DIR, LDT_RESULT_CACHE_SHM_MB=64 and
            LDT_FLEET_STATUS_PORT, beside a 1-member fleet: 16 clients'
            answers equal the CPU front's, every member launched the
            kernel once a dispatch (its /metrics), the same bodies again
            hit the shared tier across members, the 2-member fleet
            against the 1-member one in alternating passes of 2.5 s
            (docs/s, p50/p99), a rolling SIGHUP swap under load with
            zero non-2xx and zero failed requests, and a SIGKILLed member replaced
            with its postmortem harvested (failed requests printed)
  coldstart boot-hot start: fresh processes time cold-to-ready (process
            start to a first detect_codes over 512 documents of the mix,
            split into interpreter, torch import, CUDA context, port
            import, tables, library build or load, first detect): (a)
            empty compile cache and bundle, one nvcc build, one entry
            exported; (b) the bundle under LDT_AOT_REQUIRE with no nvcc
            on PATH and CUDA_HOME empty: no build, one load, the loaded
            kernel == plain on the adversarial grids; (c) the entry read
            with a bit flipped (the aot_load seam): AotError (corrupt)
            under LDT_AOT_REQUIRE, else refused, rebuilt and rewritten,
            and (d) a fourth process loads the healed entry with no
            build; every answer equal to the main path's
  autotune  the SLO autotuner (autotune.autotune over LDT_MAX_INFLIGHT
            and LDT_MAX_QUEUE_DOCS, LDT_SLO p99_ms=500,err_pct=1) on a
            2-member fleet of the asyncio front (no result caches):
            loadgen's flash_crowd replayed on its schedule by 32 clients
            (1,600 records over 2 s), each candidate pushed through the
            status port's POST /configz and scored as the best of two
            laps, then 3 alternating default / winner laps; the winner
            holds the SLO in each, and every member launched the kernel
            once a device dispatch (its /metrics)
  debug     the port's score-trace CLI against that live fleet:
            --engine-stats over 256 documents of the mix on the card
            equals a --device cpu run (both in spawned processes) and
            the main path; --slo (/sloz), --fleet-traces (/tracez) and
            --admission (a member's /debug/vars), each `python -m
            language_detector_tpu_torch.debug` through a recording
            proxy, exit 0 and print the port formatter's output on the
            document they read
  tools     the port's offline entry points (language_detector_tpu_torch
            .tools): the evaluator's reports over eval_corpus.tsv and
            over 16,384 seeded 30-60-word windows of its documents
            (streamed from a TSV), and the expected-score table on
            those windows, equal to the same tools' run on the CPU (a
            spawned worker); every soak path at a quarter of scale 1
            answers as the scalar engine, launches equal to the soak
            engine's dispatches; profile_score's three host-clock lines
            and the kernel's CUDA-event time on its wire; under 90 s
  lockdebug the concurrent card paths in a fresh process with the
            lock-order watchdog on (LDT_LOCK_DEBUG=1 before the port is
            imported): the engine at depth 2 over 4 pool lanes with the
            integrity scrub on, over the mix's first 1,024 documents and
            a 30%-duplicate copy, then the asyncio front's HTTP and
            unix-socket lanes under 16 clients over the service bodies;
            0 inversions, a non-empty order graph, launches = dispatches
            (plus one canary launch a scrubbed lane), answers equal to
            the main path's and the CPU fronts', under 45 s

--kernel-times runs only device, build and the kernel and wrapper times
on the timing and mixed wires (phase kernel_times). With --port-root it
imports language_detector_tpu_torch from another checkout (an earlier
commit unpacked with git archive), so two versions of the kernel can be
timed in turns on one card.

The last two lines are the kernel table as JSON (its launches count the
main path's, the traced windows', every accuracy path's, the scheduler,
service, pool, shards, integrity and eval phases', the shm phase's,
the supervisor's and fleet members' read from their /metrics
ldt_kernel_launches_total, the cold-start processes' first detects,
the autotune fleet members', the CLI's --engine-stats run, the
tools phase's and the lockdebug phase's) and the run's verdict,
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
import threading
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


T_START = time.monotonic()


def phase(name: str, **fields) -> None:
    """One phase line; t_s is the seconds since the smoke started."""
    fields["t_s"] = time.monotonic() - T_START
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
    holds no device events. count: a launch counter read just inside
    the traced window, at its start and after the device is idle, so
    "launches" counts what the trace could see; "launch_calls" counts
    the trace's kernel-launch API records (every launch in the window,
    whoever made it). Windows that are not the run whose answers a
    phase checks run in a fresh process (run_fresh): late in a long
    process the profiler loses kernel records."""
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
    return {"wall_s": wall, "device_events": len(spans),
            "device_busy_s": busy,
            "device_busy_share": busy / wall if spans else None,
            "fused_tote_traced": len(ours),
            "fused_tote_traced_ms": sum(ours) / 1e3,
            "other_kernels": len(kernel_events) - len(ours),
            "other_kernel_names": others, "launches": n_launch,
            "launch_calls": sum(
                1 for e in events if e.get("ph") == "X" and
                e.get("cat") in ("cuda_runtime", "cuda_driver") and
                "LaunchKernel" in e.get("name", ""))}


def check_trace(name: str, t: dict) -> None:
    """Every launch of a traced window is in its trace, as a launch call
    and as a fused_tote kernel record, and no other kernel ran."""
    if not (t["launches"] == t["launch_calls"] == t["fused_tote_traced"]
            > 0) or t["other_kernels"]:
        raise AssertionError(
            f"{name}: {t['launches']} launches, {t['launch_calls']} launch "
            f"calls, {t['fused_tote_traced']} traced fused_tote launches "
            f"and {t['other_kernels']} other kernels "
            f"{t['other_kernel_names']}; want one launch a dispatch, each "
            "traced")


def traced_windows(kind: str, payload) -> dict:
    """Worker process, started fresh for each phase's traced windows
    (run_fresh): late in a long process torch.profiler loses kernel
    records, in a fresh one it keeps them all, so these traces are held
    to fused_tote records == launches (check_trace). One untraced warm
    pass of the same work comes first, as in the main process. kind
    "main": payload (K groups, the mix) -> the per-bucket and mixed
    detect_codes passes; "scheduler": the mix through a depth-2 engine
    with the long-doc lane on; "service": request bodies through the
    port's fronts on the card, the asyncio HTTP lane. Returns the
    traces, plus "process_launches": every kernel launch this process
    made."""
    import functools
    import tempfile

    from language_detector_tpu_torch.models.ngram import NgramBatchEngine
    from language_detector_tpu_torch.ops import kernels
    from language_detector_tpu_torch.registry import registry as reg
    from language_detector_tpu_torch.tables import load_tables
    torch.cuda.set_device(0)
    count = lambda: kernels.launches                          # noqa: E731
    if kind == "service":
        fronts = Fronts("language_detector_tpu_torch",
                        functools.partial(port_service, device=None),
                        tempfile.mkdtemp(prefix="ldt-trace-"))
        try:
            drive_lane(fronts, "aio-http", payload)
            quiesce(kernels)
            out = device_busy(lambda: drive_lane(fronts, "aio-http",
                                                 payload), count)
        finally:
            fronts.close()
    else:
        tables = load_tables()
        if kind == "main":
            groups, docs = payload
            eng = NgramBatchEngine(tables, reg, device="cuda")
            runs = {"per_bucket": lambda: [eng.detect_codes(g)
                                           for g in groups.values()],
                    "mixed": lambda: eng.detect_codes(docs)}
        elif kind == "scheduler":
            eng = NgramBatchEngine(tables, reg, device="cuda",
                                   pipeline_depth=2,
                                   longdoc_chunk_slots=1024)
            runs = {"traced": lambda: eng.detect_codes(payload)}
        else:
            raise ValueError(kind)
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        out = {name: device_busy(run, count) for name, run in runs.items()}
        if kind == "scheduler":
            out = out["traced"]
    out["process_launches"] = kernels.launches
    return out


def run_fresh(kind: str, payload) -> dict:
    """traced_windows(kind, payload) in a freshly spawned process."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
        return pool.submit(traced_windows, kind, payload).result()


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
            def launch(cb, lane="main", full_out=False, trace=None,
                       _orig=eng._launch):
                wire = {k: np.array(v) for k, v in cb.wire.items()}
                fut = _orig(cb, lane, full_out, trace)
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
                         (ngram.kernels.DeviceResult, "__array__")],
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
    device's busy share), through the fronts started anew in a fresh
    process (run_fresh). Every (status, request id, payload) must
    equal the port's fronts on the CPU (a spawned worker, run first);
    the kernel must have launched once per device dispatch, every launch
    of the traced lane must be in its trace (check_trace), the threaded
    HTTP lane's p99 must stay under 1 s, the
    breaker must have stayed closed,
    no request was answered by the scalar engine, and the card's run
    took under 60 s. Returns the kernel launches it made and the CPU
    fronts' answers ({lane: answers}, the later phases' reference).
    device: the fronts' engine device (None: the card; a CPU rehearsal
    passes "cpu" and fails at the launch check)."""
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
        n_launch = kernels.launches
        phase_s = time.monotonic() - t_phase
        after = {f: e.stats_snapshot() for f, e in engines.items()}
        breaker = {f: BREAKER_STATE_NAMES[
            svc.admission.breaker.stats()["state"]]
            for f, svc in fronts.svc.items()}
    finally:
        fronts.close()
    # the asyncio HTTP lane once more under torch.profiler, through the
    # port's fronts started in a fresh process
    traced = run_fresh("service", bodies)
    n_traced = traced.pop("process_launches")
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
    if lanes["threaded-http"]["p99_ms"] >= 1000:
        raise AssertionError(f"service: threaded HTTP p99 "
                             f"{lanes['threaded-http']['p99_ms']:.1f} ms "
                             "(a connect stalled on the accept backlog?)")
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
    return n_launch + n_traced, want


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
            def launch(cb, lane="main", full_out=False, trace=None,
                       _orig=eng._launch):
                best = self.largest.get(lane)
                if best is None or cb.wire["cnsl"].size > \
                        best["cnsl"].size:
                    self.largest[lane] = {k: np.array(v)
                                          for k, v in cb.wire.items()}
                return _orig(cb, lane, full_out, trace)
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
    depth-2 pass runs under torch.profiler in a fresh process
    (run_fresh, check_trace), and the kernel
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
    phase_s = time.monotonic() - t_phase
    # the traced depth-2 pass, in a fresh process
    traced = run_fresh("scheduler", inputs["mix"])
    n_launch += traced.pop("process_launches")
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


# -- device pool, sharded launches, integrity scrub, eval scorecard ---------

POOL_LANES = 4               # simulated pool lanes on the one card
# seeded schedules that fire within a call's first dispatches (lane_lost
# on fetch 1, lane_stall on fetch 2)
POOL_RULES = {"clean": None,
              "lane_lost": "lane_lost:error:p=0.3:seed=3",
              "lane_stall": "lane_stall:delay_ms=20:p=0.3:seed=7"}
SHARD_COUNTS = (2, 4)        # shards of the one-card meshes
SCRUB_INTERVAL_S = 60        # the scrub cadence the overhead is read at


@contextlib.contextmanager
def env_knobs(**values):
    """Set environment knobs for the block (engines read them when they
    are built), then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class WireRecorder:
    """Keeps a copy of every wire the engine launches inside the block
    (numpy, as packed)."""

    def __init__(self, eng):
        self.eng = eng
        self.wires: list = []

    def __enter__(self):
        def launch(cb, lane="main", full_out=False, trace=None,
                   _orig=self.eng._launch):
            self.wires.append({k: np.array(v) for k, v in cb.wire.items()})
            return _orig(cb, lane, full_out, trace)
        self.eng._launch = launch
        return self

    def __exit__(self, *exc):
        del self.eng._launch
        return False


def held_to_plain(kernels, dt, dev, wires: list) -> int:
    """The kernel against its plain version on the card, word1, bit for
    bit, on every wire; returns the largest |kernel - plain|."""
    from language_detector_tpu_torch.ops.score import (score_chunks_plain,
                                                       wire_to_device)
    err = 0
    for wire in wires:
        w = wire_to_device(wire, dev)
        got = kernels.score_chunks(dt, w)
        want = score_chunks_plain(dt, w)
        torch.cuda.synchronize()
        if got.numel():
            err = max(err, int((got.to(torch.int64) -
                                want.to(torch.int64)).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain on a {wire_shape_of(wire)}"
                                 f" wire: {int((got != want).sum())} words "
                                 "differ")
    return err


def pool_counts(eng) -> tuple:
    """(pool launches, hedges, redispatches, device dispatches) so far."""
    c = eng.pool.dispatch_counts()
    return (c["launched"], c["hedges"], c["redispatches"],
            eng.stats_snapshot()["device_dispatches"])


def pool_phase(docs: list, answer: dict, kernels, smi: str, tables, reg,
               dev) -> int:
    """Phase `pool`: POOL_LANES simulated pool lanes on the card. The
    mix through detect_codes answers as the pool-less engine did (the
    main path's answers) clean, under a lane_lost rule (lost batches
    redispatched on other lanes) and, on an engine whose hedge floor is
    2 ms, under a lane_stall rule (straggler fetches hedged); on every
    call the kernel launches equal the pool's launches, which equal the
    device dispatches plus hedges plus redispatches, and no staging
    lease is released under a copy in flight or left out. Then the
    threaded front with a pooled engine on the card renders the live
    ldt_pool_* gauges. Returns the kernel launches it made."""
    import urllib.request

    from language_detector_tpu_torch import faults
    from language_detector_tpu_torch.models.ngram import NgramBatchEngine
    from language_detector_tpu_torch.service import server
    t_phase = time.monotonic()
    want = [answer[d] for d in docs]
    lanes = str(POOL_LANES)
    with env_knobs(LDT_POOL_LANES=lanes):
        eng = NgramBatchEngine(tables, reg, device=dev)
    with env_knobs(LDT_POOL_LANES=lanes, LDT_POOL_HEDGE_FACTOR="1",
                   LDT_POOL_HEDGE_MIN_MS="2"):
        heng = NgramBatchEngine(tables, reg, device=dev)
    n_launch = 0
    # every lane of the hedging engine needs HEDGE_MIN_SAMPLES fetches
    # before its p95 is trusted
    kernels.launches = 0
    for _ in range(4):
        heng.detect_codes(docs)
    n_launch += kernels.launches
    runs: dict = {}
    bad: list = []
    for name, rule in POOL_RULES.items():
        e = heng if name == "lane_stall" else eng
        c0 = pool_counts(e)
        faults.configure(rule)
        kernels.launches = 0
        t0 = time.perf_counter()
        try:
            got = e.detect_codes(docs)
        finally:
            faults.configure(None)
        wall = time.perf_counter() - t0
        launched = kernels.launches
        n_launch += launched
        pl, hedges, redisp, disp = (b - a for a, b in
                                    zip(c0, pool_counts(e)))
        ring = e.staging_stats()
        runs[name] = {"launches": launched, "pool_launches": pl,
                      "dispatches": disp, "hedges": hedges,
                      "redispatches": redisp, "wall_s": wall,
                      "docs_per_s": len(docs) / wall,
                      "lanes": e.pool.stats(),
                      "pending_releases": ring["pending_releases"],
                      "staging_occupancy": ring["occupancy"],
                      "answers_equal": got == want}
        if got != want or not (launched == pl == disp + hedges + redisp) \
                or ring["pending_releases"] or ring["occupancy"]:
            bad.append(name)
    if not runs["lane_lost"]["redispatches"]:
        bad.append("lane_lost: no redispatch")
    if not runs["lane_stall"]["hedges"]:
        bad.append("lane_stall: no hedge")
    for e in (eng, heng):
        e.pool.close()
    # the pool's gauges through a front on the card
    with env_knobs(LDT_POOL_LANES=lanes):
        svc = server.DetectorService(device=dev)
    httpd, metricsd, svc = server.make_server(0, 0, service=svc)
    for srv in (httpd, metricsd):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    # a request of 256 short documents (under the fronts' body limit)
    short = [d for d in docs if len(d) < 2000][:256]
    kernels.launches = 0
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/",
            data=json.dumps({"request": [{"text": t}
                                         for t in short]}).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            codes = [x.get("iso6391code") for x in
                     json.loads(r.read())["response"]]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{metricsd.server_address[1]}/metrics",
                timeout=30) as r:
            text = r.read().decode()
        front_pool = svc._engine.pool.dispatch_counts()
    finally:
        for srv in (httpd, metricsd):
            srv.shutdown()
            srv.server_close()
        svc.batcher.close()
        svc._engine.pool.close()
    front_launches = kernels.launches
    n_launch += front_launches
    gauges = {k: metric_value(text, k) for k in
              ("ldt_pool_lanes_total", "ldt_pool_lanes_active")}
    phase_s = time.monotonic() - t_phase
    phase("pool", card=smi, lanes=POOL_LANES, docs=len(docs), runs=runs,
          front={"gauges": gauges, "launches": front_launches,
                 "pool": front_pool,
                 "answers_equal": codes == [answer[d] for d in short]},
          phase_s=phase_s)
    if gauges != {"ldt_pool_lanes_total": POOL_LANES,
                  "ldt_pool_lanes_active": POOL_LANES} or \
            codes != [answer[d] for d in short] or front_launches <= 0 or \
            front_launches != front_pool["launched"]:
        bad.append("front")
    if bad:
        raise AssertionError(f"pool: {bad}")
    return n_launch


def shards_phase(docs: list, answer: dict, kernels, smi: str, tables,
                 reg, dev) -> tuple:
    """Phase `shards`: engines over meshes of SHARD_COUNTS shards on the
    one card (several shards on one device: each shard its own
    fused-tote launch over its own shard row). The mix through
    detect_codes answers as the unsharded engine did; the kernel
    launches equal shards x device dispatches; the kernel equals its
    plain version on every shard's wire. A mesh over several cards runs
    only when the machine has them. Returns (kernel launches made, the
    largest |kernel - plain|)."""
    from language_detector_tpu_torch.models.ngram import NgramBatchEngine
    from language_detector_tpu_torch.ops.device_tables import DeviceTables
    from language_detector_tpu_torch.parallel.mesh import (batch_mesh,
                                                           shard_wire)
    t_phase = time.monotonic()
    want = [answer[d] for d in docs]
    dt = DeviceTables.from_host(tables, reg, dev)
    meshes = {f"cuda:0x{n}": batch_mesh(devices=[dev] * n)
              for n in SHARD_COUNTS}
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        meshes[f"cards{n_cards}"] = batch_mesh()
    n_launch, err = 0, 0
    out: dict = {}
    bad: list = []
    for name, m in meshes.items():
        eng = NgramBatchEngine(tables, reg, device=dev, mesh=m)
        before = eng.stats_snapshot()["device_dispatches"]
        with WireRecorder(eng) as rec:
            kernels.launches = 0
            t0 = time.perf_counter()
            got = eng.detect_codes(docs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = kernels.launches
        n_launch += launched
        disp = eng.stats_snapshot()["device_dispatches"] - before
        shard_wires = [w for wire in rec.wires
                       for w in shard_wire(wire, m.size)]
        err = max(err, held_to_plain(kernels, dt, dev, shard_wires))
        ring = eng.staging_stats()
        out[name] = {"shards": m.size,
                     "devices": [str(d) for d in m.devices],
                     "launches": launched, "dispatches": disp,
                     "shard_wires": len(shard_wires),
                     "wire_shapes": sorted({str(wire_shape_of(w))
                                            for w in rec.wires}),
                     "wall_s": wall, "docs_per_s": len(docs) / wall,
                     "pending_releases": ring["pending_releases"],
                     "answers_equal": got == want}
        if got != want or launched != m.size * disp or \
                len(shard_wires) != launched or ring["pending_releases"]:
            bad.append(name)
    phase("shards", card=smi, meshes=out, max_abs_err=err,
          multi_card=("run" if n_cards >= 2 else
                      f"not run: {n_cards} CUDA device"),
          phase_s=time.monotonic() - t_phase)
    if bad:
        raise AssertionError(f"shards: {bad}")
    return n_launch, err


def integrity_phase(docs: list, answer: dict, kernels, smi: str, tables,
                    reg, dev) -> int:
    """Phase `integrity`: the device table digest (torch ops on the
    card) equals device_tables.fold_host on every plane; on a 2-lane
    pooled engine scrubbing every SCRUB_INTERVAL_S, a seeded bit-flip
    of one lane's tables on the card is detected by the scrub,
    quarantined (capacity drops), healed from the host tables and
    readmitted by one served batch, while the other lane kept the
    shared tables; then tables whose digest was made to match but whose
    scores are wrong are caught by the canary alone. The mix answers as
    before after each heal. Also the scrub cycle's ms and its overhead
    at SCRUB_INTERVAL_S (bench_scrub_overhead). Returns the kernel
    launches it made."""
    import dataclasses

    from language_detector_tpu_torch import integrity, telemetry
    from language_detector_tpu_torch.models.ngram import NgramBatchEngine
    from language_detector_tpu_torch.ops.device_tables import (
        PLANES, DeviceTables, fingerprint)
    from language_detector_tpu_torch.parallel.pool import LANE_ACTIVE
    t_phase = time.monotonic()
    want = [answer[d] for d in docs]
    dt = DeviceTables.from_host(tables, reg, dev)
    fp = fingerprint(dt)
    digest = kernels.table_digest(dt).tolist()
    digest_ms = device_ms(lambda: kernels.table_digest(dt), 10, 5)
    bad: list = []
    if tuple(digest) != fp:
        bad.append(("digest", [n for n, a, b in zip(PLANES, digest, fp)
                               if a != b]))
    with env_knobs(LDT_POOL_LANES="2",
                   LDT_SCRUB_INTERVAL_SEC=str(SCRUB_INTERVAL_S)):
        eng = NgramBatchEngine(tables, reg, device=dev)
    mon = eng.integrity
    n_launch = 0
    kernels.launches = 0
    steps: dict = {}

    def served():
        got = eng.detect_codes(docs)
        return {"answers_equal": got == want,
                "states": [ln.snapshot()["state"] for ln in eng.pool.lanes],
                "capacity": eng.pool.capacity()}

    steps["clean_scrub"] = {"result": [mon.scrub_lane(ln)
                                       for ln in eng.pool.lanes]}
    lane = eng.pool.lanes[1]
    # seed 21 flips a bit of cat_ind2 (21 % 19 planes = 2), the plane of
    # langprobs every launch reads
    lane.dt = integrity.corrupt_tables(lane.dt, seed=21)
    flipped = [n for n, a, b in zip(PLANES,
                                    kernels.table_digest(lane.dt).tolist(),
                                    fp) if a != b]
    mon.scrub_pass()
    steps["seeded_flip"] = {
        "plane": flipped, "stats": dict(mon.stats),
        "capacity": eng.pool.capacity(),
        "lane0_shared": eng.pool.lanes[0].dt is eng.dt,
        "healed_digest_equal":
            tuple(kernels.table_digest(lane.dt).tolist()) == fp,
        "served": served()}
    cap0 = telemetry.REGISTRY.counter_value(
        "ldt_integrity_detected_total", kind="canary",
        lane=eng.pool.lanes[0].name)
    l0 = eng.pool.lanes[0]
    l0.dt = dataclasses.replace(l0.dt,
                                cat_ind2=torch.zeros_like(l0.dt.cat_ind2))
    mon.expected[l0.idx] = fingerprint(l0.dt)
    steps["canary_fault"] = {
        "result": mon.scrub_lane(l0),
        "canary_detections": telemetry.REGISTRY.counter_value(
            "ldt_integrity_detected_total", kind="canary",
            lane=l0.name) - cap0,
        "capacity": eng.pool.capacity(), "served": served()}
    over = integrity.bench_scrub_overhead(eng)
    n_launch += kernels.launches
    eng.pool.close()
    phase("integrity", card=smi, planes=len(PLANES), digest_equal=not bad,
          digest_ms=digest_ms, steps=steps, scrub_stats=dict(mon.stats),
          scrub_cycle_ms=over["scrub_cycle_ms"],
          overhead_frac_at_60s=over["overhead_frac"], launches=n_launch,
          phase_s=time.monotonic() - t_phase)
    sf, cf = steps["seeded_flip"], steps["canary_fault"]
    active = ["active"] * 2
    if steps["clean_scrub"]["result"] != ["ok", "ok"] or \
            len(flipped) != 1 or \
            (sf["stats"]["detected"], sf["stats"]["healed"]) != (1, 1) or \
            sf["capacity"] != (1, 2) or not sf["lane0_shared"] or \
            not sf["healed_digest_equal"] or \
            sf["served"] != {"answers_equal": True, "states": active,
                             "capacity": (2, 2)} or \
            cf["result"] != "mismatch" or cf["canary_detections"] != 1 or \
            cf["capacity"] != (1, 2) or \
            cf["served"] != {"answers_equal": True, "states": active,
                             "capacity": (2, 2)} or \
            not all(ln.state() == LANE_ACTIVE for ln in eng.pool.lanes):
        bad.append("scrub")
    if bad:
        raise AssertionError(f"integrity: {bad}")
    return n_launch


def eval_reference() -> dict:
    """Worker process: the eval scorecard of the port's engine on the
    CPU (device="cpu"), the whole corpus."""
    torch.set_num_threads(2)
    from language_detector_tpu_torch import evalsuite
    return evalsuite.run_eval(device="cpu")


def eval_phase(want: dict, kernels, smi: str, tables, reg, dev) -> int:
    """Phase `eval`: the eval scorecard (evalsuite.run_eval, the whole
    corpus) of the engine on the card equals the CPU worker's key for
    key and clears check_floor. Returns the kernel launches it made."""
    from language_detector_tpu_torch import evalsuite
    from language_detector_tpu_torch.models.ngram import NgramBatchEngine
    eng = NgramBatchEngine(tables, reg, device=dev)
    kernels.launches = 0
    t0 = time.monotonic()
    card = evalsuite.run_eval(eng)
    secs = time.monotonic() - t0
    n_launch = kernels.launches
    phase("eval", card=smi, corpus_docs=card["corpus_docs"],
          languages=card["languages"], agreement=card["agreement"],
          label_accuracy=card["label_accuracy"],
          hint_flip=card["hint_flip"]["flipped"], launches=n_launch,
          cpu_equal=card == want, run_s=secs)
    if card != want or n_launch <= 0:
        raise AssertionError("eval: the card's scorecard differs from the "
                             "CPU's" if card != want else
                             "eval: no kernel launch")
    evalsuite.check_floor(card)
    return n_launch


# -- the process layer: shm ring lane, supervisor, fleet -----------------------

SHM_SLOTS = 8                # ring slots the smoke's client pipelines over
SHM_SLOT_BYTES = 1 << 21     # holds the largest service body (1 MB)
SHM_PASSES = 2               # timed passes a lane, alternating
SHM_PASS_S = 2.5             # seconds a timed pass cycles the bodies
POISON_DOCS = 32             # documents of the poison frame
PROC_CLIENTS = 16            # HTTP clients of the supervisor and fleet
FLEET_WORKERS = 2            # fleet members on the one card
FLEET_ORDER = (2, 1, 1, 2)   # fleet sizes of the throughput passes
FLEET_PASS_S = 2.5           # seconds a throughput pass cycles the bodies
PROC_START_S = 240           # a supervised worker or fleet must be ready


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def get_url(url: str, timeout: float = 10.0) -> tuple:
    """(status, body bytes) of one GET; (0, b"") when it fails."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    except Exception:  # noqa: BLE001 - not up yet / mid-teardown
        return 0, b""


def scrape(metrics_port: int) -> str:
    return get_url(f"http://127.0.0.1:{metrics_port}/metrics")[1].decode()


def fleetz(status_port: int) -> dict | None:
    st, body = get_url(f"http://127.0.0.1:{status_port}/fleetz")
    return json.loads(body) if st == 200 else None


def wait_for(pred, what: str, limit_s: float, proc=None):
    """Poll pred() every 0.1 s until it returns a true value (returned);
    raises after limit_s or when proc has exited."""
    deadline = time.monotonic() + limit_s
    while True:
        got = pred()
        if got:
            return got
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"{what}: the process exited with "
                                 f"{proc.returncode}")
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {limit_s} s")
        time.sleep(0.1)


def body_docs(body: bytes) -> int:
    """The documents a request body asks about (0 for a malformed one)."""
    try:
        return len(json.loads(body)["request"])
    except (ValueError, KeyError, TypeError):
        return 0


class HttpLoad:
    """Clients posting bodies over HTTP/1.1 keep-alive to one port.
    Request i carries the id "aio-http-<i>", the id the service phase's
    CPU reference gave the same body. run() sends every body once
    (answers in request order); start()/stop() cycle through the bodies
    until stopped, and run_for(s) does so for s seconds. A request whose
    connection fails before any response (a keep-alive connection a
    draining or killed worker closed) is sent again once on a new
    connection: `retries` counts those, `failed` the requests that
    still got no response. `docs` counts the documents of the 2xx
    answers; with `want` (the reference's (status, id, payload) per
    body), `mismatched` counts the answers whose status or payload
    differs from it."""

    def __init__(self, port: int, bodies: list, clients: int,
                 want: list | None = None):
        self.port, self.bodies, self.clients = port, bodies, clients
        self.want = want
        self.body_docs = [body_docs(b) for b in bodies]
        self.lock = threading.Lock()
        self.stop_ev = threading.Event()
        self.answers: list = [None] * len(bodies)
        self.statuses: list = []
        self.secs: list = []
        self.docs = 0
        self.mismatched = 0
        self.retries = 0
        self.failed = 0
        self.errors: list = []
        self._threads: list = []

    def _post(self, conn, i: int) -> tuple:
        conn.request("POST", "/", self.bodies[i], {
            "Content-Type": "application/json",
            "X-LDT-Request-Id": f"aio-http-{i}"})
        r = conn.getresponse()
        payload = r.read()
        return r.status, r.getheader("X-LDT-Request-Id"), payload

    def _client(self, work) -> None:
        import http.client

        def connect():
            return http.client.HTTPConnection("127.0.0.1", self.port,
                                              timeout=120)
        conn = connect()
        try:
            while not self.stop_ev.is_set():
                i = work()
                if i is None:
                    return
                t0 = time.perf_counter()
                try:
                    got = self._post(conn, i)
                except (OSError, http.client.HTTPException):
                    conn.close()
                    conn = connect()
                    with self.lock:
                        self.retries += 1
                    try:
                        got = self._post(conn, i)
                    except (OSError, http.client.HTTPException) as e:
                        conn.close()
                        conn = connect()
                        with self.lock:
                            self.failed += 1
                            self.errors.append(repr(e))
                        continue
                dt = time.perf_counter() - t0
                with self.lock:
                    self.answers[i] = got
                    self.statuses.append(got[0])
                    self.secs.append(dt)
                    if got[0] in (200, 203):
                        self.docs += self.body_docs[i]
                    if self.want is not None and (got[0], got[2]) != (
                            self.want[i][0], self.want[i][2]):
                        self.mismatched += 1
        finally:
            conn.close()

    def _spawn(self, work) -> None:
        self._threads = [threading.Thread(target=self._client,
                                          args=(work,), daemon=True)
                         for _ in range(self.clients)]
        for t in self._threads:
            t.start()

    def _join(self) -> None:
        for t in self._threads:
            t.join(600)
        if any(t.is_alive() for t in self._threads):
            raise AssertionError("an HTTP client hung")

    def run(self) -> float:
        """Every body once; returns the wall seconds."""
        nxt = iter(range(len(self.bodies)))

        def work():
            with self.lock:
                return next(nxt, None)
        t0 = time.perf_counter()
        self._spawn(work)
        self._join()
        return time.perf_counter() - t0

    def start(self) -> None:
        counter = iter(range(1 << 62))

        def work():
            with self.lock:
                return next(counter) % len(self.bodies)
        self._spawn(work)

    def stop(self) -> None:
        self.stop_ev.set()
        self._join()

    def run_for(self, limit_s: float) -> float:
        """Cycle through the bodies for limit_s seconds, then let the
        requests in flight finish; returns the wall seconds of the
        whole window (start to the last answer)."""
        t0 = time.perf_counter()
        self.start()
        time.sleep(limit_s)
        self.stop()
        return time.perf_counter() - t0

    def non_2xx(self) -> list:
        return sorted({s for s in self.statuses if s not in (200, 203)})

    def payload_mismatches(self, want: list) -> list:
        """Indices whose last answer's (status, payload) differs from
        want's (status, id, payload) for the same body."""
        return [i for i, a in enumerate(self.answers)
                if a is not None and (a[0], a[2]) != (want[i][0],
                                                      want[i][2])]


def proc_env(**values) -> dict:
    """The environment of a supervisor the smoke starts: this one, the
    checkout on the path, and values."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.update({k: str(v) for k, v in values.items()})
    return env


def start_supervisor(env: dict, log_path: str, module: str | None = None):
    """python -m language_detector_tpu_torch.service.supervisor [module]
    (by default its own default, the asyncio front) in a session of its
    own, its output to log_path."""
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "language_detector_tpu_torch.service.supervisor"] +
        ([module] if module else []),
        cwd=str(ROOT), env=env, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)
    proc.log = log
    return proc


def stop_supervisor(proc, sig=None, limit_s: float = 120) -> int | None:
    """Signal the supervisor (SIGTERM by default), wait for it, then
    kill whatever is left of its session; its exit code (None if it had
    to be killed)."""
    import signal
    rc = None
    try:
        if proc.poll() is None:
            proc.send_signal(sig or signal.SIGTERM)
        rc = proc.wait(timeout=limit_s)
    except subprocess.TimeoutExpired:
        pass
    finally:
        with contextlib.suppress(ProcessLookupError, PermissionError):
            os.killpg(proc.pid, signal.SIGKILL)
        with contextlib.suppress(subprocess.TimeoutExpired):
            proc.wait(timeout=30)
        proc.log.close()
    return rc


def member_counts(metrics_port: int) -> dict:
    """One worker's kernel launches, device dispatches, flushes,
    shared-tier hits, warmup ms and generation from its /metrics."""
    text = scrape(metrics_port)
    return {"launches": metric_value(text, "ldt_kernel_launches_total"),
            "dispatches": metric_value(text,
                                       "ldt_device_dispatches_total"),
            "flushes": metric_value(text, "ldt_batch_flushes_total"),
            "shared_hits": metric_value(text,
                                        "ldt_shared_cache_hits_total"),
            "warmup_ms": metric_value(text, "ldt_warmup_ms"),
            "generation": metric_value(text, "ldt_worker_generation")}


def lane_stats(load: HttpLoad, wall: float) -> dict:
    """docs/s over the whole window (every answered document over its
    wall seconds) and the request latencies of a timed load."""
    return {"docs": load.docs, "requests": len(load.statuses),
            "wall_s": wall, "docs_per_s": load.docs / wall,
            "p50_ms": percentile(load.secs, 50) * 1e3,
            "p99_ms": percentile(load.secs, 99) * 1e3,
            "retries": load.retries, "failed": load.failed,
            "mismatched": load.mismatched, "non_2xx": load.non_2xx()}


def shm_phase(bodies: list, want: dict, answer: dict, docs: list,
              kernels, smi: str, device=None) -> int:
    """Phase `shm`: one threaded front's service on the card serving its
    unix-socket lane and its shared-memory ring lane (the servers its
    main() opens for LDT_UNIX_SOCKET and LDT_SHM_DIR), driven as
    bench.py's bench_shm drives them: the service bodies through the
    socket (v1 frames, one in flight) and through the ring (a RingClient
    pipelining over SHM_SLOTS slots), SHM_PASSES alternating passes a
    lane, each cycling through the bodies for SHM_PASS_S seconds (docs/s
    = every answered document over the pass's whole window). An untimed
    socket pass sends every body once first: its answers must equal the
    CPU front's, and every timed response of either lane must be
    byte-identical to it for the same body, with zero non-2xx; launches
    equal device dispatches. Then, under a poison_doc:error rule, a
    POISON_DOCS-document frame with one poison document: bisection
    quarantines exactly that one and the other documents answer as the
    main path did. Returns the kernel launches of the timed passes.
    device: the service's engine device (None: the card)."""
    import shutil
    import socket
    import tempfile

    from language_detector_tpu_torch import faults
    from language_detector_tpu_torch.service import server, shmring, wire
    tmp = tempfile.mkdtemp(prefix="ldt-smoke-shm-")
    uds_path = os.path.join(tmp, "ldt.sock")
    svc = server.DetectorService(device=device)
    uds = wire.UnixFrameServer(svc, uds_path)
    uds.start()
    ring_srv = shmring.ShmRingServer(svc, os.path.join(tmp, "rings"))
    ring_srv.start()
    cli = shmring.RingClient(os.path.join(tmp, "rings"), slots=SHM_SLOTS,
                             slot_bytes=SHM_SLOT_BYTES)
    n_of = [body_docs(b) for b in bodies]
    n_docs = sum(n_of)
    ref = want["threaded-uds"]

    def indices(limit_s, t0):
        """Every body once (limit_s None), else cycling through the
        bodies until limit_s seconds after t0."""
        if limit_s is None:
            yield from range(len(bodies))
            return
        i = 0
        while time.perf_counter() - t0 < limit_s:
            yield i % len(bodies)
            i += 1

    def uds_pass(limit_s=None):
        lat, out = [], []
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(120)
        conn.connect(uds_path)
        t0 = time.perf_counter()
        try:
            for j in indices(limit_s, t0):
                t1 = time.perf_counter()
                conn.sendall(wire.pack_frame(bodies[j]))
                st, _, payload = wire.recv_response_frame(conn)
                lat.append(time.perf_counter() - t1)
                out.append((j, st, payload))
        finally:
            conn.close()
        return out, lat, time.perf_counter() - t0

    def shm_pass(limit_s=None):
        lat, out = [], []
        pending: list = []
        t0 = time.perf_counter()

        def drain_oldest():
            j, slot, t1 = pending.pop(0)
            out.append((j, *cli.wait(slot, timeout=120.0)))
            lat.append(time.perf_counter() - t1)

        for j in indices(limit_s, t0):
            while True:
                slot = cli.submit(bodies[j])
                if slot is not None:
                    break
                drain_oldest()
            pending.append((j, slot, time.perf_counter()))
        while pending:
            drain_oldest()
        return out, lat, time.perf_counter() - t0

    engine = svc._engine
    passes: dict = {"uds": [], "shm": []}
    try:
        cli.wait_attached(60.0)
        # untimed: every body once through the socket (the flush pool
        # warms); the lane's answers, held to the CPU front's
        base = {j: (st, p) for j, st, p in uds_pass()[0]}
        cpu_bad = [i for i in range(len(bodies))
                   if base[i] != (ref[i][0], ref[i][2])]
        before = engine.stats_snapshot()["device_dispatches"]
        kernels.launches = 0
        for _ in range(SHM_PASSES):
            for name, fn in (("uds", uds_pass), ("shm", shm_pass)):
                out, lat, wall = fn(SHM_PASS_S)
                answered = sum(n_of[j] for j, st, _ in out
                               if st in (200, 203))
                passes[name].append({
                    "docs": answered, "requests": len(out),
                    "docs_per_s": answered / wall, "wall_s": wall,
                    "p50_ms": percentile(lat, 50) * 1e3,
                    "p99_ms": percentile(lat, 99) * 1e3,
                    "non_2xx": sorted({st for _, st, _ in out
                                       if st not in (200, 203)}),
                    "unequal_to_uds": sum(base[j] != (st, p)
                                          for j, st, p in out)})
        n_launch = kernels.launches
        dispatches = engine.stats_snapshot()["device_dispatches"] - before
        # the poison frame: short documents of the mix and a marked one
        rng = random.Random(len(bodies))
        frame_docs = rng.sample([d for d in docs if len(d) < 2000],
                                POISON_DOCS - 1)
        at = rng.randrange(POISON_DOCS)
        frame_docs.insert(at, f"{frame_docs[0]} {shmring.POISON_MARKER}")
        q0 = ring_srv.quarantine.stats()
        faults.configure("poison_doc:error")
        try:
            st, resp = cli.request(json.dumps({"request": [
                {"text": t} for t in frame_docs]}).encode(), timeout=120)
        finally:
            faults.configure(None)
        codes = [r.get("iso6391code") for r in
                 json.loads(resp)["response"]]
        q1 = ring_srv.quarantine.stats()
        others = frame_docs[:at] + frame_docs[at + 1:]
        poison = {"status": st, "at": at, "code_at": codes[at],
                  "others_equal": codes[:at] + codes[at + 1:] == [
                      answer[t] for t in others],
                  "quarantined": q1["quarantined_docs"] -
                  q0["quarantined_docs"],
                  "bisect_batches": q1["bisect_batches"] -
                  q0["bisect_batches"]}
        shm_stats = ring_srv.stats()
    finally:
        cli.close(unlink=True)
        ring_srv.close()
        uds.close()
        svc.batcher.close()
        shutil.rmtree(tmp, ignore_errors=True)
    phase("shm", card=smi, requests=len(bodies), docs=n_docs,
          slots=SHM_SLOTS, slot_bytes=SHM_SLOT_BYTES, passes=passes,
          shm_docs_per_s=statistics.median(
              p["docs_per_s"] for p in passes["shm"]),
          uds_docs_per_s=statistics.median(
              p["docs_per_s"] for p in passes["uds"]),
          shm_p99_ms=statistics.median(p["p99_ms"] for p in passes["shm"]),
          cpu_equal=not cpu_bad, launches=n_launch,
          device_dispatches=dispatches, ring=shm_stats, poison=poison)
    bad_pass = [p for ps in passes.values() for p in ps
                if p["non_2xx"] or p["unequal_to_uds"]]
    if cpu_bad or bad_pass:
        raise AssertionError(f"shm: responses differ from the socket "
                             f"lane's or the CPU front's "
                             f"({cpu_bad[:5]}, {bad_pass[:2]})")
    if not (n_launch > 0 and n_launch == dispatches):
        raise AssertionError(f"shm: {n_launch} kernel launches over "
                             f"{dispatches} device dispatches")
    if not (poison["quarantined"] == 1 and poison["code_at"] == "un" and
            poison["others_equal"] and poison["status"] in (200, 203)):
        raise AssertionError(f"shm: poison bisection {poison}")
    return n_launch


def supervisor_phase(bodies: list, want: dict, smi: str) -> int:
    """Phase `supervisor`: python -m
    language_detector_tpu_torch.service.supervisor runs one asyncio
    front on the card (LDT_REUSEPORT, LDT_WARMUP), PROC_CLIENTS clients
    post the service bodies over HTTP, and a SIGHUP runs the blue/green
    drill under that load: the standby becomes ready on the card, the
    old generation drains, generation 2 serves the load (its dispatches
    grow after the cut-over). Zero non-2xx, zero
    failed requests, every payload equal to the CPU front's, and the
    supervisor exits 0 on SIGTERM. Prints the standby's warmup_ms and
    the cut-over time. Returns the kernel launches of two windows, each
    of which must equal its device dispatches: generation 1's from its
    ready to the end of one pass of every body (both reads with nothing
    in flight), and generation 2's from the SIGHUP (its process did not
    exist, so its count was 0) to the end of the load, its warm-up
    flush included."""
    import re
    import shutil
    import signal
    import tempfile
    tmp = tempfile.mkdtemp(prefix="ldt-smoke-sup-")
    port, mport = free_port(), free_port()
    log_path = os.path.join(tmp, "supervisor.log")
    sup = start_supervisor(proc_env(
        LISTEN_PORT=port, PROMETHEUS_PORT=mport, LDT_REUSEPORT=1,
        LDT_WARMUP=1, LDT_SWAP_TIMEOUT_SEC=120), log_path)
    ref = want["aio-http"]
    t_phase = time.monotonic()
    rc = None
    try:
        wait_for(lambda: get_url(f"http://127.0.0.1:{mport}/readyz")[0]
                 == 200, "supervised worker ready", PROC_START_S, sup)
        gen1_0 = member_counts(mport)
        ready1_s = time.monotonic() - t_phase
        pre = HttpLoad(port, bodies, PROC_CLIENTS, want=ref)
        pre.run()
        gen1 = member_counts(mport)
        load = HttpLoad(port, bodies, PROC_CLIENTS)
        load.start()
        time.sleep(1.0)                       # load established
        t_hup = time.monotonic()
        sup.send_signal(signal.SIGHUP)
        # cut over: the standby is ready and the old generation drained
        wait_for(lambda: "supervisor: swap complete" in open(
            log_path).read(), "swap drill complete", PROC_START_S, sup)
        cutover_s = time.monotonic() - t_hup
        gen2_0 = member_counts(mport)
        time.sleep(2.0)                       # traffic rides generation 2
        load.stop()
        gen2 = member_counts(mport)
        rc = stop_supervisor(sup)
        text = open(log_path).read()
    finally:
        if rc is None:
            stop_supervisor(sup)
        shutil.rmtree(tmp, ignore_errors=True)
    m = re.search(r'"msg": "supervisor: swap complete".*?'
                  r'"standby_ready_sec": ([0-9.]+)', text)
    bad = load.payload_mismatches(ref)
    win1 = {k: gen1[k] - gen1_0[k] for k in ("launches", "dispatches")}
    phase("supervisor", card=smi, clients=PROC_CLIENTS,
          requests=len(load.statuses),
          generation1={"ready_s": ready1_s, **gen1},
          generation1_window={**win1, "requests": len(pre.statuses),
                              "mismatched": pre.mismatched},
          standby_warmup_ms=gen2["warmup_ms"],
          standby_ready_s=float(m.group(1)) if m else None,
          cutover_s=cutover_s, generation2=gen2,
          generation2_served_dispatches=gen2["dispatches"] -
          gen2_0["dispatches"],
          non_2xx=load.non_2xx(), failed=load.failed,
          retries=load.retries, payloads_equal=not bad, exit_code=rc,
          phase_s=time.monotonic() - t_phase)
    if load.non_2xx() or load.failed or bad or rc != 0 or \
            "swap-abort" in text or m is None or pre.mismatched or \
            pre.failed or pre.non_2xx():
        raise AssertionError(
            f"supervisor drill: non-2xx {load.non_2xx()}, "
            f"{load.failed} failed ({load.errors[:3]}), payloads differ "
            f"at {bad[:5]}, exit {rc}; log tail {text[-1500:]}")
    if not (gen2["generation"] == 2 and
            gen2["dispatches"] > gen2_0["dispatches"] and
            gen2["launches"] == gen2["dispatches"] and
            win1["launches"] > 0 and
            win1["launches"] == win1["dispatches"]):
        raise AssertionError(f"supervisor: {win1['launches']} kernel "
                             f"launches over {win1['dispatches']} "
                             f"dispatches in generation 1's window, "
                             f"generation 2 {gen2['launches']} over "
                             f"{gen2['dispatches']}")
    return int(win1["launches"] + gen2["launches"])


class Fleet:
    """python -m language_detector_tpu_torch.service.supervisor with
    LDT_FLEET_WORKERS=n: n members of `module` (None: the supervisor's
    default, the asyncio front on the card) on one SO_REUSEPORT port,
    each with its own ring directory under LDT_SHM_DIR and recorder
    under LDT_FLIGHTREC_DIR, sharing one result-cache tier file
    (LDT_RESULT_CACHE_SHM_MB)."""

    def __init__(self, n: int, tmp: str, module: str | None = None,
                 **env):
        self.n = n
        self.port, self.sport = free_port(), free_port()
        d = os.path.join(tmp, f"fleet{n}-{self.port}")
        os.makedirs(d)
        self.log_path = os.path.join(d, "fleet.log")
        self.proc = start_supervisor(proc_env(**{
            "LISTEN_PORT": self.port, "PROMETHEUS_PORT": 0,
            "LDT_FLEET_WORKERS": n, "LDT_FLEET_STATUS_PORT": self.sport,
            "LDT_SHM_DIR": os.path.join(d, "shm"),
            "LDT_FLIGHTREC_DIR": os.path.join(d, "fr"),
            "LDT_RESULT_CACHE_MB": 64, "LDT_RESULT_CACHE_SHM_MB": 64,
            "LDT_SWAP_TIMEOUT_SEC": 120,
            "LDT_CRASH_BACKOFF_BASE_SEC": 0.2,
            "LDT_CRASH_BACKOFF_MAX_SEC": 1.0, **env}),
            self.log_path, module)

    def snap(self) -> dict | None:
        return fleetz(self.sport)

    def wait(self, pred, what: str, limit_s: float = PROC_START_S) -> dict:
        return wait_for(lambda: (lambda s: s if s is not None and pred(s)
                                 else None)(self.snap()),
                        what, limit_s, self.proc)

    def counts(self) -> dict:
        """{slot: member_counts} over the members /fleetz lists."""
        return {m["slot"]: member_counts(m["metrics_port"])
                for m in self.snap()["members"] if m["metrics_port"]}

    def log(self) -> str:
        return open(self.log_path).read()

    def close(self) -> int | None:
        import signal
        return stop_supervisor(self.proc, signal.SIGINT)


def compute_mode() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def fleet_phase(bodies: list, want: dict, smi: str) -> int:
    """Phase `fleet`: FLEET_WORKERS members of the port's asyncio front
    on the one card (needs the card's compute mode Default), and beside
    it a 2-member and a 1-member fleet without result caches for the
    throughput passes. Answers: PROC_CLIENTS clients post the
    service bodies to the fleet; every (status, id, payload) equals the
    CPU front's, and every member launched the kernel once a dispatch
    (read from each member's /metrics). Shared tier: the same bodies
    again, and the shared-tier hits summed over members must be above
    0. Throughput: the cacheless 2-member fleet against the 1-member
    fleet in alternating passes (FLEET_ORDER), each cycling through the
    bodies for FLEET_PASS_S seconds, every answer equal to the CPU
    front's (docs/s = every answered document over the pass's whole
    window). Rolling swap: a SIGHUP under
    load, zero non-2xx and zero failed requests. Member death: SIGKILL
    of one member under load, /fleetz back at FLEET_WORKERS ready with
    its postmortem harvested (the failed requests printed). Returns the
    kernel launches read from the members."""
    import shutil
    import signal
    import tempfile
    mode = compute_mode()
    if mode != "Default":
        raise AssertionError(f"fleet: the card's compute mode is {mode!r}; "
                             "two member processes need Default")
    tmp = tempfile.mkdtemp(prefix="ldt-smoke-fleet-")
    ref = want["aio-http"]
    n_docs = sum(len(json.loads(b)["request"]) for b in bodies)
    t_phase = time.monotonic()
    # the fleet under test, and for the throughput passes two fleets
    # without result caches (a cached pass would time the cache)
    no_cache = {"LDT_RESULT_CACHE_MB": 0, "LDT_RESULT_CACHE_SHM_MB": 0}
    fleets = {"main": Fleet(FLEET_WORKERS, tmp),
              FLEET_WORKERS: Fleet(FLEET_WORKERS, tmp, **no_cache),
              1: Fleet(1, tmp, **no_cache)}
    fl = fleets["main"]
    rcs: dict = {}
    try:
        for f in fleets.values():
            f.wait(lambda s, n=f.n: s["ready"] == n,
                   f"{f.n}-member fleet ready")
        ready_s = time.monotonic() - t_phase
        c0 = fl.counts()
        load = HttpLoad(fl.port, bodies, PROC_CLIENTS)
        load.run()
        bad = [i for i, (a, w) in enumerate(zip(load.answers, ref))
               if a != w]
        dup = HttpLoad(fl.port, bodies, PROC_CLIENTS)
        dup.run()
        bad_dup = dup.payload_mismatches(ref)
        c1 = fl.counts()
        per_member = {s: {k: c1[s][k] - c0[s][k]
                          for k in ("launches", "dispatches",
                                    "shared_hits")} for s in c1}
        launches = sum(m["launches"] for m in per_member.values())
        dispatches = sum(m["dispatches"] for m in per_member.values())
        shared_hits = sum(m["shared_hits"] for m in per_member.values())
        # throughput: the two cacheless fleets in alternating passes,
        # each cycling through the service bodies for FLEET_PASS_S
        tput: dict = {FLEET_WORKERS: [], 1: []}
        for n in FLEET_ORDER:
            f = fleets[n]
            before = f.counts()
            lt = HttpLoad(f.port, bodies, PROC_CLIENTS, want=ref)
            wall = lt.run_for(FLEET_PASS_S)
            after = f.counts()
            tput[n].append(lane_stats(lt, wall))
            launches += sum(after[s]["launches"] - before[s]["launches"]
                            for s in after if s in before)
            dispatches += sum(after[s]["dispatches"] -
                              before[s]["dispatches"]
                              for s in after if s in before)
            if lt.failed or lt.non_2xx() or lt.mismatched:
                raise AssertionError(f"fleet of {n}: a throughput pass "
                                     f"failed {tput[n][-1]}")
        for n in (FLEET_WORKERS, 1):
            rcs[f"throughput-{n}"] = fleets.pop(n).close()
        # rolling swap under load
        gen_before = max(m["generation"] for m in fl.snap()["members"])
        roll = HttpLoad(fl.port, bodies, PROC_CLIENTS)
        roll.start()
        time.sleep(1.0)
        t_hup = time.monotonic()
        fl.proc.send_signal(signal.SIGHUP)
        fl.wait(lambda s: s["ready"] == FLEET_WORKERS and
                min(m["generation"] for m in s["members"]) > gen_before,
                "rolling swap done")
        wait_for(lambda: "rolling swap complete" in fl.log(),
                 "rolling swap logged", 30, fl.proc)
        roll_s = time.monotonic() - t_hup
        time.sleep(1.0)
        roll.stop()
        # member death under load
        victim = fl.snap()["members"][0]
        death = HttpLoad(fl.port, bodies, PROC_CLIENTS)
        death.start()
        time.sleep(1.0)
        t_kill = time.monotonic()
        os.kill(victim["pid"], signal.SIGKILL)
        after_kill = fl.wait(
            lambda s: s["ready"] == FLEET_WORKERS and any(
                m["slot"] == victim["slot"] and
                m["pid"] not in (None, victim["pid"])
                for m in s["members"]) and any(
                p.get("pid") == victim["pid"]
                for p in s.get("postmortems", ())),
            "killed member replaced")
        replace_s = time.monotonic() - t_kill
        time.sleep(1.0)
        death.stop()
        text = fl.log()
        rcs["main"] = fleets.pop("main").close()
    finally:
        for n, f in fleets.items():
            rcs[n] = f.close()
        shutil.rmtree(tmp, ignore_errors=True)
    pm = next(p for p in after_kill["postmortems"]
              if p.get("pid") == victim["pid"])
    phase("fleet", card=smi, compute_mode=mode, workers=FLEET_WORKERS,
          clients=PROC_CLIENTS, requests=len(bodies), docs=n_docs,
          ready_s=ready_s, cpu_equal=not bad and not bad_dup,
          members=per_member, launches=launches, dispatches=dispatches,
          shared_hits=shared_hits,
          throughput={str(n): v for n, v in tput.items()},
          fleet_over_one=statistics.median(
              p["docs_per_s"] for p in tput[FLEET_WORKERS]) /
          statistics.median(p["docs_per_s"] for p in tput[1]),
          rolling_swap={"s": roll_s, "requests": len(roll.statuses),
                        "non_2xx": roll.non_2xx(), "failed": roll.failed,
                        "retries": roll.retries,
                        "payloads_equal":
                        not roll.payload_mismatches(ref)},
          member_death={"slot": victim["slot"], "replace_s": replace_s,
                        "requests": len(death.statuses),
                        "failed": death.failed, "retries": death.retries,
                        "non_2xx": death.non_2xx(),
                        "postmortem_events": pm.get("events_total")},
          exit_codes={str(n): rc for n, rc in rcs.items()},
          phase_s=time.monotonic() - t_phase)
    if bad or bad_dup:
        raise AssertionError(f"fleet answers differ from the CPU front's "
                             f"at {bad[:5]} / {bad_dup[:5]}")
    if len(per_member) != FLEET_WORKERS or any(
            m["launches"] <= 0 or m["launches"] != m["dispatches"]
            for m in per_member.values()):
        raise AssertionError(f"fleet: a member did not launch the kernel "
                             f"once a dispatch: {per_member}")
    if launches != dispatches:
        raise AssertionError(f"fleet: {launches} launches over "
                             f"{dispatches} dispatches")
    if shared_hits <= 0:
        raise AssertionError("fleet: no shared-tier hit across members")
    if roll.non_2xx() or roll.failed or roll.payload_mismatches(ref) or \
            "swap-abort" in text:
        raise AssertionError(f"fleet rolling swap: non-2xx "
                             f"{roll.non_2xx()}, {roll.failed} failed "
                             f"({roll.errors[:3]})")
    if any(rc != 0 for rc in rcs.values()):
        raise AssertionError(f"fleet exit codes {rcs}")
    return int(launches)


# -- boot-hot start, the SLO autotuner, the score-trace CLI ----------------

COLD_DOCS = 512              # documents of a cold-start process's first detect
COLD_LIMIT_S = 300           # a cold-start process must finish within
TUNE_RECORDS = 1600          # flash_crowd records a replay lap sends
TUNE_SPAN_S = 2.0            # their scheduled span; a lap adds 0.5 s lead
TUNE_CLIENTS = 32            # replay clients: the crowd's 2,160 requests/s
TUNE_SLO = "p99_ms=500,err_pct=1,window_sec=30"   # bench.py's default spec
TUNE_KNOBS = ("LDT_MAX_INFLIGHT", "LDT_MAX_QUEUE_DOCS")
TUNE_ROUNDS = 1              # coordinate-descent rounds (time budget)
TUNE_CONFIRM = 3             # alternating default / winner laps
DEBUG_DOCS = 256             # documents of the CLI's --engine-stats run

# One cold-start process: times its way from interpreter start to its
# first full detect_codes, then (grid seed > 0) holds the kernel it
# loaded against the plain version on the adversarial grids. argv: the
# checkout, the documents (JSON), the output path, the grid seed.
COLDSTART_CHILD = r"""
import json, os, shutil, sys, time
t_start = time.time()
import torch
t_torch = time.time()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t_ctx = time.time()
root, docs_path, out_path, grid_seed = sys.argv[1:5]
sys.path.insert(0, root)
from language_detector_tpu_torch import telemetry
from language_detector_tpu_torch.models.ngram import NgramBatchEngine
from language_detector_tpu_torch.ops import kernels
t_import = time.time()
spent = {"library_s": 0.0, "nvcc_s": 0.0}


def timed(fn, key):
    def call(*a, **k):
        t0 = time.time()
        try:
            return fn(*a, **k)
        finally:
            spent[key] += time.time() - t0
    return call


kernels._load = timed(kernels._load, "library_s")
kernels._nvcc_build = timed(kernels._nvcc_build, "nvcc_s")
with open(docs_path, encoding="utf-8") as f:
    docs = json.load(f)
t0 = time.time()
eng = NgramBatchEngine(device="cuda")
t_engine = time.time()
codes = eng.detect_codes(docs)
torch.cuda.synchronize()
t_ready = time.time()
launches = kernels.launches
grid = None
if int(grid_seed):
    import chip_smoke
    from language_detector_tpu_torch.ops.score import (score_chunks_plain,
                                                       wire_to_device)
    grid = {"cases": 0, "unequal": 0, "max_abs_err": 0}
    for name, wire in chip_smoke.adversarial_wires(int(grid_seed)):
        w = wire_to_device(wire, eng.dt.device)
        for full in (False, True):
            got = kernels.score_chunks(eng.dt, w, full_out=full)
            want = score_chunks_plain(eng.dt, w, full_out=full)
            torch.cuda.synchronize()
            grid["cases"] += 1
            grid["unequal"] += not torch.equal(got, want)
            if got.numel():
                grid["max_abs_err"] = max(grid["max_abs_err"], int(
                    (got.to(torch.int64) - want.to(torch.int64))
                    .abs().max()))
home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
out = {"codes": codes, "builds": kernels.builds, "launches": launches,
       "aot": eng._aot.stats() if eng._aot is not None else None,
       "aot_loads_total":
           telemetry.REGISTRY.counter_value("ldt_aot_loads_total"),
       "nvcc_found": shutil.which("nvcc") is not None or
           os.path.exists(os.path.join(home, "bin", "nvcc")),
       "t_start": t_start, "torch_import_s": t_torch - t_start,
       "cuda_context_s": t_ctx - t_torch, "port_import_s": t_import - t_ctx,
       "tables_s": t_engine - t0 - spent["library_s"],
       "library_s": spent["library_s"], "nvcc_s": spent["nvcc_s"],
       "first_detect_s": t_ready - t_engine, "t_ready": t_ready,
       "grid": grid}
with open(out_path, "w") as f:
    json.dump(out, f)
"""


def compiler_free_env(env: dict, empty_dir: str) -> dict:
    """env with no nvcc to be found: PATH without any directory that
    holds one, and CUDA_HOME (where ops/kernels.py looks first) an
    empty directory."""
    out = dict(env)
    out["PATH"] = os.pathsep.join(
        p for p in env.get("PATH", "").split(os.pathsep)
        if p and not os.path.exists(os.path.join(p, "nvcc")))
    os.makedirs(empty_dir, exist_ok=True)
    out["CUDA_HOME"] = empty_dir
    return out


def cold_process(tmp: str, docs_path: str, cache: str, *,
                 require: bool = False, no_nvcc: bool = False,
                 faults: str | None = None, grid_seed: int = 0) -> dict:
    """COLDSTART_CHILD in a fresh interpreter with its own compile cache
    (tmp/cache) and the shared bundle (tmp/bundle): its result with
    ready_s (process start to its first detect's end, on the host
    clock) and interpreter_s, or its exit code and the end of its
    standard error when it failed."""
    env = proc_env(LDT_COMPILE_CACHE_DIR=os.path.join(tmp, cache),
                   LDT_AOT_DIR=os.path.join(tmp, "bundle"),
                   LDT_AOT_REQUIRE=int(require))
    env.pop("LDT_FAULTS", None)
    if faults:
        env["LDT_FAULTS"] = faults
    if no_nvcc:
        env = compiler_free_env(env, os.path.join(tmp, "no-cuda-home"))
    out_path = os.path.join(tmp, f"{cache}.json")
    t_spawn = time.time()
    r = subprocess.run([sys.executable, "-c", COLDSTART_CHILD, str(ROOT),
                        docs_path, out_path, str(grid_seed)],
                       cwd=str(ROOT), env=env, capture_output=True,
                       text=True, timeout=COLD_LIMIT_S)
    if r.returncode != 0:
        return {"rc": r.returncode, "stderr": r.stderr[-3000:]}
    with open(out_path) as f:
        res = json.load(f)
    res.update(rc=0, ready_s=res.pop("t_ready") - t_spawn,
               interpreter_s=res.pop("t_start") - t_spawn)
    return res


def coldstart_phase(docs: list, answer: dict, smi: str, seed: int) -> int:
    """Phase `coldstart`: boot-hot start on the card. Fresh processes
    (COLDSTART_CHILD) each time cold-to-ready, from process start to its
    first full detect_codes over the mix's first COLD_DOCS documents,
    split into interpreter start, torch import, CUDA context, port
    import, tables (load and upload), library (build or load; nvcc's
    part apart) and first detect. (a) cold: an empty compile cache and
    an empty bundle: one nvcc build, one entry exported. (b) boot-hot: a
    second empty compile cache, the bundle from (a), LDT_AOT_REQUIRE,
    no nvcc on PATH and CUDA_HOME empty: no build, one load, and the
    kernel it loaded equals the plain version on the adversarial grids.
    (c) the bundle read with one bit flipped through the aot_load seam's
    corrupt rule: under LDT_AOT_REQUIRE (and no nvcc) the process fails
    with AotError, reason corrupt; without it the entry is refused,
    rebuilt with nvcc and rewritten, and (d) a fourth process (REQUIRE,
    no nvcc, another empty cache) loads the healed entry with no build.
    Every process's answers equal the main path's. Returns the
    processes' kernel launches on their detect runs (not the grid
    comparisons)."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="ldt-smoke-cold-")
    t_phase = time.monotonic()
    sample = docs[:COLD_DOCS]
    want = [answer[d] for d in sample]
    docs_path = os.path.join(tmp, "docs.json")
    with open(docs_path, "w", encoding="utf-8") as f:
        json.dump(sample, f)
    entry = os.path.join(tmp, "bundle", "cuda-fused_tote.ldtx")
    corrupt = f"aot_load:corrupt:seed={seed}"
    try:
        runs = {"cold": cold_process(tmp, docs_path, "cache-a")}
        entry_a = os.stat(entry) if os.path.exists(entry) else None
        runs["boot_hot"] = cold_process(tmp, docs_path, "cache-b",
                                        require=True, no_nvcc=True,
                                        grid_seed=seed)
        hot_built = os.path.exists(os.path.join(tmp, "cache-b",
                                                "libldt_fused_tote.so"))
        runs["corrupt_require"] = cold_process(
            tmp, docs_path, "cache-c1", require=True, no_nvcc=True,
            faults=corrupt)
        runs["corrupt_heal"] = cold_process(tmp, docs_path, "cache-c2",
                                            faults=corrupt)
        entry_c = os.stat(entry) if os.path.exists(entry) else None
        runs["healed"] = cold_process(tmp, docs_path, "cache-d",
                                      require=True, no_nvcc=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    keys = ("rc", "ready_s", "interpreter_s", "torch_import_s",
            "cuda_context_s", "port_import_s", "tables_s", "library_s",
            "nvcc_s", "first_detect_s", "builds", "launches",
            "aot_loads_total", "nvcc_found", "aot", "grid")
    modes = {name: {k: r[k] for k in keys if k in r}
             for name, r in runs.items()}
    for name, r in runs.items():
        if "codes" in r:
            modes[name]["answers_equal"] = r["codes"] == want
    req = runs["corrupt_require"]
    modes["corrupt_require"]["error"] = \
        (req.get("stderr") or "").strip().splitlines()[-1:]
    cold, hot = runs["cold"], runs["boot_hot"]
    rewritten = None not in (entry_a, entry_c) and \
        entry_c.st_ino != entry_a.st_ino
    phase("coldstart", card=smi, docs=COLD_DOCS, modes=modes,
          nvcc_share_cold=(cold["nvcc_s"] / cold["ready_s"]
                           if cold["rc"] == 0 else None),
          boot_hot_saves_s=(cold["ready_s"] - hot["ready_s"]
                            if cold["rc"] == hot["rc"] == 0 else None),
          entry_rewritten=rewritten, phase_s=time.monotonic() - t_phase)
    for name in ("cold", "boot_hot", "corrupt_heal", "healed"):
        r = runs[name]
        if r["rc"] != 0:
            raise AssertionError(f"coldstart {name}: exit {r['rc']}: "
                                 f"{r['stderr']}")
        if r["codes"] != want:
            raise AssertionError(f"coldstart {name}: answers differ from "
                                 "the main path's")
    heal, healed = runs["corrupt_heal"], runs["healed"]
    if not (cold["builds"] == 1 and cold["aot"]["exports"] == 1 and
            entry_a is not None):
        raise AssertionError(f"coldstart cold: {cold['builds']} builds, "
                             f"bundle {cold['aot']}")
    for name, r in (("boot_hot", hot), ("healed", healed)):
        if not (r["builds"] == 0 and r["aot_loads_total"] == 1 and
                r["aot"]["loads"] == 1 and not r["nvcc_found"]):
            raise AssertionError(f"coldstart {name}: {r['builds']} builds, "
                                 f"{r['aot_loads_total']} loads, nvcc "
                                 f"found {r['nvcc_found']}")
    if hot_built:
        raise AssertionError("coldstart boot_hot: a library appeared in "
                             "its compile cache")
    g = hot["grid"]
    if not g["cases"] or g["unequal"] or g["max_abs_err"]:
        raise AssertionError(f"coldstart boot_hot: the loaded kernel "
                             f"differs from the plain version: {g}")
    if req["rc"] == 0 or "AotError" not in req["stderr"] or \
            "(corrupt)" not in req["stderr"]:
        raise AssertionError(f"coldstart corrupt_require: exit "
                             f"{req['rc']}, want AotError (corrupt): "
                             f"{req.get('stderr')}")
    if not (heal["builds"] == 1 and heal["aot"]["refusals"] == 1 and
            heal["aot"]["exports"] == 1 and rewritten):
        raise AssertionError(f"coldstart corrupt_heal: {heal['builds']} "
                             f"builds, bundle {heal['aot']}, entry "
                             f"rewritten {rewritten}")
    return int(sum(r["launches"] for r in (cold, hot, heal, healed)))


def replay_plan(records: list, pool: list) -> list:
    """(offset s, body, headers, documents) per loadgen record: the
    record's document count, each document cut from a pool document to
    its share of the record's bytes; a tenant cycles through 16
    documents (the duplicate-heavy stream of real tenants)."""
    arr0 = records[0]["arrival_ns"]
    plan = []
    for i, r in enumerate(records):
        n = max(int(r["docs"]), 1)
        target = max(int(r["approx_bytes"]) // n, 8)
        texts = []
        for j in range(n):
            rng = random.Random((r["tenant_hash"] & 0xFFFFFFFF) * 31 +
                                (i * 131 + j) % 16)
            texts.append(pool[rng.randrange(len(pool))].encode()[:target]
                         .decode(errors="ignore"))
        headers = {"Content-Type": "application/json",
                   "X-LDT-Tenant": r["tenant"]}
        if r["priority"]:
            headers["X-LDT-Priority"] = "1"
        plan.append(((r["arrival_ns"] - arr0) / 1e9,
                     json.dumps({"request": [{"text": t} for t in texts]})
                     .encode(), headers, n))
    return plan


def replay_lap(plan: list, port: int, clients: int = TUNE_CLIENTS) -> dict:
    """One lap: every request of the plan POSTed on its schedule by
    `clients` keep-alive clients, as bench.py::replay_records sends.
    SLIs in the shape autotune.score reads: p50/p99 of the successful
    answers, errors and dropped requests against the error budget, sheds
    (429/503) apart, and answered documents per second over the lap."""
    import http.client
    lock = threading.Lock()
    cursor = [0]
    counts = {"ok": 0, "shed": 0, "error": 0, "drop": 0}
    ok_lat: list = []
    ok_docs = [0]
    t_start = time.time() + 0.5

    def drive():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            while True:
                with lock:
                    i = cursor[0]
                    if i >= len(plan):
                        return
                    cursor[0] = i + 1
                offset, body, headers, n = plan[i]
                delay = t_start + offset - time.time()
                if delay > 0:
                    time.sleep(delay)
                t0 = time.time()
                try:
                    conn.request("POST", "/", body, headers)
                    resp = conn.getresponse()
                    resp.read()
                except (OSError, http.client.HTTPException):
                    conn.close()
                    conn = http.client.HTTPConnection("127.0.0.1", port,
                                                      timeout=120)
                    with lock:
                        counts["drop"] += 1
                    continue
                ms = (time.time() - t0) * 1e3
                with lock:
                    if resp.status in (429, 503):
                        counts["shed"] += 1
                    elif resp.status >= 500:
                        counts["error"] += 1
                    else:
                        counts["ok"] += 1
                        ok_lat.append(ms)
                        ok_docs[0] += n
        finally:
            conn.close()

    threads = [threading.Thread(target=drive, daemon=True)
               for _ in range(min(clients, len(plan)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a replay client hung")
    wall = max(time.time() - t_start, 1e-9)
    n = max(len(plan), 1)
    return {"p50_ms": percentile(ok_lat, 50) if ok_lat else 0.0,
            "p99_ms": percentile(ok_lat, 99) if ok_lat else 0.0,
            "err_pct": 100.0 * (counts["error"] + counts["drop"]) / n,
            "shed_pct": 100.0 * counts["shed"] / n,
            "ok_docs_per_sec": ok_docs[0] / wall, "wall_sec": wall,
            "counts": counts}


def push_config(status_port: int, batch: dict) -> None:
    """One fleet-wide override batch through the status port's POST
    /configz, probation 0 (the caller scores the candidate itself)."""
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{status_port}/configz",
        data=json.dumps({"set": batch, "probation_sec": 0}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        if r.status != 200:
            raise AssertionError(f"POST /configz: {r.status}")
        r.read()


def autotune_phase(fl, docs: list, smi: str, seed: int) -> int:
    """Phase `autotune`: the SLO autotuner on a live 2-member fleet of
    the port's asyncio front on the card (LDT_FLEET_SCALE_UP_DEPTH=0,
    LDT_SLO=TUNE_SLO, no result caches). Traffic: loadgen's flash_crowd
    scenario from the seed (TUNE_RECORDS records over TUNE_SPAN_S s),
    replayed on its schedule (replay_lap). One untimed warm lap, then
    autotune.autotune over TUNE_KNOBS, each candidate pushed fleet-wide
    through POST /configz and scored as the best of two laps, then
    TUNE_CONFIRM alternating laps of the default against the winner.
    Passes when the winner holds the SLO in every confirmation lap and
    every member launched the kernel once a dispatch over the phase (its
    /metrics; flushes of at most TINY_BATCH_C_PATH documents answer on
    the all-C path and dispatch nothing, so `flushes` is printed beside
    them). Returns the members' kernel launches."""
    from language_detector_tpu_torch import autotune, loadgen, slo
    t_phase = time.monotonic()
    records = loadgen.generate(
        "flash_crowd", n=TUNE_RECORDS, seed=seed,
        base_rps=TUNE_RECORDS / (TUNE_SPAN_S *
                                 loadgen.mean_intensity("flash_crowd")))
    plan = replay_plan(records, [d for d in docs if len(d) < 2000])
    spec = slo.parse_spec(TUNE_SLO)
    c0 = fl.counts()
    warm = replay_lap(plan, fl.port)
    trajectory: list = []

    def evaluate(ov: dict) -> dict:
        # full reset, then the candidate: a knob it leaves out falls back
        # to its default, not to the last candidate's value
        push_config(fl.sport, {**{k: None for k in TUNE_KNOBS}, **ov})
        laps = [replay_lap(plan, fl.port) for _ in range(2)]
        best = max(laps, key=lambda m: autotune.score(m, spec))
        trajectory.append({"overrides": dict(ov),
                           "score": autotune.score(best, spec),
                           "laps": [{k: lap[k] for k in (
                               "p99_ms", "err_pct", "shed_pct",
                               "ok_docs_per_sec", "wall_sec")}
                               for lap in laps]})
        return best

    tuned = autotune.autotune(evaluate, names=set(TUNE_KNOBS),
                              rounds=TUNE_ROUNDS, spec=spec)
    confirm: dict = {"default": [], "winner": []}
    for _ in range(TUNE_CONFIRM):
        for name, batch in (("default", {}), ("winner", tuned["best"])):
            push_config(fl.sport, {**{k: None for k in TUNE_KNOBS},
                                   **batch})
            confirm[name].append(replay_lap(plan, fl.port))
    c1 = fl.counts()
    members = {s: {k: c1[s][k] - c0[s][k]
                   for k in ("launches", "dispatches", "flushes")}
               for s in c1}
    held = [lap["p99_ms"] <= spec.target_ms and
            lap["err_pct"] <= spec.err_pct for lap in confirm["winner"]]
    phase("autotune", card=smi, records=len(records),
          span_s=records[-1]["arrival_ns"] / 1e9, clients=TUNE_CLIENTS,
          slo=TUNE_SLO, knobs=list(TUNE_KNOBS), rounds=TUNE_ROUNDS,
          warm_lap=warm, trajectory=trajectory, evals=tuned["evals"],
          winner=tuned["best"], winner_metrics=tuned["best_metrics"],
          baseline_metrics=tuned["baseline_metrics"],
          confirm={k: [{m: lap[m] for m in ("p99_ms", "err_pct",
                                            "shed_pct", "ok_docs_per_sec",
                                            "wall_sec")} for lap in v]
                   for k, v in confirm.items()},
          winner_holds_slo=held, members=members,
          phase_s=time.monotonic() - t_phase)
    if len(members) != FLEET_WORKERS or any(
            m["launches"] != m["dispatches"] for m in members.values()):
        raise AssertionError(f"autotune: a member did not launch the "
                             f"kernel once a dispatch: {members}")
    if not all(held):
        raise AssertionError(f"autotune: the winner {tuned['best']} broke "
                             f"{TUNE_SLO} in a confirmation lap: "
                             f"{confirm['winner']}")
    return int(sum(m["launches"] for m in members.values()))


class RecordingProxy:
    """A localhost HTTP pass-through to one port that keeps the body of
    every GET it relays: a CLI pointed at it reads the live endpoint,
    and the smoke formats the very document the CLI read."""

    def __init__(self, port: int):
        import http.server
        bodies = self.bodies = []

        class Relay(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                st, body = get_url(f"http://127.0.0.1:{port}{self.path}")
                bodies.append(body)
                self.send_response(st or 502)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Relay)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self._thread.join(10)


def debug_cli(argv: list) -> tuple:
    """Worker process (spawned): the port's CLI, debug._main(argv), its
    standard output captured. Returns (exit code, output, this
    process's kernel launches)."""
    import io

    from language_detector_tpu_torch import debug
    from language_detector_tpu_torch.ops import kernels
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = debug._main(argv)
    return rc, buf.getvalue(), kernels.launches


def debug_phase(fl, docs: list, answer: dict, smi: str, seed: int) -> int:
    """Phase `debug`: the port's score-trace CLI on the card against the
    live autotune fleet. --engine-stats over DEBUG_DOCS documents of the
    mix on the card (a spawned process) gives the codes of a --device
    cpu run (another spawned process) and of the main path; --slo
    against the status port's /sloz, --fleet-traces against its /tracez
    and --admission against one member's /debug/vars, each `python -m
    language_detector_tpu_torch.debug` through a RecordingProxy, exit 0
    and print the port formatter's output on the document they read.
    Returns the engine-stats run's kernel launches."""
    from language_detector_tpu_torch import debug
    t_phase = time.monotonic()
    sample = random.Random(seed).sample(docs, DEBUG_DOCS)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(2, mp_context=ctx) as pool:
        card_f, cpu_f = (pool.submit(debug_cli, [
            "--engine-stats", "--device", dev, "--", *sample])
            for dev in ("cuda", "cpu"))
        card, cpu = card_f.result(), cpu_f.result()
    codes = [ln.split(" ", 1)[0]
             for ln in card[1].splitlines()[:DEBUG_DOCS]]
    cpu_codes = [ln.split(" ", 1)[0]
                 for ln in cpu[1].splitlines()[:DEBUG_DOCS]]
    stats = dict(ln.split() for ln in card[1].splitlines()[DEBUG_DOCS:])
    member = fl.snap()["members"][0]
    views = {"--slo": (fl.sport, "/sloz", debug.format_slo),
             "--fleet-traces": (fl.sport, "/tracez",
                                debug.format_fleet_traces),
             "--admission": (member["metrics_port"], "/debug/vars",
                             debug.format_admission)}
    out: dict = {}
    for flag, (port, path, fmt) in views.items():
        proxy = RecordingProxy(port)
        try:
            r = subprocess.run(
                [sys.executable, "-m", "language_detector_tpu_torch.debug",
                 flag, f"http://127.0.0.1:{proxy.port}{path}"],
                cwd=str(ROOT), env=proc_env(), capture_output=True,
                text=True, timeout=120)
        finally:
            proxy.close()
        fetched = proxy.bodies[-1] if proxy.bodies else b""
        want = fmt(json.loads(fetched)) + "\n" if fetched else None
        out[flag] = {"rc": r.returncode,
                     "lines": len(r.stdout.splitlines()),
                     "bytes_read": len(fetched),
                     "equal": r.stdout == want,
                     "head": r.stdout.splitlines()[:2]}
        if r.returncode != 0 or r.stdout != want:
            raise AssertionError(f"debug {flag}: exit {r.returncode}, "
                                 f"output equal {r.stdout == want}: "
                                 f"{r.stderr[-1500:]}")
    phase("debug", card=smi, docs=DEBUG_DOCS, engine_stats={
        "rc": card[0], "cpu_rc": cpu[0], "launches": card[2],
        "cpu_equal": codes == cpu_codes,
        "main_path_equal": codes == [answer[d] for d in sample],
        "stats": stats}, views=out, phase_s=time.monotonic() - t_phase)
    if card[0] != 0 or cpu[0] != 0 or codes != cpu_codes or \
            len(codes) != DEBUG_DOCS:
        raise AssertionError(f"debug --engine-stats: exit {card[0]} / "
                             f"{cpu[0]}, {len(codes)} codes, equal to the "
                             f"CPU run: {codes == cpu_codes}")
    if card[2] <= 0 or card[2] != int(stats["device_dispatches"]):
        raise AssertionError(f"debug --engine-stats: {card[2]} launches "
                             f"over {stats['device_dispatches']} dispatches")
    return int(card[2])


def boot_tune_debug(docs: list, answer: dict, smi: str, seed: int) -> int:
    """Phases coldstart, autotune and debug (the last two on one 2-member
    fleet, closed after the CLI read it). Returns their kernel
    launches."""
    import shutil
    import tempfile
    launches = coldstart_phase(docs, answer, smi, seed)
    tmp = tempfile.mkdtemp(prefix="ldt-smoke-tune-")
    fl = Fleet(FLEET_WORKERS, tmp, LDT_FLEET_SCALE_UP_DEPTH=0,
               LDT_SLO=TUNE_SLO, LDT_RESULT_CACHE_MB=0,
               LDT_RESULT_CACHE_SHM_MB=0)
    rc = None
    try:
        fl.wait(lambda s: s["ready"] == FLEET_WORKERS,
                "autotune fleet ready")
        launches += autotune_phase(fl, docs, smi, seed)
        launches += debug_phase(fl, docs, answer, smi, seed)
        rc = fl.close()
    finally:
        if rc is None:
            fl.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if rc != 0:
        raise AssertionError(f"autotune fleet exit code {rc}")
    return launches


# -- the offline entry points: evaluator, expected scores, soak, profile -------

TOOLS_PREFIX = 16384         # windowed TSV lines the eval and score tools read
TOOLS_SOAK_SCALE = 0.25      # the soak's per-path counts, times this
TOOLS_PROFILE = (8192, 5)    # profile_score's batch size and iterations
TOOLS_LIMIT_S = 90           # the phase's time budget on the card


def _rateless(report: str) -> str:
    """An eval report without the rate in its first line."""
    first, rest = report.split("\n", 1)
    return first.rsplit(", ", 1)[0] + "\n" + rest


def tools_outputs(device, tmp: str) -> dict:
    """The evaluator's reports (rate stripped) over eval_corpus.tsv and
    over the first TOOLS_PREFIX windows of the windowed TSV (written
    into tmp, streamed from there), and the expected-score table with
    its line counts on those windows, each through its tool's engine on
    device; with the seconds each took."""
    from language_detector_tpu_torch.models.ngram import NgramBatchEngine
    from language_detector_tpu_torch.registry import registry
    from language_detector_tpu_torch.tables import (DATA_DIR,
                                                    ScoringTables,
                                                    load_tables)
    from language_detector_tpu_torch.tools import (eval_corpus, fuzz,
                                                   gen_expected_score)
    tsv = fuzz.write_windowed_tsv(Path(tmp) / "windows.tsv", TOOLS_PREFIX)
    tables = ScoringTables.load()
    out: dict = {"s": {}}
    for name, path in (("eval_corpus", DATA_DIR / "eval_corpus.tsv"),
                       ("eval_windows", tsv)):
        t0 = time.monotonic()
        report = eval_corpus.evaluate(eval_corpus.iter_pairs(str(path)),
                                      tables, device=device)
        out["s"][name] = time.monotonic() - t0
        out[name] = _rateless(report)
        out[name + "_head"] = report.split("\n", 1)[0]
    t0 = time.monotonic()
    eng = NgramBatchEngine(load_tables(), registry, device=device)
    out["expected"] = gen_expected_score.expected_scores(
        eval_corpus.iter_pairs(str(tsv)), eng.detect_many, eng.tables,
        registry)
    out["s"]["expected"] = time.monotonic() - t0
    return out


def tools_reference() -> dict:
    """Worker process: tools_outputs on the CPU (device="cpu")."""
    import tempfile
    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory(prefix="ldt-smoke-tools-") as tmp:
        return tools_outputs("cpu", tmp)


def tools_phase(smi: str, device="cuda") -> int:
    """Phase `tools`: the port's offline entry points on the card. The
    evaluator's reports over eval_corpus.tsv and the windowed TSV's
    first TOOLS_PREFIX lines, and the expected-score table on those
    lines, must equal the same tools' run on the CPU (a spawned worker,
    started first); every soak path at TOOLS_SOAK_SCALE must answer as
    the scalar engine, with launches equal to the engine's dispatches;
    profile_score prints its lines and the kernel's CUDA-event time. The
    phase fails on a difference or over TOOLS_LIMIT_S seconds. Returns
    the kernel launches it made."""
    import tempfile
    from language_detector_tpu_torch.models.ngram import NgramBatchEngine
    from language_detector_tpu_torch.ops import kernels
    from language_detector_tpu_torch.tools import profile_score, soak
    t0 = time.monotonic()
    kernels.launches = 0
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
        ref_fut = pool.submit(tools_reference)
        with tempfile.TemporaryDirectory(prefix="ldt-smoke-tools-") as tmp:
            card = tools_outputs(device, tmp)
        t_soak = time.monotonic()
        eng = NgramBatchEngine(device=device)
        failures = soak.soak(eng, TOOLS_SOAK_SCALE)
        soak_s = time.monotonic() - t_soak
        soak_docs = sum(len(v) for v in soak.soak_docs(
            TOOLS_SOAK_SCALE).values())
        t_prof = time.monotonic()
        prof = profile_score.main(*TOOLS_PROFILE, device=device)
        prof_s = time.monotonic() - t_prof
        t_ref = time.monotonic()
        ref = ref_fut.result()
        ref_wait_s = time.monotonic() - t_ref
    n_launch = kernels.launches
    phase_s = time.monotonic() - t0
    equal = {"eval_corpus": card["eval_corpus"] == ref["eval_corpus"],
             "eval_windows": card["eval_windows"] == ref["eval_windows"],
             "expected": card["expected"][1:] == ref["expected"][1:] and
             np.array_equal(card["expected"][0], ref["expected"][0])}
    totals = [ln for ln in card["eval_windows"].splitlines()
              if ln.startswith("_Totals_Known")]
    phase("tools", card=smi, cpu_equal=equal,
          eval_heads=[card["eval_corpus_head"], card["eval_windows_head"]],
          eval_windows_totals=totals,
          expected_lines=card["expected"][1],
          expected_label_agreeing=card["expected"][2],
          expected_cells=int((card["expected"][0] > 0).sum()),
          soak_scale=TOOLS_SOAK_SCALE, soak_docs=soak_docs,
          soak_failures=failures,
          profile={k: v for k, v in prof.items() if k != "words"},
          launches=n_launch, card_s=card["s"], cpu_s=ref["s"],
          soak_s=soak_s, profile_s=prof_s, cpu_wait_s=ref_wait_s,
          phase_s=phase_s)
    bad = []
    if not all(equal.values()):
        bad.append(f"the card's outputs differ from the CPU's: {equal}")
    if failures:
        bad.append(f"the soak failed ({failures})")
    if prof["kernel_ms"] is None or not prof["kernel_ms"] > 0:
        bad.append(f"no kernel time from profile_score: {prof['kernel_ms']}")
    if n_launch <= 0:
        bad.append("no kernel launch")
    if phase_s > TOOLS_LIMIT_S:
        bad.append(f"took {phase_s:.1f} s")
    if bad:
        raise AssertionError(f"tools: {bad}")
    return n_launch


# -- the lock-order watchdog over the concurrent card paths ---------------------

LOCKDEBUG_DOCS = 1024        # documents of the mix the pooled engine scores
LOCKDEBUG_SCRUB_S = 0.05     # scrub cadence: a scrub between most flushes
LOCKDEBUG_SLICE = 128        # the engine's slice (detect_codes batch_size)
LOCKDEBUG_LANES = ("aio-http", "aio-uds")
LOCKDEBUG_LIMIT_S = 45       # the phase's time budget on the card
LOCKDEBUG_FRONT_S = 15       # of which the fronts' traffic
# watched roles the card paths must take: pool futures, staging-lease
# leases and releases, the kernel library's load and the launch count
LOCKDEBUG_ROLES = ("pool.future", "pool.lane", "staging.ring",
                   "kernels.library", "kernels.launch_count")


def lockdebug_worker(device, docs: list, dup: list, bodies: list,
                     sock_dir: str, lanes: int = POOL_LANES,
                     clients: int = SERVICE_CLIENTS,
                     scrub_s: float = LOCKDEBUG_SCRUB_S) -> dict:
    """The port's concurrent paths in this process, whose locks the
    environment decides (LDT_LOCK_DEBUG is read when a lock is made, so
    the caller sets it before the port is imported): a pooled engine
    (`lanes` lanes, pipeline depth 2, the integrity scrub every
    `scrub_s`) over `docs` and `dup` in slices of LOCKDEBUG_SLICE, then the asyncio front's HTTP and
    unix-socket lanes (Fronts) under `clients` clients over `bodies`.
    Returns the answers, the watchdog's counts (locks, edges,
    inversions: locks.WATCHDOG.stats() and its edge list), the kernel
    launches and what they are held to, and the seconds each part
    took."""
    import functools

    from language_detector_tpu_torch import knobs, locks
    from language_detector_tpu_torch.models.ngram import NgramBatchEngine
    from language_detector_tpu_torch.ops import kernels
    from language_detector_tpu_torch.registry import registry as reg
    from language_detector_tpu_torch.tables import load_tables
    t0 = time.monotonic()
    with env_knobs(LDT_POOL_LANES=str(lanes),
                   LDT_SCRUB_INTERVAL_SEC=str(scrub_s)):
        eng = NgramBatchEngine(load_tables(), reg, device=device,
                               pipeline_depth=2)
    try:
        c0 = pool_counts(eng)
        s0 = eng.integrity.stats["scrubs"]
        kernels.launches = 0
        # slices of LOCKDEBUG_SLICE documents: many dispatches in flight
        # across the lanes at once
        got = {"mix": eng.detect_codes(docs, LOCKDEBUG_SLICE),
               "dup_heavy": eng.detect_codes(dup, LOCKDEBUG_SLICE)}
        if device != "cpu":
            torch.cuda.synchronize()
        pl, hedges, redisp, disp = (b - a for a, b in
                                    zip(c0, pool_counts(eng)))
        ring = eng.staging_stats()
        engine = {"launches": kernels.launches, "pool_launches": pl,
                  "dispatches": disp, "hedges": hedges,
                  "redispatches": redisp,
                  # a clean scrub pass launches one canary batch a lane
                  "canary_launches": (eng.integrity.stats["scrubs"] - s0)
                  * len(eng.pool.lanes),
                  "scrub": dict(eng.integrity.stats),
                  "pending_releases": ring["pending_releases"],
                  "staging_occupancy": ring["occupancy"]}
    finally:
        eng.pool.close()
    engine["s"] = time.monotonic() - t0
    t1 = time.monotonic()
    fronts = Fronts("language_detector_tpu_torch",
                    functools.partial(port_service, device=device),
                    sock_dir)
    try:
        aio = fronts.svc["aio"]._engine
        before = aio.stats_snapshot()["device_dispatches"]
        kernels.launches = 0
        answers = {lane: drive_lane(fronts, lane, bodies, clients)[0]
                   for lane in LOCKDEBUG_LANES}
        if device != "cpu":
            torch.cuda.synchronize()
        front = {"launches": kernels.launches,
                 "dispatches": aio.stats_snapshot()["device_dispatches"]
                 - before,
                 "requests": sum(len(a) for a in answers.values())}
    finally:
        fronts.close()
    front["s"] = time.monotonic() - t1
    edges = locks.WATCHDOG.edges()
    return {"lock_debug": knobs.get_bool("LDT_LOCK_DEBUG"),
            "watchdog": locks.WATCHDOG.stats(),
            "edges": sorted(f"{a}->{b}" for a, bs in edges.items()
                            for b in bs),
            "engine": engine, "front": front, "codes": got,
            "answers": answers}


def lockdebug_run(lock_debug: bool, *args, **kw) -> dict:
    """lockdebug_worker in a freshly spawned process whose environment
    has LDT_LOCK_DEBUG set (1) or cleared (0) before it imports the
    port."""
    ctx = multiprocessing.get_context("spawn")
    with env_knobs(LDT_LOCK_DEBUG="1" if lock_debug else "0"), \
            concurrent.futures.ProcessPoolExecutor(
                1, mp_context=ctx) as pool:
        return pool.submit(lockdebug_worker, *args, **kw).result()


def lockdebug_phase(docs: list, answer: dict, bodies: list, want: dict,
                    smi: str, seed: int, device="cuda") -> int:
    """Phase `lockdebug`: the port's concurrent card paths in a fresh
    process with the lock-order watchdog on (LDT_LOCK_DEBUG=1 before
    import): the engine at pipeline depth 2 over POOL_LANES pool lanes
    with the integrity scrub on, over the mix's first LOCKDEBUG_DOCS
    documents and a 30%-duplicate copy, then the asyncio front's HTTP
    and unix-socket lanes under SERVICE_CLIENTS clients over the service
    bodies. Watched locks are then taken by pool futures and lanes,
    staging-lease leases and releases, the kernel library's load, the
    launch count, flush workers and the fronts' threads at once. Fails
    on any LockOrderInversion (the watchdog counts the ones it raised,
    wherever a thread caught them), an empty edge set, a role of
    LOCKDEBUG_ROLES never taken, launches other than one a
    dispatch (pool: dispatches + hedges + redispatches, plus one canary
    launch a scrubbed lane), answers other than the main path's and the
    CPU fronts', or over LOCKDEBUG_LIMIT_S seconds. Returns the kernel
    launches it made."""
    import shutil
    import tempfile
    t0 = time.monotonic()
    first = docs[:LOCKDEBUG_DOCS]
    dup = scheduler_inputs(first, seed)["dup_heavy"]
    tmp = tempfile.mkdtemp(prefix="ldt-smoke-lock-")
    try:
        out = lockdebug_run(True, device, first, dup, bodies, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_s = time.monotonic() - t0
    eng, front, dog = out["engine"], out["front"], out["watchdog"]
    equal = {"mix": out["codes"]["mix"] == [answer[d] for d in first],
             "dup_heavy": out["codes"]["dup_heavy"] ==
             [answer[d] for d in dup],
             **{lane: out["answers"][lane] == want[lane]
                for lane in LOCKDEBUG_LANES}}
    phase("lockdebug", card=smi, lock_debug=out["lock_debug"],
          debug_locks=dog["locks"], edges=dog["edges"],
          inversions=dog["inversions"], edge_list=out["edges"],
          roles=dog["roles"],
          engine=eng, front=front, answers_equal=equal, phase_s=phase_s)
    bad = []
    if not out["lock_debug"] or dog["locks"] <= 0 or dog["edges"] <= 0:
        bad.append("the watchdog did not watch")
    if dog["inversions"]:
        bad.append(f"{dog['inversions']} lock-order inversions")
    unwatched = sorted(set(LOCKDEBUG_ROLES) - set(dog["roles"]))
    if unwatched:
        bad.append(f"roles never taken under the watchdog: {unwatched}")
    if not all(equal.values()):
        bad.append(f"answers {equal}")
    if not (eng["launches"] > 0 and eng["pool_launches"] ==
            eng["dispatches"] + eng["hedges"] + eng["redispatches"] and
            eng["launches"] == eng["pool_launches"] +
            eng["canary_launches"]) or eng["pending_releases"] or \
            eng["staging_occupancy"] or eng["scrub"]["detected"]:
        bad.append(f"engine launches {eng}")
    if not front["launches"] == front["dispatches"] > 0:
        bad.append(f"front launches {front}")
    if front["s"] > LOCKDEBUG_FRONT_S or phase_s > LOCKDEBUG_LIMIT_S:
        bad.append(f"took {phase_s:.1f} s (fronts {front['s']:.1f} s)")
    if bad:
        raise AssertionError(f"lockdebug: {bad}")
    return eng["launches"] + front["launches"]


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
          packer_s=round(time.monotonic() - t0, 3),
          lib=str(kernels.lib_path() if hasattr(kernels, "lib_path")
                  else kernels.LIB),
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
    traced = run_fresh("main", (groups, docs))
    launches += traced.pop("process_launches")
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
    with concurrent.futures.ProcessPoolExecutor(len(paths) + 3,
                                                mp_context=ctx) as pool:
        cpu_futs = {name: pool.submit(cpu_reference, name, inputs)
                    for name in paths}
        scalar_fut = pool.submit(scalar_reference, samples, inputs)
        sched_fut = pool.submit(scheduler_reference, sched_inputs)
        eval_fut = pool.submit(eval_reference)
        cpu_ref = {name: f.result() for name, f in cpu_futs.items()}
        scalar_ref = scalar_fut.result()
        sched_ref = sched_fut.result()
        eval_ref = eval_fut.result()
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
    n_service, service_want = service_phase(args.seed, docs, kernels, smi,
                                            answer)
    launches += n_service

    # -- device pool, sharded launches, integrity scrub, eval scorecard -----
    launches += pool_phase(docs, answer, kernels, smi, tables, reg, dev)
    n_shard, shard_err = shards_phase(docs, answer, kernels, smi, tables,
                                      reg, dev)
    launches += n_shard
    max_err = max(max_err, shard_err)
    launches += integrity_phase(docs, answer, kernels, smi, tables, reg,
                                dev)
    launches += eval_phase(eval_ref, kernels, smi, tables, reg, dev)

    # -- the process layer: shm ring lane, supervisor, fleet ----------------
    bodies = service_requests(docs, args.seed)
    launches += shm_phase(bodies, service_want, answer, docs, kernels, smi)
    launches += supervisor_phase(bodies, service_want, smi)
    launches += fleet_phase(bodies, service_want, smi)

    # -- boot-hot start, the SLO autotuner, the score-trace CLI -------------
    launches += boot_tune_debug(docs, answer, smi, args.seed)

    # -- the offline entry points: evaluator, expected scores, soak, profile
    launches += tools_phase(smi)

    # -- the lock-order watchdog over the concurrent card paths -------------
    launches += lockdebug_phase(docs, answer, bodies, service_want, smi,
                                args.seed)

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


# -- every process the smoke started ends with it ------------------------------

PR_SET_CHILD_SUBREAPER = 36


def become_subreaper() -> None:
    """Make this process the parent of every orphaned descendant (Linux
    PR_SET_CHILD_SUBREAPER): a worker whose supervisor was killed is then
    still found by stop_descendants."""
    import ctypes
    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL(None, use_errno=True).prctl(
            PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0)


def descendants(root: int) -> dict:
    """{pid: (state, command line)} of every live process below root,
    from /proc."""
    parent, info = {}, {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        fields = stat[stat.rfind(")") + 2:].split()
        parent[int(d)] = int(fields[1])
        info[int(d)] = (fields[0], cmd.strip()[:200])
    out, todo = {}, [root]
    while todo:
        p = todo.pop()
        for c, pp in parent.items():
            if pp == p and c not in out:
                out[c] = info[c]
                todo.append(c)
    return out


def stop_descendants(limit_s: float = 10.0) -> dict:
    """Stop every process this run started that is still there when it
    ends: multiprocessing's resource tracker by closing its pipe, every
    other descendant with SIGTERM and, after limit_s, SIGKILL; reap them.
    Returns {pid: (state, command line)} of those that were still
    running (not zombies) before that."""
    import signal
    from multiprocessing import resource_tracker
    with contextlib.suppress(Exception):
        resource_tracker._resource_tracker._stop()
    me = os.getpid()
    left = {p: v for p, v in descendants(me).items() if v[0] != "Z"}
    for sig, wait_s in ((signal.SIGTERM, limit_s), (signal.SIGKILL, 5.0)):
        live = [p for p, v in descendants(me).items() if v[0] != "Z"]
        if not live:
            break
        for p in live:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.kill(p, sig)
        t_end = time.monotonic() + wait_s
        while time.monotonic() < t_end and any(
                v[0] != "Z" for v in descendants(me).values()):
            with contextlib.suppress(ChildProcessError):
                os.waitpid(-1, os.WNOHANG)
            time.sleep(0.05)
    with contextlib.suppress(ChildProcessError):
        while os.waitpid(-1, os.WNOHANG)[0]:
            pass
    return left


if __name__ == "__main__":
    become_subreaper()
    try:
        rc = main()
    finally:
        left = stop_descendants()
        if left:
            print(f"chip_smoke: stopped {len(left)} process(es) still "
                  f"running at the end: {left}", file=sys.stderr,
                  flush=True)
    sys.exit(rc)
