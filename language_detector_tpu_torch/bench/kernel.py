"""--kernel: the device step over real packed wires, one tier per corpus
composition (bench.py `bench_kernel`).

The port has one scorer, the fused-tote kernel (csrc/fused_tote.cu),
so there is no xla/fused/lax A/B: each tier's wire is copied to the
device once and the kernel's wrapper (ops.kernels.score_chunks) is
timed alone with CUDA events on the device's clock, warmed first and
averaged over `reps`.
The plain version is timed once on a tiny wire only, as the reference
times Pallas interpret mode: a parity tool, not a serving mode.
Engine docs/sec and a scalar-engine sample anchor the kernel's time to
end-to-end throughput. On the CPU the scorer is the plain version and
the clock the host's.
"""
from __future__ import annotations

import time

from . import card, check_device
from .corpus import make_corpus, make_longheavy_corpus, make_mixed_corpus


# cycles of the sleep kernel that holds the stream while the timed
# launches are enqueued (about 10 ms, longer than enqueueing them)
HOLD_CYCLES = 20_000_000


def _mean_ms(fn, reps: int, device) -> float:
    """Mean time of one fn() over reps calls after a warm call. On the
    card, CUDA events bracket the calls while a sleep kernel holds the
    stream, so they time the device's work, not the host's launch
    overhead; on the CPU, the host clock."""
    import torch
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def bench_kernel(n: int = 4096, reps: int = 10,
                 device: str = "cuda") -> dict:
    import torch

    from ..engine_scalar import detect_scalar
    from ..models.ngram import NgramBatchEngine
    from ..ops import kernels
    from ..ops.score import score_chunks_plain, wire_to_device

    check_device(device)
    eng = NgramBatchEngine(device=device)
    dev = eng.device
    kernel = eng.pipeline_stats()["kernel"]

    def device_wire(docs: list) -> dict:
        cb = eng._pack(docs, staging=False)
        p = wire_to_device(cb.wire, dev)
        p.pop("copied", None)
        return p

    corpora = [
        ("service", make_corpus(n)),
        ("mixed", make_mixed_corpus(n)),
        ("longheavy", make_longheavy_corpus(max(n // 4, 1024))),
    ]
    tiers = {}
    for tier, docs in corpora:
        p = device_wire(docs)
        ms = _mean_ms(lambda: kernels.score_chunks(eng.dt, p), reps, dev)
        tiers[tier] = dict(grid_g=int(p["cnsl"].numel()), grid_k=p["K"],
                           n_docs=len(docs), dispatch_ms={kernel: ms})

    # the plain version: one tiny dispatch, parity cost only
    small = device_wire(make_corpus(64))
    score_chunks_plain(eng.dt, small)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    score_chunks_plain(eng.dt, small)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    plain_ms = round((time.perf_counter() - t0) * 1e3, 1)

    docs = make_corpus(n)
    eng.detect_batch(docs)                   # warm shapes
    t0 = time.time()
    eng.detect_batch(docs)
    engine_docs_sec = {kernel: round(n / (time.time() - t0), 1)}
    t0 = time.time()
    for t in docs[:256]:
        detect_scalar(t, eng.tables, eng.reg)
    scalar_docs_sec = round(256 / (time.time() - t0), 1)

    ms = tiers["service"]["dispatch_ms"][kernel]
    clock = ("CUDA events" if dev.type == "cuda" else "host clock")
    return dict(
        metric="kernel_dispatch_ms",
        value=ms,
        unit=f"ms ({kernel} scorer, service tier, {clock}, mean of "
             f"{reps})",
        vs_baseline=None,
        card=card(device),
        detail=dict(
            backend=dev.type,
            kernel_selected=kernel,
            kernel_reason=eng.pipeline_stats()["kernel_reason"],
            tiers=tiers,
            plain_ms_small=plain_ms,
            engine_docs_sec=engine_docs_sec,
            scalar_docs_sec=scalar_docs_sec,
            reps=reps,
        ),
    )
