"""Host-clock timing of the device step, three ways.

The port of the reference package's tools/profile_score.py. Packs the
bench corpus (tools/fuzz.make_corpus) into one wire and times the
engine's scorer (ops/kernels.score_chunks: the fused-tote kernel on the
card, the plain PyTorch version on the CPU) on it:

  fixed dispatch latency      a trivial device op plus a host readback
                              of one scalar
  compute + readback          the device-resident wire scored, words
                              read back to the host
  transfer+compute+readback   the host wire copied, scored and read back
                              (ops/kernels.score_wire, the engine's path)

Each is the mean of `iters` calls on the host clock, after one warm
call. On the card it adds the kernel's own time from CUDA events on the
same wire (a prepared launch, no host work), so the three host-clock
lines can be read against it.

Usage:
  python -m language_detector_tpu_torch.tools.profile_score
      [batch_size] [iters] [--device {cuda,cpu}]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _mean_ms(fn, iters: int) -> float:
    t0 = time.time()
    for _ in range(iters):
        fn()
    return (time.time() - t0) / iters * 1e3


def kernel_event_ms(dt, pd: dict, reps: int = 20, inner: int = 10
                    ) -> float:
    """The fused-tote kernel alone on a device-resident wire: CUDA
    events around `inner` prepared launches, the median of `reps`."""
    from ..ops import kernels
    call = kernels.prepare(dt, pd)
    kernels.launch(call)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            kernels.launch(call)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def main(batch_size: int = 8192, iters: int = 5,
         device: str = "cuda") -> dict:
    """Prints the lines; returns their numbers and the words the timed
    scorer produced ([G] uint32, from the compute + readback call)."""
    from .. import native
    from ..models.ngram import NgramBatchEngine
    from ..ops import kernels
    from ..ops.score import wire_to_device
    from .fuzz import make_corpus

    eng = NgramBatchEngine(device=device)
    dev = eng.device
    docs = make_corpus(batch_size)
    t0 = time.time()
    cb = native.pack_chunks_native(docs, eng.tables, eng.reg,
                                   flags=eng.flags)
    t_pack = time.time() - t0
    p = cb.wire
    out = {"B": batch_size, "N": int(p["idx"].shape[1]),
           "G": int(p["cmeta"].shape[1]), "K": int(p["k_iota"].shape[0]),
           "avg_slots": float(cb.n_slots.mean()),
           "MB": sum(a.nbytes for a in p.values()) / 1e6,
           "pack_ms": t_pack * 1e3, "device": str(dev)}
    print(f"wire: B={batch_size} N={out['N']} G={out['G']} K={out['K']} "
          f"avg_slots={out['avg_slots']:.1f} ({out['MB']:.2f} MB); "
          f"pack {out['pack_ms']:.1f} ms", flush=True)

    x = torch.arange(1024, dtype=torch.int32, device=dev)
    int(x.sum())
    out["dispatch_ms"] = _mean_ms(lambda: int(x.sum()), iters)
    print(f"fixed dispatch latency:      {out['dispatch_ms']:8.1f} ms",
          flush=True)

    pd = wire_to_device(p, dev)
    pd.pop("copied", None)
    out["words"] = kernels.score_chunks(eng.dt, pd).cpu().numpy() \
        .view(np.uint32)
    out["compute_ms"] = _mean_ms(
        lambda: kernels.score_chunks(eng.dt, pd).cpu(), iters)
    print(f"compute + readback:          {out['compute_ms']:8.1f} ms",
          flush=True)

    out["roundtrip_ms"] = _mean_ms(
        lambda: np.asarray(kernels.score_wire(eng.dt, p)), iters)
    print(f"transfer+compute+readback:   {out['roundtrip_ms']:8.1f} ms",
          flush=True)

    out["kernel_ms"] = None
    if dev.type == "cuda":
        out["kernel_ms"] = kernel_event_ms(eng.dt, pd)
        print(f"kernel alone (CUDA events):  {out['kernel_ms']:8.4f} ms",
              flush=True)
    return out


def cli(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("batch_size", nargs="?", type=int, default=8192)
    ap.add_argument("iters", nargs="?", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without CUDA) or cpu "
                         "(the plain PyTorch scorer)")
    args = ap.parse_args(argv)
    main(args.batch_size, args.iters, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
