"""python -m language_detector_tpu_torch.bench [mode] [args]
    [--device {cuda,cpu}] [--out PATH]

The reference's bench.py modes, each printing one JSON line:

    (none)                  the headline: batch_detect_throughput
    --kernel [N]            the fused-tote kernel per tier wire
    --longdoc [N]           the long-doc lane on against off
    --multichip [N]         pooled throughput over an N-device mesh
    --fleet [N]             an N-member fleet against 1 member
    --shm                   the shm ring lane against the UDS lane
    --coldstart [N]         cold, compile-cache and bundle starts, and
                            an N-member duplicate-heavy fleet pass
    --replay DIR [--speedup X] [--workers N]
    --replay-synth [STREAM] [--speedup X] [--workers N] [--clients N]
                   [--autotune] [--slo SPEC]
    --eval [--quick]        the accuracy scorecard; exits non-zero below
                            the agreement floor
    --profile DIR           the headline under torch.profiler, its Chrome
                            trace written into DIR
    --smoke                 the CI gates (lint, telemetry, capture, scrub
                            budgets) over a small headline

--device cuda (the default) raises without CUDA; cpu runs the engine's
modes on the plain PyTorch scorer. --out PATH also writes the line,
indented, to PATH; nothing else is written.
"""
from __future__ import annotations

import json
import sys


def _flag(argv: list, name: str, default=None, cast=str):
    """The value after `name` in argv (removed with it), else default."""
    if name not in argv:
        return default
    i = argv.index(name)
    if i + 1 >= len(argv):
        raise SystemExit(f"bench: {name} needs a value")
    value = argv[i + 1]
    del argv[i:i + 2]
    return cast(value)


def _arg(argv: list, default: int) -> int:
    """The mode's optional positional count (argv[1])."""
    return int(argv[1]) if len(argv) > 1 and \
        not argv[1].startswith("--") else default


def run(argv: list) -> dict:
    device = _flag(argv, "--device", "cuda")
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"bench: --device {device!r}: cuda or cpu")
    mode = argv[0] if argv else None
    if mode == "--longdoc":
        from .engine import bench_longdoc
        return bench_longdoc(_arg(argv, 256), device=device)
    if mode == "--multichip":
        from .engine import run_multichip
        return run_multichip(_arg(argv, 8), device=device)
    if mode == "--multichip-child":
        from .engine import bench_multichip_child
        return bench_multichip_child(int(argv[1]), device=device)
    if mode == "--scrub-child":
        from .overhead import scrub_child
        return scrub_child(device)
    if mode == "--fleet":
        from .fronts import bench_fleet
        return bench_fleet(_arg(argv, 3), device=device)
    if mode == "--shm":
        from .fronts import bench_shm
        return bench_shm(device=device)
    if mode == "--kernel":
        from .kernel import bench_kernel
        return bench_kernel(_arg(argv, 4096), device=device)
    if mode == "--coldstart":
        from .coldstart import bench_coldstart
        return bench_coldstart(fleet_workers=_arg(argv, 2), device=device)
    if mode in ("--replay", "--replay-synth"):
        from .replay import bench_replay
        speedup = _flag(argv, "--speedup", 1.0, float)
        workers = _flag(argv, "--workers", 2, int)
        if mode == "--replay":
            if len(argv) < 2:
                raise SystemExit("usage: bench --replay CAPTURE_DIR "
                                 "[--speedup N] [--workers N]")
            return bench_replay(argv[1], speedup=speedup,
                                workers=workers, device=device)
        clients = _flag(argv, "--clients", 8, int)
        # search the admission knobs against this stream, scoring on
        # the declared SLO (overridable with --slo)
        slo = "p99_ms=500,err_pct=1,window_sec=30" \
            if "--autotune" in argv else None
        slo = _flag(argv, "--slo", slo)
        stream = argv[1] if len(argv) > 1 and \
            not argv[1].startswith("--") else "zipf"
        return bench_replay(synth=stream, speedup=speedup,
                            workers=workers, clients=clients,
                            autotune_slo=slo, device=device)
    if mode == "--eval":
        # the accuracy scorecard (evalsuite.py): the labeled corpus
        # through the engine, against the scalar oracle doc for doc;
        # --quick runs the strided subset. No ACC_rNN.json is written,
        # so the card has no round.
        from . import card
        from ..evalsuite import run_eval
        from ..models.ngram import NgramBatchEngine
        out = run_eval(engine=NgramBatchEngine(device=device),
                       quick="--quick" in argv)
        out["card"] = card(device)
        return out
    if mode == "--profile":
        if len(argv) < 2:
            raise SystemExit("usage: bench [--profile TRACE_DIR | --smoke]")
        return _profiled(argv[1], device)
    if mode == "--smoke":
        from .overhead import smoke
        return smoke(device)
    if mode is not None:
        raise SystemExit(f"bench: unknown mode {mode!r}")
    from .engine import bench
    return bench(device=device)


def _profiled(trace_dir: str, device: str) -> dict:
    """The headline (no service bench) under torch.profiler with CPU
    and, on the card, CUDA activities; the Chrome trace goes to
    TRACE_DIR/trace.json."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from .engine import bench
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = bench(http_bench=False, device=device)
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return out


def main(argv: list | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    out_path = _flag(argv, "--out")
    out = run(argv)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps(out))
    if argv and argv[0] == "--eval":
        from ..evalsuite import check_floor
        check_floor(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
