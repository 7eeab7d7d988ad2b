"""The hand-written CUDA scorer and the wrapper that launches it.

`score_chunks(dt, wire, full_out)` is the engine's device step. For CUDA
tensors it launches csrc/fused_tote.cu (the port of the reference
package's Pallas kernel ops/kernels.py::_fused_tote_kernel plus its XLA
gather prologue, chunk starts included: the kernel scans them itself, so
a dispatch is one launch). For CPU tensors, and only then, it runs the
plain PyTorch version in ops/score.py. Nothing falls back: a failed build
or a refused launch raises.

The kernel is built with nvcc for sm_90a into LDT_COMPILE_CACHE_DIR
(default: the checkout's build/torch_kernels/) at first use (a plain C
entry point, loaded with ctypes) and launched on PyTorch's current
stream. An engine with a kernel-library bundle armed (LDT_AOT_DIR,
aot.py) loads the library from its bundle entry instead, with no
compiler, and writes back a library it had to build. `launches` counts
kernel launches, so a run can show that its main path went through the
kernel; `builds` counts nvcc runs, so a run can show that it used no
compiler.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from .. import aot, faults, knobs, telemetry
from ..locks import make_lock
from ..native import build_lock
from .device_tables import PLANES, DeviceTables
from .score import score_chunks_plain, wire_to_device

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_tote.cu"
LIB_NAME = "libldt_fused_tote.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

# kernel launches since import (or since the caller last reset it);
# bumped only through count_launch, under _count_lock, since flush
# workers launch from several threads at once
launches = 0
# nvcc runs in this process (a boot-hot process makes none)
builds = 0
_count_lock = make_lock("kernels.launch_count")

# rows a shard row may hold: the kernel scans chunk starts in int32, and
# 2^23 rows of at most 255 slots sum below 2^31
MAX_SHARD_ROWS = 1 << 23

# the wire planes' carriers (ops/score.py wire_to_device): unsigned bits
# in the signed type of their width
_WIRE_TYPES = {"idx": torch.int16, "cnsl": torch.uint8,
               "cmeta": torch.int32, "cscript": torch.uint8,
               "cwhack": torch.int16, "hint_lp": torch.int32,
               "whack_tbl": torch.uint8, "cprior": torch.int16,
               "prior_tbl": torch.uint8}

_lib = None
_lock = make_lock("kernels.library")


def _nvcc() -> str:
    home = knobs.get_str("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def build_dir() -> Path:
    """The compile cache: LDT_COMPILE_CACHE_DIR or build/torch_kernels/."""
    return aot.compile_cache_dir()


def lib_path() -> Path:
    return build_dir() / LIB_NAME


def _nvcc_build(src: Path, flags, out: Path, verbose: bool) -> Path:
    """One nvcc run: src into out (a temporary name, then os.replace,
    so no process loads a half-written library); raises with the
    compiler's output on failure."""
    global builds
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(src)]
    with _count_lock:
        builds += 1
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stdout}"
                           f"{r.stderr}")
    os.replace(tmp, out)
    if verbose:
        print(r.stdout + r.stderr, end="")
    return out


def build(verbose: bool = False) -> Path:
    """Compile fused_tote.cu into lib_path() (always from the source).
    Returns the library path."""
    return _nvcc_build(SOURCE, NVCC_FLAGS, lib_path(), verbose)


def build_source(source: str, flags, out) -> Path:
    """Build kernel source text with `flags` into the library file
    `out` (the bundle's portable payload; aot.AotStore's builder)."""
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    src = out.with_suffix(f".{os.getpid()}.cu")
    src.write_text(source)
    try:
        return _nvcc_build(src, flags, out, False)
    finally:
        src.unlink(missing_ok=True)


def load_library(path) -> ctypes.CDLL:
    """The library at `path`, its entry points typed (aot.AotStore's
    loader)."""
    lib = ctypes.CDLL(str(path))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.ldt_fused_tote
    fn.argtypes = [P, L, P, L, P, P, P, P, I, P, P, I, P, I, P, I,
                   P, I, P, P, P, I, L, I, I, P, I, P]
    fn.restype = ctypes.c_int
    occ = lib.ldt_fused_tote_occupancy
    occ.argtypes = [I, ctypes.POINTER(I), ctypes.POINTER(I)]
    occ.restype = ctypes.c_int
    return lib


def _load_built(store) -> ctypes.CDLL:
    """The compile cache's library, built first when it is missing or
    older than the source; offered back to the bundle when one is
    armed."""
    d = build_dir()
    d.mkdir(parents=True, exist_ok=True)
    path = d / LIB_NAME
    # one build per compile cache: processes starting at once (test
    # workers, spawned references, fleet members) wait for the first
    with build_lock(d / "fused_tote.lock"):
        if not path.exists() or \
                path.stat().st_mtime < SOURCE.stat().st_mtime:
            build()
    lib = load_library(path)
    if store is not None:
        store.offer(aot.LIBRARY, path,
                    aot.portable_payload(SOURCE.read_text(), NVCC_FLAGS))
    return lib


def _load(store=None):
    """The kernel library of this process: the one already loaded, else
    the bundle entry of `store` (an aot.AotStore, verified and loaded
    without a compiler), else the compile cache's (built with nvcc when
    missing). Raises when none loads; never gives way to the plain
    scorer.

    The first load in a process is the port's counterpart of the
    reference's first-execution XLA compile: it passes the `compile`
    fault seam first and counts one ldt_xla_compiles_total, on the
    reference's lane label "main" (one library serves every lane). Its
    time is recorded nowhere the breaker reads: the engine loads the
    library when it is built, so no flush pays it, and the reference's
    ldt_xla_compile_ms, which the stall watchdog folds in, is not
    declared in the port."""
    global _lib
    with _lock:
        if _lib is None:
            if faults.ACTIVE is not None:
                faults.hit("compile")
            lib = store.lookup(aot.LIBRARY) if store is not None else None
            _lib = lib if lib is not None else _load_built(store)
            telemetry.REGISTRY.counter_inc("ldt_xla_compiles_total",
                                           lane="main")
        return _lib


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def occupancy(device) -> tuple[int, int]:
    """(kernel blocks one SM holds at once, the card's SM count): the
    persistent grid is at most their product, blocks of 8 chunk rows."""
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    rc = _load().ldt_fused_tote_occupancy(
        torch.device(device).index or 0, ctypes.byref(per_sm),
        ctypes.byref(sms))
    if rc != 0:
        raise RuntimeError(f"fused_tote occupancy query: CUDA error {rc}")
    return per_sm.value, sms.value


def score_chunks_cuda(dt: DeviceTables, p: dict,
                      full_out: bool = False) -> torch.Tensor:
    """Launch the fused-tote kernel over a wire on dt's CUDA device:
    [G] int32 word1, or [G, 2] int32 when full_out (u32 bits)."""
    return launch(prepare(dt, p, full_out))


def prepare(dt: DeviceTables, p: dict, full_out: bool = False) -> tuple:
    """Check a wire against dt's device and lay out one launch:
    contiguous planes (no copy for the engine's wires) and the output
    tensor; the kernel derives the chunk starts from cnsl's [D, Gs]
    shape. Returns (entry-point arguments, output, the tensors the
    arguments point into); `launch` runs it, as often as asked."""
    dev = dt.device
    for name, dtype in _WIRE_TYPES.items():
        t = p.get(name)
        if t is None:
            continue
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"wire plane {name} is {t.dtype} on "
                             f"{t.device}; the kernel takes {dtype} on "
                             f"{dev}")
    idx = p["idx"].reshape(-1).contiguous()
    Gs = p["cnsl"].shape[-1]            # the starts restart every shard row
    cnsl = p["cnsl"].reshape(-1).contiguous()
    cmeta = p["cmeta"].reshape(-1).contiguous()
    cscript = p["cscript"].reshape(-1).contiguous()
    G = cnsl.shape[0]
    if Gs > MAX_SHARD_ROWS:
        raise ValueError(f"a shard row holds {Gs} chunk rows; the kernel "
                         f"takes at most {MAX_SHARD_ROWS}")
    if not (cmeta.shape[0] == cscript.shape[0] == G):
        raise ValueError(f"chunk planes disagree: cnsl {G}, cmeta "
                         f"{cmeta.shape[0]}, cscript {cscript.shape[0]}")
    if p["cwhack"].shape[-1] == 1:
        cwhack = whack_tbl = None
        n_whack = 0
    else:
        cwhack = p["cwhack"].reshape(-1).contiguous()
        whack_tbl = p["whack_tbl"].contiguous()
        n_whack = whack_tbl.shape[0]
        if cwhack.shape[0] != G or whack_tbl.shape[1:] != (2, 256):
            raise ValueError("cwhack / whack_tbl shapes")
    if "cprior" in p:
        cprior = p["cprior"].reshape(-1).contiguous()
        prior_tbl = p["prior_tbl"].contiguous()
        n_prior = prior_tbl.shape[0]
        if cprior.shape[0] != G or prior_tbl.shape[1:] != (2, 256):
            raise ValueError("cprior / prior_tbl shapes")
    else:
        cprior = prior_tbl = None
        n_prior = 0
    for tbl in (whack_tbl, prior_tbl):
        if tbl is not None and tbl.data_ptr() % 8:
            raise ValueError("whack_tbl / prior_tbl must be 8-byte aligned "
                             "(the kernel reads 8 languages per load)")
    hint_lp = p["hint_lp"].reshape(-1).contiguous()
    if dt.expected_score.shape[0] != dt.close_set.numel():
        raise ValueError("expected_score and close_set disagree on the "
                         "language count")
    out = torch.empty((G, 2) if full_out else (G,), dtype=torch.int32,
                      device=dev)
    args = (_ptr(idx), idx.numel(), _ptr(cnsl), Gs, _ptr(cmeta),
            _ptr(cscript), _ptr(cwhack), _ptr(whack_tbl), n_whack,
            _ptr(cprior), _ptr(prior_tbl), n_prior,
            _ptr(hint_lp), hint_lp.numel(), _ptr(dt.cat_ind2),
            dt.cat_ind2.numel(), _ptr(dt.lg_prob3), dt.lg_prob3.shape[0],
            _ptr(dt.plang_to_lang), _ptr(dt.expected_score),
            _ptr(dt.close_set), dt.close_set.numel(),
            G, int(p["K"]), 1 if full_out else 0, _ptr(out),
            out.device.index or 0)
    held = (dt, idx, cnsl, cmeta, cscript, cwhack, whack_tbl, cprior,
            prior_tbl, hint_lp)
    return args, out, held


def count_launch() -> None:
    """Add one to `launches` (atomic across threads)."""
    global launches
    with _count_lock:
        launches += 1


def launch(call: tuple) -> torch.Tensor:
    """Launch one prepared call (`prepare`) on the output device's
    current stream; returns its output tensor."""
    args, out, _held = call
    if out.shape[0] == 0:
        return out
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = _load().ldt_fused_tote(*args, stream)
    if rc != 0:
        raise RuntimeError(f"fused_tote launch failed: CUDA error {rc}")
    count_launch()
    return out


def score_chunks(dt: DeviceTables, p: dict,
                 full_out: bool = False) -> torch.Tensor:
    """The device step: CUDA kernel for tables on a CUDA device, the
    plain version for tables on the CPU; any other device raises."""
    kind = dt.device.type
    if kind == "cuda":
        return score_chunks_cuda(dt, p, full_out)
    if kind == "cpu":
        for name, v in p.items():
            if isinstance(v, torch.Tensor) and v.device.type != "cpu":
                raise ValueError(f"wire plane {name} is on {v.device}, "
                                 "tables on the CPU")
        return score_chunks_plain(dt, p, full_out)
    raise ValueError(f"no scorer for device {dt.device}")



class DeviceResult:
    """A launched scorer's output. np.asarray(result) reads the packed
    words back on the stream that launched them (so it waits for that
    job's copies and kernel, not for other jobs' work on other streams)
    and returns them as a host np.uint32 array. `copies` holds the CUDA
    events recorded after the launch's wire copies (empty on the CPU):
    the host wire may be written again only once they have completed."""

    __slots__ = ("out", "stream", "copies")

    def __init__(self, out: torch.Tensor, stream=None, copies=()):
        self.out = out
        self.stream = stream
        self.copies = tuple(copies)

    def __array__(self, dtype=None, copy=None):
        if self.stream is None:
            host = self.out.cpu()
        else:
            with torch.cuda.stream(self.stream):
                host = self.out.cpu()    # copy + wait on the job's stream
        a = host.numpy().view(np.uint32)
        return a if dtype is None else a.astype(dtype)


def score_wire(dt: DeviceTables, wire: dict,
               full_out: bool = False) -> DeviceResult:
    """The single-device scorer: copy a host wire (pack_chunks_native's
    numpy arrays) to dt's device on its current stream and launch the
    device step there (score_chunks); returns before the kernel
    finishes."""
    dev = dt.device
    w = wire_to_device(wire, dev)
    if dev.type != "cuda":
        return DeviceResult(score_chunks(dt, w, full_out))
    return DeviceResult(score_chunks(dt, w, full_out),
                        torch.cuda.current_stream(dev), (w["copied"],))

# -- integrity scrub fold ------------------------------------------------------

_WORD_BITS = {1: (torch.uint8, 0xFF), 2: (torch.int16, 0xFFFF),
              4: (torch.int32, 0xFFFFFFFF)}


def _fold(a: torch.Tensor) -> torch.Tensor:
    """Device twin of device_tables.fold_host: one table plane -> its
    u32 digest (an int64 scalar tensor on the plane's device), the
    position-weighted wrap-sum over the plane's u32 words. Each plane
    widens to its unsigned words in int64, each product is masked to
    32 bits before the sum (products reach 2^48, so unmasked sums of
    the large planes could overflow int64), and the sum wraps mod
    2^32, so it equals the numpy fold bit for bit."""
    v = a.reshape(-1).contiguous()
    if v.dtype == torch.bool:
        v = v.to(torch.uint8)
    carrier, mask = _WORD_BITS[v.element_size()]
    w = v.view(carrier).to(torch.int64) & mask
    weights = torch.arange(w.numel(), dtype=torch.int64,
                           device=w.device) % 65521 + 1
    return ((w * weights) & 0xFFFFFFFF).sum() & 0xFFFFFFFF


def table_digest(dt: DeviceTables) -> torch.Tensor:
    """Every dt plane folded on the tables' device, no host copy of the
    planes: [n_planes] int64 (u32 values), index-aligned with
    device_tables.fingerprint() (PLANES order). The twin of the
    reference package's XLA program ops/kernels.py::table_digest_impl;
    the integrity scrub compares it with a lane's upload fingerprint."""
    return torch.stack([_fold(getattr(dt, n)) for n in PLANES])
