"""Test-only member module: the port's asyncio front on the CPU.

The port's fronts serve on the CUDA card and raise without one, so the
supervisor and fleet tests pass this module as the supervisor's module
argument instead of language_detector_tpu_torch.service.aioserver:

    python -m language_detector_tpu_torch.service.supervisor \\
        tests.torch_cpu_front

It runs the port's own `aioserver.serve()` (listen ports, SO_REUSEPORT,
the unix-socket and shm lanes, the ready-file handshake, the SIGTERM
drain and the recycle exit) over DetectorService(device="cpu"), whose
batched engine scores with the plain PyTorch version.
"""
from __future__ import annotations

import asyncio
import sys

from language_detector_tpu_torch import knobs
from language_detector_tpu_torch.service import aioserver, server
from language_detector_tpu_torch.service.recycle import RECYCLE_EXIT_CODE


def main() -> None:
    svc = server.DetectorService(device="cpu", start_batcher=False)
    try:
        result = asyncio.run(aioserver.serve(
            knobs.get_int("LISTEN_PORT") or 0,
            knobs.get_int("PROMETHEUS_PORT") or 0, svc=svc))
    except KeyboardInterrupt:
        return
    if result == "recycle":
        sys.exit(RECYCLE_EXIT_CODE)


if __name__ == "__main__":
    main()
