"""Test-only module: the port's threaded front on the CPU.

`python -m tests.torch_cpu_threaded_front` runs the port's own
`service.server.main()` (listen ports, the recycle watcher, the SIGTERM
drain, the unix-socket and shm lanes) with its DetectorService built on
device="cpu", whose batched engine scores with the plain PyTorch
version; the port's front itself serves on the card and raises without
one. tests/torch_cpu_front.py is the asyncio twin.
"""
from __future__ import annotations

from language_detector_tpu_torch.service import server

_make_server = server.make_server


def make_server(port: int = 0, metrics_port: int = 0, service=None):
    return _make_server(port, metrics_port,
                        service or server.DetectorService(device="cpu"))


if __name__ == "__main__":
    server.make_server = make_server
    server.main()
