"""HTTP-path throughput benchmark: docs/sec through POST / end to end.

The port of the reference package's tools/bench_service.py. Starts the
port's service in-process (engine + batcher + the reference's JSON
contract, service/server.py), drives it with concurrent keep-alive
HTTP clients, and reports end-to-end docs/sec.

Usage:
  python -m language_detector_tpu_torch.tools.bench_service
      [--aio | --aio-cold] [total_docs] [clients] [docs_per_request]
      [--device {cuda,cpu}]

Prints one JSON line. --aio benches the asyncio front with a same-loop
asyncio load generator, plus a unix-socket pass and wire-stage stats;
the default benches the threaded front with threaded clients.
--aio-cold runs exactly ONE pass and reports it as the value: run it in
a FRESH process with LDT_COMPILE_CACHE_DIR pointing at an empty
directory, so the pass pays the kernel library's nvcc build (the
port's compile cache; the bench's headline does this). --device cuda
(the default) raises without CUDA; cpu scores with the plain PyTorch
version.
"""
from __future__ import annotations

import http.client
import json
import os
import shutil
import struct
import sys
import tempfile
import threading
import time

from .fuzz import make_corpus


def run(total_docs: int = 98304, clients: int = 8,
        docs_per_request: int = 512, device: str = "cuda") -> dict:
    from ..service.server import DetectorService, make_server

    svc = DetectorService(use_device=True, max_delay_ms=4.0,
                          device=device)
    httpd, metricsd, svc = make_server(0, 0, service=svc)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    port = httpd.server_address[1]

    docs = make_corpus(total_docs)
    n_requests = total_docs // docs_per_request
    payloads = []
    for r in range(n_requests):
        chunk = docs[r * docs_per_request:(r + 1) * docs_per_request]
        payloads.append(json.dumps(
            {"request": [{"text": d} for d in chunk]}).encode())

    # warm-up: the kernel library and first flush on a small request
    warm = json.dumps({"request": [{"text": d}
                                   for d in docs[:256]]}).encode()
    conn = http.client.HTTPConnection("127.0.0.1", port)
    conn.request("POST", "/", warm,
                 {"Content-Type": "application/json"})
    conn.getresponse().read()
    conn.close()

    results = {"docs": 0, "errors": 0}
    lock = threading.Lock()
    work = list(enumerate(payloads))
    widx = [0]

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port)
        got, errs = 0, 0
        while True:
            with lock:
                if widx[0] >= len(work):
                    break
                _, payload = work[widx[0]]
                widx[0] += 1
            conn.request("POST", "/", payload,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            if resp.status in (200, 203):
                # byte count instead of a JSON parse: the client shares
                # the host with the server
                got += body.count(b'"iso6391code"')
            else:
                errs += 1
        conn.close()
        with lock:
            results["docs"] += got
            results["errors"] += errs

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.time()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    took = time.time() - t0

    httpd.shutdown()
    httpd.server_close()
    metricsd.server_close()
    svc.batcher.close()
    docs_sec = results["docs"] / took
    return dict(
        metric="service_http_throughput",
        value=round(docs_sec, 1),
        unit="docs/sec",
        detail=dict(total_docs=results["docs"], errors=results["errors"],
                    clients=clients, docs_per_request=docs_per_request,
                    took_sec=round(took, 2)),
    )


def _wire_stats() -> dict:
    """Parse/serialize stage stats + fast-path hit rate, read straight
    off the in-process telemetry registry (the server shares it)."""
    from .. import telemetry
    reg = telemetry.REGISTRY
    out: dict = {}
    for field, name in (("parse_ms", "ldt_http_parse_ms"),
                        ("serialize_ms", "ldt_http_serialize_ms")):
        h = reg.histogram_peek(name)
        if h is not None:
            _, hsum, hcount, _ = h.snapshot()
            if hcount:
                out[field + "_mean"] = round(hsum / hcount, 4)
                out[field + "_p95"] = round(h.percentile(95), 4)
    hit = reg.counter_value("ldt_http_parse_fast_total", result="hit")
    miss = reg.counter_value("ldt_http_parse_fast_total", result="miss")
    if hit + miss:
        out["parse_fast_hit_rate"] = round(hit / (hit + miss), 4)
    return out


def run_aio(total_docs: int = 98304, clients: int = 32,
            docs_per_request: int = 512, cold_only: bool = False,
            device: str = "cuda") -> dict:
    """Bench the asyncio front: server + clients share one event loop,
    no thread thrash. The full bench runs a cold pass, a warm timed
    pass and a unix-socket pass; cold_only stops after the first pass
    (see the module docstring). The unix-socket lane's path is set in
    LDT_UNIX_SOCKET for the run and put back after it."""
    import asyncio
    import socket

    from .. import knobs
    from ..service.aioserver import serve
    from ..service.server import DetectorService

    docs = make_corpus(total_docs)
    n_requests = total_docs // docs_per_request
    bodies = []
    payloads = []
    for r in range(n_requests):
        chunk = docs[r * docs_per_request:(r + 1) * docs_per_request]
        body = json.dumps(
            {"request": [{"text": d} for d in chunk]}).encode()
        bodies.append(body)
        payloads.append(
            b"POST / HTTP/1.1\r\nHost: x\r\n"
            b"Content-Type: application/json\r\n"
            b"Content-Length: %d\r\n\r\n" % len(body) + body)

    async def client(port, work, results):
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", port, limit=1 << 22)
        sock = writer.get_extra_info("socket")
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while work:
            payload = work.pop()
            writer.write(payload)
            await writer.drain()
            head = await reader.readuntil(b"\r\n\r\n")
            length = int(head.lower().split(b"content-length:")[1]
                         .split(b"\r\n")[0])
            body = await reader.readexactly(length)
            status = int(head.split(b" ")[1])
            if status in (200, 203):
                results["docs"] += body.count(b'"iso6391code"')
            else:
                results["errors"] += 1
        writer.close()

    async def uds_client(uds_path, work, results):
        reader, writer = await asyncio.open_unix_connection(
            uds_path, limit=1 << 22)
        while work:
            body = work.pop()
            writer.write(struct.pack("!I", len(body)))
            writer.write(body)
            await writer.drain()
            hdr = await reader.readexactly(6)
            length, status = struct.unpack("!IH", hdr)
            payload = await reader.readexactly(length)
            if status in (200, 203):
                results["docs"] += payload.count(b'"iso6391code"')
            else:
                results["errors"] += 1
        writer.close()

    async def main(uds_path):
        svc = DetectorService(use_device=True, max_delay_ms=4.0,
                              start_batcher=False, device=device)
        ready = asyncio.get_running_loop().create_future()
        server_task = asyncio.create_task(
            serve(0, 0, svc=svc, ready=ready))
        port, _ = await ready

        async def one_pass(fn, work_items):
            results = {"docs": 0, "errors": 0}
            work = list(work_items)
            t0 = time.time()
            await asyncio.gather(*[fn(work, results)
                                   for _ in range(clients)])
            return results, time.time() - t0

        def tcp(work, results):
            return client(port, work, results)

        def uds(work, results):
            return uds_client(uds_path, work, results)

        # cold pass first (the first flush shapes land inside it), then
        # the warm timed pass: the full-size flushes only appear under
        # concurrent load, so small sequential warm-ups are not enough
        try:
            cold = await one_pass(tcp, payloads)
            if cold_only:
                return cold, None, None
            return (cold, await one_pass(tcp, payloads),
                    await one_pass(uds, bodies))
        finally:
            server_task.cancel()
            try:
                await server_task
            except asyncio.CancelledError:
                pass

    tmp = tempfile.mkdtemp(prefix="ldt-bench-")
    uds_path = os.path.join(tmp, "ldt.sock")
    # the front reads its socket path from the environment at serve()
    env = os.environ  # ldt-lint: disable=knob-direct-env -- setting the front's socket path for this run, not reading config
    saved = env.get("LDT_UNIX_SOCKET")
    env["LDT_UNIX_SOCKET"] = uds_path
    try:
        cold, warm, uds_run = asyncio.run(main(uds_path))
    finally:
        if saved is None:
            env.pop("LDT_UNIX_SOCKET", None)
        else:
            env["LDT_UNIX_SOCKET"] = saved
        shutil.rmtree(tmp, ignore_errors=True)
    (cold_results, cold_took) = cold
    if cold_only:
        docs_sec = cold_results["docs"] / cold_took
        return dict(
            metric="service_http_throughput_aio_cold",
            value=round(docs_sec, 1),
            unit="docs/sec",
            detail=dict(total_docs=cold_results["docs"],
                        errors=cold_results["errors"],
                        clients=clients,
                        docs_per_request=docs_per_request,
                        took_sec=round(cold_took, 2),
                        compile_cache_dir=knobs.get_str(
                            "LDT_COMPILE_CACHE_DIR"),
                        **_wire_stats()),
        )
    (results, took), (uds_results, uds_took) = warm, uds_run
    docs_sec = results["docs"] / took
    return dict(
        metric="service_http_throughput_aio",
        value=round(docs_sec, 1),
        unit="docs/sec",
        detail=dict(total_docs=results["docs"], errors=results["errors"],
                    clients=clients, docs_per_request=docs_per_request,
                    took_sec=round(took, 2),
                    cold_docs_sec=round(
                        cold_results["docs"] / cold_took, 1),
                    cold_errors=cold_results["errors"],
                    uds_docs_sec=round(
                        uds_results["docs"] / uds_took, 1),
                    uds_errors=uds_results["errors"],
                    **_wire_stats()),
    )


def main(argv: list | None = None) -> int:
    """Parse the reference's argv (plus --device) and print the line.
    Nothing is set up for the compile cache: the kernel module reads
    LDT_COMPILE_CACHE_DIR (default build/torch_kernels/) when the engine
    loads the library, and creates the directory there."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"bench_service: --device {device!r}: cuda or "
                         "cpu")
    if argv and argv[0] in ("--aio", "--aio-cold"):
        out = run_aio(*[int(a) for a in argv[1:]],
                      cold_only=argv[0] == "--aio-cold", device=device)
    else:
        out = run(*[int(a) for a in argv], device=device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
