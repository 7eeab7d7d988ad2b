"""--fleet and --shm over the port's fronts (bench.py `bench_fleet`,
`bench_shm`): the children are the port's supervisor, asyncio front and
threaded front, serving on the card.
"""
from __future__ import annotations

import http.client
import json
import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

from . import (PKG, ROOT, card, check_front_device, child_env, free_port,
               kill_group, log_tail, require, start_fleet, wait_ready)
from .corpus import make_corpus


def _payloads(total_docs: int, docs_per_request: int) -> list:
    docs = make_corpus(total_docs)
    return [json.dumps({"request": [{"text": d} for d in
                                    docs[r * docs_per_request:
                                         (r + 1) * docs_per_request]]}
                       ).encode()
            for r in range(total_docs // docs_per_request)]


def bench_fleet(n_workers: int = 3, total_docs: int = 24576,
                clients: int = 32, docs_per_request: int = 256,
                device: str = "cuda") -> dict:
    """Fleet saturation: aggregate docs/sec and request p99 through an
    N-member REUSEPORT fleet (service/fleet.py) against a 1-member fleet
    on the same host. Zero-drop is a gate, not a statistic: any non-2xx
    status or connection failure in the timed pass fails the bench
    (admission bounds stay unset, so the fleet has no legitimate shed
    path here)."""
    check_front_device(device)
    payloads = _payloads(total_docs, docs_per_request)

    def _pass(workers: int, tmp: str) -> dict:
        log_path = os.path.join(tmp, f"fleet-{workers}.log")
        # liveness-only members: the bench drives saturation itself
        sup, port, _ = start_fleet(workers, {"PROMETHEUS_PORT": "0"},
                                   log_path)
        try:
            lock = threading.Lock()
            drops = [0]

            def drive(work, lat, count):
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=120)
                while True:
                    with lock:
                        if not work:
                            break
                        payload = work.pop()
                    t0 = time.time()
                    try:
                        conn.request(
                            "POST", "/", payload,
                            {"Content-Type": "application/json"})
                        resp = conn.getresponse()
                        body = resp.read()
                    except Exception:  # noqa: BLE001 - counted as drop
                        with lock:
                            drops[0] += 1
                        conn.close()
                        conn = http.client.HTTPConnection(
                            "127.0.0.1", port, timeout=120)
                        continue
                    if resp.status in (200, 203):
                        n = body.count(b'"iso6391code"')
                        ms = (time.time() - t0) * 1e3
                        with lock:
                            count[0] += n
                            if lat is not None:
                                lat.append(ms)
                    else:
                        with lock:
                            drops[0] += 1
                conn.close()

            def run_pass(lat, count):
                work = list(payloads)
                threads = [threading.Thread(target=drive,
                                            args=(work, lat, count))
                           for _ in range(clients)]
                t0 = time.time()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                return time.time() - t0

            # untimed warm pass: REUSEPORT spreads the connections, so
            # every member pays its first flushes here
            run_pass(None, [0])
            drops[0] = 0
            lat: list = []
            count = [0]
            took = run_pass(lat, count)
            require(drops[0] == 0,
                    f"{drops[0]} dropped requests in the timed pass "
                    f"({workers} workers): the fleet bench must be "
                    "zero-drop")
            require(count[0] > 0, "nothing served in the timed pass")
            sup.send_signal(signal.SIGINT)
            rc = sup.wait(timeout=120)
            require(rc == 0, f"fleet exit {rc}: {log_tail(log_path)}")
            lat.sort()
            return dict(
                docs_sec=round(count[0] / took, 1),
                total_docs=count[0],
                took_sec=round(took, 2),
                p50_ms=round(lat[len(lat) // 2], 1),
                p99_ms=round(lat[min(len(lat) - 1,
                                     int(len(lat) * 0.99))], 1),
                drops=drops[0],
            )
        finally:
            kill_group(sup)

    with tempfile.TemporaryDirectory(prefix="ldt-fleet-bench-") as tmp:
        base = _pass(1, tmp)
        fleet = _pass(n_workers, tmp)
    host_cores = os.cpu_count() or 1
    detail = dict(
        fleet_workers=n_workers,
        clients=clients,
        docs_per_request=docs_per_request,
        host_cores=host_cores,
        zero_drop=True,
        fleet_speedup=round(fleet["docs_sec"] / base["docs_sec"], 3),
        **fleet,
        **{"baseline_" + k: v for k, v in base.items()},
    )
    if host_cores < n_workers:
        # N workers time-sharing fewer than N cores cannot show the
        # real scaling: the numbers hold for THIS host, the ratio is
        # what transfers
        detail["scaling_caveat"] = (
            f"host has {host_cores} core(s) for {n_workers} workers: "
            "members time-share the CPU, so aggregate throughput "
            "cannot exceed one worker's; compare ratios only; the "
            ">=2x claim requires >= fleet_workers cores")
    return dict(
        metric="service_fleet_saturation",
        value=fleet["docs_sec"],
        unit="docs/sec",
        card=card(device),
        detail=detail,
    )


def bench_shm(total_docs: int = 8192, docs_per_request: int = 64,
              device: str = "cuda") -> dict:
    """Shared-memory ring lane (service/shmring.py) against the framed
    unix-socket lane, both served by ONE threaded-front worker, so the
    scorer is the shared bottleneck and only the transport differs.
    The UDS pass keeps one framed request in flight; the shm pass
    pipelines across the ring's slots. Three gates: zero-drop on both
    timed passes, shm_docs_sec >= uds_docs_sec, and a hard p99 ceiling
    on the shm pass (a stuck lease, a fence hang or a sweep stall shows
    up as a blown tail long before a timeout)."""
    from ..service import shmring

    check_front_device(device)
    payloads = _payloads(total_docs, docs_per_request)
    port = free_port()
    tmp = tempfile.mkdtemp(prefix="ldt_shm_bench_")
    uds_path = os.path.join(tmp, "ldt.sock")
    shm_dir = os.path.join(tmp, "rings")
    log_path = os.path.join(tmp, "server.log")
    env = child_env({
        "LISTEN_PORT": str(port),
        "PROMETHEUS_PORT": "0",
        "LDT_UNIX_SOCKET": uds_path,
        "LDT_SHM_DIR": shm_dir,
    })
    with open(log_path, "w") as log:
        srv = subprocess.Popen(
            [sys.executable, "-m", f"{PKG}.service.server"],
            cwd=str(ROOT), env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True)
    hdr = struct.Struct("!I")
    rhdr = struct.Struct("!IH")
    try:
        def ready() -> bool:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/readyz", timeout=5) as resp:
                return resp.status == 200 and os.path.exists(uds_path)

        try:
            wait_ready(ready, srv, "worker")
        except RuntimeError as e:
            raise RuntimeError(f"{e}: {log_tail(log_path)}") from e

        def uds_pass(lat, drops):
            conn = socket.socket(socket.AF_UNIX)
            conn.connect(uds_path)
            served = 0
            t0 = time.time()
            for body in payloads:
                t1 = time.time()
                conn.sendall(hdr.pack(len(body)) + body)
                raw = b""
                while len(raw) < rhdr.size:
                    chunk = conn.recv(rhdr.size - len(raw))
                    if not chunk:
                        raise RuntimeError("UDS peer closed mid-frame")
                    raw += chunk
                length, status = rhdr.unpack(raw)
                resp = bytearray()
                while len(resp) < length:
                    chunk = conn.recv(length - len(resp))
                    if not chunk:
                        raise RuntimeError("UDS peer closed mid-body")
                    resp += chunk
                if status in (200, 203):
                    served += bytes(resp).count(b'"iso6391code"')
                    if lat is not None:
                        lat.append((time.time() - t1) * 1e3)
                else:
                    drops[0] += 1
            conn.close()
            return served, time.time() - t0

        def shm_pass(cli, lat, drops):
            served = 0
            pending = []          # (slot, t_submit), submit order
            t0 = time.time()

            def drain_oldest():
                nonlocal served
                i, t1 = pending.pop(0)
                status, resp = cli.wait(i, timeout=60.0)
                if status in (200, 203):
                    served += resp.count(b'"iso6391code"')
                    if lat is not None:
                        lat.append((time.time() - t1) * 1e3)
                else:
                    drops[0] += 1

            for body in payloads:
                while True:
                    i = cli.submit(body)
                    if i is not None:
                        break
                    drain_oldest()      # ring full: free a slot first
                pending.append((i, time.time()))
            while pending:
                drain_oldest()
            return served, time.time() - t0

        # untimed warm passes on both lanes
        warm_drops = [0]
        uds_pass(None, warm_drops)
        cli = shmring.RingClient(shm_dir)
        cli.wait_attached(60.0)
        shm_pass(cli, None, warm_drops)

        # two timed passes per lane, interleaved, best-of per lane;
        # every pass must still be zero-drop and fully served
        lanes = {}
        for _ in range(2):
            for name, one_pass in (
                    ("uds", uds_pass),
                    ("shm", lambda l, d: shm_pass(cli, l, d))):
                lat: list = []
                drops = [0]
                served, took = one_pass(lat, drops)
                require(drops[0] == 0,
                        f"{drops[0]} dropped frames on the {name} lane: "
                        "the shm bench must be zero-drop")
                require(served == total_docs,
                        f"{name} lane answered {served}/{total_docs} docs")
                lat.sort()
                res = dict(
                    docs_sec=round(served / took, 1),
                    took_sec=round(took, 2),
                    p50_ms=round(lat[len(lat) // 2], 2),
                    p99_ms=round(lat[min(len(lat) - 1,
                                         int(len(lat) * 0.99))], 2),
                    drops=0,
                )
                if name not in lanes or \
                        res["docs_sec"] > lanes[name]["docs_sec"]:
                    lanes[name] = res
        cli.close(unlink=True)

        p99_ceiling_ms = 5_000.0
        require(lanes["shm"]["p99_ms"] < p99_ceiling_ms,
                f"shm p99 {lanes['shm']['p99_ms']}ms blew the "
                f"{p99_ceiling_ms}ms ceiling: a lease/fence stall, not a "
                "throughput problem")
        require(lanes["shm"]["docs_sec"] >= lanes["uds"]["docs_sec"],
                f"shm lane ({lanes['shm']['docs_sec']} docs/s) slower "
                f"than UDS ({lanes['uds']['docs_sec']} docs/s)")

        srv.send_signal(signal.SIGTERM)
        rc = srv.wait(timeout=120)
        require(rc == 0, f"worker exit {rc}: {log_tail(log_path)}")
        return dict(
            metric="shm_ring_ingest",
            value=lanes["shm"]["docs_sec"],
            unit="docs/sec",
            card=card(device),
            detail=dict(
                total_docs=total_docs,
                docs_per_request=docs_per_request,
                zero_drop=True,
                p99_ceiling_ms=p99_ceiling_ms,
                shm_over_uds=round(lanes["shm"]["docs_sec"] /
                                   lanes["uds"]["docs_sec"], 3),
                **{"shm_" + k: v for k, v in lanes["shm"].items()},
                **{"uds_" + k: v for k, v in lanes["uds"].items()},
            ),
        )
    finally:
        kill_group(srv)
        shutil.rmtree(tmp, ignore_errors=True)
