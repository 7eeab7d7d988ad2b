"""--replay DIR and --replay-synth STREAM [--autotune] (bench.py
`replay_records`, `bench_replay`): re-drive a capture, or a synthetic
stream, against a REUSEPORT fleet of the port's asyncio front on the
recorded schedule, optionally searching the admission knobs against an
SLO on the same fleet.
"""
from __future__ import annotations

import http.client
import json
import os
import shutil
import signal
import tempfile
import threading
import time
import urllib.request

from . import card, check_front_device, kill_group, start_fleet
from .corpus import _synth_replay_text, synth_capture_records

# mutable knobs the replay autotuner searches: the admission bounds
# that decide what an overloaded front sheds vs queues
AUTOTUNE_NAMES = frozenset({"LDT_MAX_INFLIGHT", "LDT_MAX_QUEUE_DOCS"})


def replay_records(records: list, port: int, speedup: float = 1.0,
                   clients: int = 8) -> dict:
    """Re-drive a merged capture against a live front on 127.0.0.1:
    each record becomes one POST with synthesized docs to the recorded
    size bucket, the recorded tenant/priority/deadline headers, fired
    on the recorded arrival schedule compressed by `speedup`. Returns
    schedule fidelity (achieved-vs-recorded send-time skew) and
    per-tenant latency/shed/error SLIs."""
    if not records:
        return {"requests": 0, "error": "empty capture"}
    speedup = max(float(speedup), 1e-6)
    arr0 = records[0]["arrival_ns"]
    plan = []
    for i, r in enumerate(records):
        offset = (r["arrival_ns"] - arr0) / 1e9 / speedup
        docs_n = max(int(r.get("docs", 1)), 1)
        target = max(int(r.get("approx_bytes", 256)), 64)
        texts = [_synth_replay_text(r.get("tenant_hash", 0), i * 131 + j,
                                    max(target // docs_n, 8))
                 for j in range(docs_n)]
        body = json.dumps(
            {"request": [{"text": t} for t in texts]}).encode()
        headers = {"Content-Type": "application/json",
                   "X-LDT-Tenant": r.get("tenant", "default")}
        if r.get("priority"):
            headers["X-LDT-Priority"] = "1"
        if r.get("deadline_ms"):
            headers["X-LDT-Deadline-Ms"] = str(int(r["deadline_ms"]))
        plan.append((offset, r.get("tenant", "default"), body, headers,
                     docs_n))

    lock = threading.Lock()
    cursor = [0]
    sent: list = []            # (scheduled_offset, actual_offset)
    by_tenant: dict = {}
    counts = {"ok": 0, "shed": 0, "error": 0, "drop": 0}
    ok_lat: list = []          # latency of successful answers only
    ok_docs = [0]              # docs actually served ok (cost proxy)
    t_start = time.time() + 0.5   # shared epoch: lead time to spin up

    def drive():
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=120)
        while True:
            with lock:
                i = cursor[0]
                if i >= len(plan):
                    break
                cursor[0] = i + 1
            offset, tenant, body, headers, docs_n = plan[i]
            delay = t_start + offset - time.time()
            if delay > 0:
                time.sleep(delay)
            actual = time.time() - t_start
            t0 = time.time()
            try:
                conn.request("POST", "/", body, headers)
                resp = conn.getresponse()
                resp.read()
                status = resp.status
            except Exception:  # noqa: BLE001 - counted, not fatal
                with lock:
                    counts["drop"] += 1
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=120)
                continue
            ms = (time.time() - t0) * 1e3
            with lock:
                sent.append((offset, actual))
                t = by_tenant.setdefault(
                    tenant, {"lat": [], "shed": 0, "errors": 0})
                t["lat"].append(ms)
                if status in (429, 503):
                    counts["shed"] += 1
                    t["shed"] += 1
                elif status >= 500:
                    counts["error"] += 1
                    t["errors"] += 1
                else:
                    counts["ok"] += 1
                    ok_lat.append(ms)
                    ok_docs[0] += docs_n
        conn.close()

    threads = [threading.Thread(target=drive)
               for _ in range(min(clients, len(plan)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = max(time.time() - t_start, 1e-9)

    skews = sorted(abs(a - s) for s, a in sent)
    span_sched = plan[-1][0] if len(plan) > 1 else 0.0

    def _pct(xs, q):
        return xs[min(len(xs) - 1, int(len(xs) * q))] if xs else 0.0

    tenants = {}
    for tenant, d in sorted(by_tenant.items()):
        lat = sorted(d["lat"])
        tenants[tenant] = {
            "requests": len(lat),
            "p50_ms": round(_pct(lat, 0.50), 2),
            "p99_ms": round(_pct(lat, 0.99), 2),
            "shed": d["shed"],
            "errors": d["errors"],
        }
    p95_skew = _pct(skews, 0.95)
    oklat = sorted(ok_lat)
    n_resp = max(len(plan), 1)
    return {
        "requests": len(plan),
        "completed": len(sent),
        "speedup": speedup,
        # overall SLIs in the shape autotune.score() consumes: latency
        # of SUCCESSFUL answers (a shed is fast by construction and must
        # not dilute p99), errors+drops against the error budget, and
        # the docs/sec cost proxy over the achieved wall time
        "sli": {
            "p50_ms": round(_pct(oklat, 0.50), 2),
            "p99_ms": round(_pct(oklat, 0.99), 2),
            "err_pct": round(100.0 * (counts["error"] + counts["drop"])
                             / n_resp, 3),
            "shed_pct": round(100.0 * counts["shed"] / n_resp, 3),
            "ok_docs_per_sec": round(ok_docs[0] / wall, 2),
            "wall_sec": round(wall, 3),
        },
        "span_scheduled_sec": round(span_sched, 3),
        "schedule": {
            "p50_skew_ms": round(_pct(skews, 0.50) * 1e3, 2),
            "p95_skew_ms": round(p95_skew * 1e3, 2),
            "max_skew_ms": round((skews[-1] if skews else 0) * 1e3, 2),
            # the acceptance ratio: p95 send-time skew as a fraction of
            # the replayed span (<= 0.10 reproduces the schedule)
            "skew_frac_p95": round(p95_skew / span_sched, 4)
            if span_sched > 0 else 0.0,
        },
        "counts": counts,
        "tenants": tenants,
    }


def load_records(capture_dir: str | None, synth: str | None) -> tuple:
    """(records, source) of a capture directory or a synthetic stream:
    `zipf`, or any loadgen scenario."""
    from .. import capture as cap
    from .. import loadgen

    if synth:
        if synth == "zipf":
            records = synth_capture_records()
        else:
            if synth not in loadgen.scenario_names():
                raise SystemExit(
                    f"unknown synth stream {synth!r} (have: zipf, "
                    f"{', '.join(loadgen.scenario_names())})")
            records = loadgen.generate(synth)
        return records, {"synth": synth, "records": len(records)}
    records = cap.merge_captures(capture_dir)
    if not records:
        raise SystemExit(f"bench --replay: no capture records under "
                         f"{capture_dir}")
    return records, {"dir": capture_dir, "records": len(records)}


def bench_replay(capture_dir: str | None = None, speedup: float = 1.0,
                 workers: int = 2, synth: str | None = None,
                 clients: int = 8, autotune_slo: str | None = None,
                 device: str = "cuda") -> dict:
    """Boot a REUSEPORT fleet and re-drive a capture (or a synthetic
    stream) against it on the recorded schedule. With `autotune_slo`
    (an LDT_SLO spec string) the same fleet then hosts an
    autotune.autotune() search: each candidate override batch is pushed
    fleet-wide through the supervisor's POST /configz (probation 0) and
    scored on the replayed SLIs, then the default and the winner run 3
    alternating confirmation laps. Writes no file."""
    check_front_device(device)
    records, source = load_records(capture_dir, synth)
    tmp = tempfile.mkdtemp(prefix="ldt-replay-")
    log_path = os.path.join(tmp, "fleet.log")
    # pin the fleet size: autoscale churn mid-replay would swap
    # cold-cache workers into the measurement
    sup, port, sport = start_fleet(workers, {
        "PROMETHEUS_PORT": "0", "LDT_FLEET_SCALE_UP_DEPTH": "0"},
        log_path)
    try:
        # untimed warm lap over the FULL record set: first flushes and
        # shared-cache fills are not charged to the recorded schedule
        replay_records(records, port, speedup=speedup, clients=clients)
        result = replay_records(records, port, speedup=speedup,
                                clients=clients)
        tuned = None
        if autotune_slo:
            tuned = _autotune(records, port, sport, speedup, clients,
                              autotune_slo)
        sup.send_signal(signal.SIGINT)
        rc = sup.wait(timeout=120)
        if rc != 0:
            result["fleet_exit"] = rc
    finally:
        kill_group(sup)
        shutil.rmtree(tmp, ignore_errors=True)
    out = dict(metric="service_replay",
               value=result.get("schedule", {}).get("skew_frac_p95",
                                                    1.0),
               unit="p95_skew_frac_of_span",
               card=card(device),
               detail=dict(source=source, fleet_workers=workers,
                           clients=clients, **result))
    if tuned is not None:
        out["detail"]["autotune"] = dict(scenario=synth or "capture",
                                         slo=autotune_slo, **tuned)
    return out


def _autotune(records: list, port: int, sport: int, speedup: float,
              clients: int, autotune_slo: str) -> dict:
    from .. import autotune, slo

    spec = slo.parse_spec(autotune_slo)
    tuned_names = sorted(AUTOTUNE_NAMES)

    def push_config(batch: dict) -> None:
        req = urllib.request.Request(
            f"http://127.0.0.1:{sport}/configz",
            data=json.dumps({"set": batch, "probation_sec": 0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            resp.read()

    def evaluate(ov: dict) -> dict:
        # full-reset-then-set: knobs the candidate leaves out fall back
        # to env defaults, not linger from the previous push
        batch = {name: None for name in tuned_names}
        batch.update(ov)
        push_config(batch)
        # best of two laps: the lap right after a push pays the
        # transition's cache re-warming, which belongs to no candidate
        m = None
        for _lap in range(2):
            r = replay_records(records, port, speedup=speedup,
                               clients=clients)
            m2 = dict(r["sli"], counts=r["counts"])
            if m is None or autotune.score(m2, spec) \
                    > autotune.score(m, spec):
                m = m2
        return m

    tuned = autotune.autotune(evaluate, names=AUTOTUNE_NAMES, spec=spec)
    # confirmation laps, alternating default / winner on the same warm
    # fleet: eval-order warm-up must not flatter whichever config ran
    # last, and single-lap noise must not decide the verdict
    confirm: dict = {"default": [], "autotuned": []}
    for _lap in range(3):
        push_config({name: None for name in tuned_names})
        r = replay_records(records, port, speedup=speedup, clients=clients)
        confirm["default"].append(r["sli"])
        push_config(dict({name: None for name in tuned_names},
                         **tuned["best"]))
        r = replay_records(records, port, speedup=speedup, clients=clients)
        confirm["autotuned"].append(r["sli"])

    def mean_sli(laps: list) -> dict:
        return {k: round(sum(lap[k] for lap in laps) / len(laps), 2)
                for k in laps[0]}

    tuned["confirm"] = {"laps": confirm,
                        "default": mean_sli(confirm["default"]),
                        "autotuned": mean_sli(confirm["autotuned"])}
    return tuned
