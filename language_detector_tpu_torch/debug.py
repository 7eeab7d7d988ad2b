"""Score-trace debugging: the port's copy of language_detector_tpu/debug.py,
the reference's HTML debug dumps (debug.cc CLD2_Debug chunk rendering +
DumpHitBuffer/DumpSummaryBuffer, scoreonescriptspan.cc:561-661, flag-gated
by kCLDFlagHtml/kCLDFlagVerbose, compact_lang_det.h:343-348).

`trace_detect` runs full scalar detection while recording every scoring
decision — spans, per-chunk summaries, the document tote before and after
close-pair refinement and unreliable-language removal, recursion events,
and the final summary-language calculation — and `format_trace` renders it
as readable text. Unlike the reference's stderr HTML (not thread safe,
compact_lang_det_impl.cc:478-485), the trace is a plain data object.

The other formatters render the JSON documents the port's fronts serve
(/debug/slow, /sloz, /tracez, /debug/vars), capture summaries, engine
stats and the eval scorecard, each with the reference's output for the
same input. The CLI: python -m language_detector_tpu_torch.debug; its
--engine-stats runs the batched engine on --device (cuda by default,
which raises without CUDA; cpu runs the plain scorer).
"""
from __future__ import annotations

import dataclasses

from .engine_scalar import (FLAG_BEST_EFFORT, FLAG_FINISH, FLAG_REPEATS,
                            FLAG_SQUEEZE, ScalarResult, detect_scalar)
from .registry import Registry, registry as default_registry
from .tables import ScoringTables, load_tables


@dataclasses.dataclass
class DetectionTrace:
    """Ordered trace events: (kind, payload) tuples.

    Kinds: "pass" (flags for a detection pass; recursion produces
    several), "span" (script/bytes), "chunk" (per-chunk summary),
    "doc_tote" (stage name + [(lang, bytes, score, reliability)]),
    "summary" (final decision)."""
    events: list = dataclasses.field(default_factory=list)
    result: ScalarResult | None = None

    def add(self, kind: str, **payload):
        self.events.append((kind, payload))

    def add_tote(self, stage: str, doc_tote, reg):
        """Record a doc-tote snapshot (called by the engine so it does not
        depend on this module's helpers)."""
        self.add("doc_tote", stage=stage, rows=_tote_rows(doc_tote, reg))


def _tote_rows(doc_tote, reg):
    rows = []
    for i in range(doc_tote.MAX):
        if doc_tote.key[i] != doc_tote.UNUSED and doc_tote.value[i] > 0:
            rows.append((reg.code(int(doc_tote.key[i])),
                         int(doc_tote.value[i]), int(doc_tote.score[i]),
                         int(doc_tote.rel[i]) //
                         max(int(doc_tote.value[i]), 1)))
    return sorted(rows, key=lambda r: -r[2])


def trace_detect(text: str, tables: ScoringTables | None = None,
                 reg: Registry | None = None, flags: int = 0,
                 is_plain_text: bool = True, hints=None,
                 want_chunks: bool = False) -> DetectionTrace:
    """Full-document detection with a recorded score trace.

    want_chunks traces the result-VECTOR path instead (offset-preserving
    squeeze rewrites + boundary sharpening) — exactly like the reference,
    that path can produce different byte totals and therefore different
    percentages on squeeze/repeat-triggering documents, so it is off by
    default: a plain trace matches a plain detect_scalar call."""
    tables = tables or load_tables()
    reg = reg or default_registry
    trace = DetectionTrace()
    trace.result = detect_scalar(text, tables, reg, flags,
                                 is_plain_text=is_plain_text, hints=hints,
                                 want_chunks=want_chunks, _trace=trace)
    return trace


def format_trace(trace: DetectionTrace, reg: Registry | None = None,
                 html: bool = False) -> str:
    """Render a DetectionTrace as indented text, or — with html=True —
    as a self-contained HTML page with every chunk decision as a colored
    cell (the eyeballable per-chunk dump the reference renders to stderr
    under kCLDFlagHtml, debug.cc CLD2_Debug)."""
    if html:
        return _format_trace_html(trace, reg or default_registry)
    reg = reg or default_registry
    out = []
    for kind, p in trace.events:
        if kind == "pass":
            fl = []
            if p["flags"] & FLAG_FINISH:
                fl.append("FINISH")
            if p["flags"] & FLAG_SQUEEZE:
                fl.append("SQUEEZE")
            if p["flags"] & FLAG_REPEATS:
                fl.append("REPEATS")
            if p["flags"] & FLAG_BEST_EFFORT:
                fl.append("BEST_EFFORT")
            out.append(f"pass flags={p['flags']:#x} "
                       f"[{' '.join(fl) or 'default'}]")
        elif kind == "span":
            out.append(f"  span script={p['script']} "
                       f"({reg.ulscript_code[p['script']]}) "
                       f"bytes={p['bytes']} rtype={p['rtype']}")
        elif kind == "chunk":
            out.append(
                f"    chunk @{p['offset']}+{p['bytes']}B "
                f"{reg.code(p['lang1'])}.{p['score1']} "
                f"{reg.code(p['lang2'])}.{p['score2']} "
                f"grams={p['grams']} relD={p['rel_delta']} "
                f"relS={p['rel_score']}")
        elif kind == "doc_tote":
            rows = " ".join(f"{c}:{b}B/{s}/{r}%" for c, b, s, r in p["rows"])
            out.append(f"  doc_tote[{p['stage']}] {rows or '(empty)'}")
        elif kind == "summary":
            out.append(
                f"summary {reg.code(p['lang'])} reliable={p['reliable']} "
                f"top3={[(reg.code(l), pc) for l, pc in p['top3']]} "
                f"bytes={p['text_bytes']}")
    return "\n".join(out)


def _lang_color(code: str) -> str:
    """Stable pastel per language code (debug.cc keys its colors off the
    language too; exact palette is presentation, not contract)."""
    h = 0
    for ch in code:
        h = (h * 131 + ord(ch)) % 360
    return f"hsl({h},70%,85%)"


def _format_trace_html(trace: DetectionTrace, reg: Registry) -> str:
    from html import escape

    rows: list = []
    cur_pass = 0
    for kind, p in trace.events:
        if kind == "pass":
            cur_pass += 1
            rows.append(f"<h3>pass {cur_pass} "
                        f"(flags={p['flags']:#x})</h3>")
        elif kind == "span":
            rows.append(
                f"<div class=span>span "
                f"{escape(str(reg.ulscript_code[p['script']]))} "
                f"{p['bytes']}B rtype={p['rtype']}</div>")
        elif kind == "chunk":
            c1 = reg.code(p["lang1"])
            c2 = reg.code(p["lang2"])
            rows.append(
                f"<span class=chunk style=\"background:"
                f"{_lang_color(c1)}\" title=\""
                f"offset={p['offset']} bytes={p['bytes']} "
                f"grams={p['grams']} relD={p['rel_delta']} "
                f"relS={p['rel_score']}\">"
                f"{escape(c1)}.{p['score1']}&nbsp;/"
                f"&nbsp;{escape(c2)}.{p['score2']}"
                f"<small>&nbsp;{p['bytes']}B</small></span>")
        elif kind == "doc_tote":
            body = "".join(
                f"<tr><td style=\"background:{_lang_color(c)}\">"
                f"{escape(c)}</td><td>{b}</td><td>{s}</td>"
                f"<td>{r}%</td></tr>"
                for c, b, s, r in p["rows"])
            rows.append(
                f"<details><summary>doc_tote "
                f"[{escape(p['stage'])}]</summary><table>"
                f"<tr><th>lang</th><th>bytes</th><th>score</th>"
                f"<th>rel</th></tr>{body}</table></details>")
        elif kind == "summary":
            top3 = " ".join(f"{escape(reg.code(l))}:{pc}%"
                            for l, pc in p["top3"])
            rows.append(
                f"<div class=summary style=\"background:"
                f"{_lang_color(reg.code(p['lang']))}\">summary "
                f"<b>{escape(reg.code(p['lang']))}</b> "
                f"reliable={p['reliable']} {top3} "
                f"bytes={p['text_bytes']}</div>")
    style = ("<style>body{font:13px monospace;margin:1em}"
             ".chunk{padding:2px 6px;margin:1px;display:inline-block;"
             "border:1px solid #bbb;border-radius:3px}"
             ".span{color:#666;margin-top:4px}"
             ".summary{padding:6px;margin-top:8px;border:1px solid #888}"
             "table{border-collapse:collapse;margin:4px 0}"
             "td,th{border:1px solid #ccc;padding:1px 6px}</style>")
    return ("<!doctype html><html><head><meta charset=\"utf-8\">"
            f"<title>score trace</title>{style}</head><body>"
            + "\n".join(rows) + "</body></html>")


def format_engine_stats(stats: dict) -> str:
    """Human-readable render of the batched engine's scheduler counters
    (models/ngram.py NgramBatchEngine.stats / detector.engine_stats):
    dispatch lanes per shape tier, retry-lane overlap, dedup savings,
    fallback/recursion volume. The service /metrics endpoint exports the
    same counters as Prometheus series; this is their terminal twin for
    bench output and the CLI."""
    order = ["batches", "device_dispatches", "c_path_docs",
             "tier_short_dispatches", "tier_mid_dispatches",
             "tier_long_dispatches", "tier_mixed_dispatches",
             "retry_lane_dispatches", "dedup_docs",
             "retry_skipped_docs",
             "fallback_docs", "scalar_recursion_docs"]
    keys = ([k for k in order if k in stats] +
            sorted(k for k in stats if k not in order))
    if not keys:
        return "(no engine stats)"
    w = max(len(k) for k in keys)
    return "\n".join(f"{k:<{w}}  {stats[k]}" for k in keys)


def format_slow_traces(doc: dict) -> str:
    """Pretty-print a /debug/slow JSON document (telemetry.SlowTraceRing
    snapshot): one block per sampled request, spans indented by depth
    with start offset and duration — the span-tree twin of
    format_trace's indented scalar dump."""
    lines = [f"slow traces: {len(doc.get('traces', []))} held / "
             f"{doc.get('recorded', 0)} recorded "
             f"(threshold {doc.get('threshold_ms', 0)}ms, "
             f"ring {doc.get('capacity', 0)})"]
    import datetime
    for i, tr in enumerate(doc.get("traces", [])):
        when = datetime.datetime.fromtimestamp(tr.get("ts", 0)) \
            .strftime("%H:%M:%S.%f")[:-3]
        meta = " ".join(f"{k}={v}" for k, v in
                        sorted(tr.get("meta", {}).items()))
        lines.append(f"\n#{i} {when} total={tr.get('total_ms', 0)}ms"
                     + (f" [{meta}]" if meta else ""))
        for sp in tr.get("spans", []):
            pad = "  " * (sp.get("depth", 0) + 1)
            lines.append(f"{pad}{sp.get('name', '?'):<12} "
                         f"@{sp.get('start_ms', 0):>9.3f}ms "
                         f"+{sp.get('dur_ms', 0):.3f}ms")
    return "\n".join(lines)


def format_fleet_traces(doc: dict) -> str:
    """Pretty-print a fleet /tracez merge (service/fleet._fleet_traces):
    one block per request id, listing the processes it touched, every
    slow-trace capture (with owning member slot), and the recorder
    events carrying that id in time order — the cross-process twin of
    format_slow_traces."""
    reqs = doc.get("requests", [])
    lines = [f"fleet traces: {doc.get('count', len(reqs))} request "
             f"id(s) merged"]
    for e in reqs:
        procs = ", ".join(str(p) for p in e.get("processes", []))
        lines.append(f"\nrequest {e.get('request_id', '?')} "
                     f"[{procs}]")
        for tr in e.get("traces", []):
            meta = " ".join(f"{k}={v}" for k, v in
                            sorted(tr.get("meta", {}).items()))
            lines.append(f"  slot {tr.get('slot', '?')} trace "
                         f"total={tr.get('total_ms', 0)}ms"
                         + (f" [{meta}]" if meta else ""))
            for sp in tr.get("spans", []):
                pad = "  " * (sp.get("depth", 0) + 2)
                lines.append(f"{pad}{sp.get('name', '?'):<12} "
                             f"@{sp.get('start_ms', 0):>9.3f}ms "
                             f"+{sp.get('dur_ms', 0):.3f}ms")
        for ev in sorted(e.get("events", []),
                         key=lambda x: x.get("ts", 0)):
            fields = " ".join(
                f"{k}={v}" for k, v in sorted(ev.items())
                if k not in ("ev", "ts", "pid", "request_id"))
            lines.append(f"  pid {ev.get('pid', '?')} "
                         f"{ev.get('ev', '?'):<14}"
                         + (f" {fields}" if fields else ""))
    return "\n".join(lines)


def format_admission(doc: dict) -> str:
    """Human-readable render of the admission controller's state as
    published under /debug/vars "admission" (service/admission.py
    AdmissionController.stats): live queue occupancy against configured
    bounds, brownout ladder position, breaker state, and shed counts by
    reason — the operator's first stop when clients start seeing 429s."""
    adm = doc.get("admission", doc)
    if not adm:
        return "(admission control idle: no stats published)"
    limits = adm.get("limits", {})

    def bound(v):
        return "unbounded" if v is None else str(v)

    lines = [
        f"queue_docs   {adm.get('queue_docs', 0)} / "
        f"{bound(limits.get('max_queue_docs'))}",
        f"queue_bytes  {adm.get('queue_bytes', 0)} / "
        f"{bound(limits.get('max_queue_bytes'))}",
        f"inflight     {adm.get('inflight', 0)} / "
        f"{bound(limits.get('max_inflight'))}",
        f"brownout     level={adm.get('brownout_level', 0)} "
        f"ema={adm.get('brownout_ema', 0.0):.3f}",
    ]
    br = adm.get("breaker", {})
    lines.append(f"breaker      {br.get('state_name', 'closed')} "
                 f"consec={br.get('consecutive_failures', 0)} "
                 f"trips={br.get('trips', 0)} "
                 f"probes={br.get('probes', 0)}")
    shed = adm.get("shed", {})
    total = sum(shed.values()) if shed else 0
    lines.append(f"shed         total={total} " +
                 " ".join(f"{k}={v}" for k, v in sorted(shed.items())))
    lines.append(f"deadline_expired  {adm.get('deadline_expired', 0)}")
    return "\n".join(lines)


def format_slo(doc: dict) -> str:
    """Human-readable render of a /sloz document (slo.sloz, or the
    fleet merge's "slo" block): declared targets, fleet-wide and
    per-tenant windowed SLIs, budget burn rates, and the alert state —
    the operator's answer to "are we meeting the SLO, and for whom
    not"."""
    if not doc.get("enabled"):
        return ("(SLO engine off: " +
                doc.get("hint", "set LDT_SLO on the fronts") + ")")
    # the fleet merge has a different shape (aggregated tenants, no
    # window pairs) — render it with the member count it carries
    if "members" in doc and "fleet" not in doc:
        lines = [f"fleet SLO: alert={doc.get('alert', 'ok')} "
                 f"members={len(doc.get('members', []))}"]
        spec = doc.get("spec") or {}
        if spec:
            lines.append(
                f"targets      p{spec.get('percentile', 99):g}"
                f"<={spec.get('target_ms')}ms "
                f"err<={spec.get('err_pct')}% "
                f"window={spec.get('window_sec')}s")
        for t, agg in sorted((doc.get("tenants") or {}).items()):
            lines.append(
                f"  {t:<20} count={agg.get('count', 0)} "
                f"bad={agg.get('bad', 0)} shed={agg.get('shed', 0)} "
                f"worst_burn={agg.get('burn_rate_max', 0.0)}")
        return "\n".join(lines)
    spec = doc.get("spec", {})
    alert = doc.get("alert", {})
    lines = [
        f"targets      p{spec.get('percentile', 99):g}"
        f"<={spec.get('target_ms')}ms err<={spec.get('err_pct')}% "
        f"windows={spec.get('window_sec')}s/"
        f"{spec.get('slow_window_sec')}s",
        f"alert        {alert.get('state', 'ok')}"
        + (f" since={alert.get('since_sec')}s"
           if alert.get("since_sec") is not None else "")
        + f" breaches_total={alert.get('breaches_total', 0)}",
        f"observed     {doc.get('observed', 0)} requests",
    ]

    def _scope(name: str, view: dict) -> None:
        for label in ("fast", "slow"):
            w = view.get(label) or {}
            pq = next((v for k, v in w.items()
                       if k.startswith("p") and k.endswith("_ms")
                       and k != "p50_ms"), None)
            lines.append(
                f"  {name:<18} {label:<4} count={w.get('count', 0)} "
                f"err={w.get('err_ratio', 0.0)} "
                f"shed={w.get('shed', 0)} p50={w.get('p50_ms')}ms "
                f"pX={pq}ms burn={w.get('burn_rate', 0.0)}")

    lines.append("fleet-wide")
    _scope("(all tenants)", doc.get("fleet") or {})
    tenants = doc.get("tenants") or {}
    if tenants:
        lines.append("per-tenant")
        for t, view in sorted(tenants.items()):
            _scope(t, view)
    return "\n".join(lines)


def format_capture_summary(doc: dict) -> str:
    """Human-readable render of capture.summarize(dir): segment/record
    volumes, the capture's time span, and the tenant/lane/status mix —
    the sanity check before pointing bench.py --replay at it."""
    lines = [
        f"capture {doc.get('dir', '?')}",
        f"records      {doc.get('records', 0)} across "
        f"{doc.get('segments', 0)} sealed segment(s) + "
        f"{doc.get('rings', 0)} live/abandoned ring(s)",
        f"span         {doc.get('span_sec', 0.0)}s",
        f"tenants      {doc.get('tenants', 0)} distinct "
        f"(sheds={doc.get('sheds', 0)})",
    ]
    for row in doc.get("top_tenants", []):
        lines.append(f"  {row.get('tenant', '?'):<20} "
                     f"{row.get('records', 0)} record(s)")
    lanes = doc.get("lanes") or {}
    if lanes:
        lines.append("lanes        " + " ".join(
            f"{k}={v}" for k, v in sorted(lanes.items())))
    statuses = doc.get("statuses") or {}
    if statuses:
        lines.append("statuses     " + " ".join(
            f"{k}={v}" for k, v in sorted(statuses.items())))
    return "\n".join(lines)


def _read_slow_source(src: str) -> dict:
    """--slow-traces input: an http(s) URL (a running front's
    GET /debug/slow), a JSON file path, or '-' for stdin."""
    import json
    import sys
    if src == "-":
        return json.loads(sys.stdin.read())
    if src.startswith(("http://", "https://")):
        from urllib.request import urlopen
        with urlopen(src, timeout=10) as r:
            return json.loads(r.read())
    from pathlib import Path
    return json.loads(Path(src).read_text())


def format_scorecard(card: dict) -> str:
    """Render an ACC_r*.json accuracy scorecard (bench.py --eval /
    evalsuite.run_eval) for postmortem reading: agreement vs the scalar
    oracle, label accuracy, the top per-script confusions, reliability
    calibration, and the documented hint-flip demo."""
    out = [f"accuracy scorecard — round {card.get('round', '?')}"
           f" ({card['corpus_docs']} docs, {card['languages']} languages"
           f"{', quick' if card.get('quick') else ''},"
           f" engine={card.get('engine', '?')})"]
    ag = card["agreement"]
    out.append(f"  device-vs-oracle agreement: "
               f"top-1 {ag['top1']:.4f}  top-3 {ag['top3']:.4f}  "
               f"(floor {ag['floor']})")
    la = card["label_accuracy"]
    out.append(f"  label accuracy: top-1 {la['top1']:.4f}  "
               f"top-3 {la['top3']:.4f}")
    scripts = card.get("per_script") or {}
    if scripts:
        out.append("  per-script label accuracy (confusions "
                   "label->got xN):")
        for name in sorted(scripts):
            row = scripts[name]
            conf = "  ".join(f"{l}->{g} x{n}"
                             for l, g, n in row.get("confusions", []))
            out.append(f"    {name:4s} docs={row['docs']:<4d} "
                       f"top-1 {row['label_top1']:.3f}"
                       + (f"  ({conf})" if conf else ""))
    cal = card.get("calibration") or []
    if cal:
        out.append("  calibration (reported pct -> observed accuracy):")
        for b in cal:
            rng = f"{b['pct_lo']}-{b['pct_hi']}"
            out.append(f"    {rng:>7s}  n={b['docs']:<4d} "
                       f"acc={b['label_top1']:.3f} "
                       f"reliable={b['reliable_frac']:.3f}")
    hf = card.get("hint_flip")
    if hf:
        out.append(f"  hint-flip demo: {hf['before']} -> {hf['after']} "
                   f"({hf['hint']}; flipped={hf['flipped']})")
    return "\n".join(out)


def _latest_scorecard(src: str | None):
    """--eval source: an explicit ACC_r*.json path, or the
    highest-numbered round in the repo root when given 'latest'."""
    import json
    from pathlib import Path
    if src and src != "latest":
        return json.loads(Path(src).read_text())
    root = Path(__file__).resolve().parent.parent
    cards = sorted(root.glob("ACC_r*.json"))
    if not cards:
        raise SystemExit("no ACC_r*.json found — run bench.py --eval")
    return json.loads(cards[-1].read_text())


def format_spans(text: str, spans: list, reg) -> str:
    """Pretty-print per-span verdicts: one line per span with its byte
    range, code, confidence, and the (escaped, truncated) text slice."""
    out = []
    data = text.encode("utf-8")
    for off, ln, code, pct, rel in spans:
        piece = data[off:off + ln].decode("utf-8", errors="replace")
        piece = piece.replace("\n", " ")
        if len(piece) > 48:
            piece = piece[:45] + "..."
        mark = " " if rel else "?"
        out.append(f"  [{off:6d}..{off + ln:6d}) {code:4s} "
                   f"{pct:3d}%{mark} {piece!r}")
    return "\n".join(out)


def _main(argv=None):
    """CLI harness (the reference's compact_lang_det_test.cc interactive
    tool): text from args/stdin -> summary + optional score trace and
    per-range vector.

      python -m language_detector_tpu_torch.debug [--vector]
          [--plain|--html] [text ...]   (stdin if none)
    """
    import argparse
    import sys

    ap = argparse.ArgumentParser(prog="language_detector_tpu_torch.debug")
    ap.add_argument("text", nargs="*", help="text (stdin when omitted)")
    ap.add_argument("--html", action="store_true",
                    help="treat input as HTML (strip tags, expand "
                         "entities, scan lang= attributes)")
    ap.add_argument("--vector", action="store_true",
                    help="also print per-range results")
    ap.add_argument("--quiet", action="store_true",
                    help="summary line only, no trace")
    ap.add_argument("--render-html", metavar="FILE",
                    help="write the colored per-chunk HTML dump to FILE "
                         "(the kCLDFlagHtml debug render)")
    ap.add_argument("--engine-stats", action="store_true",
                    help="run the input through the batched engine "
                         "(each arg / stdin line = one document) and "
                         "print the scheduler's dispatch/tier/dedup "
                         "counters instead of a scalar trace")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the --engine-stats engine: cuda "
                         "launches the fused-tote kernel (raises without "
                         "CUDA), cpu runs its plain PyTorch version")
    ap.add_argument("--slow-traces", metavar="SRC",
                    help="pretty-print sampled slow-request span trees: "
                         "SRC is a metrics-port URL (the front's "
                         "GET /debug/slow), a JSON file, or '-' for "
                         "stdin (requires LDT_SLOW_TRACE_MS set on the "
                         "server)")
    ap.add_argument("--fleet-traces", metavar="SRC",
                    help="pretty-print the fleet-wide request-id merge: "
                         "SRC is the fleet status port's GET /tracez "
                         "URL, a JSON file, or '-' for stdin (requires "
                         "LDT_FLEET_STATUS_PORT on the fleet)")
    ap.add_argument("--slo", metavar="SRC",
                    help="pretty-print SLO targets, windowed SLIs, "
                         "budget burn rates, and alert state: SRC is a "
                         "metrics-port /sloz URL (front or fleet "
                         "status port), a JSON file, or '-' for stdin "
                         "(requires LDT_SLO set on the server)")
    ap.add_argument("--capture-summary", metavar="DIR",
                    help="summarize a traffic-capture directory tree "
                         "(LDT_CAPTURE_DIR): segment/record counts, "
                         "time span, tenant/lane/status mix")
    ap.add_argument("--eval", metavar="SRC", nargs="?", const="latest",
                    dest="eval_src",
                    help="render an accuracy scorecard: SRC is an "
                         "ACC_r*.json path, or omitted for the latest "
                         "round in the repo root (bench.py --eval)")
    ap.add_argument("--spans", action="store_true",
                    help="pretty-print per-span language verdicts for "
                         "the input text (the LDT_SPANS surface; "
                         "scalar oracle, no accelerator needed)")
    ap.add_argument("--admission", metavar="SRC",
                    help="pretty-print admission-control state "
                         "(queue occupancy, brownout level, breaker, "
                         "shed counts): SRC is a metrics-port URL (the "
                         "front's GET /debug/vars), a JSON file, or "
                         "'-' for stdin")
    args = ap.parse_args(argv)
    if args.slow_traces:
        print(format_slow_traces(_read_slow_source(args.slow_traces)))
        return 0
    if args.fleet_traces:
        print(format_fleet_traces(
            _read_slow_source(args.fleet_traces)))
        return 0
    if args.slo:
        print(format_slo(_read_slow_source(args.slo)))
        return 0
    if args.capture_summary:
        from . import capture
        print(format_capture_summary(
            capture.summarize(args.capture_summary)))
        return 0
    if args.admission:
        print(format_admission(_read_slow_source(args.admission)))
        return 0
    if args.eval_src:
        print(format_scorecard(_latest_scorecard(args.eval_src)))
        return 0
    if args.spans:
        from .engine_scalar import detect_scalar_spans
        from .tables import load_tables
        text = " ".join(args.text) if args.text else sys.stdin.read()
        tables = load_tables()
        r = detect_scalar_spans(text, tables, default_registry)
        code = default_registry.code(r.summary_lang)
        print(f"=> {code} reliable={r.is_reliable} "
              f"spans={len(r.spans or [])}")
        print(format_spans(text, r.spans or [], default_registry))
        return 0
    if args.engine_stats:
        docs = list(args.text) if args.text \
            else [ln for ln in sys.stdin.read().splitlines() if ln]
        from .models.ngram import NgramBatchEngine
        eng = NgramBatchEngine(device=args.device)
        for d, r in zip(docs, eng.detect_many(docs)):
            code = default_registry.code(r.summary_lang)
            print(f"{code:4s} {d[:60]!r}")
        print(format_engine_stats(eng.stats_snapshot()))
        return 0
    text = " ".join(args.text) if args.text else sys.stdin.read()

    tr = trace_detect(text, is_plain_text=not args.html,
                      want_chunks=args.vector)
    if args.render_html:
        from pathlib import Path
        Path(args.render_html).write_text(format_trace(tr, html=True))
        print(f"wrote {args.render_html}")
    if not args.quiet:
        print(format_trace(tr))
    r = tr.result
    reg = default_registry
    print(f"=> {reg.code(r.summary_lang)} "
          f"reliable={r.is_reliable} "
          f"top3={[(reg.code(l), p) for l, p in zip(r.language3, r.percent3)]}")
    if args.vector and r.chunks:
        for c in r.chunks:
            print(f"   [{c.offset:6d}..{c.offset + c.bytes:6d}) "
                  f"{reg.code(c.lang1)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
