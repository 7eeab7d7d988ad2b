"""The port's generated doc tables: docs/TORCH_OBSERVABILITY.md (knobs,
metrics, flight-recorder events, binary layouts) and
docs/TORCH_ROBUSTNESS.md (fault points).

The reference keeps these tables in docs/OBSERVABILITY.md and
docs/ROBUSTNESS.md, which predate the port; the drift rules of the
reference's analyzers, loaded through tools.lint_torch, compare the
port's registries against the two files here instead. Every table is
generated from the port's own declarations (telemetry.METRICS,
flightrec.EVENTS, faults.FAULT_POINTS read by AST, knobs.doc_table(),
the layout registry), so ``write_docs`` rebuilds both files whole; it
writes the knob and layout blocks as --write-knob-docs and
--write-layout-docs do, and the tables those flags have no writer for.
It is a writer only: the drift rules are the one check that the files
are current.
"""
from __future__ import annotations

import ast
from pathlib import Path

from . import PORT_PKG, knob_registry, layout_registry
from .base import repo_root

OBSERVABILITY_REL = "docs/TORCH_OBSERVABILITY.md"
ROBUSTNESS_REL = "docs/TORCH_ROBUSTNESS.md"


def _registry(root: Path, rel: str, name: str) -> dict:
    """The literal dict assigned to `name` at the top of a port module."""
    tree = ast.parse((root / rel).read_text())
    for node in tree.body:
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target] if isinstance(node, ast.AnnAssign) else []
        if any(isinstance(t, ast.Name) and t.id == name for t in targets):
            return ast.literal_eval(node.value)
    raise LookupError(f"{rel} declares no {name}")


def _cell(text: str) -> str:
    return " ".join(text.split()).replace("|", "\\|")


def metric_table(root: Path) -> str:
    rows = ["| Series | Type | Meaning |", "| --- | --- | --- |"]
    for name, (kind, help_) in _registry(
            root, f"{PORT_PKG}/telemetry.py", "METRICS").items():
        rows.append(f"| `{name}` | {kind} | {_cell(help_)} |")
    return "\n".join(rows)


def event_table(root: Path) -> str:
    rows = ["| event | category | meaning |", "|---|---|---|"]
    for name, (cat, meaning) in _registry(
            root, f"{PORT_PKG}/flightrec.py", "EVENTS").items():
        rows.append(f"| `{name}` | {cat} | {_cell(meaning)} |")
    return "\n".join(rows)


def fault_table(root: Path) -> str:
    rows = ["| Point | Seam, and what an injected rule models |",
            "| --- | --- |"]
    for name, where in _registry(
            root, f"{PORT_PKG}/faults.py", "FAULT_POINTS").items():
        rows.append(f"| `{name}` | {_cell(where)} |")
    return "\n".join(rows)


def _block(tag: str, table: str) -> str:
    return (f"<!-- ldt-{tag}-table:begin -->\n{table.strip()}\n"
            f"<!-- ldt-{tag}-table:end -->")


def observability_text(root: Path) -> str:
    return f"""# Observability contract of the PyTorch/CUDA port

Generated by `python -m tools.lint_torch --write-docs` from the
declarations in `{PORT_PKG}/`; do not edit by hand. The
drift rules of `python -m tools.lint_torch` (metric-undocumented,
event-undocumented, knob-docs-drift, layout-drift) hold the port's
registries to these tables. Prose on each series, event, knob and
layout is the reference's, in docs/OBSERVABILITY.md.

## Exported series

{_block("metric", metric_table(root))}

## Flight-recorder events

{_block("event", event_table(root))}

## Env knobs

{_block("knob", knob_registry.generated_table(root))}

## Binary layouts

{_block("layout", layout_registry.generated_table(root))}
"""


def robustness_text(root: Path) -> str:
    return f"""# Fault points of the PyTorch/CUDA port

Generated by `python -m tools.lint_torch --write-docs` from
`{PORT_PKG}/faults.py`'s FAULT_POINTS; do not edit by hand.
The fault-registry rule of `python -m tools.lint_torch` holds the
declaration, its seams and this table to each other. The LDT_FAULTS
grammar and the recovery invariants are the reference's, in
docs/ROBUSTNESS.md.

## Fault points

{_block("fault", fault_table(root))}
"""


def write_docs(root: Path | None = None) -> list:
    """Rebuild both files; returns the repo-relative paths that
    changed."""
    root = root or repo_root()
    changed = []
    for rel, text in ((OBSERVABILITY_REL, observability_text(root)),
                      (ROBUSTNESS_REL, robustness_text(root))):
        path = root / rel
        if not path.exists() or path.read_text() != text:
            path.write_text(text)
            changed.append(rel)
    return changed
