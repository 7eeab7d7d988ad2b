"""CLI: python -m tools.lint_torch [--rule r1,r2] [--changed]
[--knob-table] [--write-knob-docs] [--layout-table]
[--write-layout-docs] [--write-docs]

The reference's CLI (tools/lint/__main__.py, loaded as
tools.lint_torch.refmain) over the port: the same flags, the same
suppression contract, eleven of its thirteen analyzers (LEFT_OUT names
the other two and why). ``--write-docs`` regenerates the port's doc
tables (docs/TORCH_OBSERVABILITY.md, docs/TORCH_ROBUSTNESS.md) whole.
"""
from __future__ import annotations

import sys

from . import PORT_PKG, docs, refmain

# analyzer -> why it does not run over the port
LEFT_OUT = {
    "trace-safety": "its rules (host syncs and Python branches on "
                    "traced values inside jax.jit, wires that bypass "
                    "the bucket ladder because XLA recompiles per "
                    "shape) have no object in the port: it has no jit, "
                    "and a CUDA launch compiles nothing per shape",
    "jit-contract": "its rules (reads of donated jit buffers, "
                    "recompiles from captured Python values) have no "
                    "object in the port, which has no jit and donates "
                    "no device buffer",
}

ANALYZERS = tuple(a for a in refmain.ANALYZERS if a[0] not in LEFT_OUT)
_LEFT_OUT_RULES = {rule for name, _fn, emits in refmain.ANALYZERS
                   if name in LEFT_OUT for rule in emits}

refmain.ANALYZERS = ANALYZERS
for _name in LEFT_OUT:
    refmain._SCOPED.pop(_name, None)
# the analyzers' own sources, the port's registries and its doc tables
refmain._FULL_RUN_TRIGGERS = (
    "tools/lint/",
    "tools/lint_torch/",
    f"{PORT_PKG}/knobs.py",
    f"{PORT_PKG}/faults.py",
    f"{PORT_PKG}/telemetry.py",
    f"{PORT_PKG}/flightrec.py",
    f"{PORT_PKG}/locks.py",
    docs.OBSERVABILITY_REL,
    docs.ROBUSTNESS_REL,
)


run = refmain.run


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--write-docs" in argv:
        changed = docs.write_docs()
        print(", ".join(changed) + " updated" if changed
              else "port doc tables already current")
        return 0
    for i, a in enumerate(argv):
        want = argv[i + 1] if a == "--rule" and i + 1 < len(argv) else \
            a.split("=", 1)[1] if a.startswith("--rule=") else None
        if want is None:
            continue
        gone = sorted({r.strip() for r in want.split(",")}
                      & (set(LEFT_OUT) | _LEFT_OUT_RULES))
        if gone:
            print(f"left out over the port: {', '.join(gone)}; "
                  + "; ".join(f"{n}: {why}" for n, why in
                              LEFT_OUT.items()), file=sys.stderr)
            return 2
    return refmain.main(argv)


if __name__ == "__main__":
    sys.exit(main())
