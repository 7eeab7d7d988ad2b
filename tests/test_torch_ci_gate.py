"""Static checks of ci_torch.sh, the port's one-command gate: it parses
as bash, every `echo "== ... =="` stage of ci.sh (the JAX package's
gate) has a stage of the same name in it that runs something or states
why it is left out, and every test node id it names is one pytest
collects."""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
STAGE = re.compile(r'^echo "== (.+) =="$', re.M)
NODE = re.compile(r"\btests/test_\w+\.py(?:::\w+)?")


def _stages(path: Path) -> dict:
    """{stage name: the script's lines up to the next stage}."""
    src = path.read_text()
    marks = list(STAGE.finditer(src))
    return {m.group(1): src[m.end():marks[i + 1].start()
                            if i + 1 < len(marks) else len(src)]
            for i, m in enumerate(marks)}


def test_ci_torch_parses_as_bash():
    r = subprocess.run(["bash", "-n", str(REPO / "ci_torch.sh")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_every_reference_stage_has_a_counterpart():
    ref = _stages(REPO / "ci.sh")
    port = _stages(REPO / "ci_torch.sh")
    assert len(ref) == 22
    assert list(port) == list(ref), sorted(set(ref) ^ set(port))
    for name, body in port.items():
        lines = [ln.strip() for ln in body.splitlines() if ln.strip()]
        commands = [ln for ln in lines if not ln.startswith("#")]
        assert commands or "left out" in body, \
            f"stage {name!r} neither runs anything nor gives a reason"


def test_named_tests_are_collected():
    ids = sorted(set(NODE.findall((REPO / "ci_torch.sh").read_text())))
    assert len(ids) > 40
    for node in ids:
        assert (REPO / node.split("::")[0]).is_file(), node
    named = [n for n in ids if "::" in n]
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", "-p", "no:randomly", *named],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    collected = {ln.split("[")[0] for ln in r.stdout.splitlines()
                 if "::" in ln}
    missing = [n for n in named if n not in collected]
    assert not missing, missing
