"""The packer's table gate never waits on a build of the library.

Every entry point of language_detector_tpu_torch/native loads the
library (`_load`, which builds it when it is missing or stale) before it
enters `_TableGate.reading`, so `_install`, the one caller of `_load`
under the gate, always finds it loaded: no install holds the gate
(native.table_gate) across a compiler run. In a fresh process, four
threads pack with two table pairs at once, then `ensure_init` installs
one again; every install must see the library loaded and no reader in
it.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

CHILD = r'''
import threading
from language_detector_tpu_torch import native
from language_detector_tpu_torch.registry import registry
from language_detector_tpu_torch.tables import ScoringTables, load_tables

assert native._lib is None, "the library is loaded before any entry point"
seen = []
install = native._install


def watched(tables, reg):
    seen.append((native._lib is not None, native._gate._readers))
    return install(tables, reg)


native._install = watched
pairs = [load_tables(), ScoringTables.load(quad_path=False)]


def run(i):
    for _ in range(3):
        native.pack_chunks_native(["hello world", "bonjour le monde"],
                                  pairs[i % 2], registry)


threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
for t in threads:
    t.start()
for t in threads:
    t.join()
native.ensure_init(pairs[0], registry)
assert len(seen) >= 3, seen
assert all(loaded and readers == 0 for loaded, readers in seen), seen
print("installs", len(seen))
'''


def test_no_install_loads_the_library():
    r = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("installs ")
