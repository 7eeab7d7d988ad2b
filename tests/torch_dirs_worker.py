"""tests/fake_worker.py, also printing the LDT_AOT_DIR it was handed.

The port's supervisor and fleet hand every generation and member one
compile-cache dir (LDT_COMPILE_CACHE_DIR, which fake_worker prints as
fake_worker_cache_dir) and one kernel-library bundle dir (LDT_AOT_DIR,
printed here as fake_worker_aot_dir); tests/test_torch_supervisor.py
and tests/test_torch_fleet.py run this module as the supervised worker
to read both. Every fake_worker mode works unchanged.
"""
from __future__ import annotations

import json
import os
import sys

from tests import fake_worker


def main() -> int:
    print(json.dumps({"fake_worker_aot_dir":
                      os.environ.get("LDT_AOT_DIR", "unset")}),
          flush=True)
    return fake_worker.main()


if __name__ == "__main__":
    sys.exit(main())
