"""Generate the service's ISO-639 code -> English name map.

The port of the reference package's tools/gen_service_codes.py, over the
port's registry. It mirrors the reference service's data/gen_codes.py
pipeline (which capitalized the uppercase CLD2 language-name table into
data/cld_codes.json, 164 entries): walk the registry's (code, name)
pairs, keep codes the service should answer with, capitalize names, and
fail on conflicting names per code. The file is byte for byte the
shipped language_detector_tpu/service/cld_codes.json, which the port's
fronts read by path.

Departure from the reference script: --out defaults to
build/torch_tables/cld_codes.json under the checkout, never the shipped
file.

Usage:
  python -m language_detector_tpu_torch.tools.gen_service_codes [--out PATH]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..registry import registry

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "build" / "torch_tables" / "cld_codes.json"


def service_codes() -> dict:
    """{code: capitalized English name} for every code the service
    answers with."""
    langs: dict = {}
    for lang in range(registry.num_languages):
        code = registry.code(lang)
        name = registry.name(lang)
        if not code or code in ("un", "xxx", "none"):
            continue
        # the reference maps both Chinese variants to "Chinese"
        # (data/cld_codes.json zh / zh-Hant rows), and used the older
        # table's names for two codes our newer registry renames
        if code == "zh-Hant":
            name = "Chinese"
        elif code == "ny":
            name = "Chichewa"
        elif code == "tlh":
            name = "Klingon"
        pretty = name.capitalize()
        if code in langs and langs[code] != pretty:
            raise SystemExit(f"conflicting names for {code}: "
                             f"{langs[code]} vs {pretty}")
        langs[code] = pretty
    return langs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(OUT))
    out = Path(ap.parse_args(argv).out)
    langs = service_codes()
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(langs, indent=4, separators=(",", ": "),
                              sort_keys=True) + "\n")
    print(f"wrote {out} ({len(langs)} codes)")


if __name__ == "__main__":
    main()
