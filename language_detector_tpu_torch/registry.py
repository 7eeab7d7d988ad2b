"""Language / script registry.

Wraps the registry arrays from the table artifact: the 614-entry language
enum (names, ISO-639 codes, per-script 8-bit packing, close sets, closest
statistical alternates) and the 102-entry unicode-letter-script enum
(recognition type, default language). Mirrors the data contracts of the
reference's generated_language.cc / generated_ulscript.cc / lang_script.cc.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from pathlib import Path

import numpy as np

from .tables import DATA_DIR

# Well-known language ids (generated_language.h:31-647)
ENGLISH = 0
TG_UNKNOWN_LANGUAGE = 25  # "Ignore" bucket
UNKNOWN_LANGUAGE = 26

# Recognition types per script (generated_ulscript.h:26)
RTYPE_NONE = 0
RTYPE_ONE = 1
RTYPE_MANY = 2
RTYPE_CJK = 3

# Scripts (generated_ulscript.h:30-135)
ULSCRIPT_COMMON = 0
ULSCRIPT_LATIN = 1
ULSCRIPT_HANI = 24

_DATA = DATA_DIR / "cld2_tables.npz"


@dataclasses.dataclass
class Registry:
    """Immutable registry of languages and scripts."""

    lang_name: np.ndarray        # [614] str
    lang_code: np.ndarray        # [614] str ISO-639-1/2/3 (+ -Latn variants)
    lang_cname: np.ndarray       # [614] str C enum identifiers
    lang_scripts: np.ndarray     # [614, 4] int32 ULScript ids (0=none)
    lang_to_plang: np.ndarray    # [512] uint8 per-script language number
    plang_to_lang_latn: np.ndarray   # [256] uint16
    plang_to_lang_othr: np.ndarray   # [256] uint16
    plang_close_set_latn: np.ndarray  # [256] uint8 close-set id (0=none)
    plang_close_set_othr: np.ndarray  # [256] uint8
    closest_alt_lang: np.ndarray  # [166] int32 closest statistical alternate
    ulscript_name: np.ndarray    # [102] str
    ulscript_code: np.ndarray    # [102] str 4-letter codes
    ulscript_rtype: np.ndarray   # [102] int32 RTYPE_*
    ulscript_default_lang: np.ndarray  # [102] int32 Language

    @classmethod
    def load(cls, path: Path = _DATA) -> "Registry":
        z = np.load(path, allow_pickle=False)
        return cls(**{f.name: z[f.name] for f in dataclasses.fields(cls)})

    @property
    def num_languages(self) -> int:
        return len(self.lang_name)

    @property
    def num_scripts(self) -> int:
        return len(self.ulscript_name)

    @cached_property
    def code_to_lang(self) -> dict:
        return {str(c): i for i, c in enumerate(self.lang_code)}

    def code(self, lang: int) -> str:
        """ISO code for a language id (reference LanguageCode, lang_script.h)."""
        return str(self.lang_code[lang])

    def name(self, lang: int) -> str:
        return str(self.lang_name[lang])

    def default_language(self, ulscript: int) -> int:
        """Most common language for a script (lang_script.cc:314)."""
        return int(self.ulscript_default_lang[ulscript])

    def rtype(self, ulscript: int) -> int:
        return int(self.ulscript_rtype[ulscript])

    def per_script_number(self, ulscript: int, lang: int) -> int:
        """Pack a full language into its per-script 8-bit number
        (PerScriptNumber, lang_script.cc:320-326)."""
        if ulscript < 0 or ulscript >= self.num_scripts:
            return 0
        if int(self.ulscript_rtype[ulscript]) == 0:  # RTypeNone
            return 1
        if lang < len(self.lang_to_plang):
            return int(self.lang_to_plang[lang])
        return 0

    def from_per_script_number(self, ulscript: int, pslang: int) -> int:
        """Inverse of per_script_number, script-sensitive
        (FromPerScriptNumber, lang_script.cc:328-341)."""
        if ulscript < 0 or ulscript >= self.num_scripts:
            return UNKNOWN_LANGUAGE
        if int(self.ulscript_rtype[ulscript]) in (0, 1):  # RTypeNone/One
            return int(self.ulscript_default_lang[ulscript])
        if ulscript == ULSCRIPT_LATIN:
            return int(self.plang_to_lang_latn[pslang])
        return int(self.plang_to_lang_othr[pslang])

    @cached_property
    def _close_sets(self) -> dict:
        """Statistically-close language sets (LanguageCloseSet,
        lang_script.cc:261-303): winner-take-all groups."""
        groups = [("id", "ms"), ("bo", "dz"), ("cs", "sk"), ("zu", "xh"),
                  ("bs", "hr", "sr", "sr-ME"), ("hi", "mr", "bh", "ne"),
                  ("no", "nn", "da"), ("gl", "es", "pt"), ("rw", "rn")]
        out = {}
        for gid, codes in enumerate(groups, start=1):
            for c in codes:
                if c in self.code_to_lang:
                    out[self.code_to_lang[c]] = gid
        return out

    def close_set(self, lang: int) -> int:
        """Close-set id (id/ms, bs/hr/sr, cs/sk, no/nn/da...; 0 = none)."""
        return self._close_sets.get(lang, 0)

    def closest_alt(self, lang: int) -> int:
        """Closest statistical alternate for merging unreliable languages
        (compact_lang_det_impl.cc:259-427); UNKNOWN if none/too far."""
        if lang < len(self.closest_alt_lang):
            return int(self.closest_alt_lang[lang])
        return UNKNOWN_LANGUAGE


registry = Registry.load()
