"""Scoring-table artifact: the model weights of the n-gram detector.

Holds the 4-way-associative hash tables (buckets + indirect langprob arrays)
and auxiliary decode tables, loaded from the compressed npz artifact built by
tools/extract_tables. Mirrors the reference's ScoringTables bundle
(scoreonescriptspan.h:100-114) and CLD2TableSummary (cld2tablesummary.h:37-49),
re-laid-out as flat numpy arrays so they can be uploaded once to TPU HBM and
probed with vectorized gathers.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

# The shipped table artifact lives in the reference package's data
# directory; the port reads it by path and keeps no copy of its own.
DATA_DIR = Path(__file__).resolve().parent.parent / \
    "language_detector_tpu" / "data"
_DATA = DATA_DIR / "cld2_tables.npz"


@dataclasses.dataclass
class NgramTable:
    """One 4-way-associative <gram-fingerprint, langprobs> hash table."""

    buckets: np.ndarray    # [size, 4] uint32: key | indirect-subscript
    ind: np.ndarray        # [n] uint32 packed langprobs
    size_one: int          # indirect subscripts >= this decode to 2 entries
    size: int              # bucket count (power of two)
    keymask: int           # upper-bit mask selecting the stored key
    build_date: int
    langscripts: str       # recognized "en-Latn az-Arab ..." list

    @classmethod
    def from_npz(cls, z, prefix: str) -> "NgramTable":
        meta = z[f"{prefix}_meta"]
        return cls(
            buckets=z[f"{prefix}_buckets"],
            ind=z[f"{prefix}_ind"],
            size_one=int(meta[0]),
            size=int(meta[1]),
            keymask=int(meta[2]),
            build_date=int(meta[3]),
            langscripts=str(z[f"{prefix}_langscripts"]),
        )

    @property
    def empty(self) -> bool:
        return self.size <= 1


def _empty_table() -> NgramTable:
    return NgramTable(
        buckets=np.zeros((1, 4), dtype=np.uint32),
        ind=np.zeros(2, dtype=np.uint32),
        size_one=1, size=1, keymask=0xFFFFF000, build_date=0, langscripts="")


@dataclasses.dataclass
class ScoringTables:
    """Full weight bundle for the n-gram scorer."""

    quadgram: NgramTable          # primary quadgram table (RTypeMany base)
    quadgram2: NgramTable         # dual quadgram table (may be empty)
    deltaocta: NgramTable         # word (octagram) delta scores
    distinctocta: NgramTable      # distinctive words + word pairs
    cjkdeltabi: NgramTable        # CJK bigram delta scores
    distinctbi: NgramTable        # CJK distinct bigrams (empty in snapshot)
    cjkcompat: NgramTable         # CJK compat classes -> langprobs
    cjk_uni_prop: np.ndarray      # [0x110000] uint8 codepoint -> compat class
    avg_delta_octa_score: np.ndarray  # [614, 4] int16 expected score/KB
    lg_prob: np.ndarray           # [240, 8] uint8 quantized log-prob decode
    script_of_cp: np.ndarray      # [0x110000] uint8 letter -> ULScript (0=not)
    lower_pairs: np.ndarray       # [n, 2] uint32 (cp, lowercase cp)
    interchange_ok: np.ndarray    # [0x110000] uint8 interchange-valid flag
    entity_names: np.ndarray      # [265] str HTML entity names (sorted)
    entity_values: np.ndarray     # [265] int32 entity codepoints
    # Hint lookup tables (compact_lang_det_hint_code.cc:102-940 data)
    langtag1_keys: np.ndarray     # [213] str long lang= tags
    langtag1_prior1: np.ndarray   # [213] int32 packed OneCLDLangPrior
    langtag1_prior2: np.ndarray
    langtag2_keys: np.ndarray     # [257] str short lang codes
    langtag2_prior1: np.ndarray
    langtag2_prior2: np.ndarray
    tld_hint_keys: np.ndarray     # [181] str TLDs
    tld_hint_prior1: np.ndarray
    tld_hint_prior2: np.ndarray
    encoding_names: np.ndarray    # [76] str Encoding enum names, in order

    @classmethod
    def load(cls, path: Path = _DATA,
             quad_path: Path | None | bool = None) -> "ScoringTables":
        """Load the table bundle.

        quad_path: None = auto-discover data/quad_tables.npz;
        False = explicitly disable quadgram tables (reference-snapshot
        parity mode); a Path = load that file."""
        if quad_path is True:
            raise ValueError("quad_path must be a Path, None (auto-discover) "
                             "or False (disable)")
        z = np.load(path, allow_pickle=False)
        discovery_miss = False
        if quad_path is None:
            qp = DATA_DIR / "quad_tables.npz"
            quad_path = qp if qp.exists() else False
            discovery_miss = quad_path is False
        if quad_path is not False:
            qz = np.load(quad_path, allow_pickle=False)
        else:
            qz = None
        return cls._build(z, qz, quad_warning=(
            "quad_tables.npz not found: quadgram scoring disabled, "
            "so most Latin/Cyrillic/Greek-script languages will "
            "detect as unknown. Build it with `python -m "
            "language_detector_tpu_torch.tools.train_quad_tables`.")
            if discovery_miss else None)

    @classmethod
    def load_mmap(cls, path: Path) -> "ScoringTables":
        """Load from the single-file mmap artifact (artifact.py): every
        array is a zero-copy view over one shared mapping — the serving
        load path (the npz pair remains the interchange format). Arrays
        are namespaced "c/<name>" (cld2 tables) and "q/<name>" (quad
        tables; absent when the artifact was packed without them)."""
        from .artifact import load_artifact
        arrays = load_artifact(path)
        z = {k[2:]: v for k, v in arrays.items() if k.startswith("c/")}
        qz = {k[2:]: v for k, v in arrays.items() if k.startswith("q/")}
        st = cls._build(z, qz or None, quad_warning=None if qz else (
            f"{path} was packed without quad tables: quadgram scoring "
            "disabled, so most Latin/Cyrillic/Greek-script languages "
            "will detect as unknown. Re-pack with `python -m "
            "language_detector_tpu_torch.tools.artifact_tool --pack "
            "--data DIR --out DIR`, DIR holding cld2_tables.npz and the "
            "trained quad_tables.npz."))
        # integrity identity: the artifact's digest-footer fingerprint
        # (None for a legacy footerless pack) names the serving
        # generation — result-cache epochs and /debug/vars use it
        from .artifact import artifact_digest
        st.artifact_digest = artifact_digest(path)
        # golden-canary pack baked at artifact build time (the g/
        # arrays, written by artifact_tool --pack): pinned docs and their
        # expected codes for integrity.py's per-lane canary check
        gd, go = arrays.get("g/docs_u8"), arrays.get("g/docs_off")
        cd, co = arrays.get("g/codes_u8"), arrays.get("g/codes_off")
        if gd is not None and go is not None and cd is not None \
                and co is not None:
            st.canary_docs = tuple(
                bytes(gd[go[i]:go[i + 1]]).decode("utf-8")
                for i in range(len(go) - 1))
            st.canary_codes = tuple(
                bytes(cd[co[i]:co[i + 1]]).decode("ascii")
                for i in range(len(co) - 1))
        return st

    @classmethod
    def _build(cls, z, qz, quad_warning: str | None = None
               ) -> "ScoringTables":
        """Shared constructor over mapping-like table sources (npz files
        or mmap-artifact views). quad_warning is emitted when qz is None
        (source-specific remediation advice)."""
        expected_override = None
        if qz is not None:
            quad = NgramTable.from_npz(qz, "quadgram")
            qz_files = getattr(qz, "files", qz)
            quad2 = (NgramTable.from_npz(qz, "quadgram2")
                     if "quadgram2_meta" in qz_files else _empty_table())
            if "expected_score_override" in qz_files:
                # Trained tables carry their own expected-score calibration
                # (the reference regenerates kAvgDeltaOctaScore per table
                # build via cld2_do_score.cc; zero = "no data yet" => the
                # delta reliability model governs, cldutil.cc:588).
                expected_override = qz["expected_score_override"]
        else:
            if quad_warning:
                import warnings
                warnings.warn(quad_warning, stacklevel=2)
            quad, quad2 = _empty_table(), _empty_table()
        expected = z["avg_delta_octa_score"] if expected_override is None \
            else expected_override
        return cls(
            quadgram=quad,
            quadgram2=quad2,
            deltaocta=NgramTable.from_npz(z, "deltaocta"),
            distinctocta=NgramTable.from_npz(z, "distinctocta"),
            cjkdeltabi=NgramTable.from_npz(z, "cjkdeltabi"),
            distinctbi=NgramTable.from_npz(z, "distinctbi"),
            cjkcompat=NgramTable.from_npz(z, "cjkcompat"),
            cjk_uni_prop=z["cjk_uni_prop"],
            avg_delta_octa_score=expected,
            lg_prob=z["lg_prob_v2"],
            script_of_cp=z["script_of_cp"],
            lower_pairs=z["lower_pairs"],
            interchange_ok=z["interchange_ok"],
            entity_names=z["entity_names"],
            entity_values=z["entity_values"],
            **{k: z[k] for k in (
                "langtag1_keys", "langtag1_prior1", "langtag1_prior2",
                "langtag2_keys", "langtag2_prior1", "langtag2_prior2",
                "tld_hint_keys", "tld_hint_prior1", "tld_hint_prior2",
                "encoding_names")},
        )


_tables_cache: dict = {}


def load_tables(path: Path = _DATA) -> ScoringTables:
    """Default table loading: the single-file mmap artifact
    (data/model.ldta, zero-copy) when present next to the npz bundle,
    else the npz pair; both sources are bit-identical
    (test_artifact_mmap). The port never rewrites the shipped pack:
    `python -m language_detector_tpu_torch.tools.artifact_tool --pack
    --data DIR --out DIR` packs a tree of its own into DIR/model.ldta,
    which ScoringTables.load_mmap loads and a front's POST /swap
    serves.

    The chosen source is logged once, and a stale shipped artifact (npz
    bundle newer than the packed file) logs a warning at load time
    rather than waiting for the artifact verify of ci_torch.sh to
    notice the drift."""
    import logging
    key = str(path)
    if key not in _tables_cache:
        log = logging.getLogger(__name__)
        ldta = Path(path).parent / "model.ldta"
        if str(path) == str(_DATA) and ldta.exists():
            npz_mtime = 0.0
            for src in (Path(path),
                        Path(path).parent / "quad_tables.npz"):
                try:
                    npz_mtime = max(npz_mtime, src.stat().st_mtime)
                except OSError:
                    pass  # optional bundle absent (quadgram disabled)
            try:
                ldta_mtime = ldta.stat().st_mtime
            except OSError:
                # concurrent delete/replace between exists() and stat():
                # the staleness warning is informational only and must
                # never fail table loading (load_mmap below re-raises if
                # the file is truly gone)
                ldta_mtime = None
            if ldta_mtime is not None and npz_mtime > ldta_mtime:
                log.warning(
                    "serving tables from %s but the npz bundle beside "
                    "it is newer; the port never rewrites this shipped "
                    "pack (check content drift with `python -m "
                    "language_detector_tpu_torch.tools.artifact_tool "
                    "--verify` or ci_torch.sh; serve retrained tables "
                    "from a pack of their own: `... artifact_tool --pack "
                    "--data DIR --out DIR`)", ldta)
            else:
                log.info("loading tables from %s (mmap artifact)", ldta)
            _tables_cache[key] = ScoringTables.load_mmap(ldta)
        else:
            log.info("loading tables from %s (npz bundle)", path)
            _tables_cache[key] = ScoringTables.load(path)
    return _tables_cache[key]
