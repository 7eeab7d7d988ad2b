"""language_detector_tpu_torch — the language detector on PyTorch and CUDA.

The port of language_detector_tpu (JAX/TPU) to an NVIDIA H100. The host
side (native C++ packer and epilogue, scalar engine, tables) is the
reference package's own code, copied; the device step that scores the
chunk grid is a hand-written CUDA kernel (csrc/fused_tote.cu). Entry
points run on the card unless the caller passes device="cpu", which
scores with the plain PyTorch version (ops/score.py).

Public API:
    detect(text)                 -> DetectionResult (top-3 + reliability)
    detect_batch(texts)          -> list[DetectionResult]
    LanguageDetector             -> configurable detector object (also
                                    detect_spans, detect_bytes)
    CLDHints                     -> detection hints
    detect_language_version()    -> code and table version string
    load_tables() / ScoringTables
"""

from .registry import (  # noqa: F401
    Registry,
    registry,
    UNKNOWN_LANGUAGE,
    TG_UNKNOWN_LANGUAGE,
    ENGLISH,
)
from .tables import ScoringTables, load_tables  # noqa: F401
from .detector import (LanguageDetector, DetectionResult, detect,  # noqa: F401
                       detect_batch, detect_language_version)
from .hints import CLDHints  # noqa: F401

__version__ = "0.4.0"
