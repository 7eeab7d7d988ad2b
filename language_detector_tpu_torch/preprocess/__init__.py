from .segment import ScriptSpan, segment_text  # noqa: F401
from .hashing import (  # noqa: F401
    quad_hash_v2,
    octa_hash40,
    bi_hash_v2,
    pair_hash,
)
