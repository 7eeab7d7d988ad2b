"""The reference's tests/test_native_epilogue.py run on the port, its
engine on the CPU."""
from torch_refcases import adopt

CASES = adopt("native_epilogue", globals(), replace=(
    ("NgramBatchEngine(ScoringTables.load(), registry)",
     'NgramBatchEngine(ScoringTables.load(), registry, device="cpu")'),
), exclude={})
