"""The reference's tests/test_c_abi.py run on the port."""
from torch_refcases import adopt

CASES = adopt("c_abi", globals(), replace=(
    ("NgramBatchEngine()", 'NgramBatchEngine(device="cpu")'),
), exclude={})
