"""The reference's tests/test_native_pack.py run on the port."""
from torch_refcases import adopt

CASES = adopt("native_pack", globals(), exclude={})
