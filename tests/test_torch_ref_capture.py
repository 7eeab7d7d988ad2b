"""The reference's tests/test_capture.py run on the port."""
from torch_refcases import adopt

CASES = adopt("capture", globals(), exclude={})
