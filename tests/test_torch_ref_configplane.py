"""The reference's tests/test_configplane.py run on the port."""
from torch_refcases import adopt

CASES = adopt("configplane", globals(), exclude={})
