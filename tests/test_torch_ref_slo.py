"""The reference's tests/test_slo.py run on the port."""
from torch_refcases import adopt

CASES = adopt("slo", globals(), exclude={})
