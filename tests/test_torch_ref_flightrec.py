"""The reference's tests/test_flightrec.py run on the port."""
from torch_refcases import adopt

CASES = adopt("flightrec", globals(), exclude={})
