"""The reference's tests/test_locks.py run on the port."""
from torch_refcases import adopt

CASES = adopt("locks", globals(), exclude={})
