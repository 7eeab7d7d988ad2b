"""The reference's tests/test_model_check.py run against
tools.lint_torch: the bounded model checker's products (admission,
pool, supervisor, fleet, shm ring, scrub, config plane, torn writes)
explored over the port's own classes."""
from torch_refcases import adopt

CASES = adopt("model_check", globals(), exclude={})
