"""The reference's tests/test_admission.py run on the port, engines on
the CPU.

test_engine_near_deadline_sets_no_retry gives its near-deadline trace a
spent budget (0 ms) where the reference gives 1 ms: the case needs the
budget under two expected flushes, and the port's CPU dispatch stage
(the plain scorer's p95, about 0.3 ms) puts two flushes under 1 ms,
where XLA's on the CPU does not."""
from torch_refcases import adopt

CASES = adopt("admission", globals(), replace=(
    ("NgramBatchEngine()", 'NgramBatchEngine(device="cpu")'),
    ("tr.deadline = Deadline(1)  # ~expired",
     "tr.deadline = Deadline(0)  # expired"),
), exclude={})
