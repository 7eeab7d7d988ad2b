"""The reference's tests/test_batch_agreement.py run on the port, the
engine on the CPU. The cases built from the CLD2 golden suite (the
reference snapshot's unittest_data.h, absent on both hosts) are left
out; the port's batched engine is held to the JAX engine's on the
chip_smoke.py mix by tests/test_torch_scheduler.py and
tests/test_torch_engine.py."""
from torch_refcases import adopt

_GOLDEN = ("left out: oracle: its documents are the CLD2 golden suite "
           "(tests/golden_data.py reads the reference snapshot)")

ADOPTED = adopt("batch_agreement", globals(), replace=(
    ("NgramBatchEngine()", 'NgramBatchEngine(device="cpu")'),
), exclude={name: _GOLDEN for name in (
    "test_golden_agreement", "test_random_mixed_script_agreement",
    "test_gate_failure_recursion_agreement", "test_chunk_level_parity",
    "test_detect_many_matches_detect_batch",
    "test_fuzz_mixed_traffic_agreement", "test_hinted_detection_agreement",
    "test_html_detection_agreement", "test_fuzz_multi_slice_deferred_retry")})
