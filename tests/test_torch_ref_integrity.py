"""The reference's tests/test_integrity.py run on the port, engines on the
CPU."""
from torch_refcases import adopt

ADOPTED = adopt("integrity", globals(), replace=(
), exclude={
    'test_fold_parity_host_vs_device':
        'held by tests/test_torch_integrity.py::test_fold_parity_host_vs_device',
    'test_detect_quarantines_and_excludes_capacity':
        'held by tests/test_torch_integrity_monitor.py::test_detect_quarantines_and_excludes_capacity',
    'test_all_corrupt_raises_instead_of_serving':
        'held by tests/test_torch_integrity_monitor.py::test_all_corrupt_raises_instead_of_serving',
    'test_scrub_detects_heals_and_readmits':
        'held by tests/test_torch_integrity_monitor.py::test_scrub_detects_heals_and_readmits',
    'test_bad_heal_source_keeps_quarantine_and_retries':
        'held by tests/test_torch_integrity_monitor.py::test_bad_heal_source_keeps_quarantine_and_retries',
    'test_canary_mismatch_detects':
        'held by tests/test_torch_integrity_monitor.py::test_canary_mismatch_detects',
    'test_scrub_pass_contains_lane_errors':
        'held by tests/test_torch_integrity_monitor.py::test_scrub_pass_contains_lane_errors',
    'test_maybe_scrub_cadence':
        'held by tests/test_torch_integrity_monitor.py::test_maybe_scrub_cadence',
    'test_corrupt_rule_schedule_and_isolation':
        'held by tests/test_torch_integrity_monitor.py::test_corrupt_rule_schedule_and_isolation',
    'test_corrupt_tables_flips_one_plane':
        'held by tests/test_torch_integrity.py::test_corrupt_tables_flips_same_plane_and_bit',
})
