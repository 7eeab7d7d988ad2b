"""The reference's tests/test_bucket_scheduler.py run on the port, engines on the
CPU."""
from torch_refcases import adopt

ADOPTED = adopt("bucket_scheduler", globals(), replace=(
), exclude={
    'test_tier_ladder_boundaries':
        'held by tests/test_torch_scheduler.py::test_tier_ladder_boundaries',
    'test_bucket_boundary_parity':
        'held by tests/test_torch_scheduler.py::test_bucket_boundary_parity',
    'test_undersized_lanes_coalesce_upward':
        'held by tests/test_torch_scheduler.py::test_undersized_lanes_coalesce_upward',
    'test_retry_lane_parity':
        'held by tests/test_torch_scheduler.py::test_retry_lane_parity',
    'test_dedup_parity_and_stats':
        'held by tests/test_torch_scheduler.py::test_dedup_parity_and_stats',
    'test_single_flush_fast_path':
        'held by tests/test_torch_scheduler.py::test_single_flush_fast_path',
    'test_gc_paused_forces_periodic_collect':
        'held by tests/test_torch_scheduler.py::test_gc_paused_forces_periodic_collect',
})
