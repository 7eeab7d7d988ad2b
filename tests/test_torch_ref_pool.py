"""The reference's tests/test_pool.py run on the port, engines on the
CPU."""
from torch_refcases import adopt

ADOPTED = adopt("pool", globals(), replace=(
    ('NgramBatchEngine()',
     'NgramBatchEngine(device="cpu")'),
), exclude={
    'test_round_robin_rotation':
        'held by tests/test_torch_pool.py::test_round_robin_rotation',
    'test_result_memoized_fetch_runs_exactly_once':
        'held by tests/test_torch_pool.py::test_result_memoized_fetch_runs_exactly_once',
    'test_exhausted_budget_raises_typed_with_cause':
        'held by tests/test_torch_pool.py::test_exhausted_budget_raises_typed_with_cause',
    'test_lane_ewma_and_p95':
        'held by tests/test_torch_pool.py::test_lane_ewma_and_p95',
    'test_lane_eviction_probe_cycle_with_fake_clock':
        'held by tests/test_torch_pool.py::test_lane_eviction_probe_cycle_with_fake_clock',
    'test_fully_evicted_pool_still_dispatches':
        'held by tests/test_torch_pool.py::test_fully_evicted_pool_still_dispatches',
    'test_build_from_env_off_by_default':
        'held by tests/test_torch_pool_engine.py::test_build_from_env_off_by_default',
    'test_build_from_env_simulated_lanes':
        'held by tests/test_torch_pool_engine.py::test_build_from_env_simulated_lanes',
    'test_flush_workers_widen_with_pool':
        'held by tests/test_torch_pool_engine.py::test_flush_workers_widen_with_pool',
})
