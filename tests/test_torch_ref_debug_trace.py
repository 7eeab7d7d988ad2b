"""The reference's tests/test_debug_trace.py run on the port, engines on the
CPU."""
from torch_refcases import adopt

ADOPTED = adopt("debug_trace", globals(), replace=(
), exclude={
    'test_trace_records_pipeline':
        'held by tests/test_torch_debug.py::test_trace_records_pipeline',
    'test_trace_recursion_passes':
        'held by tests/test_torch_debug.py::test_trace_recursion_passes',
})
