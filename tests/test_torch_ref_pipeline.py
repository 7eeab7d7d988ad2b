"""The reference's tests/test_pipeline.py run on the port, engines on the
CPU.

`_engine` builds the port's engine with the reference's long-doc lane
default (`longdoc_chunk_slots=1024`, the reference's
LDT_LONGDOC_CHUNK_SLOTS): the port's engine keeps the lane off unless
asked (ROADMAP C2), and the cases that pin the lane's merge need it on.
A case's own `longdoc_chunk_slots` still wins. The cases the port
already holds under their own names in tests/test_torch_scheduler.py
are not run twice."""
from torch_refcases import adopt

ADOPTED = adopt("pipeline", globals(), replace=(
    ("        return NgramBatchEngine(**kw)",
     '        return NgramBatchEngine(**{"device": "cpu",\n'
     '                                   "longdoc_chunk_slots": 1024, '
     '**kw})'),
), exclude={
    'test_device_flush_error_retires_dispatch':
        'held by tests/test_torch_scheduler.py::test_device_flush_error_retires_dispatch',
    'test_longdoc_chunk_merge_exact_vs_scalar':
        'held by tests/test_torch_scheduler.py::test_longdoc_chunk_merge_exact_vs_scalar',
    'test_longdoc_lane_off_still_exact':
        'held by tests/test_torch_scheduler.py::test_longdoc_lane_off_still_exact',
    'test_longdoc_default_threshold_takes_fat_tail':
        'held by tests/test_torch_scheduler.py::test_longdoc_default_threshold_takes_fat_tail',
})
