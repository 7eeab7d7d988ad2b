"""The reference's tests/test_swap.py run on the port, device services
on the CPU."""
from torch_refcases import adopt

ADOPTED = adopt("swap", globals(), replace=(
    ("DetectorService(use_device=True, max_delay_ms=1.0,",
     'DetectorService(use_device=True, device="cpu", max_delay_ms=1.0,'),
), exclude={
    "test_compile_cache_dir_knob":
        "held by tests/test_torch_aot.py::test_compile_cache_dir_knob",
})
