"""The reference's chaos suite (tests/test_faults.py) run on the port.

Engines and device services are built on the CPU (`device="cpu"`); the
port's own default is the card. The port's device service answers a
503 while its breaker is open, where the reference serves the scalar
engine (ROADMAP C2): the storm cases that expect those 200s are left
out (the port's copy is tests/test_torch_service.py::
test_breaker_storm_opens_then_halfopen_recovers), and the
probabilistic storm also takes a 503 as a resolved request."""
from torch_refcases import adopt

_OPEN_BREAKER = ("the open breaker answers 503 on the port, where the "
                 "reference serves exact 200s on the scalar engine "
                 "(ROADMAP C2); the port's copy is tests/"
                 "test_torch_service.py::test_breaker_storm_opens_then_"
                 "halfopen_recovers")

CASES = adopt("faults", globals(), replace=(
    ("NgramBatchEngine()", 'NgramBatchEngine(device="cpu")'),
    ("DetectorService(use_device=True,",
     'DetectorService(use_device=True, device="cpu",'),
    # the probabilistic storm may open the breaker: 503 there (C2)
    ("        assert status in (200, 500)\n        if status == 200:",
     "        assert status in (200, 500, 503)\n        if status == 200:"),
), exclude={
    "test_sync_breaker_storm_opens_then_halfopen_recovers": _OPEN_BREAKER,
    "test_aio_breaker_storm_opens_then_halfopen_recovers": _OPEN_BREAKER,
    "test_compile_delay_does_not_corrupt_results":
        "the compile seam is the kernel library's first load "
        "(ops/kernels._load), which only a CUDA engine reaches; the "
        "card runs it as tests/test_torch_cuda.py::"
        "test_compile_seam_fires_once_and_keeps_words",
})
