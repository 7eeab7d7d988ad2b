"""The reference's tests/test_recycle.py run on the port.

The port's fronts serve on the card and raise without one, so the
front cases start the CPU test modules instead of the fronts' own
module entries: tests/torch_cpu_threaded_front.py (the port's
`server.main()`) and tests/torch_cpu_front.py (the port's
`aioserver.serve()`), each over DetectorService(device="cpu"). Started
as the fronts themselves, each case would wait out its 120 s port-read
deadline on a child that exited at once.

The in-flight cases need the first flush still on the scorer when the
second request connects 50 ms later; the port's CPU flush of 100 short
documents can finish sooner, and the watcher then stops the accept loop
before the second request is taken (a reset, in one of four runs here).
Their fronts get LDT_FAULTS="scorer_launch:delay_ms=300", so every
launch outlasts that gap, as the reference's XLA launches do."""
from torch_refcases import adopt

CASES = adopt("recycle", globals(), replace=(
    ('"-m", "language_detector_tpu_torch.service.server"]',
     '"-m", "tests.torch_cpu_threaded_front"]'),
    ('f"language_detector_tpu_torch.service.{module}"',
     '{"server": "tests.torch_cpu_threaded_front",\n'
     '          "aioserver": "tests.torch_cpu_front"}[module]'),
    ('         "language_detector_tpu_torch.service.aioserver"],',
     '         "tests.torch_cpu_front"],'),
    ('_spawn_front(module, {"LDT_MAX_DISPATCHES": "1",',
     '_spawn_front(module, {"LDT_MAX_DISPATCHES": "1",\n'
     '                                    "LDT_FAULTS": '
     '"scorer_launch:delay_ms=300",'),
), exclude={})
