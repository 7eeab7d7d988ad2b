"""The reference's tests/test_telemetry.py run on the port, engines and
the device service on the CPU.

test_metrics_endpoint_lint_and_series drops its last assertion (an XLA
compile counted by a CPU engine): the port's ldt_xla_compiles_total
counts the kernel library's first load in a process, which only a CUDA
engine makes."""
from torch_refcases import adopt

CASES = adopt("telemetry", globals(), replace=(
    ("NgramBatchEngine()", 'NgramBatchEngine(device="cpu")'),
    ("DetectorService(use_device=True,",
     'DetectorService(use_device=True, device="cpu",'),
    ('    assert sum(by_series.get("ldt_xla_compiles_total", [0])) > 0\n',
     ""),
), exclude={
    "test_compile_counter_two_shapes":
        "it counts XLA compiles per padded wire shape; the port compiles "
        "nothing per shape, and its ldt_xla_compiles_total counts the "
        "kernel library's first load in a process, which a CPU engine "
        "never makes (tests/test_torch_repairs.py holds that count)",
})
