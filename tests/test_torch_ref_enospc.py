"""The reference's tests/test_enospc.py run on the port.

The two AOT export cases drive the reference's bundle with a stand-in
jitted function over `aot._SpecView` wire specs, objects the port's
bundle (one kernel library per entry, no jit) does not have; the port's
copies are tests/test_torch_aot.py::test_export_enospc_sticky_disable
and ::test_export_seam_error_not_sticky. Their module-level wire spec is
therefore replaced by None, and build_from_env is called with the
port's signature (tables first, no kernel-mode positional)."""
from torch_refcases import adopt

_JIT_EXPORT = ("; it drives a JAX jitted function's lowering over "
               "aot._SpecView wire specs, and the port's bundle exports a "
               "built kernel library")

CASES = adopt("enospc", globals(), replace=(
    ('_WIRE = {"x": aot._SpecView((4,), "float32")}', "_WIRE = None"),
    ('aot.build_from_env("vector", dt=None)', "aot.build_from_env(None)"),
), exclude={
    "test_aot_export_enospc_sticky_disable":
        "held by tests/test_torch_aot.py::"
        "test_export_enospc_sticky_disable" + _JIT_EXPORT,
    "test_aot_export_other_failure_not_sticky":
        "held by tests/test_torch_aot.py::"
        "test_export_seam_error_not_sticky" + _JIT_EXPORT,
})
