"""The reference's tests/test_artifact_verify.py run beside the port.

The cases check tools/artifact_tool.py, which imports no package, on
the checked-in tables the port reads by path (language_detector_tpu/
data/): they hold the data the port scores with, not port code."""
from torch_refcases import adopt

CASES = adopt("artifact_verify", globals(), exclude={})
