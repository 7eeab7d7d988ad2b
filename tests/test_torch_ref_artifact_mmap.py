"""The reference's tests/test_artifact_mmap.py run on the port."""
from torch_refcases import adopt

CASES = adopt("artifact_mmap", globals(), exclude={})
