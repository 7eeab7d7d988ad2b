"""The reference's tests/test_artifact_verify.py run on the port's tool.

The cases checked tools/artifact_tool.py, the reference package's tool,
which imports language_detector_tpu (its --verify loads model.ldta
through language_detector_tpu.artifact). Here they run on the port's
copy, language_detector_tpu_torch.tools.artifact_tool, over the
checked-in tables the port reads by path (language_detector_tpu/data/):
the shipped npz pair, manifest and pack verify, the structure checks
catch a damaged quad table, and the manifest catches drift.
tests/test_torch_tools_artifact.py holds the two tools to each other."""
from torch_refcases import adopt

CASES = adopt("artifact_verify", globals(), exclude={}, replace=(
    ('sys.path.insert(0, str(REPO / "tools"))\n\n'
     'import artifact_tool  # noqa: E402',
     "from language_detector_tpu_torch.tools import artifact_tool"),))
