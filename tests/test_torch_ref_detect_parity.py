"""The reference's tests/test_detect_parity.py run on the port, over the
port's snapshot-parity tables (`base_tables` below: the port's
ScoringTables without quadgram tables). The case held to the compiled
CLD2 oracle is left out; the public detect()'s all-C path is held to
the scalar engine, with the detector on the CPU."""
import pytest

from torch_refcases import adopt

ADOPTED = adopt("detect_parity", globals(), replace=(
    ("LanguageDetector(tables=base_tables)",
     'LanguageDetector(tables=base_tables, device="cpu")'),
), exclude={
    "test_detect_parity":
        "left out: oracle: it compares with the compiled CLD2 oracle "
        "library (tools/oracle/, built from the reference snapshot)",
})


@pytest.fixture(scope="module")
def base_tables():
    from language_detector_tpu_torch.tables import ScoringTables
    return ScoringTables.load(quad_path=False)
