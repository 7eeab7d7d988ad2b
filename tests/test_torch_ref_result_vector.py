"""The reference's tests/test_result_vector.py run on the port, engines
and the detector on the CPU, over the port's snapshot-parity tables
(`base_tables` below: the port's ScoringTables without quadgram
tables, as tests/conftest.py loads the reference's). The parity case
against the compiled CLD2 oracle and the fuzz over golden-suite
documents are left out."""
import pytest

from torch_refcases import adopt

ADOPTED = adopt("result_vector", globals(), replace=(
    ("NgramBatchEngine(tables=base_tables)",
     'NgramBatchEngine(tables=base_tables, device="cpu")'),
    ("LanguageDetector(tables=base_tables)",
     'LanguageDetector(tables=base_tables, device="cpu")'),
), exclude={
    "test_result_vector_parity":
        "left out: oracle: it compares with the compiled CLD2 oracle "
        "library (tools/oracle/, built from the reference snapshot)",
    "test_device_path_chunks_fuzz":
        "left out: oracle: its documents are cut from the CLD2 golden "
        "suite (tests/test_batch_agreement.py _fuzz_docs)",
})


@pytest.fixture(scope="module")
def base_tables():
    from language_detector_tpu_torch.tables import ScoringTables
    return ScoringTables.load(quad_path=False)
