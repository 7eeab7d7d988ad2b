"""The reference's tests/test_spans.py run on the port, engines on the
CPU."""
from torch_refcases import adopt

ADOPTED = adopt("spans", globals(), replace=(
    ('NgramBatchEngine()',
     'NgramBatchEngine(device="cpu")'),
    ("                             longdoc_chunk_slots=8)",
     '                             longdoc_chunk_slots=8, device="cpu")'),
    ("LanguageDetector(eng.tables, eng.reg)",
     'LanguageDetector(eng.tables, eng.reg, device="cpu")'),
), exclude={
    'test_spans_tile_document_bytes':
        'held by tests/test_torch_spans.py::test_spans_tile_document_bytes',
})
