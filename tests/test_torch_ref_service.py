"""The reference's tests/test_service.py run on the port, engines on the
CPU."""
from torch_refcases import adopt

ADOPTED = adopt("service", globals(), replace=(
    ('DetectorService(use_device=True,',
     'DetectorService(use_device=True, device="cpu",'),
    # the port's fronts read the shipped code map by path
    ('"language_detector_tpu_torch/service/cld_codes.json"',
     '"language_detector_tpu/service/cld_codes.json"'),
), exclude={
    'test_usage':
        'held by tests/test_torch_service.py::test_usage',
    'test_not_found':
        'held by tests/test_torch_service.py::test_not_found',
    'test_wrong_content_type':
        'held by tests/test_torch_service.py::test_wrong_content_type',
    'test_bad_json':
        'held by tests/test_torch_service.py::test_bad_json',
    'test_missing_text_key_keeps_batch_going':
        'held by tests/test_torch_service.py::test_missing_text_key_keeps_batch_going',
    'test_unknown_language_203':
        'held by tests/test_torch_service.py::test_unknown_language_203',
    'test_empty_request_list':
        'held by tests/test_torch_service.py::test_empty_request_list',
    'test_oversized_body_rejected':
        'held by tests/test_torch_service.py::test_oversized_body_rejected',
    'test_metrics_endpoint':
        'held by tests/test_torch_service.py::test_metrics_endpoint',
})
