"""The reference's tests/test_hints_parity.py run on the port, engines on
the CPU.

test_device_matches_numpy_oracle_all_modes runs the port's one device
program, the fused-tote kernel's wrapper (`kernels.score_wire`: the
plain version on the CPU, the CUDA kernel on the card), where the
reference runs its four JAX programs (XLA, fused, lax.scan, Pallas in
interpret mode); the oracle and the assertion are the reference's. The
cases that compare with the compiled CLD2 oracle are left out."""
from torch_refcases import adopt

_ORACLE = ("left out: oracle: it compares with the compiled CLD2 oracle "
           "library (tools/oracle/, built from the reference snapshot)")

ADOPTED = adopt("hints_parity", globals(), replace=(
    ("NgramBatchEngine()", 'NgramBatchEngine(device="cpu")'),
    ("""    from language_detector_tpu_torch.ops import kernels
    from language_detector_tpu_torch.ops.score import score_chunks
    modes = [("xla", score_chunks),
             ("fused", kernels.score_chunks_fused),
             ("lax", kernels.score_chunks_lax)]
    ps, _, _ = kernels._pallas_score_fns(interpret=True)
    modes.append(("pallas-interpret", ps))
    return modes""", """    from language_detector_tpu_torch.ops import kernels
    return [("fused-tote", kernels.score_wire)]"""),
), exclude={
    "test_hinted_detection_parity": _ORACLE,
    "test_encoding_hint_parity": _ORACLE,
})
