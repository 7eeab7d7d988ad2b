"""The fused-tote CUDA kernel against its plain version, on the card.

The kernel has no CPU mode, so these tests carry the `cuda` marker and
skip on a host without a card. Run them on one with

    python -m pytest -m cuda tests/test_torch_cuda.py

They import only torch, numpy and the port (no jax): the adversarial
grids come from chip_smoke.py, which runs the same comparison and the
main path end to end. The real-path wires are the ones the engine sends
on its hinted (prior planes and whack rows), HTML, chunk-vector (full
output) and span paths, recorded from a CPU engine.
"""
from __future__ import annotations

import pytest
import torch

import chip_smoke
from language_detector_tpu_torch import native
from language_detector_tpu_torch.hints import CLDHints
from language_detector_tpu_torch.models.ngram import NgramBatchEngine
from language_detector_tpu_torch.ops import kernels
from language_detector_tpu_torch.ops.device_tables import DeviceTables
from language_detector_tpu_torch.ops.score import (score_chunks_plain,
                                                   wire_to_device)
from language_detector_tpu_torch.registry import registry
from language_detector_tpu_torch.tables import DATA_DIR, load_tables


@pytest.fixture(scope="module")
def cuda_dt():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return DeviceTables.from_host(load_tables(), registry, "cuda")


@pytest.fixture(scope="module")
def grids():
    return chip_smoke.adversarial_wires(20261016)


def _assert_kernel_equals_plain(dt, wire):
    w = wire_to_device(wire, dt.device)
    for full in (False, True):
        before = kernels.launches
        got = kernels.score_chunks(dt, w, full_out=full)
        assert kernels.launches == before + 1
        want = score_chunks_plain(dt, w, full_out=full)
        assert torch.equal(got, want), \
            f"{int((got != want).sum())} words differ (full={full})"


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(chip_smoke.ADVERSARIAL)))
def test_adversarial_grids(cuda_dt, grids, case):
    _assert_kernel_equals_plain(cuda_dt, grids[case][1])


@pytest.mark.cuda
def test_s1_clip(cuda_dt):
    doctored, wire = chip_smoke.s1_clip_case(cuda_dt)
    _assert_kernel_equals_plain(doctored, wire)


@pytest.mark.cuda
def test_real_packer_wire(cuda_dt):
    docs = [ln.split("\t", 1)[1] for ln in
            open(DATA_DIR / "eval_corpus.tsv", encoding="utf-8")]
    cb = native.pack_chunks_native(docs, load_tables(), registry)
    _assert_kernel_equals_plain(cuda_dt, cb.wire)


@pytest.mark.cuda
def test_cuda_tensor_never_reaches_plain_path(cuda_dt, grids):
    """Tables on the CPU with a wire on the card raise instead of
    scoring on either device."""
    cpu_dt = DeviceTables.from_host(load_tables(), registry, "cpu")
    wire = wire_to_device(grids[0][1], "cuda")
    with pytest.raises(ValueError):
        kernels.score_chunks(cpu_dt, wire)


def _eval_docs() -> list[str]:
    return [ln.split("\t", 1)[1].rstrip("\n") for ln in
            open(DATA_DIR / "eval_corpus.tsv", encoding="utf-8")]


# path -> (engine arguments, the call that drives the path)
REAL_PATHS = {
    "hinted-priors": ({"hint_priors": True}, lambda e, docs: e.detect_batch(
        docs, hints=CLDHints(content_language_hint="id", tld_hint="rs"))),
    "html": ({}, lambda e, docs: e.detect_batch(
        [f'<p lang="fr">{d}</p>&amp;<script>x</script>' for d in docs],
        is_plain_text=False)),
    "want-ranges": ({}, lambda e, docs: e.detect_batch(
        docs, return_chunks=True)),
    "span-subdocs": ({"longdoc_chunk_slots": 64}, lambda e, docs:
                     e.detect_spans([" ".join(docs[i::8])
                                     for i in range(8)])),
}


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(REAL_PATHS))
def test_real_path_wires(cuda_dt, path):
    """The wires a CPU engine sends on each path, through the kernel and
    the plain version on the card: the hinted wire carries prior planes
    and whack rows, the chunk-vector wire asks for full output."""
    kw, run = REAL_PATHS[path]
    eng = NgramBatchEngine(device="cpu", **kw)
    with chip_smoke.DispatchRecorder([eng]) as rec:
        run(eng, _eval_docs())
    assert rec.records
    for r in rec.records:
        if path == "hinted-priors":
            assert "cprior" in r["wire"]
            assert r["wire"]["cwhack"].shape[-1] > 1
        assert r["full_out"] == (path == "want-ranges")
        _assert_kernel_equals_plain(cuda_dt, r["wire"])
