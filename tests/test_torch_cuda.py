"""The fused-tote CUDA kernel against its plain version, on the card.

The kernel has no CPU mode, so these tests carry the `cuda` marker and
skip on a host without a card. Run them on one with

    python -m pytest -m cuda tests/test_torch_cuda.py

They import only torch, numpy and the port (no jax): the adversarial
grids come from chip_smoke.py, which runs the same comparison and the
main path end to end. The real-path wires are the ones the engine sends
on its hinted (prior planes and whack rows), HTML, chunk-vector (full
output) and span paths, recorded from a CPU engine. The scheduler cases
drive the engine on the card: depth 2 against depth 1 and the CPU, and
concurrent flushes sharing one engine's staging ring and streams.
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


@pytest.fixture(scope="module")
def sched_docs():
    return chip_smoke.build_docs(_eval_docs(), 20261017, 1500)


@pytest.mark.cuda
def test_scheduler_depth2_equals_depth1_and_cpu(cuda_dt, sched_docs):
    """detect_codes and detect_many through the stream scheduler on the
    card at depth 2 equal depth 1 on the card and the CPU engine; one
    launch a device dispatch, every lease back, none released under a
    copy in flight. The long-doc lane is on (the reference's 1024-slot
    sub-packs), so its split documents are among them."""
    want = NgramBatchEngine(device="cpu").detect_codes(sched_docs)
    want_rows = chip_smoke.answer_rows(
        NgramBatchEngine(device="cpu").detect_many(sched_docs))
    for depth in (1, 2):
        eng = NgramBatchEngine(device="cuda", pipeline_depth=depth,
                               longdoc_chunk_slots=1024)
        before = kernels.launches
        assert eng.detect_codes(sched_docs) == want
        assert kernels.launches - before == \
            eng.stats_snapshot()["device_dispatches"]
        assert eng.stats["longdoc_split_docs"] > 0
        assert chip_smoke.answer_rows(eng.detect_many(sched_docs)) == \
            want_rows
        ring = eng.staging_stats()
        assert ring["pending_releases"] == 0 and ring["occupancy"] == 0
        assert eng.pipeline_stats()["inflight"] == 0


@pytest.mark.cuda
def test_concurrent_flushes_reuse_leases(cuda_dt, sched_docs):
    """Four threads flushing through one engine at depth 2, three rounds
    each: answers equal the CPU's, later flushes take their staging
    leases from the ring, and no lease is released while its copy is in
    flight."""
    import concurrent.futures
    parts = [sched_docs[i::4] for i in range(4)]
    cpu = NgramBatchEngine(device="cpu")
    want = [cpu.detect_codes(p) for p in parts]
    eng = NgramBatchEngine(device="cuda", pipeline_depth=2)
    before = kernels.launches
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for _ in range(3):
            got = list(pool.map(eng.detect_codes, parts))
            assert got == want
    assert kernels.launches - before == \
        eng.stats_snapshot()["device_dispatches"]
    ring = eng.staging_stats()
    assert ring["hits"] > 0
    assert ring["pending_releases"] == 0 and ring["occupancy"] == 0
    assert eng.pipeline_stats()["inflight"] == 0
