"""The torch port's plain scorer is bit-identical to the reference.

language_detector_tpu_torch/ops/score.py is the plain PyTorch version of
the device step (the CUDA kernel in ops/kernels.py is held against it on
the card). Here, on the CPU, it must give the same packed words — word1
and the full [G, 2] output — as every reference program: the XLA
`score_chunks` / `score_chunks_full`, the Pallas kernel under the
interpreter, and the numpy `oracle_score_chunks`. Tolerance 0: the
outputs are packed integer words.

Inputs: adversarial synthetic grids (empty chunks, K=256 fat rows, hint
slots at and above HINT_BASE, whack tables present and absent, every
_lscript4 script, decode rows past the 240-row clamp, the s1 = 0x3FFF
clip, hint-prior planes) and real packer wires from eval_corpus.tsv.
"""
from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest
import torch

from language_detector_tpu import native as jnative
from language_detector_tpu.evalsuite import oracle_score_chunks
from language_detector_tpu.ops import kernels as jkernels
from language_detector_tpu.ops.device_tables import \
    DeviceTables as JaxDeviceTables
from language_detector_tpu.ops.score import (HINT_BASE, score_chunks,
                                             score_chunks_full)
from language_detector_tpu.registry import registry as jreg
from language_detector_tpu.tables import load_tables as jload_tables
from language_detector_tpu_torch.ops import kernels as tkernels
from language_detector_tpu_torch.ops.device_tables import DeviceTables
from language_detector_tpu_torch.ops.score import (score_chunks_plain,
                                                   wire_to_device,
                                                   words_to_numpy)
from language_detector_tpu_torch.registry import registry as treg
from language_detector_tpu_torch.tables import DATA_DIR
from language_detector_tpu_torch.tables import load_tables as tload_tables
from torch_support import jax_packer

# while this worker collects, before any of its tests run
jax_packer()


H_WINDOW = 64          # hint_lp window size for synthetic wires
N_WHACK = 5            # whack table rows
N_PRIOR = 4            # prior_tbl rows


@pytest.fixture(scope="module")
def jax_tables():
    t = jload_tables()
    return t, JaxDeviceTables.from_host(t, jreg)


@pytest.fixture(scope="module")
def torch_dt():
    return DeviceTables.from_host(tload_tables(), treg, "cpu")


def _langprob(rng, n, hi_rows=True):
    """Random langprob u32s: row byte over the FULL 0..255 range when
    hi_rows (rows >= 240 exercise the clamp), pslangs over 0..255 with a
    bias toward 0 (the 'no language' plane terminator)."""
    row = rng.integers(0, 256 if hi_rows else 240, n, dtype=np.uint32)
    ps = rng.integers(0, 256, (n, 3), dtype=np.uint32)
    ps[rng.random((n, 3)) < 0.3] = 0
    return (row | (ps[:, 0] << 8) | (ps[:, 1] << 16)
            | (ps[:, 2] << 24)).astype(np.uint32)


def _wire(rng, G, K, hint_frac=0.0, whack=True, empty_frac=0.0,
          scripts=(1, 3, 6, 9), cat_n=4096, prior=False):
    """Synthetic chunk-major flat wire (the pack_chunks_native layout)."""
    cnsl = rng.integers(0, min(K, 255) + 1, G).astype(np.int64)
    if empty_frac:
        cnsl[rng.random(G) < empty_frac] = 0
    # a fixed slot count per (G, K) (slots past the rows' total are
    # never read) so every seed reuses one compiled reference program
    N = G * min(K, 255)
    idx = rng.integers(0, cat_n, N).astype(np.uint16)
    if hint_frac:
        hints = rng.random(N) < hint_frac
        idx[hints] = (HINT_BASE
                      + rng.integers(0, H_WINDOW, int(hints.sum()))
                      ).astype(np.uint16)
    cbytes = rng.integers(0, 1500, G).astype(np.uint32)
    grams = rng.integers(0, 600, G).astype(np.uint32)
    side = rng.integers(0, 2, G).astype(np.uint32)
    real = rng.integers(0, 2, G).astype(np.uint32)
    cmeta = (cbytes | (grams << 16) | (side << 28)
             | (real << 29)).astype(np.uint32)
    if whack:
        cwhack = rng.integers(0, N_WHACK, G).astype(np.uint16)
    else:
        cwhack = np.zeros(1, np.uint16)     # the dropped-gather dummy
    wire = {
        "idx": idx,
        "cnsl": cnsl.astype(np.uint8).reshape(1, G),
        "cmeta": cmeta,
        "cscript": rng.choice(np.array(scripts, np.uint8), G),
        "cwhack": cwhack,
        "hint_lp": _langprob(rng, H_WINDOW),
        "whack_tbl": (rng.random((N_WHACK, 2, 256)) < 0.1
                      ).astype(np.uint8),
        "k_iota": np.arange(K, dtype=np.uint8),
    }
    if prior:
        # LDT_HINTS prior planes: row 0 is the no-prior zero plane, the
        # rest carry qprob-sized boosts on a sparse set of languages
        tbl = rng.integers(0, 13, (N_PRIOR, 2, 256)).astype(np.uint8)
        tbl[rng.random((N_PRIOR, 2, 256)) < 0.7] = 0
        tbl[0] = 0
        wire["cprior"] = rng.integers(0, N_PRIOR, G).astype(np.uint16)
        wire["prior_tbl"] = tbl
    return wire


def _port(dt, wire, full_out=False):
    return words_to_numpy(score_chunks_plain(
        dt, wire_to_device(wire, "cpu"), full_out=full_out))


def _assert_port_matches(jdt, tdt, wire, tables=None, pallas=True):
    """Port word1 and full == XLA, Pallas (interpreted) and the numpy
    oracle (word1), bit for bit."""
    ref = np.asarray(score_chunks(jdt, wire))
    reff = np.asarray(score_chunks_full(jdt, wire))
    got = _port(tdt, wire)
    gotf = _port(tdt, wire, full_out=True)
    assert np.array_equal(got, ref), \
        f"word1 diverges at rows {np.flatnonzero(got != ref)[:8]}"
    assert np.array_equal(gotf, reff), "full output diverges"
    if pallas:
        ps, _, pf = jkernels._pallas_score_fns(interpret=True)
        assert np.array_equal(got, np.asarray(ps(jdt, wire)))
        assert np.array_equal(gotf, np.asarray(pf(jdt, wire)))
    if tables is not None:
        assert np.array_equal(got, oracle_score_chunks(tables, jreg, wire))
    return got


SYNTHETIC = {
    "random-hints-whacks": dict(G=24, K=24, hint_frac=0.15, whack=True,
                                empty_frac=0.1),
    "whack-absent-dummy": dict(G=12, K=16, whack=False),
    "hint-window-only": dict(G=12, K=16, hint_frac=1.0, whack=False),
    "prior-planes": dict(G=24, K=24, hint_frac=0.1, whack=True,
                         prior=True),
    "prior-no-whack": dict(G=12, K=16, whack=False, prior=True),
    "script-latn": dict(G=12, K=16, scripts=(1,)),
    "script-hani": dict(G=12, K=16, scripts=(3,)),
    "script-arab": dict(G=12, K=16, scripts=(6,)),
    "script-other": dict(G=12, K=16, scripts=(9,)),
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_synthetic_grids(jax_tables, torch_dt, case):
    """Adversarial grids: hints, whacks, empties, every script branch,
    clamp rows, prior planes — several seeds each."""
    tables, jdt = jax_tables
    for seed in range(3):
        rng = np.random.default_rng(20261016 + seed)
        wire = _wire(rng, **SYNTHETIC[case])
        _assert_port_matches(jdt, torch_dt, wire, tables,
                             pallas=seed == 0)


def test_all_empty_grid(jax_tables, torch_dt):
    """cnsl = 0 everywhere, idx a single pad slot: every row picks
    index 0 from an all -1 sortkey."""
    tables, jdt = jax_tables
    wire = _wire(np.random.default_rng(7), G=16, K=8)
    wire["cnsl"][:] = 0
    wire["idx"] = wire["idx"][:1]
    got = _assert_port_matches(jdt, torch_dt, wire, tables)
    assert ((got >> 10) & 0x3FFF == 0).all()


def test_fat_rows_k256(jax_tables, torch_dt):
    """The fattest legal rows: K = 256, every chunk at the 255-slot
    cnsl ceiling."""
    tables, jdt = jax_tables
    rng = np.random.default_rng(11)
    wire = _wire(rng, G=8, K=256, hint_frac=0.1, whack=True)
    wire["cnsl"][:] = 255
    wire["idx"] = rng.integers(0, 4096, 8 * 255).astype(np.uint16)
    _assert_port_matches(jdt, torch_dt, wire, tables)


def test_out_of_range_indices_clamp(jax_tables, torch_dt):
    """Slot indices past cat_ind2 and past the hint window, and whack /
    prior rows past their tables, clamp as XLA gathers do."""
    tables, jdt = jax_tables
    rng = np.random.default_rng(23)
    wire = _wire(rng, G=16, K=16, whack=True, prior=True)
    wire["idx"][::3] = 40000            # past cat_ind2, under HINT_BASE
    wire["idx"][1::5] = 0xFFFF          # far past the hint window
    wire["cwhack"][::2] = 999
    wire["cprior"][1::2] = 999
    _assert_port_matches(jdt, torch_dt, wire, tables, pallas=False)


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_chunk_starts(jax_tables, torch_dt, shards):
    """A [D, Gs] wire: chunk starts are an exclusive cumsum that restarts
    at every shard row (the rule the CUDA kernel's in-kernel scan keeps);
    the 4-shard wire has an all-empty shard row between full ones."""
    tables, jdt = jax_tables
    Gs, K = 12, 16
    rng = np.random.default_rng(31 + shards)
    wire = _wire(rng, G=shards * Gs, K=K, hint_frac=0.1, whack=True,
                 prior=True)
    cnsl = wire["cnsl"].reshape(shards, Gs)
    if shards > 2:
        cnsl[1] = 0
    wire["cnsl"] = cnsl
    wire["idx"] = wire["idx"].reshape(shards, -1)
    _assert_port_matches(jdt, torch_dt, wire, tables)


def _doctored(jdt, tdt):
    """qprob rows 100/101 carry 255/63 — enough to push a chunk tote
    past the s1 clip (real tables max out at 12)."""
    import jax.numpy as jnp
    lg3 = np.asarray(jdt.lg_prob3).copy()
    lg3[100] = 255
    lg3[101] = 63
    pad = np.empty((256, 3), np.uint8)
    pad[:len(lg3)] = lg3
    pad[len(lg3):] = lg3[-1]
    jd = dataclasses.replace(jdt, lg_prob3=jnp.asarray(lg3),
                             lg_prob3_pad=jnp.asarray(pad))
    td = dataclasses.replace(tdt, lg_prob3=torch.from_numpy(lg3),
                             lg_prob3_pad=torch.from_numpy(pad))
    return jd, td


def test_s1_clip_boundary(jax_tables, torch_dt):
    """Chunk totes straddling s1's 14-bit clip: 25500 (clipped), 16383
    (exactly 0x3FFF), 16320 (under)."""
    _, jdt = jax_tables
    jd, td = _doctored(jdt, torch_dt)
    lang = 37
    mk = lambda row, n: np.full(n, row | (lang << 8), np.uint32)  # noqa: E731
    rows = [np.concatenate([mk(100, 100), np.zeros(28, np.uint32)]),
            np.concatenate([mk(100, 64), mk(101, 1),
                            np.zeros(63, np.uint32)]),
            np.concatenate([mk(100, 64), np.zeros(64, np.uint32)])]
    G, K = 3, 128
    wire = {
        "idx": (HINT_BASE + np.arange(3 * K)).astype(np.uint16),
        "cnsl": np.full((1, G), K, np.uint8),
        "cmeta": np.full(G, 500 | (100 << 16) | (1 << 29), np.uint32),
        "cscript": np.full(G, 1, np.uint8),
        "cwhack": np.zeros(1, np.uint16),
        "hint_lp": np.concatenate(rows),
        "whack_tbl": np.zeros((1, 2, 256), np.uint8),
        "k_iota": np.arange(K, dtype=np.uint8),
    }
    got = _assert_port_matches(jd, td, wire)
    assert list((got >> 10) & 0x3FFF) == [0x3FFF, 0x3FFF, 16320]


def _corpus():
    docs = [ln.split("\t", 1)[1].rstrip("\n") for ln in
            open(DATA_DIR / "eval_corpus.tsv", encoding="utf-8")]
    rng = random.Random(20261016)
    out = list(docs)
    for _ in range(150):               # slices and mixed concatenations
        t = rng.choice(docs)
        lo = rng.randrange(max(1, len(t) - 40))
        out.append(" ".join([t[lo:lo + rng.randint(5, 120)]] +
                            [rng.choice(docs)[:rng.randint(20, 200)]
                             for _ in range(rng.randint(0, 3))]))
    return out


REAL_WIRES = ("corpus", "corpus-repeats-flags", "short-slices",
              "cjk-fat-chunks")


def _real_wire(case):
    docs = _corpus()
    flags = 0
    if case == "corpus-repeats-flags":
        from language_detector_tpu.engine_scalar import (FLAG_FINISH,
                                                         FLAG_REPEATS)
        flags = FLAG_REPEATS | FLAG_FINISH
    elif case == "short-slices":
        docs = [d[:40] for d in docs[:200]]
    elif case == "cjk-fat-chunks":
        rng = random.Random(5)
        docs = ["".join(chr(rng.randrange(0x4E00, 0x9FFF))
                        for _ in range(rng.randint(300, 3000)))
                for _ in range(6)] + docs[:20]
    return jnative.pack_chunks_native(docs, jload_tables(), jreg,
                                      flags=flags).wire


@pytest.mark.parametrize("case", REAL_WIRES)
def test_real_packer_wires(jax_tables, torch_dt, case):
    """Real wires from eval_corpus.tsv docs (a few hundred, with
    slices, concatenations, a flagged retry-style pack and CJK docs
    with fat chunks)."""
    tables, jdt = jax_tables
    wire = _real_wire(case)
    _assert_port_matches(jdt, torch_dt, wire, tables)


def test_hinted_packer_wire(jax_tables, torch_dt):
    """A hinted pack from the reference packer: hint-window slots,
    whack rows and prior planes as the engine would ship them."""
    from language_detector_tpu.hints import (CLDHints, apply_hints,
                                             prior_vector)
    tables, jdt = jax_tables
    docs = _corpus()[:40]
    codes = ["id", "ms", "sr", "fr", "uk", "ja", "af", "de"]
    hbs = [apply_hints(t, True,
                       CLDHints(content_language_hint=codes[i % 8]),
                       tables, jreg) for i, t in enumerate(docs)]
    pvs = [prior_vector(hb, tables) for hb in hbs]
    cb = jnative.pack_chunks_native(docs, tables, jreg, hint_boosts=hbs,
                                    hint_priors=pvs)
    assert "cprior" in cb.wire
    _assert_port_matches(jdt, torch_dt, cb.wire, tables)


def test_score_chunks_cpu_takes_plain_version(torch_dt):
    """The wrapper runs the plain version for CPU tensors without
    counting a kernel launch."""
    wire = wire_to_device(_wire(np.random.default_rng(3), G=8, K=8), "cpu")
    before = tkernels.launches
    got = tkernels.score_chunks(torch_dt, wire, full_out=True)
    assert tkernels.launches == before
    assert torch.equal(got, score_chunks_plain(torch_dt, wire,
                                               full_out=True))


def test_prepare_passes_shard_rows(torch_dt):
    """The kernel's entry point takes the shard row length Gs (its scan
    restarts the chunk starts there), and refuses shard rows long enough
    to overflow its int32 scan."""
    wire = _wire(np.random.default_rng(5), G=8, K=8)
    wire["cnsl"] = wire["cnsl"].reshape(2, 4)
    args, out, _ = tkernels.prepare(torch_dt, wire_to_device(wire, "cpu"))
    assert args[3] == 4 and out.shape == (8,)
    big = wire_to_device(wire, "cpu")
    big["cnsl"] = torch.zeros((1, tkernels.MAX_SHARD_ROWS + 1),
                              dtype=torch.uint8)
    with pytest.raises(ValueError, match="shard row"):
        tkernels.prepare(torch_dt, big)
