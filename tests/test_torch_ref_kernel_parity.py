"""The reference's tests/test_kernel_parity.py run on the port's
scorer on the CPU.

The reference holds its four device programs (XLA, fused, lax.scan,
Pallas under the interpreter) to each other. The port has one device
program, the fused-tote kernel, whose plain version runs for tables on
the CPU: `score_chunks` / `score_chunks_full` here are the kernel's
wrapper (`kernels.score_wire`, the plain version on the CPU, the CUDA
kernel on the card), and the mode it is held to is the port's pure
numpy mirror, `evalsuite.oracle_score_chunks`, over host tables
doctored as the device tables are. One assertion goes: each JAX
program's full [G, 2] output equal to the XLA scorer's, since the port
has one device program and LDT_KERNEL is absent (ROADMAP C2: the knobs
the port leaves out); the full output's word1 is still held to word1.
Every grid, seed and other assertion is the reference's; the
engine-level cases select among the reference's JAX programs
(LDT_KERNEL, Pallas interpret mode), which the port does not have."""
import copy

import numpy as np
import torch

from torch_refcases import adopt

_JAX_MODES = ("left out: JAX-only: it selects among the reference's JAX "
              "programs (LDT_KERNEL: xla, fused, lax, Pallas and its "
              "interpret mode); the port has one kernel")

ADOPTED = adopt("kernel_parity", globals(), replace=(
    ("from language_detector_tpu_torch.ops.score import (HINT_BASE, "
     "score_chunks,\n                                             "
     "score_chunks_full)",
     "from language_detector_tpu_torch.ops.score import HINT_BASE"),
    ("""    modes = {
        "fused": (kernels.score_chunks_fused,
                  kernels.score_chunks_fused_full),
        "lax": (kernels.score_chunks_lax,
                kernels.score_chunks_lax_full),
    }
    if interpret_pallas:
        ps, _, pf = kernels._pallas_score_fns(interpret=True)
        modes["pallas-interpret"] = (ps, pf)
    for name, (score, full) in modes.items():
        got = np.asarray(score(dt, wire))
        assert np.array_equal(got, ref), \\
            f"{name} word1 diverges at rows {np.flatnonzero(got != ref)[:8]}"
        gotf = np.asarray(full(dt, wire))
        assert np.array_equal(gotf, reff), \\
            f"{name} full output diverges"
""", """    modes = {"numpy-oracle": _oracle_words}
    for name, score in modes.items():
        got = np.asarray(score(dt, wire))
        assert np.array_equal(got, ref), \\
            f"{name} word1 diverges at rows {np.flatnonzero(got != ref)[:8]}"
"""),
    ("""    import jax.numpy as jnp
    return dataclasses.replace(dt, lg_prob3=jnp.asarray(lg3),
                               lg_prob3_pad=jnp.asarray(pad))""",
     """    return dataclasses.replace(dt, lg_prob3=torch.from_numpy(lg3),
                               lg_prob3_pad=torch.from_numpy(pad))"""),
    ("    return NgramBatchEngine()", '    return NgramBatchEngine(device="cpu")'),
), exclude={
    "test_engine_modes_match_scalar": _JAX_MODES,
    "test_engine_pallas_interpret_matches_scalar": _JAX_MODES,
    "test_unknown_kernel_value_degrades_to_auto": _JAX_MODES,
})


def score_chunks(dt, wire):
    from language_detector_tpu_torch.ops import kernels as port_kernels
    return np.asarray(port_kernels.score_wire(dt, wire))


def score_chunks_full(dt, wire):
    from language_detector_tpu_torch.ops import kernels as port_kernels
    return np.asarray(port_kernels.score_wire(dt, wire, full_out=True))


def _oracle_words(dt, wire):
    """evalsuite.oracle_score_chunks over the shipped host tables with
    dt's qprob decode rows (the s1-clip case doctors them)."""
    from language_detector_tpu_torch import evalsuite
    from language_detector_tpu_torch.registry import registry as reg
    from language_detector_tpu_torch.tables import load_tables
    tables = load_tables()
    lg3 = dt.lg_prob3.numpy()
    if not np.array_equal(lg3, tables.lg_prob[:len(lg3), 5:8]):
        tables = copy.copy(tables)
        tables.lg_prob = tables.lg_prob.copy()
        tables.lg_prob[:len(lg3), 5:8] = lg3
    return evalsuite.oracle_score_chunks(tables, reg, wire)
