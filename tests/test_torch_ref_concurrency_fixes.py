"""The reference's tests/test_concurrency_fixes.py run on the port, its
engine on the CPU.

test_stats_snapshot_survives_concurrent_mutation builds a bare engine
with object.__new__; the port's stats_snapshot also reads the engine's
kernel-library bundle store (`_aot`, None when no bundle is armed), so
the bare engine gets one."""
from torch_refcases import adopt

CASES = adopt("concurrency_fixes", globals(), replace=(
    ("NgramBatchEngine()", 'NgramBatchEngine(device="cpu")'),
    ('    eng._stats_lock = make_lock("engine.stats")\n',
     '    eng._stats_lock = make_lock("engine.stats")\n'
     '    eng._aot = None\n'),
), exclude={})
