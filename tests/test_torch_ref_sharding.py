"""The reference's tests/test_sharding.py run on the port: the sharded
engine over a 4-device CPU mesh (`batch_mesh(devices=["cpu"] * 4)`;
the port's default mesh is the CUDA devices). The 8-device dry run
drives the JAX package's own entry module, `__graft_entry__`; the
port's sharded engine is held to the JAX engine over a mesh by
tests/test_torch_sharding.py."""
from torch_refcases import adopt

ADOPTED = adopt("sharding", globals(), replace=(
    ("single = NgramBatchEngine()",
     'single = NgramBatchEngine(device="cpu")'),
    ("NgramBatchEngine(mesh=batch_mesh(4))",
     'NgramBatchEngine(mesh=batch_mesh(devices=["cpu"] * 4), '
     'device="cpu")'),
), exclude={
    "test_dryrun_multichip_8dev":
        "held by tests/test_torch_sharding.py::"
        "test_sharded_engine_answers_equal_jax",
})
