"""The reference's tests/test_profiling.py run on the port.

The port's capture is torch.profiler's Chrome trace, `trace.json` in
the window's directory, where the reference's jax.profiler writes
`*.xplane.pb`; and a window the port arms stops on its own (there is no
process-wide trace to stop), so the clean-up fixture waits for it
instead of calling jax.profiler.stop_trace."""
from torch_refcases import adopt

CASES = adopt("profiling", globals(), replace=(
    ("*.xplane.pb", "trace.json"),
    ("        import jax\n"
     "        with contextlib.suppress(Exception):\n"
     "            jax.profiler.stop_trace()\n",
     "        deadline = time.time() + 10.0\n"
     "        while profiling.active() is not None and \\\n"
     "                time.time() < deadline:\n"
     "            time.sleep(0.02)\n"),
), exclude={})
