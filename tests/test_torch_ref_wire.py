"""The reference's tests/test_wire.py run on the port, engines on the
CPU."""
from torch_refcases import adopt

ADOPTED = adopt("wire", globals(), replace=(
), exclude={
})
