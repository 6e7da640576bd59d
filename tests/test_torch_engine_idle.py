"""An idle serving slot whose ``len`` passes the cache.

Every decode step advances every slot's ``len``, live or idle, and the
engine resets a slot's ``len`` only when its request completes, so an
engine that serves one request at a time over two slots counts its idle
slot past ``max_len``.  The reference's functional cache write drops a
column past the cache and keeps serving; the port's in-place write must do
the same (on the CPU an out-of-range ``index_put_`` raises IndexError, on
the card it is a device-side assert).  Held against the reference's engine
on the same weights: the served tokens and the ``len`` vector after each
of four ``run()`` calls, for the dense family and for the hybrid family
(whose shared attention block writes its KV through the same function)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jz  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.serve import Request as JRequest, ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b"])
def test_idle_slot_past_max_len_serves_as_the_reference(arch):
    jcfg = dataclasses.replace(j_get_smoke(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    jp = jz.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ref = JServeEngine(jcfg, jp, slots=2, max_len=16)
    eng = ServeEngine(tcfg, tp, slots=2, max_len=16, device="cpu")
    rng = np.random.default_rng(0)
    for run in range(4):
        prompt = rng.integers(1, 400, size=10).astype(np.int32)
        jr = JRequest(uid=run, prompt=prompt, eos_id=-1)
        tr = Request(uid=run, prompt=prompt, eos_id=-1)
        ref.submit(jr)
        eng.submit(tr)
        ref.run()
        eng.run()
        assert tr.done and tr.out_tokens == jr.out_tokens, run
        assert eng.cache["len"].tolist() == np.asarray(ref.cache["len"]).tolist()
        assert dataclasses.asdict(eng.stats) == dataclasses.asdict(ref.stats)
    # The idle slot did pass the cache: the case the repair is for.
    assert int(eng.cache["len"][1]) > 16
