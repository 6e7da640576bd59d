"""Random shapes: K2's plain version equals the reference's Pallas kernel
(interpret mode), mirroring ``tests/test_kernels.py``'s property test."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 10_000))
def test_flash_plain_property(seed):
    rng = np.random.default_rng(seed)
    B = int(rng.integers(1, 3))
    Hkv = int(rng.integers(1, 3))
    Hq = Hkv * int(rng.integers(1, 4))
    Lq = int(rng.integers(1, 70))
    Lk = Lq + int(rng.integers(0, 70))
    D = int(rng.choice([16, 32, 64]))
    q = rng.normal(size=(B, Hq, Lq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Lk, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Lk, D)).astype(np.float32)
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                  bq=32, bkv=32, interpret=True)
    out = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-5,
                               atol=3e-5)
