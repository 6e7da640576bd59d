"""Port serving engine vs the JAX reference: the same prompts give the same
tokens and the same ``EngineStats``; within the port, continuous batching
equals solo decoding, EOS at prefill and a one-token budget complete at
insert time, the cache limit stops a request; the engine and the CLI run on
the CPU only when told to and otherwise refuse without a card."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

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
from repro_torch.serve import EngineStats, Request, ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def model():
    """The smoke llama in fp32 (as tests/test_serve.py), reference weights."""
    jcfg = dataclasses.replace(j_get_smoke("llama3.2-1b"), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                               dtype=torch.float32)
    jp = jz.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 400, size=n).astype(np.int32) for n in lengths]


# (prompts, slots, max_len, max_new): tests/test_serve.py's scenarios —
# queueing behind 2 slots, 14 prompt lengths over 3 buckets, and a request
# that runs into the cache limit.
SCENARIOS = {
    "batched": (_prompts(0, [5, 3, 8, 4, 7]), 2, 64, 6),
    "buckets": (_prompts(1, range(3, 17)), 2, 64, 3),
    "max_len": ([np.array([5] * 8, np.int32)], 1, 12, 100),
}


def _serve(engine, request_cls, prompts, max_new):
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=max_new, eos_id=-1)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    stats = engine.run(max_ticks=50)
    return [r.out_tokens for r in reqs], dataclasses.asdict(stats)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_reference(model, name):
    jcfg, jp, tcfg, tp = model
    prompts, slots, max_len, max_new = SCENARIOS[name]
    ref = _serve(JServeEngine(jcfg, jp, slots=slots, max_len=max_len),
                 JRequest, prompts, max_new)
    got = _serve(ServeEngine(tcfg, tp, slots=slots, max_len=max_len,
                             device="cpu"), Request, prompts, max_new)
    assert got == ref


def _solo(model, prompt, n_new, max_len):
    _, _, tcfg, tp = model
    eng = ServeEngine(tcfg, tp, slots=1, max_len=max_len, device="cpu")
    req = Request(uid=0, prompt=prompt, max_new_tokens=n_new, eos_id=-1)
    eng.submit(req)
    eng.run()
    return req.out_tokens


def test_batched_equals_solo(model):
    prompts, slots, max_len, max_new = SCENARIOS["batched"]
    solo = [_solo(model, p, max_new, max_len) for p in prompts]
    tokens, stats = _serve(ServeEngine(model[2], model[3], slots=slots,
                                       max_len=max_len, device="cpu"),
                           Request, prompts, max_new)
    assert stats["completed"] == len(prompts) and tokens == solo


def test_eos_at_prefill_frees_slot_same_tick(model):
    _, _, tcfg, tp = model
    prompt = np.array([7, 11, 13], np.int32)
    first_tok = _solo(model, prompt, 1, 32)[0]
    eng = ServeEngine(tcfg, tp, slots=1, max_len=32, device="cpu")
    hit = Request(uid=0, prompt=prompt, max_new_tokens=8, eos_id=first_tok)
    follow = Request(uid=1, prompt=np.array([1, 2, 3, 4], np.int32),
                     max_new_tokens=3, eos_id=-1)
    eng.submit(hit)
    eng.submit(follow)
    eng.tick()
    assert hit.done and hit.out_tokens == [first_tok]
    assert eng.live[0] is follow
    assert eng.stats.completed == 1
    assert int(eng.cache["len"][0]) == len(follow.prompt) + 1
    assert len(follow.out_tokens) == 2
    eng.run()
    assert eng.stats.completed == 2 and follow.done


def test_one_token_budget_completes_at_prefill(model):
    _, _, tcfg, tp = model
    eng = ServeEngine(tcfg, tp, slots=2, max_len=32, device="cpu")
    req = Request(uid=0, prompt=np.array([3, 5, 9], np.int32),
                  max_new_tokens=1, eos_id=-1)
    eng.submit(req)
    eng.run(max_ticks=5)
    assert req.done and len(req.out_tokens) == 1
    assert eng.stats == EngineStats(ticks=0, prefills=1, completed=1,
                                    generated_tokens=0)
    assert req.out_tokens == _solo(model, req.prompt, 1, 32)


def test_engine_stops_at_max_len(model):
    _, _, tcfg, tp = model
    eng = ServeEngine(tcfg, tp, slots=1, max_len=12, device="cpu")
    req = Request(uid=0, prompt=np.array([5] * 8, np.int32),
                  max_new_tokens=100, eos_id=-1)
    eng.submit(req)
    eng.run(max_ticks=50)
    assert eng.stats.completed == 1 and req.done
    assert len(req.out_tokens) == 12 - 1 - 8 + 1   # prefill + 3 decodes
    assert eng.live == [None]


def test_queue_respects_slots(model):
    _, _, tcfg, tp = model
    eng = ServeEngine(tcfg, tp, slots=2, max_len=32, device="cpu")
    for i in range(4):
        eng.submit(Request(uid=i, prompt=np.array([1, 2, 3], np.int32),
                           max_new_tokens=4, eos_id=-1))
    eng.tick()
    assert sum(r is not None for r in eng.live) == 2 and len(eng.queue) == 2
    eng.run()
    assert eng.stats.completed == 4


def _cli(*args, cuda_visible=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if cuda_visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = cuda_visible
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "llama3.2-1b", "--smoke", *args], env=env, capture_output=True,
        text=True, timeout=300, cwd=ROOT)


def test_cli_serves_on_cpu():
    r = _cli("--device", "cpu", "--requests", "3", "--max-new", "4")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "3/3 requests, 9 tokens in 3 ticks" in r.stdout   # 1 + 3 each


def test_cli_refuses_without_a_card():
    r = _cli(cuda_visible="")
    assert r.returncode != 0
    assert "CUDA device requested" in r.stderr


def test_engine_defaults_to_the_card(model):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        ServeEngine(model[2], model[3], slots=1, max_len=16)
