"""The control, the plain reference in TF32 in the program's place, fails
each cell's comparison; the program passes it."""
import json

import pytest
import torch

from bench import faults, harness, loop
from bench.ref.common import round_tf32
from bench.tests.test_bench_reference import small_system

CELLS = ["siot-gcn.infer", "siot-gat.infer", "siot-gcn.train",
         "siot-gat.train"]


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -3.0 - 2 ** -9])
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                                      1.0, -3.0 - 2 ** -9]


def traffic_of(cell):
    wl = harness.cell(harness.spec(), cell)
    system = small_system(wl["config"].split("-")[1])
    kind = harness.generator(wl["generator"])
    tr = kind.Traffic(system, 12345678901, wl["params"])
    loop.run_steps(tr.call, 2 * wl["params"].get("ring", 1) + 1, 8,
                   system.device)
    return tr, wl["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    tr, limits = traffic_of(cell)
    numbers, _, failed = tr.check(limits)
    assert failed == 0, numbers
    numbers, _, failed = tr.control(limits)
    assert failed >= 1, numbers


def test_faults_are_known():
    assert set(faults.FAULTS) == {"state_unchanged", "half_batch",
                                  "exchange_left_out", "answer_altered"}


def test_compared_train_steps_follow_a_dropped_call():
    """The step's first call, which on the card runs eagerly and captures,
    is dropped; the steps compared start again from the drawn weights, so
    on the card each is a replay, as in the window."""
    from bench.traffic import train
    system = small_system("gcn")
    make, given = system.train_step, []

    def recording(*a, **kw):
        step = make(*a, **kw)

        def call(params, blocks):
            given.append(params)
            return step(params, blocks)
        return call
    system.train_step = recording
    tr = train.Traffic(system, 5, {"lr": 0.1})
    assert len(given) == 1 + train.FIRST
    assert given[0] is tr.params0 and given[1] is tr.params0
    assert all(a is b for a, b in zip(given[2:], tr.after))
