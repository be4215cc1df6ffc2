"""The control on the card: the reference put in the program's place at
TF32 products, the next precision below the configurations' float32,
comes out not correct, while the program comes out correct, on the same
served requests, for three seeds. The configuration at its published
size under a short closed loop (16 clients, prompts of 64-256 tokens,
answers of 32-64), every finished request judged. Needs a CUDA device;
skips without one."""
import pytest

from perfbench import harness, judge, traffic

SEEDS = [2 ** 31 + 17, 3 * 10 ** 9 + 5, 77]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control reads the card's TF32")
    return "cuda"


def _mix():
    gen = {"seed": 5, "count": 256,
           "prompt": {"dist": "uniform", "min": 64, "max": 256},
           "output": {"dist": "uniform", "min": 32, "max": 64}}
    return {"name": "control", "loop": "closed", "clients": 16, "slots": 8,
            "setup_group": 8, "warm": "first_completion", "warm_steps": 0,
            "check": {"from": "finished", "requests": 10 ** 6},
            "generator": gen, "requests": traffic.generate(gen)}


@pytest.mark.parametrize("name", ["phi4-mini-3.8b"])
def test_control_is_not_correct(card, name):
    config = harness.load_json("configs", name)
    for seed in SEEDS:
        out = harness.serve(config, _mix(), seed, 4.0, trace=False,
                            device=card, metrics=[], control=True,
                            clock=lambda: 0.0)
        assert judge.correct(out["compared"]), (seed, out["compared"])
        assert not judge.correct(out["control"]), (seed, out["control"])
