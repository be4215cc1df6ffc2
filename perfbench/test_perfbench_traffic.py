"""The traffic mixes: frozen lists equal to what their generator writes,
and every seed the same work (lengths, order, schedule), other token ids."""
import json

import numpy as np
import pytest

from perfbench import harness, testing, traffic

MIXES = sorted(p.stem for p in (harness.HERE / "traffic").glob("*.json"))


@pytest.mark.parametrize("name", MIXES)
def test_frozen_list_is_the_generators(name):
    mix = harness.load_json("traffic", name)
    assert mix["requests"] == traffic.generate(mix["generator"])
    assert len(mix["requests"]) == mix["generator"]["count"]


@pytest.mark.parametrize("name", MIXES)
def test_two_seeds_same_lengths_other_ids(name):
    mix = harness.load_json("traffic", name)
    a = traffic.prompt_tokens(mix, 2 ** 31 + 11, 151936)
    b = traffic.prompt_tokens(mix, 12345, 151936)
    assert [len(x) for x in a] == [len(x) for x in b] == \
        [p for p, _o in mix["requests"]]
    assert sum(map(len, a)) == sum(map(len, b))
    assert not np.array_equal(np.concatenate(a), np.concatenate(b))
    again = traffic.prompt_tokens(mix, 2 ** 31 + 11, 151936)
    assert all(np.array_equal(x, y) for x, y in zip(a, again))


@pytest.mark.parametrize("name", MIXES)
def test_clients_partition_the_list(name):
    mix = harness.load_json("traffic", name)
    seen = sorted(j for c in range(mix["clients"])
                  for j in traffic.client_entries(mix, c))
    assert seen == list(range(len(mix["requests"])))
    assert traffic.client_entries(mix, 1)[:2] == [1, 1 + mix["clients"]]


def test_frozen_file_round_trips(tmp_path):
    mix = testing.tiny_mix()
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps({k: v for k, v in mix.items()
                                if k != "requests"}))
    traffic.write_frozen(path)
    assert json.loads(path.read_text())["requests"] == mix["requests"]


@pytest.mark.parametrize("warm", ["first_completion", "admitted"])
@pytest.mark.parametrize("pool_pages", [0, 10])
def test_every_seed_drives_the_same_schedule(pool_pages, warm):
    """The engine's steps (prefill groups, padding, decode contexts,
    tokens a step and pages held) are the same for two seeds, also where
    admission waits for the pool's pages: the seed changes no work."""
    from repro_torch.common.types import ModelConfig
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import LibraEngine

    from perfbench import weights

    config = testing.tiny_config("phi4-mini-3.8b")
    mix = dict(testing.tiny_mix(warm=warm), pool_pages=pool_pages)
    schedules = []
    for seed in (3, 2 ** 31 + 99):
        cfg = ModelConfig(**config["model"])
        model = build_model(cfg, page_size=16)
        params = weights.draw(config["params"], seed, "cpu")
        prompts = traffic.prompt_tokens(mix, seed, cfg.vocab_size)
        eng = LibraEngine(model, params, max_batch=mix["slots"],
                          max_len=max(p + o for p, o in mix["requests"]) + 8,
                          page_size=16, pool_pages=pool_pages, device="cpu")
        loop = harness.ClosedLoop(eng, mix, prompts)
        harness.setup_loop(loop, mix)
        steps = [loop.step() for _ in range(40)]
        schedules.append([(s.tokens, s.prefill_lens, s.prefill_width,
                           s.decode_ctx, s.pool_used) for s in steps])
    assert schedules[0] == schedules[1]
    if pool_pages:   # the pool is full at times: admission waited
        assert max(s[4] for s in schedules[0]) > 0.8
