"""The harness's judgement on a broken program: each fault a serving cell
can have, planted under a run on the CPU at a tiny size, turns ``correct``
false. (Exchange between chips: no cell runs on more than one.)"""
import pytest

from perfbench import judge, testing


def _token_altered(inner):
    def step(self, params, tokens, *args, **kw):
        out = inner(self, params, tokens, *args, **kw)
        return (out + 1) % self.cfg.vocab_size
    return step


def _state_unchanged(inner):
    def step(self, params, tokens, seq_lens, pool, *args, **kw):
        saved = pool.clone()
        out = inner(self, params, tokens, seq_lens, pool, *args, **kw)
        pool.copy_(saved)          # the step's K/V never lands in the pool
        return out
    return step


def _half_batch(inner):
    def step(self, params, tokens, *args, **kw):
        out = inner(self, params, tokens, *args, **kw).clone()
        half = out.shape[0] // 2   # the second half takes the first's tokens
        out[half:] = out[:out.shape[0] - half]
        return out
    return step


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged, _half_batch])
def test_a_broken_decode_step_is_not_correct(monkeypatch, fault):
    from repro_torch.models.transformer import TransformerLM

    monkeypatch.setattr(TransformerLM, "decode_step",
                        fault(TransformerLM.decode_step))
    out = testing.serve_cpu(testing.tiny_config("phi4-mini-3.8b"),
                            testing.tiny_mix(), 11)
    assert not judge.correct(out["compared"])


def test_an_altered_first_token_is_not_correct(monkeypatch):
    from repro_torch.models.transformer import TransformerLM

    monkeypatch.setattr(TransformerLM, "prefill",
                        _token_altered(TransformerLM.prefill))
    out = testing.serve_cpu(testing.tiny_config("phi4-mini-3.8b"),
                            testing.tiny_mix(), 12)
    assert not judge.correct(out["compared"])
