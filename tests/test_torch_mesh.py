"""The port's mesh on the CPU, against the JAX package's on two devices.

The two-device cases run in processes of their own (each with a timeout
of its own): ``_mesh_jax.py`` runs the JAX package on two forced host
devices, and ``_mesh_ranks.py`` runs the port as two ``gloo`` ranks; both
read one ``inputs.npz`` made here from seeds (the reduced models' weights
by the JAX package):

* the flash-decode combine of ``paged_decode_attention`` over a
  ``(data=1, model=2)`` mesh, on DTensors and on local shards, and
  ``prefill`` + three ``decode_step`` of reduced phi3-mini there
  (tensor-parallel parameters, pages striped over two shards);
* reduced qwen2-moe's ``moe_ffn`` through the expert-parallel path;
* ``compressed_psum`` over two ranks;
* reduced libra-proxy's ``Trainer`` on ``(data=2, model=1)`` against the
  JAX package's on the same mesh, and against the port's one-device run.

In one process: ``Trainer.resume(mesh=...)`` onto a ``(1, 1)`` mesh (the
JAX trainer's checkpoint too), and ``compressed_psum`` on one rank (twins
of ``tests/test_training_ft.py``'s two mesh tests).
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as jconfigs
from _mesh_cases import (
    DECODE_ARCH,
    JAX_CKPT,
    MOE_ARCH,
    TRAIN_ARCH,
    TRAIN_BATCH,
    TRAIN_OPT,
    TRAIN_SEQ,
    make_inputs,
)
from repro.core.anchor_pool import AnchorPool
from repro.data.pipeline import DataPipeline as JPipe
from repro.data.pipeline import SyntheticCorpus as JCorpus
from repro.models.registry import build_model as j_build
from repro.training.optimizer import AdamWConfig as JCfg
from repro.training.train_loop import Trainer as JTrainer

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
#: each spawned process's own limit, seconds
PROC_TIMEOUT = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(TESTS)])
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Run both sides once: ``(inputs, jax outputs, rank outputs (a list),
    rank-0 json)``."""
    d = tmp_path_factory.mktemp("mesh")
    dec = j_build(jconfigs.get_reduced(DECODE_ARCH), page_size=8)
    dp = jax.tree.map(np.asarray, dec.init_params(jax.random.PRNGKey(0)))
    mcfg = jconfigs.get_reduced(MOE_ARCH)
    mp = jax.tree.map(np.asarray, j_build(mcfg).init_params(
        jax.random.PRNGKey(1))["layers"])
    mp = jax.tree.map(lambda a: a[0], mp["moe"])
    inp = make_inputs(AnchorPool, dp, mp, dec.cfg.vocab_size,
                      mcfg.d_model)
    np.savez(d / "inputs.npz", **inp)
    tcfg = jconfigs.get_reduced(TRAIN_ARCH)
    JTrainer(j_build(tcfg), JCfg(**TRAIN_OPT),
             JPipe(JCorpus(tcfg.vocab_size, seed=1), batch=TRAIN_BATCH,
                   seq_len=TRAIN_SEQ),
             checkpoint_dir=str(d / JAX_CKPT), seed=0).save(blocking=True)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(TESTS / "_mesh_jax.py"),
                               str(d)], env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen([sys.executable, str(TESTS / "_mesh_ranks.py"),
                                str(r), str(port), str(d)], env=_env(),
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PROC_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [dict(np.load(d / f"torch{r}.npz")) for r in range(2)]
    with open(d / "torch.json") as f:
        meta = json.load(f)
    return inp, dict(np.load(d / "jax.npz")), ranks, meta


# ---------------------------------------------------------------------------
# two devices
# ---------------------------------------------------------------------------

def test_flash_decode_combine_matches_jax_on_two_shards(cases):
    """Each of two ``model`` ranks attends over its shard's pages and the
    partials are combined by all-reduces: the output within 1e-5 of the
    JAX package's ``shard_map``, on DTensors and on local shards, and the
    incoming token's K/V written into its owner's page only."""
    _inp, j, ranks, _ = cases
    for t in ranks:
        np.testing.assert_allclose(t["attn_out"], j["attn_out"], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(t["attn_out_local"], j["attn_out"],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(t["attn_pool"], j["attn_pool"])


def test_prefill_and_decode_on_a_two_rank_mesh_match_jax(cases):
    """Reduced phi3-mini's prefill and three decode steps on
    ``(data=1, model=2)``, parameters tensor-parallel: the tokens equal
    the JAX package's and the pool agrees to 1e-5."""
    _inp, j, ranks, _ = cases
    for t in ranks:
        np.testing.assert_array_equal(t["dec_tokens_out"],
                                      j["dec_tokens_out"])
        np.testing.assert_allclose(t["dec_pool"], j["dec_pool"], atol=1e-5,
                                   rtol=1e-5)


def test_expert_parallel_moe_matches_jax(cases):
    """Reduced qwen2-moe's FFN with its 8 experts split over two ranks:
    within 1e-5 of the JAX package's expert-parallel path, and of the
    port's one-device path."""
    _inp, j, ranks, _ = cases
    for t in ranks:
        np.testing.assert_allclose(t["moe_out"], j["moe_out"], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(t["moe_out"], t["moe_out_one_device"],
                                   atol=1e-5, rtol=1e-5)


def test_compressed_psum_on_two_ranks(cases):
    """int8 with error feedback: the mean within 2e-2 of the exact mean
    and equal to the JAX package's (1e-6), each rank's residual its own
    quantisation error."""
    inp, j, ranks, _ = cases
    g = inp["cp_g"]
    exact = g.mean(axis=0)
    for r, t in enumerate(ranks):
        rel = np.linalg.norm(t["cp_mean"] - exact) / np.linalg.norm(exact)
        assert rel < 2e-2, rel
        np.testing.assert_allclose(t["cp_mean"], j["cp_mean"][r], atol=1e-6)
        np.testing.assert_allclose(t["cp_err"], j["cp_err"][r], atol=1e-6)
        amax = np.abs(g[r]).max() + 1e-12
        scale = np.float32(amax / 127.0)
        q = np.clip(np.round(g[r] / scale), -127, 127)
        np.testing.assert_allclose(t["cp_err"], g[r] - q * scale, atol=1e-6)
        assert np.abs(t["cp_err"]).max() > 0


def test_trainer_on_a_data_parallel_mesh_tracks_one_device(cases):
    """Reduced libra-proxy's ``Trainer`` on ``(data=2, model=1)``, the
    parameters FSDP-sharded over ``data``: with every product in float32
    the three steps' losses are within 1e-4 of the one-device run's. In
    bfloat16 (the trainer's own precision) the two runs round their
    per-rank gradients apart: within 2e-3, about as far as the two
    packages' bfloat16 losses lie apart
    (``tests/test_torch_models_smoke.py``)."""
    *_, meta = cases
    assert "Shard" in meta["train_f32_placements"]
    np.testing.assert_allclose(meta["train_f32_mesh"], meta["train_f32_one"],
                               atol=1e-4, rtol=0)
    assert meta["train_bf16_mesh"][0] == meta["train_bf16_one"][0]
    np.testing.assert_allclose(meta["train_bf16_mesh"],
                               meta["train_bf16_one"], atol=2e-3, rtol=0)


def test_trainer_on_a_data_parallel_mesh_matches_jax(cases):
    """Reduced libra-proxy's ``Trainer`` on ``(data=2, model=1)`` against
    the JAX package's ``Trainer`` on the same mesh of two host devices:
    the same parameters (the JAX trainer's checkpoint at step 0, resumed
    onto the port's mesh) and batches, every product in float32. The
    three steps' losses are within 1e-4."""
    _inp, j, _ranks, meta = cases
    np.testing.assert_allclose(meta["train_f32_mesh_from_jax"],
                               j["train_f32_jax"], atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# one process: a one-rank group
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank_group():
    """A one-rank ``gloo`` group, destroyed after the test."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mk_trainer(tmp, mesh=None):
    import repro_torch.configs as tconfigs
    from repro_torch.data.pipeline import DataPipeline, SyntheticCorpus
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import Trainer

    cfg = tconfigs.get_reduced("libra-proxy-125m")
    pipe = DataPipeline(SyntheticCorpus(cfg.vocab_size, seed=1), batch=4,
                        seq_len=32)
    return Trainer(build_model(cfg), AdamWConfig(lr=3e-3, warmup_steps=5,
                                                 total_steps=200),
                   pipe, checkpoint_dir=tmp, checkpoint_every=5, seed=0,
                   device="cpu", mesh=mesh)


def test_elastic_restore_other_mesh(tmp_path, one_rank_group):
    """Restore a checkpoint onto a mesh (elastic restart): the parameters
    come back as DTensors on it, and training carries on from them with
    the losses of the run that never stopped."""
    from torch.distributed.tensor import DTensor

    from repro_torch.common.sharding import make_mesh

    t1 = _mk_trainer(str(tmp_path))
    t1.train(4)
    t1.save(blocking=True)
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    t2 = _mk_trainer(str(tmp_path))
    assert t2.resume(mesh=mesh)
    assert isinstance(t2.params["layers"]["wq"], DTensor)
    assert isinstance(t2.opt_state.mu["layers"]["wq"], DTensor)
    h = t2.train(2)
    assert np.isfinite(h[-1]["loss"])
    assert [x["loss"] for x in h] == [x["loss"] for x in t1.train(2)[-2:]]


def test_jax_checkpoint_resumes_onto_a_mesh(tmp_path, one_rank_group):
    """A checkpoint written by the JAX package's ``Trainer`` resumes in
    the port onto a ``(1, 1)`` mesh: the same step, pipeline state and
    parameters."""
    from repro.data.pipeline import DataPipeline as JPipe
    from repro.data.pipeline import SyntheticCorpus as JCorpus
    from repro.training.optimizer import AdamWConfig as JCfg
    from repro.training.train_loop import Trainer as JTrainer
    from repro_torch.common.sharding import make_mesh

    cfg = jconfigs.get_reduced("libra-proxy-125m")
    jt = JTrainer(j_build(cfg), JCfg(lr=3e-3, warmup_steps=5,
                                     total_steps=200),
                  JPipe(JCorpus(cfg.vocab_size, seed=1), batch=4, seq_len=32),
                  checkpoint_dir=str(tmp_path), checkpoint_every=50, seed=0)
    jt.train(3)
    jt.save(blocking=True)
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    t = _mk_trainer(str(tmp_path))
    assert t.resume(mesh=mesh)
    assert t.step == 3
    assert t.pipeline.state.as_dict() == jt.pipeline.state.as_dict()
    np.testing.assert_array_equal(
        t.params["layers"]["wq"].full_tensor().detach().numpy(),
        np.asarray(jt.params["layers"]["wq"]))
    assert np.isfinite(t.train(1)[-1]["loss"])


def test_gradient_compression_close_to_exact(one_rank_group):
    """int8 compressed psum with error feedback: single-participant mean
    must track the exact gradient closely; residual carries the error."""
    from repro_torch.training.optimizer import compressed_psum

    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 64)).astype(np.float32))}
    err = {"w": torch.zeros_like(g["w"])}
    out, err2 = compressed_psum(g, None, err)
    rel = float(torch.linalg.norm(out["w"] - g["w"])
                / torch.linalg.norm(g["w"]))
    assert rel < 0.02, rel
    # error feedback: residual equals the quantisation error
    assert float(err2["w"].abs().max()) > 0
    torch.testing.assert_close(out["w"] + err2["w"], g["w"])


def test_trainer_without_a_mesh_is_unchanged(tmp_path):
    """With no mesh the trainer keeps plain tensors and no process group
    is needed."""
    t = _mk_trainer(str(tmp_path))
    assert not dist.is_initialized()
    assert type(t.params["layers"]["wq"]) is torch.Tensor
    assert np.isfinite(t.train(1)[-1]["loss"])
