"""The port's BERT encoder (``paddle_tpu_torch.models.bert``) and the serving
engine's embeddings endpoint against the JAX package's.

* ``bert_init_params``: the same seed gives the same arrays.
* ``bert_encode``: within 1e-5 x max|ref| of the JAX encoder on the same
  inputs, pad rows (length 0) and several bucket shapes included.
* ``bert_params_from_jax`` hands the JAX tree to the port unchanged.
* The embeddings endpoint: engine rows equal ``bert_encode`` of each
  request alone, a row does not depend on what it was batched with, embeds
  hold no KV block and no slot, interleave with generate traffic without
  changing its streams, and the engine's counters equal the JAX engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving.engine import ServingConfig as JConfig
from paddle_tpu.inference.serving.engine import ServingEngine as JEngine
from paddle_tpu.models import bert as JB
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference.serving.engine import ServingConfig as TConfig
from paddle_tpu_torch.inference.serving.engine import ServingEngine as TEngine
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.models.convert import (bert_params_from_jax,
                                             config_from_jax, params_from_jax)

torch.set_num_threads(2)

SMALL = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=64)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        else:
            out[pre + k] = v
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_init_params_equal_reference(seed):
    cfg = dict(SMALL, num_hidden_layers=3)
    want = _flat(_np(JB.bert_init_params(JB.BertConfig(**cfg), seed=seed)))
    got = _flat(TB.bert_init_params(TB.BertConfig(**cfg), seed=seed,
                                    device="cpu"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_config_defaults_match_reference():
    import dataclasses
    assert dataclasses.asdict(TB.BertConfig()) == \
        dataclasses.asdict(JB.BertConfig())


def _batch(rng, lens, S, vocab):
    ids = np.zeros((len(lens), S), np.int32)
    for r, n in enumerate(lens):
        ids[r, :n] = rng.integers(0, vocab, (n,))
    return ids, np.asarray(lens, np.int32)


@pytest.mark.parametrize("lens,S", [([4, 9, 6, 0], 16), ([1, 8], 8),
                                    ([17, 32, 3, 0, 0, 5, 30, 2], 32)])
def test_encode_matches_reference(lens, S):
    jcfg, tcfg = JB.BertConfig(**SMALL), TB.BertConfig(**SMALL)
    jp = JB.bert_init_params(jcfg, seed=1)
    tp = bert_params_from_jax(_np(jp), device="cpu")
    ids, ln = _batch(np.random.default_rng(len(lens)), lens, S, 128)
    want = np.asarray(JB.bert_encode(jp, jcfg, jnp.asarray(ids),
                                     jnp.asarray(ln)))
    got = TB.bert_encode(tp, tcfg, torch.from_numpy(ids),
                         torch.from_numpy(ln))
    assert got.dtype == torch.float32 and got.shape == want.shape
    real = ln > 0                       # pad rows' pooled rows are unread
    np.testing.assert_allclose(got.numpy()[real], want[real], rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert np.isfinite(got.numpy()).all()


def test_bert_params_from_jax_refuses_other_trees():
    with pytest.raises(ValueError, match="missing"):
        bert_params_from_jax({"embed": np.zeros((2, 2))}, device="cpu")


# ---------------------------------------------------------------------------
# the embeddings endpoint
# ---------------------------------------------------------------------------

LCFG = JL.LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=128)
BASE = dict(block_size=8, max_slots=4, max_model_len=96, queue_depth=16,
            decode_chunk=4)


@pytest.fixture(scope="module")
def engines():
    params = JL.init_params(LCFG, jax.random.PRNGKey(0))
    jb = JB.bert_init_params(JB.BertConfig(**SMALL), seed=3)
    tb = bert_params_from_jax(_np(jb), device="cpu")
    jeng = JEngine(params, LCFG, JConfig(**BASE),
                   embed_model=(JB.BertConfig(**SMALL), jb))
    teng = TEngine(params_from_jax(_np(params), device="cpu"),
                   config_from_jax(LCFG), TConfig(**BASE), device="cpu",
                   embed_model=(TB.BertConfig(**SMALL), tb))
    return jeng, teng, jb, tb


def embed_drain(eng, erids, max_steps=50):
    out = {}
    for _ in range(max_steps):
        for e in erids:
            if e not in out:
                try:
                    out[e] = np.asarray(eng.embedding(e))
                except KeyError:
                    pass
        if len(out) == len(erids):
            return [out[e] for e in erids]
        eng.step()
    raise AssertionError("embeddings did not drain")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, (int(s),)).astype(np.int32) for s in lens]


def test_engine_rows_equal_encode_alone_and_reference(engines):
    jeng, teng, jb, tb = engines
    ps = _prompts(5, (4, 9, 6, 20, 1))
    got = embed_drain(teng, [teng.submit_embedding(p) for p in ps])
    want = embed_drain(jeng, [jeng.submit_embedding(p) for p in ps])
    cfg = TB.BertConfig(**SMALL)
    for g, w, p in zip(got, want, ps):
        alone = TB.bert_encode(tb, cfg, torch.from_numpy(p[None]),
                               torch.tensor([len(p)]))[0].numpy()
        np.testing.assert_allclose(g, alone, rtol=0,
                                   atol=1e-5 * np.abs(alone).max())
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    # a solo resubmission: the same row as in the batch
    [solo] = embed_drain(teng, [teng.submit_embedding(ps[1])])
    np.testing.assert_allclose(solo, got[1], rtol=0,
                               atol=1e-6 * np.abs(got[1]).max())


def test_embeds_hold_no_kv_and_counters_match(engines):
    jeng, teng, _, _ = engines
    ps = _prompts(6, (5, 12, 7))
    for eng in (jeng, teng):
        free0 = eng.stats()["free_blocks"]
        in_use0 = eng.cache.manager.blocks_in_use
        before = {k: eng.stats()[k] for k in ("embeds",
                                              "prefill_dispatches")}
        erids = [eng.submit_embedding(p) for p in ps]
        assert eng.depth() == 3
        embed_drain(eng, erids)
        st = eng.stats()
        assert eng.cache.manager.blocks_in_use == in_use0
        assert st["free_blocks"] == free0 and st["live_slots"] == 0
        # 3 embeds, two length buckets (8, 16): two encoder dispatches
        assert (st["embeds"] - before["embeds"],
                st["prefill_dispatches"] - before["prefill_dispatches"]) \
            == (3, 2)
        for e in erids:
            assert eng.request(e).state == "finished"
            assert eng.request(e).kind == "embed"


def test_interleaved_with_generate_traffic(engines):
    """Embeds queued between generate requests leave the generate streams
    equal to the JAX engine's and finish in the first step."""
    jeng, teng, _, _ = engines
    gen = _prompts(8, (5, 8, 6))
    emb = _prompts(9, (10, 3))
    outs = []
    for eng in (jeng, teng):
        rids, erids = [], []
        for i, p in enumerate(gen):
            rids.append(eng.submit(p, max_new_tokens=6, eos_token_id=None))
            if i < len(emb):
                erids.append(eng.submit_embedding(emb[i]))
        eng.step()
        assert all(eng.request(e).state == "finished" for e in erids)
        while eng.pending:
            eng.step()
        outs.append([eng.request(r).output().tolist() for r in rids])
        assert eng.cache.manager.blocks_in_use == 0
    assert outs[1] == outs[0]


def test_structured_errors(engines):
    jeng, teng, _, _ = engines
    plain = TEngine(params_from_jax(_np(JL.init_params(
        LCFG, jax.random.PRNGKey(0))), device="cpu"),
        config_from_jax(LCFG), TConfig(**BASE), device="cpu")
    with pytest.raises(ValueError, match="embed_model"):
        plain.submit_embedding(np.arange(1, 5, dtype=np.int32))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        teng.submit_embedding(np.ones(65, np.int32))
    with pytest.raises(ValueError, match="at least one token"):
        teng.submit_embedding(np.zeros(0, np.int32))
