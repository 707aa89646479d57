"""The port's paged entry points (``paddle_tpu_torch.models.generation``)
against the JAX package's, on the same weights and the same inputs.

One scenario drives both sides through the four entry points the serving
engine dispatches, in engine order, each side from its own zeroed pool:

1. ``paged_prefill``: a batch of two prompts plus two inactive pad rows;
2. ``paged_prefill_chunk``: a third sequence whose first block is a
   PREFIX HIT on the first prompt's block, prefilled from offset 4;
3. ``paged_mixed_step``: two decode rows plus that sequence's last chunk
   as a ``q_len = 3`` row, and an inactive row;
4. ``paged_decode_step``: all three sequences decode, one row inactive.

Before step 3 the null block and the free blocks hold NaN: every active
row's logits must stay finite (the V-zeroing containment contract) and
match JAX. Tokens fed to steps 3 and 4 are the JAX side's greedy picks,
so both sides always see the same inputs. Weights come from the JAX
``llama.init_params`` through ``models.convert.params_from_jax``.

Tolerances, at fp32 activations:

* logits: atol 1e-4 (the same products summed in another order);
* fp pools: atol 1e-5 on every K/V entry outside the null block (block 0
  is the scatter target of masked lanes, whose duplicate writes land in
  an unspecified order in both frameworks);
* int8 pools: scales rtol 1e-5; int8 values equal, except that an entry
  may differ by one step where its fp32 quotient sits within rounding
  error of an int8 rounding boundary (x.5): the projections round
  differently in the last bit, so the two sides may round such a
  quotient to neighbouring integers. Such entries must stay rare.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import generation as JG
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.models.convert import config_from_jax, params_from_jax

torch.set_num_threads(2)

V, BS, W, N = 128, 4, 8, 28
# slot tables: A and B own 6 blocks each; C's first block IS A's first
# block (the prefix hit); the last two entries of every row are the null
# block; blocks 19..27 stay free
TABLES = np.array([[1, 2, 3, 4, 5, 6, 0, 0],
                   [7, 8, 9, 10, 11, 12, 0, 0],
                   [1, 13, 14, 15, 16, 17, 0, 0],
                   [0] * W], np.int32)
FREE = list(range(18, N))
LEN_A, LEN_B, LEN_C = 7, 5, 13
CHUNK = 6                       # C's first chunk: positions 4..9

COMBOS = {
    "gqa-fp": dict(kv_heads=2, kv_quant=None, quantize=False),
    "gqa-int8pool": dict(kv_heads=2, kv_quant="int8", quantize=False),
    "gqa-int8w": dict(kv_heads=2, kv_quant=None, quantize=True),
    "gqa-int8pool-int8w": dict(kv_heads=2, kv_quant="int8", quantize=True),
    "mha-fp": dict(kv_heads=4, kv_quant=None, quantize=False),
    # every norm through the fused rms_norm (Pallas in interpret mode on the
    # JAX side, the rms_norm Function's plain path in the port)
    "gqa-fp-fusednorm": dict(kv_heads=2, kv_quant=None, quantize=False,
                             use_fused_norm=True),
}
STEPS = ("prefill", "chunk", "mixed", "decode")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, V, size=LEN_A).astype(np.int32)
    b = rng.integers(0, V, size=LEN_B).astype(np.int32)
    c = rng.integers(0, V, size=LEN_C).astype(np.int32)
    c[:BS] = a[:BS]                              # the shared first block
    return a, b, c


def _poison(pool, kv_quant):
    """NaN into the null block and every free block."""
    out = {k: np.array(v) for k, v in pool.items()}
    names = ("k_scale", "v_scale") if kv_quant else ("k", "v")
    for n in names:
        out[n][:, [0] + FREE] = np.nan
    return out


def _scenario(side, params, cfg, kv_quant, use_kernel=False, picks=None):
    """Run the four entry points in order on one side (``side`` is "jax"
    or "torch"); returns ([(logits, pool)] per step as numpy, picks).
    ``picks`` are the greedy tokens steps 3 and 4 feed: the JAX side
    takes them from its own logits, the port is handed the JAX side's."""
    a, b, c = _inputs()
    if side == "jax":
        pool = JG.init_paged_pool(cfg, N, BS, kv_quant=kv_quant)
        A = jnp.asarray

        def out(lg, p):
            return np.asarray(lg), {k: np.asarray(v) for k, v in p.items()}
    else:
        pool = TG.init_paged_pool(cfg, N, BS, kv_quant=kv_quant,
                                  device="cpu")

        def A(x):
            return torch.from_numpy(np.ascontiguousarray(x))

        def out(lg, p):
            return lg.numpy(), {k: v.clone().numpy() for k, v in p.items()}
    rec = []
    picks = {} if picks is None else picks

    def call(fn, *args, **kw):
        r = fn(*args, **kw)
        return r[0], r[1]                    # JAX also returns MoE drops

    G = JG if side == "jax" else TG
    ids = np.zeros((4, 8), np.int32)
    ids[0, :LEN_A], ids[1, :LEN_B] = a, b
    plens = np.array([LEN_A, LEN_B, 1, 1], np.int32)
    act = np.array([True, True, False, False])
    tbl = np.concatenate([TABLES[:2], np.zeros((2, W), np.int32)])
    lg, pool = call(G.paged_prefill, params, cfg, A(ids), A(plens), A(tbl),
                    pool, A(act))
    rec.append(out(lg, pool))

    cid = np.zeros((1, 8), np.int32)
    cid[0, :CHUNK] = c[BS:BS + CHUNK]
    start, n = (BS, CHUNK)
    if side == "jax":
        start, n = jnp.asarray(start, jnp.int32), jnp.asarray(n, jnp.int32)
    lg, pool = call(G.paged_prefill_chunk, params, cfg, A(cid), start, n,
                    A(TABLES[2:3]), pool)
    rec.append(out(lg, pool))

    # poison, then one mixed step: A and B decode, C's last 3 tokens
    if side == "jax":
        pool = {k: jnp.asarray(v) for k, v in
                _poison(pool, kv_quant).items()}
    else:
        for k, v in _poison({k: v.numpy() for k, v in pool.items()},
                            kv_quant).items():
            pool[k].copy_(torch.from_numpy(v))
    if side == "jax":
        picks["prefill"] = np.argmax(rec[0][0][:2], -1).astype(np.int32)
    tok_a, tok_b = picks["prefill"]
    toks = np.zeros((4, 4), np.int32)
    toks[0], toks[1] = tok_a, tok_b
    toks[2, :3] = c[BS + CHUNK:]
    toks[2, 3] = c[-1]
    toks[3] = c[0]
    starts = np.array([LEN_A, LEN_B, BS + CHUNK, 0], np.int32)
    qlens = np.array([1, 1, 3, 1], np.int32)
    act = np.array([True, True, True, False])
    lg, pool = call(G.paged_mixed_step, params, cfg, A(toks), A(starts),
                    A(qlens), A(TABLES), pool, A(act),
                    use_kernel=use_kernel)
    rec.append(out(lg, pool))

    if side == "jax":
        picks["mixed"] = np.append(np.argmax(rec[2][0][:3], -1),
                                   0).astype(np.int32)
    tok = picks["mixed"]
    seq = np.array([LEN_A + 1, LEN_B + 1, LEN_C, 0], np.int32)
    lg, pool = call(G.paged_decode_step, params, cfg, A(tok), A(seq),
                    A(TABLES), pool, A(act), use_kernel=use_kernel)
    rec.append(out(lg, pool))
    return rec, picks


def _jax_model(combo):
    c = COMBOS[combo]
    cfg = JL.LlamaConfig(vocab_size=V, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=c["kv_heads"],
                         use_fused_norm=c.get("use_fused_norm", False))
    params = JL.init_params(cfg, jax.random.PRNGKey(11))
    if c["quantize"]:
        params = JL.quantize_params(params)
    return cfg, params


@pytest.fixture(scope="module")
def runs():
    """Per combo: the JAX run and the port's runs (gather and kernel
    paths), computed once for the module."""
    cache = {}

    def get(combo):
        if combo not in cache:
            cfg, jp = _jax_model(combo)
            kvq = COMBOS[combo]["kv_quant"]
            tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")
            tcfg = config_from_jax(cfg)
            want, picks = _scenario("jax", jp, cfg, kvq)
            cache[combo] = {"jax": want}
            for use in (False, True):
                cache[combo][use], _ = _scenario("torch", tp, tcfg, kvq,
                                                 use_kernel=use, picks=picks)
        return cache[combo]
    return get


def _assert_pool(got, want):
    assert set(got) == set(want)
    for name in want:
        g, w = got[name][:, 1:], want[name][:, 1:]     # not the null block
        assert g.dtype == w.dtype, name
        if name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
        elif g.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1, name
            assert (diff > 0).mean() < 1e-3, name
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


# the prefill entry points have no kernel path; decode and mixed run both
CASES = [(c, s, k) for c in COMBOS for s in STEPS
         for k in ((False, True) if s in ("mixed", "decode") else (False,))]


@pytest.mark.parametrize(
    "combo,step,use_kernel", CASES,
    ids=[f"{c}-{s}-{'kernel' if k else 'gather'}" for c, s, k in CASES])
def test_entry_point_matches_jax(runs, combo, step, use_kernel):
    r = runs(combo)
    i = STEPS.index(step)
    (lg, pool), (want_lg, want_pool) = r[use_kernel][i], r["jax"][i]
    assert lg.dtype == np.float32 and lg.shape == want_lg.shape
    live = 2 if step == "prefill" else 1 if step == "chunk" else 3
    assert np.isfinite(lg[:live]).all()
    np.testing.assert_allclose(lg[:live], want_lg[:live], rtol=0, atol=1e-4)
    _assert_pool(pool, want_pool)


def test_out_of_vocab_ids_embed_as_nan_rows():
    """``jnp.take`` fill semantics: ids in [-V, V) wrap like Python
    indices, anything else embeds as a NaN row (never a device index
    error)."""
    emb = np.arange(12.0, dtype=np.float32).reshape(4, 3)
    ids = np.array([[-5, -4, -1, 0, 3, 4, 7]], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(emb), jnp.asarray(ids), axis=0))
    got = TG._embed({"embed": torch.from_numpy(emb)}, torch.from_numpy(ids),
                    torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def test_pool_layout_and_block_bytes_match_jax():
    cfg, _ = _jax_model("gqa-fp")
    tcfg = config_from_jax(cfg)
    for kvq in (None, "int8"):
        jp = JG.init_paged_pool(cfg, 5, BS, kv_quant=kvq)
        tp = TG.init_paged_pool(tcfg, 5, BS, kv_quant=kvq, device="cpu")
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()} \
            == {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in tp.items()}
        assert TG.paged_pool_block_bytes(tcfg, BS, kv_quant=kvq) == \
            JG.paged_pool_block_bytes(cfg, BS, kv_quant=kvq)
