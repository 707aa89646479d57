"""The port's live-migration surface against the JAX package's.

``ServingEngine.kv_shape_key`` / ``serialize_request`` / ``adopt`` /
``export_chain`` / ``graft_chain`` and ``AdoptError``, engine to engine:
every scenario runs on two JAX engines and on two port engines with the
same weights and trace, and the token streams, the per-engine
``recomputed_tokens`` and the payloads' shapes must be equal. The
exported KV itself agrees within fp32 rounding of the two forwards, and
the checksum the port stamps on a block equals the reference's CRC over
the same bytes.

Covers a request moved mid-decode and mid-chunked-prefill, a queued one
(``kv: None``), chains exported from the device pool and from the host
offload tier (copied, never aliasing the tier's buffers), a corrupt
export dropped at the graft, and every ``AdoptError`` case: a full pool,
no free slot, an unregistered adapter and a layout mismatch.
"""

import types

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.inference.serving as JV
from paddle_tpu.inference.serving import engine as JE
from paddle_tpu.inference.serving.offload import block_crc as j_block_crc
from paddle_tpu.inference.serving.paged_cache import \
    prefix_block_chain as j_chain
from paddle_tpu.models import llama as JL
from paddle_tpu.models.lora import lora_init_params

import paddle_tpu_torch.inference.serving as TV
from paddle_tpu_torch.inference.serving import engine as TE
from paddle_tpu_torch.inference.serving.offload import block_crc
from paddle_tpu_torch.inference.serving.paged_cache import prefix_block_chain
from paddle_tpu_torch.models.convert import config_from_jax, params_from_jax

torch.set_num_threads(2)

BASE = dict(block_size=4, max_slots=2, max_model_len=32, decode_chunk=2,
            queue_depth=8)
JAX = types.SimpleNamespace(name="jax", V=JV, E=JE)
PORT = types.SimpleNamespace(name="port", V=TV, E=TE)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    cfg = JL.LlamaConfig(vocab_size=97, hidden_size=64,
                         intermediate_size=96, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=64)
    params = JL.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, (s,)).astype(np.int32)
               for s in [9, 5, 12, 7]]
    return types.SimpleNamespace(
        cfg=cfg, params=params, tcfg=config_from_jax(cfg),
        tparams=params_from_jax(_np(params), device="cpu"),
        prompts=prompts, programs={})


def mk(s, ns, **kw):
    """An engine of either package at BASE (+ overrides); JAX engines
    share compiled programs per override set."""
    sc = {**BASE, **kw}
    if ns is JAX:
        key = tuple(sorted((k, str(v)) for k, v in kw.items()
                           if k not in ("num_blocks", "queue_depth")))
        eng = JE.ServingEngine(s.params, s.cfg, JV.ServingConfig(**sc),
                               programs=s.programs.get(key))
        s.programs.setdefault(key, eng.programs)
        return eng
    return TE.ServingEngine(s.tparams, s.tcfg, TV.ServingConfig(**sc),
                            device="cpu")


def both(scenario, s, *args, **kw):
    want = scenario(s, JAX, *args, **kw)
    got = scenario(s, PORT, *args, **kw)
    assert got == want
    return got


def drain(eng, acc, cap=300):
    steps = 0
    while eng.pending:
        for rid, toks in eng.step(1).items():
            acc.setdefault(rid, []).extend(int(t) for t in toks)
        steps += 1
        assert steps < cap


def kv_meta(payload):
    """A payload's shape without its bytes (comparable across packages)."""
    kv = payload["kv"]
    if kv is None:
        return None
    data = kv["data"]
    return {k: v for k, v in kv.items() if k not in ("data", "shape_key")
            } | {"leaves": None if data is None else
                 {n: tuple(a.shape) for n, a in data.items()}}


def as_np(a):
    """Host numpy of a payload leaf (bf16 never reaches here: fp32/int8)."""
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class TestLayoutKey:
    @pytest.mark.parametrize("kvq", [None, "int8"])
    def test_shape_key_equals_reference(self, setup, kvq):
        """The layout signature names the same leaves, per-block shapes
        and dtypes as the reference's (block axis left out; the int8
        scale leaves included)."""
        keys = [mk(setup, ns, kv_quant=kvq).kv_shape_key()
                for ns in (JAX, PORT)]
        assert keys[0] == keys[1]
        leaves = dict((n, (d, sh)) for n, d, sh in keys[1][3])
        assert set(leaves) == ({"k", "v"} if kvq is None else
                               {"k", "v", "k_scale", "v_scale"})
        assert leaves["k"][1] == (2, 4, 2, 16)   # [L, bs, Hk, D]
        if kvq:
            assert leaves["k"][0] == "int8"
            assert leaves["k_scale"] == ("float32", (2, 4, 2))
        # a pool of another size still interoperates
        assert mk(setup, PORT, kv_quant=kvq,
                  num_blocks=9).kv_shape_key() == keys[1]


class TestSerializeAdopt:
    @pytest.mark.parametrize("kvq", [None, "int8"])
    def test_mid_decode_moves_bit_exact(self, setup, kvq):
        """Requests serialized mid-decode and adopted by a second engine
        finish with the origin's uninterrupted streams and recompute
        nothing; the moved KV equals the JAX engine's within fp32
        rounding, and its checksum is the reference's over the same
        bytes."""
        def run(s, ns):
            ref = mk(s, ns, max_slots=4, kv_quant=kvq)
            rr = [ref.submit(p, max_new_tokens=7, eos_token_id=None)
                  for p in s.prompts]
            want = {}
            drain(ref, want)
            a = mk(s, ns, max_slots=4, kv_quant=kvq)
            b = mk(s, ns, max_slots=4, kv_quant=kvq)
            rids = [a.submit(p, max_new_tokens=7, eos_token_id=None)
                    for p in s.prompts]
            got = {}
            for _ in range(2):
                for rid, toks in a.step(1).items():
                    got.setdefault(rid, []).extend(int(t) for t in toks)
            payloads = [a.serialize_request(r) for r in rids]
            meta = [kv_meta(p) for p in payloads]
            moved = {}
            for r, p in zip(rids, payloads):
                nr = b.adopt(p)
                a.cancel(r)
                moved[nr] = r
            assert a.cache.manager.blocks_in_use == 0
            after = {}
            drain(b, after)
            streams = [got.get(r, []) + after.get(nr, [])
                       for nr, r in sorted(moved.items(),
                                           key=lambda kv: kv[1])]
            assert streams == [want[r] for r in rr]
            assert b.cache.manager.blocks_in_use == 0
            return (streams, meta, b.stats()["recomputed_tokens"],
                    [p["kv"]["data"] for p in payloads])

        j = run(setup, JAX)
        t = run(setup, PORT)
        assert t[:3] == j[:3] and t[2] == 0
        for jd, td in zip(j[3], t[3]):
            for name, arr in td.items():
                x, y = as_np(arr), np.asarray(jd[name])
                if kvq and name in ("k", "v"):
                    # int8 entries differ at most by one step at x.5 ties
                    assert np.abs(x.astype(np.int32)
                                  - y.astype(np.int32)).max() <= 1
                else:
                    np.testing.assert_allclose(
                        x, y, rtol=0, atol=1e-5 * max(1.0, np.abs(y).max()))
                assert block_crc(arr) == j_block_crc(x)

    def test_mid_chunked_prefill_resumes_at_offset(self, setup):
        def run(s, ns):
            long_p = np.concatenate([s.prompts[2], s.prompts[3]])
            a = mk(s, ns, prefill_chunk=4)
            b = mk(s, ns, prefill_chunk=4)
            r = a.submit(long_p, max_new_tokens=5, eos_token_id=None)
            a.step(1)
            p = a.serialize_request(r)
            nr = b.adopt(p)
            a.cancel(r)
            out = {}
            drain(b, out)
            ref = mk(s, ns, prefill_chunk=4)
            rr = ref.submit(long_p, max_new_tokens=5, eos_token_id=None)
            want = {}
            drain(ref, want)
            return (kv_meta(p), out[nr], want[rr],
                    b.stats()["recomputed_tokens"])

        meta, out, want, rc = both(run, setup)
        assert meta["prefilling"] and meta["entries"] == 4
        assert out == want and rc == 0

    def test_queued_request_serializes_without_kv(self, setup):
        def run(s, ns):
            a = mk(s, ns, max_slots=1)
            b = mk(s, ns)
            r0 = a.submit(s.prompts[0], max_new_tokens=3, eos_token_id=None)
            r1 = a.submit(s.prompts[1], max_new_tokens=3, eos_token_id=None)
            a.step(1)
            p = a.serialize_request(r1)
            nr = b.adopt(p)
            a.cancel(r1)
            out_a, out_b = {}, {}
            drain(a, out_a)
            drain(b, out_b)
            return (p["kv"], p["tokens"], out_b[nr], out_a[r0],
                    a.serialize_request(r0), a.serialize_request(10 ** 6))

        kv, toks, _, _, done, unknown = both(run, setup)
        assert kv is None and toks == [] and done is None
        assert unknown is None


class TestChainExportGraft:
    def _chain(self, prompt, bs=4):
        keys = list(prefix_block_chain(prompt, bs, len(prompt)))
        assert keys == list(j_chain(prompt, bs, len(prompt)))
        return keys

    def test_device_chain_grafts_and_hits(self, setup):
        """A chain exported from one engine's pool and grafted into
        another's is a prefix hit there: the next request recomputes
        nothing of it and streams as on the holder."""
        def run(s, ns):
            rng = np.random.default_rng(5)
            prefix = rng.integers(0, 97, (12,)).astype(np.int32)
            a, b = mk(s, ns), mk(s, ns)
            a.submit(np.concatenate([prefix, [1, 2]]), max_new_tokens=2,
                     eos_token_id=None)
            drain(a, {})
            chain = self._chain(prefix)
            payload = a.export_chain(chain)
            res = b.graft_chain(payload)
            again = b.graft_chain(payload)
            part = b.block_partition()
            p = np.concatenate([prefix, [3, 4, 5]]).astype(np.int32)
            rb = b.submit(p, max_new_tokens=4, eos_token_id=None)
            out = {}
            drain(b, out)
            ra = a.submit(p, max_new_tokens=4, eos_token_id=None)
            want = {}
            drain(a, want)
            crc_ok = all(block_crc(x) == j_block_crc(as_np(x))
                         == blk["crc"][n] for blk in payload["blocks"]
                         for n, x in blk["data"].items())
            return (len(payload["blocks"]), res, again, part["evictable"],
                    part["in_use"], b.stats()["prefix_hit_tokens"],
                    out[rb], want[ra], crc_ok)

        got = both(run, setup)
        assert got[0] == 3 and got[1] == {"grafted": 3, "present": 0,
                                          "corrupt": 0}
        assert got[2] == {"grafted": 0, "present": 3, "corrupt": 0}
        assert got[3] == 3 and got[4] == 0 and got[5] == 12
        assert got[6] == got[7] and got[8]

    def test_host_tier_chain_is_copied(self, setup):
        """Blocks that live in the holder's host tier export through a
        verified peek and are COPIED: the payload never aliases the
        tier's buffers, and the holder's tier keeps its entries."""
        def run(s, ns):
            rng = np.random.default_rng(9)
            a = mk(s, ns, num_blocks=9, prefix_cache=True, offload=True,
                   offload_blocks=16)
            first = rng.integers(0, 97, (12,)).astype(np.int32)
            a.submit(first, max_new_tokens=2, eos_token_id=None)
            drain(a, {})
            for _ in range(3):                    # churn the pool
                a.submit(rng.integers(0, 97, (12,)).astype(np.int32),
                         max_new_tokens=2, eos_token_id=None)
                drain(a, {})
            tier = a.cache.offload
            chain = self._chain(first)
            held = [tier.holds(k) for k, _ in chain]
            payload = a.export_chain(chain)
            if ns is PORT:
                tier.flush()
                bufs = {t.data_ptr() for e in tier._entries.values()
                        for t in e["data"].values()}
                assert not any(x.data_ptr() in bufs
                               for blk in payload["blocks"]
                               for x in blk["data"].values())
            b = mk(s, ns)
            res = b.graft_chain(payload)
            return (held, len(payload["blocks"]), res,
                    [tier.holds(k) for k, _ in chain],
                    tier.stats()["tier_hits"])

        held, n, res, still, hits = both(run, setup)
        assert all(held) and n == 3 and res["grafted"] == 3
        assert still == held and hits == 0

    def test_corrupt_export_stops_the_graft(self, setup):
        def run(s, ns):
            rng = np.random.default_rng(13)
            prefix = rng.integers(0, 97, (12,)).astype(np.int32)
            a, b = mk(s, ns), mk(s, ns)
            a.submit(np.concatenate([prefix, [7]]), max_new_tokens=2,
                     eos_token_id=None)
            drain(a, {})
            a._corrupt_next_export = True
            payload = a.export_chain(self._chain(prefix))
            armed = a._corrupt_next_export
            res = b.graft_chain(payload)
            clean = b.graft_chain(a.export_chain(self._chain(prefix)))
            return armed, res, clean, b.block_partition()["in_use"]

        armed, res, clean, in_use = both(run, setup)
        assert armed is False
        assert res == {"grafted": 0, "present": 0, "corrupt": 1}
        assert clean["grafted"] == 3 and in_use == 0
        assert TE.ServingEngine._corrupt_next_export is False

    def test_stale_chain_exports_none(self, setup):
        def run(s, ns):
            a = mk(s, ns)
            chain = self._chain(np.arange(1, 13, dtype=np.int32))
            return a.export_chain(chain), a.graft_chain(None)

        assert both(run, setup) == (None, {"grafted": 0, "present": 0,
                                           "corrupt": 0})


class TestAdoptErrors:
    def _payload(self, s, ns, **kw):
        a = mk(s, ns, **kw)
        r = a.submit(s.prompts[2], max_new_tokens=6, eos_token_id=None)
        a.step(1)
        return a.serialize_request(r)

    def _refusal(self, ns, target, payload):
        before = target.block_partition()
        with pytest.raises(ns.E.AdoptError) as ei:
            target.adopt(payload)
        assert target.block_partition() == before     # nothing leaked
        return str(ei.value)

    def test_full_pool(self, setup):
        def run(s, ns):
            p = self._payload(s, ns)
            return self._refusal(ns, mk(s, ns, num_blocks=3), p)

        assert both(run, setup) == "pool full"

    def test_no_free_slot(self, setup):
        def run(s, ns):
            p = self._payload(s, ns)
            t = mk(s, ns, max_slots=1)
            t.submit(s.prompts[0], max_new_tokens=6, eos_token_id=None)
            t.step(1)
            return self._refusal(ns, t, p)

        assert both(run, setup) == "no free decode slot"

    def test_layout_mismatch(self, setup):
        def run(s, ns):
            p = self._payload(s, ns)
            return self._refusal(ns, mk(s, ns, kv_quant="int8"), p)

        assert "layout mismatch" in both(run, setup)

    def test_graft_layout_mismatch(self, setup):
        def run(s, ns):
            a = mk(s, ns)
            prefix = np.arange(1, 13, dtype=np.int32)
            a.submit(np.concatenate([prefix, [5]]), max_new_tokens=2,
                     eos_token_id=None)
            drain(a, {})
            payload = a.export_chain(list(prefix_block_chain(prefix, 4,
                                                             12)))
            with pytest.raises(ns.E.AdoptError, match="layout mismatch"):
                mk(s, ns, kv_quant="int8").graft_chain(payload)
            return len(payload["blocks"])

        assert both(run, setup) == 3

    def test_unregistered_adapter(self, setup):
        lora = dict(block_size=8, max_slots=2, max_model_len=48,
                    lora_rank=4, lora_slots=2, lora_pool=8)
        ap = lora_init_params(setup.cfg, 4, seed=1, scale=0.5)

        def run(s, ns):
            a = mk(s, ns, **lora)
            a.register_adapter("a1", ap)
            r = a.submit(s.prompts[2], max_new_tokens=4, eos_token_id=None,
                         adapter_id="a1")
            a.step(1)
            p = a.serialize_request(r)
            msg = self._refusal(ns, mk(s, ns, **lora), p)
            t = mk(s, ns, **lora)
            t.register_adapter("a1", ap)
            nr = t.adopt(p)
            a.cancel(r)
            out = {}
            drain(t, out)
            ref = mk(s, ns, **lora)
            ref.register_adapter("a1", ap)
            rr = ref.submit(s.prompts[2], max_new_tokens=4,
                            eos_token_id=None, adapter_id="a1")
            want = {}
            drain(ref, want)
            return (msg, p["adapter_id"], p["tokens"] + out[nr], want[rr],
                    t.adapter_partition()["pinned"])

        msg, aid, out, want, pinned = both(run, setup)
        assert "not registered" in msg and aid == "a1"
        assert out == want and pinned == {}
