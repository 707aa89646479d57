"""The port's transformer layers (``nn.MultiHeadAttention``,
``TransformerEncoder(Layer)``, ``TransformerDecoder(Layer)``,
``Transformer``, ``generate_square_subsequent_mask``) against the JAX
package's, covering ``tests/test_nn.py::TestTransformer``.

Every twin loads the JAX layer's ``state_dict()`` by name; inputs come
from numpy with a seed; dropout is 0 (masks cannot match across
frameworks). fp32 outputs within ``1e-5 * max|ref|``, every parameter's
gradient of ``sum(out**2)`` within ``1e-4 * max|g|`` (``max|g|`` at
least 1e-2 of the model's largest gradient: the key projection's bias
gets a gradient that is zero analytically, since softmax ignores a shift
shared by all keys, and both packages return rounding noise for it). Covered: self- and
cross-attention, ``need_weights`` (the materialized probabilities), an
additive causal mask and a boolean one, both caches (incremental
``Cache`` and ``StaticCache``) step by step against the whole sequence,
pre- and post-norm stacks, and the full encoder-decoder.

Also recorded: the stacks' deep copies. The port renames every copied
parameter (its optimizers key state by name); the reference's copies
keep their source's names, so its optimizers share one state among the
copies (ROADMAP §C).
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T

FWD, GRAD = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def close(got, want, rtol, what="", floor=1e-30):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rtol * max(float(np.abs(want).max(initial=0.0)), floor), \
        f"{what}: {err}"


def both(build, seed=0):
    J.seed(seed)
    jl = build(J)
    tl = build(T)
    missing, unexpected = tl.set_state_dict(jl.state_dict())
    assert not missing and not unexpected
    return jl, tl


def arr(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def run_both(jl, tl, call):
    """``call(p, layer)`` -> output(s) in each package; the loss is
    sum(out**2) over the first output; returns (outs, grads) per package."""
    res = []
    for p, layer in ((J, jl), (T, tl)):
        out = call(p, layer)
        first = out[0] if isinstance(out, tuple) else out
        (first * first).sum().backward()
        outs = [o.numpy() for o in (out if isinstance(out, tuple) else
                                    (out,)) if hasattr(o, "numpy")]
        grads = {n: q.grad.numpy() for n, q in layer.named_parameters()
                 if q.grad is not None}
        res.append((outs, grads))
    (oj, gj), (ot, gt) = res
    assert len(ot) == len(oj)
    for i, (a, b) in enumerate(zip(ot, oj)):
        close(a, b, FWD, f"output {i}")
    assert gt.keys() == gj.keys()
    floor = 1e-2 * max(float(np.abs(g).max()) for g in gj.values())
    for n in gj:
        close(gt[n], gj[n], GRAD, f"grad {n}", floor)
    return res


class TestMultiHeadAttention:
    @pytest.mark.parametrize("need_weights", [False, True])
    def test_self_attention(self, need_weights):
        jl, tl = both(lambda p: p.nn.MultiHeadAttention(
            16, 4, need_weights=need_weights))
        x = arr(2, 5, 16)
        res = run_both(jl, tl, lambda p, m: m(p.to_tensor(x)))
        if need_weights:
            w = res[1][0][1]
            assert w.shape == (2, 4, 5, 5)
            np.testing.assert_allclose(w.sum(-1), 1.0, rtol=1e-5)

    @pytest.mark.parametrize("need_weights", [False, True])
    def test_cross_attention_with_mask(self, need_weights):
        jl, tl = both(lambda p: p.nn.MultiHeadAttention(
            16, 2, kdim=12, vdim=10, need_weights=need_weights), seed=1)
        q, k, v = arr(2, 3, 16, seed=1), arr(2, 6, 12, seed=2), \
            arr(2, 6, 10, seed=3)
        mask = np.zeros((2, 1, 3, 6), np.float32)
        mask[1, ..., 4:] = -1e4
        run_both(jl, tl, lambda p, m: m(p.to_tensor(q), p.to_tensor(k),
                                        p.to_tensor(v),
                                        attn_mask=p.to_tensor(mask)))

    def test_causal_mask_effect(self):
        jl, tl = both(lambda p: p.nn.MultiHeadAttention(4, 1), seed=2)
        x1 = arr(1, 3, 4, seed=4)
        x2 = x1.copy()
        x2[0, 2] += 1.0
        masks = [p.nn.Transformer.generate_square_subsequent_mask(3)
                 for p in (J, T)]
        np.testing.assert_array_equal(masks[1].numpy(), masks[0].numpy())
        for p, m, mask in ((J, jl, masks[0]), (T, tl, masks[1])):
            m.eval()
        o = [[m(p.to_tensor(x), attn_mask=mask).numpy() for x in (x1, x2)]
             for p, m, mask in ((J, jl, masks[0]), (T, tl, masks[1]))]
        for a, b in zip(o[1], o[0]):
            close(a, b, FWD, "causal")
        np.testing.assert_allclose(o[1][0][0, 0], o[1][1][0, 0], rtol=1e-5)
        assert not np.allclose(o[1][0][0, 2], o[1][1][0, 2])

    def test_bool_mask(self):
        jl, tl = both(lambda p: p.nn.MultiHeadAttention(8, 2), seed=3)
        x = arr(2, 4, 8, seed=5)
        mask = np.tril(np.ones((4, 4), bool))[None, None]
        run_both(jl, tl, lambda p, m: m(p.to_tensor(x),
                                        attn_mask=p.to_tensor(mask)))

    def test_gen_cache_incremental_and_static(self):
        jl, tl = both(lambda p: p.nn.MultiHeadAttention(8, 2), seed=4)
        x = arr(2, 4, 8, seed=6)
        mem = arr(2, 5, 8, seed=7)
        mask = np.triu(np.full((4, 4), -1e9, np.float32), 1)[None, None]
        outs = []
        for p, m in ((J, jl), (T, tl)):
            m.eval()
            cache = m.gen_cache(p.to_tensor(x))
            assert list(cache.k.shape) == [2, 0, 2, 4]
            steps = []
            for i in range(4):
                o, cache = m(p.to_tensor(x[:, i:i + 1]), cache=cache)
                steps.append(o.numpy())
            assert list(cache.k.shape) == [2, 4, 2, 4]
            whole = m(p.to_tensor(x), attn_mask=p.to_tensor(mask)).numpy()
            np.testing.assert_allclose(np.concatenate(steps, 1), whole,
                                       rtol=1e-5, atol=1e-6)
            static = m.gen_cache(p.to_tensor(mem), type=m.StaticCache)
            o_s, c2 = m(p.to_tensor(x), cache=static)
            assert c2 is static
            outs.append((np.concatenate(steps, 1), o_s.numpy(),
                         static.k.numpy()))
        for a, b in zip(outs[1], outs[0]):
            close(a, b, FWD, "cache")


class TestStacks:
    @pytest.mark.parametrize("normalize_before", [False, True])
    def test_encoder(self, normalize_before):
        def build(p):
            layer = p.nn.TransformerEncoderLayer(
                16, 4, 32, dropout=0.0, activation="gelu",
                normalize_before=normalize_before)
            return p.nn.TransformerEncoder(
                layer, 2, p.nn.LayerNorm(16) if normalize_before else None)
        jl, tl = both(build, seed=5)
        src = arr(2, 6, 16, seed=8)
        mask = np.zeros((2, 1, 1, 6), np.float32)
        mask[0, ..., 5:] = -1e4
        run_both(jl, tl, lambda p, m: m(p.to_tensor(src),
                                        p.to_tensor(mask)))

    def test_encoder_cache(self):
        def build(p):
            return p.nn.TransformerEncoder(
                p.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0), 2)
        jl, tl = both(build, seed=6)
        src = arr(2, 3, 8, seed=9)
        outs = []
        for p, m in ((J, jl), (T, tl)):
            cache = m.gen_cache(p.to_tensor(src))
            out, new = m(p.to_tensor(src), cache=cache)
            assert len(new) == 2 and list(new[0].k.shape) == [2, 3, 2, 4]
            outs.append(out.numpy())
        close(outs[1], outs[0], FWD, "encoder cache")

    @pytest.mark.parametrize("normalize_before", [False, True])
    def test_decoder(self, normalize_before):
        def build(p):
            layer = p.nn.TransformerDecoderLayer(
                16, 4, 32, dropout=0.0, normalize_before=normalize_before)
            return p.nn.TransformerDecoder(layer, 2)
        jl, tl = both(build, seed=7)
        tgt, mem = arr(2, 4, 16, seed=10), arr(2, 6, 16, seed=11)
        tmask = np.triu(np.full((4, 4), -1e9, np.float32), 1)
        run_both(jl, tl, lambda p, m: m(p.to_tensor(tgt), p.to_tensor(mem),
                                        tgt_mask=p.to_tensor(tmask)))

    def test_decoder_cache_steps(self):
        def build(p):
            return p.nn.TransformerDecoder(
                p.nn.TransformerDecoderLayer(8, 2, 16, dropout=0.0), 2)
        jl, tl = both(build, seed=8)
        tgt, mem = arr(1, 3, 8, seed=12), arr(1, 5, 8, seed=13)
        outs = []
        for p, m in ((J, jl), (T, tl)):
            m.eval()
            cache = m.gen_cache(p.to_tensor(mem))
            steps = []
            for i in range(3):
                o, cache = m(p.to_tensor(tgt[:, i:i + 1]),
                             p.to_tensor(mem), cache=cache)
                steps.append(o.numpy())
            outs.append(np.concatenate(steps, 1))
        close(outs[1], outs[0], FWD, "decoder cache")

    def test_transformer(self):
        def build(p):
            return p.nn.Transformer(d_model=16, nhead=4,
                                    num_encoder_layers=2,
                                    num_decoder_layers=2,
                                    dim_feedforward=32, dropout=0.0)
        jl, tl = both(build, seed=9)
        src, tgt = arr(2, 5, 16, seed=14), arr(2, 3, 16, seed=15)
        tmask = T.nn.Transformer.generate_square_subsequent_mask(3).numpy()
        run_both(jl, tl, lambda p, m: m(p.to_tensor(src), p.to_tensor(tgt),
                                        tgt_mask=p.to_tensor(tmask)))


def test_copied_layers_get_their_own_parameter_names():
    enc = T.nn.TransformerEncoder(T.nn.TransformerEncoderLayer(8, 2, 16), 3)
    names = [q.name for q in enc.parameters()]
    assert len(set(names)) == len(names)
    # each copy keeps its own optimizer state: one AdamW step moves the
    # copies' first moments apart when their gradients differ
    opt = T.optimizer.AdamW(parameters=enc.parameters())
    enc(T.to_tensor(arr(2, 3, 8))).sum().backward()
    opt.step()
    assert len(opt._accumulators["moment1"]) == len(names)


def test_reference_copied_layers_share_parameter_names():
    """The reference's fault, recorded (ROADMAP §C): its deep copies keep
    the source's parameter names, so an optimizer keyed by name gives all
    copies one state."""
    enc = J.nn.TransformerEncoder(J.nn.TransformerEncoderLayer(8, 2, 16), 3)
    names = [q.name for q in enc.parameters()]
    assert len(set(names)) == len(names) // 3
