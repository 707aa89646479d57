"""The port's eager ``LlamaForCausalLM`` and the eager callers of the fused
kernels against the JAX package's.

* ``LlamaForCausalLM`` on ``tests/test_llama.py``'s tiny config (vocab 97,
  hidden 32, 2 layers, 4 heads, 2 kv heads) at fp32, the port's weights
  loaded from the JAX layer's ``state_dict()`` by name: logits within
  ``1e-5 * max|logits|``, the loss within ``1e-5`` relative, every
  parameter's ``.grad`` within ``1e-4 * max|g|`` of its leaf. Once on the
  plain path, once with ``use_kernels`` + ``use_fused_norm`` + full remat
  (the JAX side runs its Pallas kernels in interpret mode, the port its
  kernel Functions' plain CPU versions).
* One ``AdamW`` step from the same gradients (the JAX ones, set on the
  port's parameters) equal to the JAX eager step within ``1e-6 * max|p|``
  per leaf.
* ``generate`` equal, token for token, to ``tests/test_generation.py``'s
  ``test_eager_layer_generate`` oracle (the iterative full-forward argmax
  of the JAX model).
* ``F.scaled_dot_product_attention`` (with and without a mask, causal or
  not), ``F.rms_norm``, ``incubate``'s ``fused_rms_norm`` and
  ``fused_rotary_position_embedding``, and ``weight_only_linear``, each
  forward and gradient against its JAX counterpart within ``1e-5`` of the
  reference's max-abs (``1e-4`` for gradients).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as J
import paddle_tpu.incubate.nn.functional as JIF
from paddle_tpu.models import llama as JL
from paddle_tpu.ops.quant import weight_only_linear as j_wol
import paddle_tpu_torch as T
import paddle_tpu_torch.incubate.nn.functional as TIF
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import config_from_jax
from paddle_tpu_torch.ops.quant import weight_only_linear as t_wol


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def np_(x):
    return np.asarray(x.numpy())


def close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    scale = float(np.abs(want).max(initial=0.0))
    assert err <= rtol * max(scale, 1e-30), \
        f"{what}: max err {err} > {rtol} * {scale}"


def tiny_cfg(**kw):
    base = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=64)
    base.update(kw)
    return JL.LlamaConfig(**base)


def twins(**kw):
    jcfg = tiny_cfg(**kw)
    jnet = JL.LlamaForCausalLM(jcfg, key=jax.random.PRNGKey(0))
    tnet = TL.LlamaForCausalLM(config_from_jax(jcfg))
    missing, unexpected = tnet.set_state_dict(jnet.state_dict())
    assert not missing and not unexpected
    return jcfg, jnet, tnet


def batch(cfg, B=2, S=16, seed=0):
    r = np.random.default_rng(seed)
    return (r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))


KERNEL_CFG = dict(use_kernels=True, use_fused_norm=True, remat=True)


class TestLlamaForCausalLM:
    def test_sorted_key_order_and_names(self):
        _, jnet, tnet = twins()
        js, ts = jnet.state_dict(), tnet.state_dict()
        assert list(ts) == list(js)
        for k in js:
            np.testing.assert_array_equal(np_(ts[k]), np.asarray(js[k].numpy()))

    @pytest.mark.parametrize("kw", [{}, KERNEL_CFG], ids=["plain", "kernels"])
    def test_logits_loss_and_grads(self, kw):
        cfg, jnet, tnet = twins(**kw)
        ids, lbl = batch(cfg)
        close(np_(tnet(T.to_tensor(ids))), np_(jnet(J.to_tensor(ids))), 1e-5,
              "logits")
        jl = jnet(J.to_tensor(ids), J.to_tensor(lbl))
        tl = tnet(T.to_tensor(ids), T.to_tensor(lbl))
        assert abs(tl.item() - jl.item()) <= 1e-5 * abs(jl.item())
        jl.backward()
        tl.backward()
        for (k, jp), tp in zip(jnet.named_parameters(), tnet.parameters()):
            close(np_(tp.grad), np_(jp.grad), 1e-4, f"grad {k}")

    def test_adamw_step_matches(self):
        cfg, jnet, tnet = twins()
        ids, lbl = batch(cfg, seed=1)
        jnet(J.to_tensor(ids), J.to_tensor(lbl)).backward()
        for jp, tp in zip(jnet.parameters(), tnet.parameters()):
            tp.grad = np_(jp.grad)
        jopt = J.optimizer.AdamW(1e-3, parameters=jnet.parameters(),
                                 weight_decay=0.01)
        topt = T.optimizer.AdamW(1e-3, parameters=tnet.parameters(),
                                 weight_decay=0.01)
        jopt.step()
        topt.step()
        for (k, jp), tp in zip(jnet.named_parameters(), tnet.parameters()):
            close(np_(tp), np_(jp), 1e-6, f"param {k}")

    def test_train_loop_steps_and_clears(self):
        cfg, _, tnet = twins()
        ids, lbl = batch(cfg, seed=2)
        opt = T.optimizer.AdamW(1e-2, parameters=tnet.parameters())
        losses = []
        for _ in range(3):
            loss = tnet(T.to_tensor(ids), T.to_tensor(lbl))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
            assert all(p.grad is None for p in tnet.parameters())
        assert losses[-1] < losses[0]

    def test_eager_layer_generate(self):
        """tests/test_generation.py:171's oracle on the JAX model, the
        port's eager ``generate`` on the same weights."""
        from paddle_tpu.models.llama import forward as jforward
        cfg = tiny_cfg(hidden_size=64, intermediate_size=96,
                       num_hidden_layers=3)
        jnet = JL.LlamaForCausalLM(cfg, key=jax.random.PRNGKey(0))
        tnet = TL.LlamaForCausalLM(config_from_jax(cfg))
        tnet.set_state_dict(jnet.state_dict())
        ids = jnp.asarray(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 9)), jnp.int32)
        cur, outs = ids, []
        for _ in range(4):
            logits = jforward(jnet.params_pytree(), cur, cfg)
            nxt = jnp.argmax(logits[:, -1].astype(jnp.float32), -1)
            outs.append(nxt.astype(ids.dtype))
            cur = jnp.concatenate([cur, outs[-1][:, None]], 1)
        oracle = np.asarray(jnp.stack(outs, 1))
        got = tnet.generate(T.to_tensor(np.asarray(ids)), max_new_tokens=4)
        np.testing.assert_array_equal(np_(got), oracle)
        np.testing.assert_array_equal(
            np_(got), np.asarray(jnet.generate(ids, max_new_tokens=4)._value))

    def test_params_pytree_is_the_functional_tree(self):
        cfg, _, tnet = twins()
        tree = tnet.params_pytree()
        assert set(tree) == {"embed", "layers", "lm_head", "ln_f"}
        ids, lbl = batch(cfg, seed=3)
        want = TL.loss_fn(tree, T.to_tensor(ids)._value,
                          T.to_tensor(lbl)._value, config_from_jax(cfg))
        assert tnet(T.to_tensor(ids), T.to_tensor(lbl)).item() == want.item()


# -- the eager kernel callers -----------------------------------------------

def _grads_of(p, fn, arrays, n_diff, proj_seed=7):
    """``fn(*tensors)`` and the gradients of ``sum(out * c)`` (``c`` fixed
    random) with respect to the float inputs among the first ``n_diff``."""
    ts = [p.to_tensor(a, stop_gradient=i >= n_diff or a.dtype.kind != "f")
          for i, a in enumerate(arrays)]
    out = fn(p, *ts)
    c = np.random.default_rng(proj_seed).standard_normal(out.shape).astype(
        np.float32)
    (out * p.to_tensor(c)).sum().backward()
    return np_(out), [np_(t.grad) for t in ts if not t.stop_gradient]


def both(fn, arrays, what, n_diff=None):
    n = len(arrays) if n_diff is None else n_diff
    (oj, gj), (ot, gt) = (_grads_of(J, fn, arrays, n),
                          _grads_of(T, fn, arrays, n))
    close(ot, oj, 1e-5, what)
    for i, (a, b) in enumerate(zip(gj, gt)):
        close(b, a, 1e-4, f"{what} grad {i}")


def qkv(B=2, S=16, H=4, Hk=2, D=16, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, S, H, D)).astype(np.float32),
            r.standard_normal((B, S, Hk, D)).astype(np.float32),
            r.standard_normal((B, S, Hk, D)).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask", [None, "bool", "additive"])
def test_sdpa(causal, mask):
    q, k, v = qkv(H=2, Hk=2)
    arrays = [q, k, v]
    if mask == "bool":
        arrays.append(np.random.default_rng(1).random((2, 1, 16, 16)) > 0.3)
        arrays[-1][..., 0] = True          # every row sees one key
    elif mask == "additive":
        arrays.append(np.random.default_rng(1).standard_normal(
            (2, 1, 16, 16)).astype(np.float32))

    def fn(p, *ts):
        return p.nn.functional.scaled_dot_product_attention(
            *ts[:3], attn_mask=ts[3] if len(ts) > 3 else None,
            is_causal=causal)
    both(fn, arrays, f"sdpa mask={mask} causal={causal}")


def test_flash_attention_entry():
    q, k, v = qkv(H=2, Hk=2, seed=2)
    both(lambda p, *ts: p.nn.functional.flash_attention(*ts, causal=True)[0],
         [q, k, v], "flash_attention")


def test_attention_probs():
    q, k, _ = qkv(H=2, Hk=2, seed=3)
    both(lambda p, a, b: p.nn.functional.attention_probs(a, b), [q, k],
         "attention_probs")


@pytest.mark.parametrize("with_weight", [True, False])
def test_rms_norm(with_weight):
    r = np.random.default_rng(4)
    x = r.standard_normal((16, 128)).astype(np.float32)
    w = r.random(128).astype(np.float32) + 0.5
    if with_weight:
        both(lambda p, a, b: p.nn.functional.rms_norm(a, b), [x, w], "rms_norm")
    else:
        both(lambda p, a: p.nn.functional.rms_norm(a), [x], "rms_norm no w")


def test_rms_norm_layer():
    x = np.random.default_rng(5).standard_normal((2, 8, 128)).astype(np.float32)
    J.seed(0)
    jl = J.nn.RMSNorm(128)
    tl = T.nn.RMSNorm(128)
    tl.set_state_dict(jl.state_dict())
    both(lambda p, a: (jl if p is J else tl)(a), [x], "nn.RMSNorm")


@pytest.mark.parametrize("bias", [False, True])
def test_fused_rms_norm(bias):
    r = np.random.default_rng(6)
    arrays = [r.standard_normal((16, 128)).astype(np.float32),
              r.random(128).astype(np.float32) + 0.5]
    if bias:
        arrays.append(r.standard_normal(128).astype(np.float32))

    def fn(p, x, w, *b):
        mod = JIF if p is J else TIF
        return mod.fused_rms_norm(x, w, b[0] if b else None, epsilon=1e-6)
    both(fn, arrays, "fused_rms_norm")


@pytest.mark.parametrize("tables", [False, True])
def test_fused_rotary_position_embedding(tables):
    q, k, v = qkv(H=4, Hk=4, D=16, seed=8)
    arrays = [q, k]
    if tables:
        from paddle_tpu_torch.kernels.rope import rope_cos_sin
        c, s = rope_cos_sin(16, 16, 500.0)
        arrays += [c.numpy(), s.numpy()]

    def fn(p, a, b, *cs):
        mod = JIF if p is J else TIF
        kw = dict(cos=cs[0], sin=cs[1]) if cs else {}
        oq, ok, ov = mod.fused_rotary_position_embedding(a, b, **kw)
        assert ov is None
        return p.concat([oq, ok], axis=2)
    both(fn, arrays, "fused_rope", n_diff=2)   # the tables take no gradient


@pytest.mark.parametrize("bias", [False, True])
def test_weight_only_linear(bias):
    from paddle_tpu_torch.kernels.quant_matmul import quantize_weights
    import torch
    r = np.random.default_rng(9)
    x = r.standard_normal((3, 5, 64)).astype(np.float32)
    w = r.standard_normal((64, 48)).astype(np.float32)
    wq, sc = quantize_weights(torch.from_numpy(w))
    arrays = [x] + ([r.standard_normal(48).astype(np.float32)] if bias else [])

    def fn(p, a, *b):
        f = j_wol if p is J else t_wol
        return f(a, p.to_tensor(wq.numpy()), p.to_tensor(sc.numpy()),
                 b[0] if b else None)
    # the gradient with respect to x (and the bias); the registry sweep of
    # test_torch_ops.py compares the scale's
    both(fn, arrays, "weight_only_linear")
