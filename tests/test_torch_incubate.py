"""The rest of the port's ``incubate`` (``paddle_tpu_torch/incubate/``): the
fused functional names, the fused layer names, ``LookAhead`` and
``ModelAverage``; the MoE plumbing ops on Tensors
(``distributed/moe_utils.py``) and the registry sweep of the two
model-parallel ops (``c_embedding``, ``c_softmax_with_cross_entropy``);
and the surface of the namespaces this slice completes, against the JAX
package.

Forward fp32 within 1e-5 x max|ref|, gradients within 1e-4 x max|g|
(``_torch_sweep.close``); optimizer wrappers' parameters within 1e-5 x
max|ref| over 12 steps. Where the port computes Paddle's contract and
the reference does not (ROADMAP §C), a test records the reference's
behaviour.
"""

import importlib

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.incubate  # noqa: F401
import paddle_tpu.incubate.nn.functional as JIF
import paddle_tpu_torch as T
import paddle_tpu_torch.incubate  # noqa: F401
import paddle_tpu_torch.incubate.nn.functional as TIF
from _torch_sweep import JR, TR, check_sweep, close, shared_ops


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def _f(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# -- fused_multi_transformer ------------------------------------------------------

L, E, H, FF = 2, 64, 2, 128
D = E // H


def _stack_weights(seed):
    """Per-layer weights of a 2-layer, 64-wide stack, in Paddle's fused
    layout (qkv ``[3, H, D, E]``)."""
    rng = np.random.default_rng(seed)
    w = {k: [] for k in ("ln_s", "ln_b", "qkv", "qkv_b", "lin", "lin_b",
                         "ffn_ln_s", "ffn_ln_b", "ffn1", "ffn1_b", "ffn2",
                         "ffn2_b")}
    for _ in range(L):
        w["ln_s"].append(1 + _f(rng, E, scale=0.1))
        w["ln_b"].append(_f(rng, E, scale=0.1))
        w["qkv"].append(_f(rng, 3, H, D, E, scale=E ** -0.5))
        w["qkv_b"].append(_f(rng, 3 * E, scale=0.1))
        w["lin"].append(_f(rng, E, E, scale=E ** -0.5))
        w["lin_b"].append(_f(rng, E, scale=0.1))
        w["ffn_ln_s"].append(1 + _f(rng, E, scale=0.1))
        w["ffn_ln_b"].append(_f(rng, E, scale=0.1))
        w["ffn1"].append(_f(rng, E, FF, scale=E ** -0.5))
        w["ffn1_b"].append(_f(rng, FF, scale=0.1))
        w["ffn2"].append(_f(rng, FF, E, scale=FF ** -0.5))
        w["ffn2_b"].append(_f(rng, E, scale=0.1))
    return w


_ORDER = ("ln_s", "ln_b", "qkv", "qkv_b", "lin", "lin_b", "ffn_ln_s",
          "ffn_ln_b", "ffn1", "ffn1_b", "ffn2", "ffn2_b")


def _fmt(p, x, w, pre=True, grad=False, **kw):
    """``fused_multi_transformer`` of package ``p``: its output and, with
    ``grad``, the gradients of sum(out²) in x and every weight."""
    xt = p.to_tensor(x, stop_gradient=not grad)
    lists = [[p.to_tensor(a, stop_gradient=not grad) for a in w[k]]
             for k in _ORDER]
    out = p.incubate.nn.functional.fused_multi_transformer(
        xt, *lists, pre_layer_norm=pre, num_heads=H, **kw)
    if not grad:
        return out.numpy(), None
    flat = [xt] + [t for ts in lists for t in ts]
    return out.numpy(), [g.numpy() for g in p.grad([(out * out).sum()],
                                                   flat)]


def test_fused_multi_transformer_matches_jax():
    w = _stack_weights(0)
    x = _f(np.random.default_rng(1), 2, 8, E)
    (oj, gj), (ot, gt) = (_fmt(p, x, w, grad=True) for p in (J, T))
    close(ot, oj)
    for a, b in zip(gt, gj):
        close(a, b, rtol=1e-4)


def test_fused_multi_transformer_with_a_mask_matches_jax():
    w = _stack_weights(2)
    x = _f(np.random.default_rng(3), 2, 6, E)
    mask = np.triu(np.full((6, 6), -1e4, np.float32), 1)[None, None]
    outs = [_fmt(p, x, w, attn_mask=p.to_tensor(mask))[0] for p in (J, T)]
    close(outs[1], outs[0])


def test_fused_layouts_and_the_encoder_layer_agree():
    """``[E, 3E]`` qkv weights give the ``[3, H, D, E]`` result, and a stack
    of ``incubate.nn.FusedTransformerEncoderLayer(normalize_before=True,
    activation="gelu", dropout=0)`` with the same weights gives it too."""
    w = _stack_weights(4)
    x = _f(np.random.default_rng(5), 2, 8, E)
    want, _ = _fmt(T, x, w)
    flat = dict(w)
    flat["qkv"] = [q.reshape(3 * E, E).T.copy() for q in w["qkv"]]
    got, _ = _fmt(T, x, flat)
    close(got, want)
    layers = []
    for i in range(L):
        lay = T.incubate.nn.FusedTransformerEncoderLayer(
            E, H, FF, dropout=0.0, activation="gelu", normalize_before=True)
        lay.eval()
        wq = flat["qkv"][i]
        bq = w["qkv_b"][i]
        for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
            getattr(lay.self_attn, proj).weight.set_value(
                wq[:, j * E:(j + 1) * E])
            getattr(lay.self_attn, proj).bias.set_value(bq[j * E:(j + 1) * E])
        lay.self_attn.out_proj.weight.set_value(w["lin"][i])
        lay.self_attn.out_proj.bias.set_value(w["lin_b"][i])
        lay.norm1.weight.set_value(w["ln_s"][i])
        lay.norm1.bias.set_value(w["ln_b"][i])
        lay.norm2.weight.set_value(w["ffn_ln_s"][i])
        lay.norm2.bias.set_value(w["ffn_ln_b"][i])
        lay.linear1.weight.set_value(w["ffn1"][i])
        lay.linear1.bias.set_value(w["ffn1_b"][i])
        lay.linear2.weight.set_value(w["ffn2"][i])
        lay.linear2.bias.set_value(w["ffn2_b"][i])
        layers.append(lay)
    h = T.to_tensor(x)
    for lay in layers:
        h = lay(h)
    close(h.numpy(), want)


def test_post_ln_applies_the_norm_weights():
    """Post-LN: the port applies ``ln_*`` after attention and ``ffn_ln_*``
    after the FFN (Paddle's contract), as a stack of ``fused_attention`` /
    ``fused_feedforward`` with those weights does. The reference passes
    them as pre-norm weights, which post-LN never reads: changing all
    four lists leaves its output exactly as it was (ROADMAP §C)."""
    w = _stack_weights(6)
    x = _f(np.random.default_rng(7), 2, 8, E)
    got, _ = _fmt(T, x, w, pre=False)
    h = T.to_tensor(x)
    for i in range(L):
        h = TIF.fused_attention(
            h, T.to_tensor(w["qkv"][i]), T.to_tensor(w["lin"][i]),
            qkv_bias=T.to_tensor(w["qkv_b"][i]),
            linear_bias=T.to_tensor(w["lin_b"][i]),
            ln_scale=T.to_tensor(w["ln_s"][i]),
            ln_bias=T.to_tensor(w["ln_b"][i]), dropout_rate=0.0,
            attn_dropout_rate=0.0, training=False)
        h = TIF.fused_feedforward(
            h, T.to_tensor(w["ffn1"][i]), T.to_tensor(w["ffn2"][i]),
            T.to_tensor(w["ffn1_b"][i]), T.to_tensor(w["ffn2_b"][i]),
            ln2_scale=T.to_tensor(w["ffn_ln_s"][i]),
            ln2_bias=T.to_tensor(w["ffn_ln_b"][i]), dropout1_rate=0.0,
            dropout2_rate=0.0, activation="gelu", training=False)
    close(got, h.numpy())
    moved = dict(w)
    for k in ("ln_s", "ln_b", "ffn_ln_s", "ffn_ln_b"):
        moved[k] = [a * 3.0 + 0.5 for a in w[k]]
    ref_post = [_fmt(J, x, v, pre=False)[0] for v in (w, moved)]
    np.testing.assert_array_equal(ref_post[0], ref_post[1])
    ref_pre = [_fmt(J, x, v, pre=True)[0] for v in (w, moved)]
    assert float(np.abs(ref_pre[0] - ref_pre[1]).max()) > 0.1
    port_post = _fmt(T, x, moved, pre=False)[0]
    assert float(np.abs(port_post - got).max()) > 0.1
    # where the reference's post-LN is right: unit weights, zero biases
    unit = dict(w)
    unit["ln_s"] = unit["ffn_ln_s"] = [np.ones(E, np.float32)] * L
    unit["ln_b"] = unit["ffn_ln_b"] = [np.zeros(E, np.float32)] * L
    close(_fmt(T, x, unit, pre=False)[0], _fmt(J, x, unit, pre=False)[0])


# -- the other attention names -----------------------------------------------------

def test_masked_multihead_attention_decode_steps_match_jax():
    rng = np.random.default_rng(8)
    B, Hh, C, Dd = 2, 3, 6, 8
    cache = {p: np.zeros((2, B, Hh, C, Dd), np.float32) for p in (J, T)}
    mask = _f(rng, B, 1, 1, C, scale=0.3)
    for step in range(4):
        x = _f(rng, B, 3 * Hh * Dd)
        lens = np.array([step, min(step + 1, C - 1)], np.int64)
        outs = {}
        for p in (J, T):
            out, cache_p = p.incubate.nn.functional.masked_multihead_attention(
                p.to_tensor(x), p.to_tensor(cache[p]),
                src_mask=p.to_tensor(mask), seq_lens=p.to_tensor(lens))
            outs[p], cache[p] = out.numpy(), cache_p.numpy()
        close(outs[T], outs[J])
        close(cache[T], cache[J])


def test_variable_length_attention_reads_kv_lens_and_mask():
    """The port masks the keys by ``kv_seq_lens`` and adds ``mask``
    (Paddle's contract, held to numpy); without them it equals the
    reference, which reads neither: given them, the reference's output is
    unchanged (ROADMAP §C)."""
    rng = np.random.default_rng(9)
    B, Hh, S, Dd = 2, 2, 5, 8
    q, k, v = (_f(rng, B, Hh, S, Dd) for _ in range(3))
    seq = np.array([5, 3], np.int64)
    kv = np.array([2, 4], np.int64)
    mask = _f(rng, B, 1, S, S)
    fn = {p: p.incubate.nn.functional.variable_length_memory_efficient_attention
          for p in (J, T)}
    base = {p: fn[p](*[p.to_tensor(a) for a in (q, k, v)],
                     seq_lens=p.to_tensor(seq)).numpy() for p in (J, T)}
    close(base[T], base[J])
    got = fn[T](*[T.to_tensor(a) for a in (q, k, v)],
                seq_lens=T.to_tensor(seq), kv_seq_lens=T.to_tensor(kv),
                mask=T.to_tensor(mask)).numpy()
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(Dd) + mask
    s = np.where(np.arange(S)[None, None, None, :] < kv[:, None, None, None],
                 s, -1e30)
    pr = np.exp(s - s.max(-1, keepdims=True))
    pr /= pr.sum(-1, keepdims=True)
    close(got, np.einsum("bhqk,bhkd->bhqd", pr, v))
    ref = fn[J](*[J.to_tensor(a) for a in (q, k, v)],
                seq_lens=J.to_tensor(seq), kv_seq_lens=J.to_tensor(kv),
                mask=J.to_tensor(mask)).numpy()
    np.testing.assert_array_equal(ref, base[J])
    assert float(np.abs(ref - got).max()) > 0.1


def test_block_multihead_attention_raises_as_the_reference():
    for p in (J, T):
        with pytest.raises(NotImplementedError):
            p.incubate.nn.functional.block_multihead_attention(
                *([None] * 6))


def test_fused_attention_pieces_match_jax():
    rng = np.random.default_rng(10)
    x = _f(rng, 2, 4, 16)
    qkv = _f(rng, 3, 2, 8, 16, scale=0.25)
    lin = _f(rng, 16, 16, scale=0.25)
    mask = np.triu(np.full((4, 4), -1e4, np.float32), 1)[None, None]
    for pre in (True, False):
        outs = [p.incubate.nn.functional.fused_attention(
            p.to_tensor(x), p.to_tensor(qkv), p.to_tensor(lin),
            pre_layer_norm=pre, attn_mask=p.to_tensor(mask),
            dropout_rate=0.0, attn_dropout_rate=0.0).numpy() for p in (J, T)]
        close(outs[1], outs[0])
    outs = [p.incubate.nn.functional.fused_multi_head_attention(
        p.to_tensor(x), p.to_tensor(qkv.reshape(48, 16).T.copy()),
        num_heads=2, causal=True, linear_weight=p.to_tensor(lin)).numpy()
        for p in (J, T)]
    close(outs[1], outs[0])
    for act in ("gelu", "relu", "silu", "swiglu", "geglu"):
        outs = [p.incubate.nn.functional.fused_bias_act(
            p.to_tensor(x), p.to_tensor(x[0, 0]), act_method=act).numpy()
            for p in (J, T)]
        close(outs[1], outs[0], what=act)
    res = [p.incubate.nn.functional.resnet_unit(
        p.to_tensor(_f(np.random.default_rng(11), 1, 2, 5, 5)),
        p.to_tensor(_f(np.random.default_rng(12), 3, 2, 3, 3)),
        *[p.to_tensor(a) for a in (np.full(3, 1.5, np.float32),
                                   np.full(3, 0.1, np.float32),
                                   np.full(3, 0.2, np.float32),
                                   np.full(3, 2.0, np.float32))],
        z=p.to_tensor(_f(np.random.default_rng(13), 1, 3, 5, 5)),
        stride=1, padding=1).numpy() for p in (J, T)]
    close(res[1], res[0])


# -- LookAhead and ModelAverage ------------------------------------------------------

def _twin_nets(seed):
    rng = np.random.default_rng(seed)
    w, b = _f(rng, 4, 3), _f(rng, 3)
    nets = {}
    for p in (J, T):
        nets[p] = p.nn.Linear(4, 3)
        nets[p].weight.set_value(w)
        nets[p].bias.set_value(b)
    return nets


def _train_step(p, net, opt, x, y):
    loss = ((net(p.to_tensor(x)) - p.to_tensor(y)) ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()


def _params_agree(nets):
    for a, b in zip(nets[T].parameters(), nets[J].parameters()):
        close(a.numpy(), b.numpy())


def test_lookahead_matches_jax_across_state_dicts():
    nets = _twin_nets(14)
    la = {p: p.incubate.LookAhead(p.optimizer.Adam(
        learning_rate=0.05, parameters=nets[p].parameters()), alpha=0.5, k=3)
        for p in (J, T)}
    rng = np.random.default_rng(15)
    for step in range(12):
        x, y = _f(rng, 5, 4), _f(rng, 5, 3)
        for p in (J, T):
            _train_step(p, nets[p], la[p], x, y)
        _params_agree(nets)
        if step == 4:      # a round trip through the state dict
            for p in (J, T):
                la[p].set_state_dict(la[p].state_dict())
        if step == 7:      # a "loaded" checkpoint without slow weights
            loaded = _f(rng, 4, 3)
            for p in (J, T):
                state = la[p].state_dict()
                state.pop("slow")
                la[p].set_state_dict(state)
                nets[p].weight.set_value(loaded)
                assert la[p]._slow is None
    st = la[T].state_dict()
    assert sorted(st["slow"]) == ["0", "1"] and st["step_count"] == 12


def test_lookahead_keeps_its_slow_weights_on_the_parameters_device():
    nets = _twin_nets(16)
    la = T.incubate.LookAhead(T.optimizer.SGD(
        learning_rate=0.1, parameters=nets[T].parameters()), k=2)
    x, y = _f(np.random.default_rng(17), 5, 4), _f(np.random.default_rng(18),
                                                   5, 3)
    _train_step(T, nets[T], la, x, y)
    import torch
    assert all(isinstance(s, torch.Tensor) and s.device.type == "cpu"
               for s in la._slow)


def test_model_average_matches_jax_through_a_rotation():
    nets = _twin_nets(19)
    opt = {p: p.optimizer.SGD(learning_rate=0.1,
                              parameters=nets[p].parameters()) for p in (J, T)}
    ma = {p: p.incubate.ModelAverage(0.5, parameters=nets[p].parameters(),
                                     min_average_window=2,
                                     max_average_window=3) for p in (J, T)}
    rng = np.random.default_rng(20)
    rotated = False
    for step in range(12):
        x, y = _f(rng, 5, 4), _f(rng, 5, 3)
        for p in (J, T):
            _train_step(p, nets[p], opt[p], x, y)
            ma[p].step()
        rotated |= ma[T]._old_num > 0
        assert ma[T]._num == ma[J]._num and ma[T]._old_num == ma[J]._old_num
        if step % 3 == 2:
            before = [q.numpy().copy() for q in nets[T].parameters()]
            for p in (J, T):
                ma[p].apply()
            _params_agree(nets)
            for p in (J, T):
                ma[p].restore()
            for q, b in zip(nets[T].parameters(), before):
                np.testing.assert_array_equal(q.numpy(), b)
    assert rotated


def test_model_average_sums_in_float32():
    import torch
    lay = T.nn.Linear(3, 2)
    lay.to(dtype="bfloat16")
    ma = T.incubate.ModelAverage(1.0, parameters=lay.parameters(),
                                 min_average_window=4, max_average_window=4)
    for _ in range(3):
        ma.step()
    assert all(s.dtype == torch.float32 for s in ma._sum.values())
    ma.apply()
    assert lay.weight._value.dtype == torch.bfloat16
    ma.restore()


# -- the MoE plumbing ops on Tensors -----------------------------------------------

MOE_NAMES = ("number_count", "expert_count", "assign_pos",
             "limit_by_capacity", "prune_gate_by_capacity", "random_routing",
             "global_scatter", "global_gather")


def test_moe_ops_take_and_return_tensors():
    out = T.distributed.number_count(T.to_tensor([0, 1, 1, 3]), 4)
    assert isinstance(out, T.Tensor)
    want = J.distributed.number_count(J.to_tensor([0, 1, 1, 3]), 4)
    assert out.numpy().tolist() == want.numpy().tolist() == [1, 2, 0, 1]
    idx = T.to_tensor(np.array([[0, 1], [2, 3]]))
    r = T.distributed.random_routing(
        idx, T.to_tensor(np.array([[0.6, 0.4], [0.9, 0.05]], np.float32)),
        T.to_tensor(np.array([0.5, 0.5], np.float32)))
    assert isinstance(r, T.Tensor) and r.numpy().tolist() == [[0, 1], [2, -1]]
    x = T.to_tensor(np.arange(6, dtype=np.float32).reshape(3, 2))
    y = T.distributed.global_scatter(x, None, None)
    assert isinstance(y, T.Tensor) and y.numpy().tolist() == x.numpy().tolist()
    assert isinstance(T.distributed.global_gather(y, None, None), T.Tensor)
    for n in MOE_NAMES:
        assert n in TR and TR[n].public is getattr(T.distributed, n), n


def test_moe_at_its_reference_location():
    from paddle_tpu_torch.distributed import moe
    from paddle_tpu_torch.incubate.distributed.models import moe as imoe
    for n in ("MoELayer", "NaiveGate", "SwitchGate", "GShardGate"):
        assert getattr(imoe, n) is getattr(moe, n)


# -- namespaces and the registry ----------------------------------------------------

def test_incubate_names():
    assert T.incubate.nn.FusedTransformerEncoderLayer is \
        T.nn.TransformerEncoderLayer
    assert T.incubate.nn.FusedMultiHeadAttention is T.nn.MultiHeadAttention
    assert T.incubate.nn.FusedRMSNorm is T.incubate.nn.RMSNorm
    rng = np.random.default_rng(21)
    x, m = _f(rng, 1, 2, 3, 4), _f(rng, 1, 1, 3, 4)
    close(T.incubate.softmax_mask_fuse(T.to_tensor(x), T.to_tensor(m)).numpy(),
          J.incubate.softmax_mask_fuse(J.to_tensor(x), J.to_tensor(m)).numpy())
    for n in ("fused_rms_norm", "fused_rotary_position_embedding"):
        assert TR[n].public is getattr(TIF, n) and TR[n].category == "fused"
    assert sorted(TIF.__all__) == sorted(JIF.__all__)


def test_surface_gaps_closed():
    assert T.distributed.spawn(lambda a, b: a + b, (2, 3)) == 5
    from paddle_tpu_torch.distributed import elastic
    for n in ("install_preemption_handler", "preempted", "start_heartbeat"):
        assert getattr(T.distributed, n) is getattr(elastic, n)
    # the function, also once the launcher's package has been imported
    import paddle_tpu_torch.distributed.launch.main  # noqa: F401
    assert T.distributed.launch.__name__ == "launch" and \
        callable(T.distributed.launch)
    from paddle_tpu_torch.models import bert, llama
    for n in ("BertConfig", "BertModel", "BertForPretraining",
              "BertForSequenceClassification"):
        assert getattr(T.models, n) is getattr(bert, n)
    for n in ("LlamaConfig", "LlamaForCausalLM", "init_params", "forward",
              "loss_fn", "param_specs"):
        assert getattr(T.models, n) is getattr(llama, n)
    assert T.is_grad_enabled_() is True
    with T.no_grad():
        assert T.is_grad_enabled_() is False


# what the reference has and the port does not, by the slice that ports it
LATER = {
    # the reference modules' own imports, not API
    "incubate.nn.functional": {"Optional", "Tensor", "jnp"},
    "nn.utils": {"jnp", "np"},
    "static": {"warnings"},
    "sparse": {"jnp", "to_tensor"},
    "sparse.nn_conv": {"Optional", "Sequence", "jax", "jnp", "to_tensor"},
}


@pytest.mark.parametrize("ns", ["nn", "nn.functional", "nn.utils",
                                "optimizer", "incubate", "incubate.nn",
                                "incubate.nn.functional", "distributed",
                                "models", "static", "static.program",
                                "sparse", "sparse.nn_conv"])
def test_public_names_match_the_reference(ns):
    def names(pkg):
        mod = importlib.import_module(f"{pkg}.{ns}")
        return {n for n in dir(mod) if not n.startswith("_")}
    missing = names("paddle_tpu") - names("paddle_tpu_torch")
    assert missing == LATER.get(ns, set()), sorted(missing)


# the reference's modules that a later slice ports (ROADMAP §A 7d)
LATER_MODULES = ("paddle_tpu.audio", "paddle_tpu.text",
                 "paddle_tpu.geometric", "paddle_tpu.distribution",
                 "paddle_tpu.device", "paddle_tpu.utils",
                 "paddle_tpu.version")


def test_registry_matches_the_reference():
    """Every op the reference has registered in this process is in the
    port's registry once the port's counterpart of its module is imported
    (the ``sparse_*`` names included: ``sparse_coalesce``, whose public
    the reference's sweep specs set, comes with ``paddle_tpu_torch.
    sparse``), but those of the modules 7d ports."""
    def module(n):
        d = JR[n]
        return getattr(d.public or d.fn, "__module__", "") or ""
    for n in set(JR) - set(TR):
        try:      # the counterpart registers its ops as it is imported
            importlib.import_module("paddle_tpu_torch" +
                                    module(n)[len("paddle_tpu"):])
        except ModuleNotFoundError:
            pass
    missing = sorted(n for n in set(JR) - set(TR)
                     if not module(n).startswith(LATER_MODULES))
    assert missing == [], missing


@pytest.mark.parametrize("name", shared_ops("incubate"))
def test_registry_sweep(name):
    check_sweep(name)
