"""The eager Megatron-style decoder of ``chip_smoke.py`` phase 46 (a)
(``chip_smoke.megatron()``, built from the port's public layers) at a
small width on the CPU against the same decoder built from the JAX
package's mpu layers on the same weights, against the port's serial twin
(``nn.Linear`` / ``nn.Embedding`` / ``nn.CrossEntropyLoss``), and against
the functional ``llama.loss_fn`` on the tree its weights came from.

dp 2 x mp 4: the JAX package on its 8-device CPU mesh, the port over
``["cpu"] * 8`` (4 heads, one an mp shard, so the attention core runs in
the per-coordinate region). Fp32. The loss within 1e-5 x |loss|, every
gradient within 1e-4 x max|g| (phase 46's own tolerances).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.incubate.nn.functional as JIF
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet.layers import mpu as jmpu
from paddle_tpu.distributed.topology import \
    set_hybrid_communicate_group as jset

import paddle_tpu_torch as T
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.topology import \
    set_hybrid_communicate_group as tset
from paddle_tpu_torch.models import llama

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

M = chip_smoke.megatron()

CFG = llama.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=4)


@pytest.fixture(autouse=True)
def _mesh():
    prev = T.get_device()
    T.set_device("cpu")
    for fl, kw in ((jfleet, {}), (tfleet, {"devices": ["cpu"] * 8})):
        st = fl.DistributedStrategy()
        st.hybrid_configs = {"dp_degree": 2, "mp_degree": 4, "pp_degree": 1}
        fl.init(is_collective=True, strategy=st, **kw)
    yield
    jset(None)
    tset(None)
    T.set_device(prev)


class _JLayer(jnn.Layer):
    """The decoder block from the JAX package's public layers."""

    def __init__(self, cfg):
        super().__init__()
        E, I_, D, H = (cfg.hidden_size, cfg.intermediate_size, cfg.head_dim,
                       cfg.num_attention_heads)
        col = lambda i, o: jmpu.ColumnParallelLinear(  # noqa: E731
            i, o, has_bias=False, gather_output=False)
        row = lambda i, o: jmpu.RowParallelLinear(  # noqa: E731
            i, o, has_bias=False, input_is_parallel=True)
        self.cfg = cfg
        self.ln_attn = self.create_parameter(
            [E], default_initializer=jnn.initializer.Constant(1.0))
        self.wq, self.wk, self.wv = col(E, H * D), col(E, H * D), col(E, H * D)
        self.wo = row(H * D, E)
        self.ln_mlp = self.create_parameter(
            [E], default_initializer=jnn.initializer.Constant(1.0))
        self.w_gate, self.w_up, self.w_down = col(E, I_), col(E, I_), \
            row(I_, E)

    def forward(self, x):
        cfg = self.cfg
        B, S, D = x.shape[0], x.shape[1], cfg.head_dim
        h = JIF.fused_rms_norm(x, self.ln_attn, epsilon=cfg.rms_norm_eps)
        q, k, v = (f(h).reshape([B, S, -1, D])
                   for f in (self.wq, self.wk, self.wv))
        q, k, _ = JIF.fused_rotary_position_embedding(
            q, k, rotary_emb_base=cfg.rope_theta)
        o = JF.scaled_dot_product_attention(q, k, v, is_causal=True)
        x = x + self.wo(o.reshape([B, S, -1]))
        h = JIF.fused_rms_norm(x, self.ln_mlp, epsilon=cfg.rms_norm_eps)
        return x + self.w_down(JF.silu(self.w_gate(h)) * self.w_up(h))


class _JEmbed(jnn.Layer):
    def __init__(self, cfg):
        super().__init__()
        self.embed = jmpu.VocabParallelEmbedding(cfg.vocab_size,
                                                 cfg.hidden_size)

    def forward(self, ids):
        return self.embed(ids)


class _JHead(jnn.Layer):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.ln_f = self.create_parameter(
            [cfg.hidden_size], default_initializer=jnn.initializer.Constant(1.0))
        self.lm_head = jmpu.ColumnParallelLinear(
            cfg.hidden_size, cfg.vocab_size, has_bias=False,
            gather_output=False)

    def forward(self, x):
        return self.lm_head(JIF.fused_rms_norm(x, self.ln_f,
                                               epsilon=self.cfg.rms_norm_eps))


class _JNet(jnn.Layer):
    def __init__(self, cfg):
        super().__init__()
        self.embedding = _JEmbed(cfg)
        self.layers = jnn.LayerList([_JLayer(cfg)
                                     for _ in range(cfg.num_hidden_layers)])
        self.head = _JHead(cfg)
        self.ce = jmpu.ParallelCrossEntropy()

    def forward(self, ids, labels):
        x = self.embedding(ids)
        for layer in self.layers:       # JAX's recompute refuses the
            x = layer(x)                 # GSPMD constraints; same numbers
        per = self.ce(self.head(x), labels)[..., 0]
        return per.mean()


def _batch():
    return np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 16))


def _port_run(net, ids):
    loss = net(T.to_tensor(ids), T.to_tensor(ids))
    loss.backward()
    return float(loss), {k: v.grad.numpy() for k, v in
                         net.named_parameters()}


def test_decoder_matches_jax_mpu_layers():
    J.seed(0)
    jnet = _JNet(CFG)
    ids = _batch()
    jl = jnet(J.to_tensor(ids), J.to_tensor(ids))
    jl.backward()
    jgrads = {k: np.asarray(v.grad.numpy()) for k, v in
              jnet.named_parameters()}
    tnet = M.Llama(CFG)
    missing, unexpected = tnet.set_state_dict(jnet.state_dict())
    assert not missing and not unexpected
    loss, grads = _port_run(tnet, ids)
    assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl))
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        want = jgrads[k]
        assert np.abs(g - want).max() <= 1e-4 * np.abs(want).max(), k
    # the attention ran per mp shard: each coordinate holds its heads' q
    w = tnet.layers[0].wq.weight
    assert {tuple(v.shape) for v in w.locals.values()} == {(32, 8)}


def test_decoder_matches_serial_twin_and_functional_loss():
    params = llama.init_params(CFG, seed=3, device="cpu")
    sd = M.state_dict(params)
    nets = [M.Llama(CFG), M.Llama(CFG, parallel=False)]
    for net in nets:
        missing, unexpected = net.set_state_dict(sd)
        assert not missing and not unexpected
    ids = _batch()
    (l1, g1), (l2, g2) = (_port_run(n, ids) for n in nets)
    ref = float(llama.loss_fn(params, torch.as_tensor(ids),
                              torch.as_tensor(ids), CFG))
    assert abs(l1 - l2) <= 1e-5 * abs(l2)
    assert abs(l1 - ref) <= 1e-5 * abs(ref)
    for k, g in g2.items():
        assert np.abs(g1[k] - g).max() <= 1e-4 * np.abs(g).max(), k
    # the state dict is the functional tree's, leaf by leaf
    for k, v in nets[0].state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy())
