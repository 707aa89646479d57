"""The port's weight-only int8 path against the JAX package.

* ``quantize_weights`` / ``generation._kv_quantize`` / ``quantize_params``:
  bitwise equal to JAX, int8 values and fp32 scales both (``torch.round``
  and ``jnp.round`` both round half to even).
* the plain ``weight_only_matmul`` and ``llama._mm`` against JAX ``_mm``
  off the TPU (``h @ (w * s)``) at fp32, rtol 1e-5: the same products,
  summed in another order.
* the CUDA kernel's split-K arithmetic (``weight_only_matmul_split_plain``)
  against the JAX Pallas kernel in interpret mode at ragged K, rtol 1e-5,
  and the kernel's plan at the serving path's shapes.

Inputs come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.quant_matmul import quantize_weights as jax_qw
from paddle_tpu.kernels.quant_matmul import weight_only_matmul as jax_wom
from paddle_tpu.models import generation as JG
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.kernels import quant_matmul as QM
from paddle_tpu_torch.kernels.quant_matmul import (
    quantize_weights, weight_only_matmul, weight_only_matmul_split_plain)
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(2)


def _ties():
    """A weight whose columns hit exact .5 quotients (amax 127 -> scale
    1.0), plus an all-zero column (the 1e-8 scale floor)."""
    w = np.zeros((6, 3), np.float32)
    w[:, 0] = [127.0, 0.5, 1.5, 2.5, -2.5, -0.5]
    w[:, 1] = [-127.0, 3.5, 4.5, -5.5, 6.5, 126.5]
    return w


@pytest.mark.parametrize("shape", [(64, 48), (37, 129), "ties"])
def test_quantize_weights_bitwise(shape):
    if shape == "ties":
        w = _ties()
    else:
        w = np.random.default_rng(1).standard_normal(shape).astype(
            np.float32) * 0.3
    jq, js = (np.asarray(a) for a in jax_qw(jnp.asarray(w)))
    tq, ts = quantize_weights(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)


@pytest.mark.parametrize("seed", range(2))
def test_kv_quantize_bitwise(seed):
    x = np.random.default_rng(seed).standard_normal((5, 7, 4, 16)).astype(
        np.float32) * 2.0
    x[0, 0, 0] = 0.0                    # an all-zero head: the scale floor
    jq, js = (np.asarray(a) for a in JG._kv_quantize(jnp.asarray(x)))
    tq, ts = TG._kv_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)


def test_quantize_params_bitwise():
    cfg = JL.LlamaConfig(vocab_size=96, hidden_size=32,
                         intermediate_size=48, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2)
    jp = JL.init_params(cfg, jax.random.PRNGKey(3))
    jq = jax.tree_util.tree_map(np.asarray, JL.quantize_params(jp))
    tq = TL.quantize_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    assert set(tq["layers"]) == set(jq["layers"])
    assert set(tq) == set(jq)
    for name, arr in jq["layers"].items():
        np.testing.assert_array_equal(tq["layers"][name].numpy(), arr)
    np.testing.assert_array_equal(tq["lm_head"].numpy(), jq["lm_head"])
    np.testing.assert_array_equal(tq["lm_head_s"].numpy(), jq["lm_head_s"])


@pytest.mark.parametrize("M,K,N", [(1, 16, 24), (8, 64, 48), (13, 40, 72)])
def test_weight_only_matmul_plain_vs_jax_mm(M, K, N):
    rng = np.random.default_rng(M * K * N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    wq, s = (np.array(a) for a in jax_qw(jnp.asarray(w)))
    lp = {"w": jnp.asarray(wq), "w_s": jnp.asarray(s)}
    want = np.asarray(JL._mm(jnp.asarray(x), lp, "w", jnp.float32))
    t = torch.from_numpy
    out = weight_only_matmul(t(x), t(wq), t(s), out_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)
    lpt = {"w": t(wq), "w_s": t(s)}
    x3 = x.reshape(1, M, K)
    out3 = TL._mm(t(x3), lpt, "w", torch.float32)
    assert out3.shape == (1, M, N) and out3.dtype == torch.float32
    np.testing.assert_allclose(out3.numpy()[0], want, rtol=1e-5, atol=1e-6)


def test_mm_fp_weights_vs_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    want = np.asarray(JL._mm(jnp.asarray(x), {"w": jnp.asarray(w)}, "w",
                             jnp.float32))
    out = TL._mm(torch.from_numpy(x), {"w": torch.from_numpy(w)}, "w",
                 torch.float32)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)


def test_quant_mode_validation():
    with pytest.raises(ValueError, match="options"):
        TL.validate_quant_mode("fp4", TL.QUANTIZE_MODES)
    with pytest.raises(ValueError, match="kv_quant"):
        TG.init_paged_pool(TL.LlamaConfig(num_hidden_layers=1,
                                          hidden_size=32,
                                          num_attention_heads=4), 4, 4,
                           kv_quant="int2", device="cpu")
    p = {"layers": {"wq": torch.zeros(1, 4, 4)}}
    assert TL.ensure_quantized(p, None) is p
    q = {"layers": {"wq": torch.zeros(1, 4, 4, dtype=torch.int8),
                    "wq_s": torch.ones(1, 4)}}
    assert TL.ensure_quantized(q, "int8") is q


@pytest.mark.parametrize("M,K,N,block_k,span", [
    (8, 300, 129, 100, 64),      # ragged K: 4 spans of 64 + one of 44
    (8, 300, 129, 100, 112),
    (16, 600, 72, 200, 256),
    (8, 300, 40, 300, 320),      # one span over all of K
])
def test_split_k_emulation_vs_jax_kernel(M, K, N, block_k, span):
    """The split-K routes' arithmetic (fp32 partial sums per span, added
    in span order, then the scale) against the JAX Pallas kernel run in
    interpret mode, at fp32 out: the same exact products (bf16 x times
    int8 values), summed in another order (rtol 1e-5)."""
    rng = np.random.default_rng(M + K + N + span)
    x = np.asarray(jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
                   .astype(jnp.float32))              # bf16-exact values
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    wq, s = (np.array(a) for a in jax_qw(jnp.asarray(w)))
    want = np.asarray(jax_wom(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s),
                              block_k=block_k, out_dtype=jnp.float32))
    t = torch.from_numpy
    got = weight_only_matmul_split_plain(t(x), t(wq), t(s), span,
                                         out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 5504), (5504, 2048),
                                 (2048, 32000)])
def test_plan_fills_the_card_at_decode(K, N):
    """At the serving path's decode shapes (M = 8) the plan takes 16-row
    tiles with at least 2 blocks per SM of a 132-SM H100, in spans of
    whole 64-row steps that cover K exactly once; the mixed dispatch
    (M = 2048) takes 128-row tiles unsplit."""
    route, splits, span = QM._plan(8, K, N, False, 132)
    assert route == QM.TC16 and span % 64 == 0
    assert (splits - 1) * span < K <= splits * span
    assert -(-N // 128) * splits >= 2 * 132
    assert QM._plan(2048, K, N, False, 132)[:2] == (QM.TC128, 1)
    assert QM._plan(8, K, N, True, 132)[0] == QM.FP32
