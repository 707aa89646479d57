"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device (marker ``cuda``) and skip without one; on the
H100 run them with ``python -m pytest tests/test_torch_cuda_kernels.py -m
cuda --noconftest -q`` (``--noconftest``: the root conftest imports jax,
which the port's machine need not have). The CPU suites
(``tests/test_torch_*.py``) hold the plain versions against the JAX
reference; here each kernel is held against its plain version on the same
inputs.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _pool_case(rng, dev, M, H, Hk, D, bs, W, dtype, quant, Q=None):
    """A random pool + tables with NaN in the null block and a free block."""
    from paddle_tpu_torch.models.generation import _kv_quantize
    N = M * W + 2
    q_shape = (M, H, D) if Q is None else (M, Q, H, D)
    q = torch.from_numpy(rng.standard_normal(q_shape).astype(np.float32))
    kf = torch.from_numpy(rng.standard_normal((N, bs, Hk, D)).astype(
        np.float32))
    vf = torch.from_numpy(rng.standard_normal((N, bs, Hk, D)).astype(
        np.float32))
    perm = rng.permutation(np.arange(1, N - 1))[:M * W]
    tbl = torch.from_numpy(perm.reshape(M, W).astype(np.int32))
    qmax = 0 if Q is None else Q - 1
    sl = torch.from_numpy(rng.integers(0, W * bs - qmax, size=M).astype(
        np.int32))
    dl = None if Q is None else torch.from_numpy(
        rng.integers(0, Q, size=M).astype(np.int32))
    for t in (kf, vf):
        t[0] = float("nan")          # the null block
        t[N - 1] = float("nan")      # a free block no table maps
    if quant:
        k, ks = _kv_quantize(kf)
        v, vs = _kv_quantize(vf)
        extra = dict(k_scale=ks.to(dev), v_scale=vs.to(dev))
    else:
        k, v, extra = kf.to(dtype), vf.to(dtype), {}
    return (q.to(dtype).to(dev), k.to(dev), v.to(dev), tbl.to(dev),
            sl.to(dev), None if dl is None else dl.to(dev), extra)


@pytest.mark.parametrize("bs,D", [(16, 128), (4, 64), (32, 128), (12, 96)])
@pytest.mark.parametrize("dtype,quant", [(torch.float32, False),
                                         (torch.bfloat16, False),
                                         (torch.bfloat16, True)])
@pytest.mark.parametrize("G,Q", [(1, None), (4, None), (1, 8), (2, 40)])
def test_paged_attention_matches_plain(dev, dtype, quant, G, Q, bs, D):
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_attention, paged_attention_plain)
    rng = np.random.default_rng(G * 100 + (Q or 0) + bs + D)
    W = max(6, (Q or 1) // bs + 3)        # room for every query row
    q, k, v, tbl, sl, dl, extra = _pool_case(rng, dev, 3, 4 * G, 4, D,
                                             bs, W, dtype, quant, Q)
    n0 = paged_attention.launches
    out = paged_attention(q, k, v, tbl, sl, draft_lens=dl, **extra)
    torch.cuda.synchronize()
    assert paged_attention.launches == n0 + 1
    ref = paged_attention_plain(q, k, v, tbl, sl, draft_lens=dl, **extra)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    # fp32 reductions in another order; bf16 outputs also round once
    tol = 2e-2 if out.dtype == torch.bfloat16 else 1e-4
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * max(1.0, ref.float().abs().max().item()), err


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(1, 40, 70), (8, 128, 200),
                                   (33, 300, 129), (130, 64, 64)])
def test_weight_only_matmul_matches_plain(dev, x_dtype, M, K, N):
    from paddle_tpu_torch.kernels.quant_matmul import (
        quantize_weights, weight_only_matmul, weight_only_matmul_plain)
    g = torch.Generator().manual_seed(M * K + N)
    x = torch.randn((M, K), generator=g).to(x_dtype).to(dev)
    wq, s = quantize_weights(torch.randn((K, N), generator=g) / K ** 0.5)
    wq, s = wq.to(dev), s.to(dev)
    out = weight_only_matmul(x, wq, s, out_dtype=x_dtype)
    torch.cuda.synchronize()
    ref = weight_only_matmul_plain(x, wq, s, out_dtype=x_dtype)
    # the kernel scales after an fp32 sum, the plain version dequantizes
    # in the output dtype first: bf16 rounding of the dequantized weight
    tol = 1e-2 if x_dtype == torch.bfloat16 else 1e-4
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


def test_kernel_wrappers_refuse_bad_operands(dev):
    from paddle_tpu_torch.kernels.paged_attention import paged_attention
    from paddle_tpu_torch.kernels.quant_matmul import weight_only_matmul
    x = torch.zeros((4, 8), device=dev)
    with pytest.raises(ValueError, match="int8"):
        weight_only_matmul(x, torch.zeros((8, 4), device=dev),
                           torch.ones(4, device=dev))
    q = torch.zeros((2, 4, 256), device=dev)
    pool = torch.zeros((3, 16, 4, 256), device=dev)
    tbl = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    sl = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(q, pool, pool, tbl, sl)


def test_engine_kernel_path_matches_gather_path(dev):
    from paddle_tpu_torch.inference.serving import ServingConfig, ServingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, init_params
    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2)
    params = init_params(cfg, seed=3, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=n) for n in (5, 40, 17, 70)]
    outs = {}
    for knob in ("on", "off"):
        sc = ServingConfig(block_size=16, max_slots=3, max_model_len=128,
                           prefill_chunk=32, paged_kernel=knob)
        eng = ServingEngine(params, cfg, sc, device=dev)
        outs[knob] = eng.run(prompts, max_new_tokens=12, eos_token_id=None)
        assert eng.stats()["mixed_dispatches"] >= 1
    for a, b in zip(outs["on"], outs["off"]):
        np.testing.assert_array_equal(a, b)
