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
@pytest.mark.parametrize("G,Q", [(1, None), (4, None), (1, 8), (2, 40),
                                 (3, 5), (1, 16)])
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


@pytest.mark.parametrize("x_dtype,quant", [(torch.bfloat16, False),
                                           (torch.bfloat16, True)])
@pytest.mark.parametrize("G,Q", [(1, None), (4, None), (1, 8), (3, 5)])
@pytest.mark.parametrize("bs", [16, 12])
def test_paged_attention_split_windows(dev, x_dtype, quant, G, Q, bs):
    """Windows of up to 2048+ keys on the split route (Q * G < 16): the
    kernel against the plain version and against the split emulation,
    one empty window (seq_len -1: its rows output 0), and the same bits
    on a second call (the splits merge in a fixed order)."""
    import importlib
    from paddle_tpu_torch.device import sm_count
    # the module (the package's ``paged_attention`` is the function)
    PA = importlib.import_module("paddle_tpu_torch.kernels.paged_attention")
    rng = np.random.default_rng(7 * G + (Q or 0) + bs)
    W = -(-2100 // bs)
    q, k, v, tbl, sl, dl, extra = _pool_case(rng, dev, 4, 4 * G, 4, 128,
                                             bs, W, x_dtype, quant, Q)
    sl[1] = -1
    if dl is not None:
        dl[1] = 0
    route, splits, _ = PA._plan(4, (Q or 1) * G, 4, W * bs, True,
                                sm_count(dev))
    assert route == PA.SPLIT and splits > 1
    out = PA.paged_attention(q, k, v, tbl, sl, draft_lens=dl, **extra)
    again = PA.paged_attention(q, k, v, tbl, sl, draft_lens=dl, **extra)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref = PA.paged_attention_plain(q, k, v, tbl, sl, draft_lens=dl, **extra)
    emu = PA.paged_attention_split_plain(q, k, v, tbl, sl, draft_lens=dl,
                                         splits=splits, **extra)
    assert torch.isfinite(out.float()).all()
    assert (out[1] == 0).all()
    tol = 2e-2 if out.dtype == torch.bfloat16 else 1e-4
    for want in (ref, emu):
        err = (out.float() - want.float()).abs().max().item()
        assert err <= tol * max(1.0, want.float().abs().max().item()), err


@pytest.mark.parametrize("H,Hk,quant", [(16, 16, False), (16, 16, True),
                                        (32, 8, False)],
                         ids=["bf16", "int8-pool", "gqa"])
def test_paged_attention_verify_shapes(dev, H, Hk, quant):
    """The speculative verify's shape (spec_decode 4: Q 5) at D 128, bs 16,
    draft_lens taking every value 0..4: Q·G 5 takes the split route, GQA
    32/8 (Q·G 20) the multi-query route."""
    import importlib
    from paddle_tpu_torch.device import sm_count
    PA = importlib.import_module("paddle_tpu_torch.kernels.paged_attention")
    M, Q, D, bs, W = 8, 5, 128, 16, 64
    rng = np.random.default_rng(H + Hk + quant)
    q, k, v, tbl, sl, _, extra = _pool_case(rng, dev, M, H, Hk, D, bs, W,
                                            torch.bfloat16, quant, Q)
    dl = torch.arange(M, dtype=torch.int32, device=dev) % Q
    route = PA._plan(M, Q * (H // Hk), Hk, W * bs, True, sm_count(dev))[0]
    assert route == (PA.SPLIT if H == Hk else PA.MULTI_QUERY)
    n0 = PA.paged_attention.launches_multiquery
    out = PA.paged_attention(q, k, v, tbl, sl, draft_lens=dl, **extra)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches_multiquery == n0 + 1
    ref = PA.paged_attention_plain(q, k, v, tbl, sl, draft_lens=dl, **extra)
    assert out.shape == ref.shape == (M, Q, H, D)
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * max(1.0, ref.float().abs().max().item()), err


def test_sample_tokens_on_the_card_matches_the_cpu(dev):
    """The sampler on CUDA tensors stays on the card, draws the CPU's bits
    and uniforms bit for bit, and picks the CPU's tokens except where the
    two candidates lie within 4e-6 in gumbel + logits / t."""
    from paddle_tpu_torch import prng
    from paddle_tpu_torch.models.generation import sample_tokens, seed_key
    rng = np.random.default_rng(0)
    B, V = 40, 32000
    lg = torch.from_numpy((rng.standard_normal((B, V)) * 2)
                          .astype(np.float32))
    keys = prng.fold_in(torch.stack([seed_key(s) for s in range(B)]), 7)
    temp = torch.tensor(np.tile([0.0, 0.8, 1.3, 0.7], B // 4),
                        dtype=torch.float32)
    topk = torch.tensor(np.tile([0, 50, 0, 5], B // 4), dtype=torch.int32)
    topp = torch.tensor(np.tile([1.0, 0.95, 0.9, 1.0], B // 4),
                        dtype=torch.float32)
    for fn in (prng.random_bits32, prng.uniform):
        cpu_draw = fn(keys, (V,))
        card_draw = fn(keys.to(dev), (V,))
        assert card_draw.device.type == "cuda"
        assert torch.equal(card_draw.cpu(), cpu_draw)
    want = sample_tokens(lg, keys, temp, topk, topp).numpy()
    got = sample_tokens(lg.to(dev), keys.to(dev), temp.to(dev),
                        topk.to(dev), topp.to(dev))
    assert got.device.type == "cuda" and got.dtype == torch.int32
    got = got.cpu().numpy()
    noise = prng.gumbel(keys, (V,)).double()
    z = noise + lg.double() / torch.clamp(temp, min=1e-6).double()[:, None]
    for r in np.nonzero(got != want)[0]:
        assert abs(z[r, got[r]] - z[r, want[r]]).item() < 4e-6, r


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


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(300, 129), (5504, 129), (300, 32000),
                                 (5504, 32000)])
@pytest.mark.parametrize("M", [1, 8, 16, 17, 64, 65, 2048])
def test_weight_only_matmul_routes(dev, x_dtype, M, K, N):
    """Every route of the plan (fp32; bf16 streaming at M <= 8, 64-row
    tiles to 64, 128-row tiles above) at ragged K and N: the kernel
    against the plain version by max error and, at bf16, by the
    norm-relative rule of chip_smoke.py (a dropped K tile can pass a
    max-error rule); the split routes give the same bits twice."""
    from paddle_tpu_torch.device import sm_count
    from paddle_tpu_torch.kernels import quant_matmul as QM
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=dev).to(x_dtype)
    wq, s = QM.quantize_weights(torch.randn((K, N), generator=g, device=dev)
                                / K ** 0.5)
    out = QM.weight_only_matmul(x, wq, s, out_dtype=x_dtype)
    torch.cuda.synchronize()
    ref = QM.weight_only_matmul_plain(x, wq, s, out_dtype=x_dtype)
    tol = 1e-2 if x_dtype == torch.bfloat16 else 1e-4
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err
    if x_dtype == torch.bfloat16:
        fro, row = _rel_errors(out, ref)
        assert fro <= 1e-2 and row <= 3e-2, (fro, row)
        _, splits, span = QM._plan(M, K, N, False, sm_count(dev))
        if splits > 1:
            assert torch.equal(out, QM.weight_only_matmul(x, wq, s,
                                                          out_dtype=x_dtype))
            emu = QM.weight_only_matmul_split_plain(x, wq, s, span,
                                                    out_dtype=torch.float32)
            assert (out.float() - emu).abs().max().item() <= \
                tol * emu.abs().max().item()


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


def _flash_case(rng, dev, dtype, B, Sq, Sk, H, Hk, D, segs):
    """q, k, v, dout on the card, and segment ids: None, "packed" (3
    segments per row, Sq == Sk), "edges" (3 segments cut on 128-key tile
    edges), "cross" (a query segment with no key) or "offset" (no segments;
    q, k and v views whose data start one element past a 16-byte
    boundary)."""
    t = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         .to(dtype).to(dev)
         for s in ((B, Sq, H, D), (B, Sk, Hk, D), (B, Sk, Hk, D),
                   (B, Sq, H, D))]
    if segs == "offset":
        for i in range(3):
            buf = torch.empty(t[i].numel() + 1, dtype=dtype, device=dev)
            buf[1:].copy_(t[i].flatten())
            t[i] = buf[1:].view(t[i].shape)
            assert t[i].data_ptr() % 16 != 0
    seg_q = seg_k = None
    if segs == "packed":
        cuts = np.sort(rng.choice(np.arange(1, Sq), (B, 2)), axis=1)
        seg_q = (np.arange(Sq)[None, :, None] >= cuts[:, None, :]).sum(-1)
        seg_k = seg_q
    elif segs == "edges":
        seg_q = np.arange(Sq)[None] // 128 * np.ones((B, 1), np.int64)
        seg_k = seg_q
    elif segs == "cross":
        seg_q = np.where(np.arange(Sq)[None] < Sq // 3, 9, 1) * np.ones(
            (B, 1), np.int64)
        seg_k = (np.arange(Sk)[None] >= Sk // 2) * np.ones((B, 1), np.int64)
    if seg_q is not None:
        seg_q = torch.from_numpy(seg_q.astype(np.int32)).to(dev)
        seg_k = torch.from_numpy(seg_k.astype(np.int32)).to(dev)
    return t, seg_q, seg_k


def _rel_errors(got, want):
    """(||got - want||_F / ||want||_F, the worst row's ||got_r - want_r|| /
    max(||want_r||, 0.1 * the RMS row norm)) over vectors of the last dim:
    the rule ``chip_smoke.py`` phase 7 holds the flash kernels to. The
    floor keeps rows whose exact value is ~0 from reading as 1."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    d = g - w
    rows = w.norm(dim=1)
    floor = 0.1 * w.norm() / rows.numel() ** 0.5
    return ((d.norm() / w.norm()).item(),
            (d.norm(dim=1) / torch.clamp(rows, min=floor)).max().item())


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,B,Sq,Sk,H,Hk,segs", [
    (True, 2, 100, 100, 4, 4, None),       # ragged tiles
    (False, 2, 64, 130, 4, 2, None),       # cross lengths, GQA
    (True, 1, 70, 150, 8, 2, None),        # bottom-right causal, Sq < Sk
    (True, 2, 128, 128, 4, 2, "packed"),
    (False, 2, 48, 96, 4, 2, "cross"),     # fully masked query rows
    (True, 1, 200, 333, 8, 2, None),       # several ragged tiles, GQA 8/2
    (True, 1, 384, 384, 4, 2, "edges"),    # segments cut on tile edges
    (True, 1, 130, 130, 4, 2, "offset"),   # operands off 16-byte alignment
])
def test_flash_attention_matches_plain(dev, dtype, D, causal, B, Sq, Sk, H,
                                       Hk, segs):
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_plain, flash_attention_fwd_plain,
        flash_attention_with_lse)
    rng = np.random.default_rng(Sq * Sk + H + D)
    (q, k, v, do), seg_q, seg_k = _flash_case(rng, dev, dtype, B, Sq, Sk, H,
                                              Hk, D, segs)
    scale = 1.0 / D ** 0.5
    n0 = (flash_attention.launches, flash_attention.launches_bwd_dq,
          flash_attention.launches_bwd_dkv)
    # (detach keeps an "offset" view where it starts)
    qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
    out, lse = flash_attention_with_lse(qq, kk, vv, causal=causal,
                                        segment_ids=seg_q,
                                        kv_segment_ids=seg_k)
    out.backward(do)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.launches_bwd_dq,
            flash_attention.launches_bwd_dkv) == tuple(n + 1 for n in n0)
    ref_out, ref_lse = flash_attention_fwd_plain(q, k, v, seg_q, seg_k, scale,
                                                 causal)
    # the backward on the Function's saved out and lse (delta = rowsum(dO
    # * O) moves with out's bf16 rounding in short causal rows)
    ref_grads = flash_attention_bwd_plain(q, k, v, seg_q, seg_k,
                                          out.detach(), lse, do, scale,
                                          causal)
    assert out.dtype == qq.grad.dtype == kk.grad.dtype == dtype
    assert lse.dtype == torch.float32
    # fp32: the same fp32 sums in another order; bf16: one more rounding of
    # each output, and p / ds rounded to bf16 before their tensor-core
    # products (the limits of chip_smoke.py phase 7)
    fro_tol, row_tol = (1e-2, 3e-2) if dtype == torch.bfloat16 else (1e-5,
                                                                     1e-4)
    for got, want in ((out, ref_out), (qq.grad, ref_grads[0]),
                      (kk.grad, ref_grads[1]), (vv.grad, ref_grads[2])):
        assert torch.isfinite(got.float()).all()
        fro, row = _rel_errors(got, want)
        assert fro <= fro_tol and row <= row_tol, (fro, row)
    lse_err = (lse - ref_lse).abs().max().item()
    assert lse_err <= (1e-3 if dtype == torch.bfloat16 else 1e-4), lse_err


# the SDXL UNet's attention (chip_smoke.py phase 7 cases (i)-(k)):
# level-1 self-attention at D 64, cross-attention over 77 text tokens (a
# key length off the 64-row tile), level-2 / mid at D 128
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,H,D", [
    (2, 4096, 4096, 10, 64),     # (i)
    (2, 4096, 77, 10, 64),       # (j)
    (2, 1024, 1024, 10, 128),    # (k) self
    (2, 1024, 77, 10, 128),      # (k) cross
])
def test_flash_attention_sdxl_shapes(dev, dtype, B, Sq, Sk, H, D):
    test_flash_attention_matches_plain(dev, dtype, D, False, B, Sq, Sk, H, H,
                                       None)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_dq_same_bits_twice(dev, D):
    # dq: each block owns its rows and sums its key tiles in order, no
    # atomics
    import importlib
    FA = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    rng = np.random.default_rng(D + 1)
    (q, k, v, do), seg, _ = _flash_case(rng, dev, torch.bfloat16, 2, 300, 300,
                                        8, 2, D, "packed")
    scale = 1.0 / D ** 0.5
    out, lse = FA._fwd_cuda(q, k, v, seg, seg, scale, True)
    ops = FA._bwd_operands(q, k, v, seg, seg, out, lse, do)
    first = FA._dq_cuda(ops, scale, True)
    second = FA._dq_cuda(ops, scale, True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_dkv_same_bits_twice(dev, D):
    # dk/dv: GQA summed in registers in a fixed order, no atomics
    import importlib
    FA = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    rng = np.random.default_rng(D)
    (q, k, v, do), seg, _ = _flash_case(rng, dev, torch.bfloat16, 2, 300, 300,
                                        8, 2, D, "packed")
    scale = 1.0 / D ** 0.5
    out, lse = FA._fwd_cuda(q, k, v, seg, seg, scale, True)
    ops = FA._bwd_operands(q, k, v, seg, seg, out, lse, do)
    first = FA._dkv_cuda(ops, scale, True)
    second = FA._dkv_cuda(ops, scale, True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1],
                                                            second[1])


def test_flash_attention_refuses_what_the_kernels_do_not_take(dev):
    from paddle_tpu_torch.kernels.flash_attention import flash_attention
    q = torch.zeros((1, 8, 2, 96), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q, q, q)


def test_training_kernel_path_matches_plain_path(dev):
    from paddle_tpu_torch.models.llama import (LlamaConfig, init_params,
                                               loss_fn)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, remat=True)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 96))).to(dev)
    out = {}
    for use in (True, False):
        params = init_params(cfg, seed=1, device=dev)
        leaves = [params["embed"], params["layers"]["wq"]]
        for p in leaves:
            p.requires_grad_(True)
        c = LlamaConfig(**{**cfg.__dict__, "use_kernels": use})
        loss = loss_fn(params, ids, ids, c)
        out[use] = (loss.item(), torch.autograd.grad(loss, leaves))
    assert abs(out[True][0] - out[False][0]) <= 1e-5 * abs(out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def _bf16_steps(got, ref):
    """The largest |got - ref| in bf16 steps of the reference, a step taken
    at the larger of |ref| and 1e-3 of ref's RMS (where a value cancels to
    ~0 the two fp32 reduction orders differ by ~1e-7 of the terms, which is
    many steps of the tiny result): <= 1 is "within one bf16 step"."""
    g, r = got.float(), ref.float()
    floor = 1e-3 * r.pow(2).mean().sqrt()
    return ((g - r).abs() / (2.0 ** -7 * torch.clamp(r.abs(), min=floor))) \
        .max().item()


def _rel_max(got, ref):
    """max |got - ref| over max |ref|."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


# routes (kernels/rms_norm.py _fwd_plan, _bwd_plan): d = 1030 and 24 take
# the two-pass kernels; 2048, 4096 and 8192 the register routes (the
# forward on one warp per row at bf16 2048, two at fp32; the backward on
# two or more), the few rows of n = 8 and 40 spread over more warps
@pytest.mark.parametrize("n,d", [(333, 1030), (333, 2048), (8, 2048),
                                 (5, 24), (8, 4096), (40, 8192)])
@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)])
def test_rms_norm_matches_plain(dev, n, d, x_dtype, w_dtype):
    from paddle_tpu_torch.device import sm_count
    from paddle_tpu_torch.kernels.rms_norm import (
        _bwd_plan, _fwd_plan, rms_norm, rms_norm_bwd_plain,
        rms_norm_fwd_plain)
    route = _fwd_plan(n, d, x_dtype, True, sm_count(dev)).route
    assert route == ("two_pass" if d in (1030, 24) else "registers")
    assert _bwd_plan(n, d, x_dtype, True, sm_count(dev)).route == route
    rng = np.random.default_rng(n + d)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(d).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((d, n)).astype(np.float32))
    x, w = x.to(x_dtype).to(dev), w.to(w_dtype).to(dev)
    g = g.to(x_dtype).to(dev).t()          # a non-contiguous grad_output
    n0 = (rms_norm.launches, rms_norm.launches_bwd)
    b0 = rms_norm.launches_bwd_by_route[route]
    xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = rms_norm(xx, ww, 1e-6)
    out.backward(g)
    torch.cuda.synchronize()
    assert (rms_norm.launches, rms_norm.launches_bwd) == (n0[0] + 1,
                                                          n0[1] + 1)
    assert rms_norm.launches_bwd_by_route[route] == b0 + 1
    ref_out, rstd = rms_norm_fwd_plain(x, w, 1e-6)
    ref_dx, ref_dw = rms_norm_bwd_plain(x, w, rstd, g)
    assert (out.dtype, xx.grad.dtype, ww.grad.dtype) == (x_dtype, x_dtype,
                                                         w_dtype)
    for got, ref in ((out, ref_out), (xx.grad, ref_dx)):
        assert torch.isfinite(got.float()).all()
        if x_dtype == torch.bfloat16:
            assert _bf16_steps(got, ref) <= 1
        else:
            assert _rel_max(got, ref) <= 1e-5
    if w_dtype == torch.bfloat16:
        assert _bf16_steps(ww.grad, ref_dw) <= 1
    else:
        assert _rel_max(ww.grad, ref_dw) <= 1e-4
    # dw is summed in a fixed order: the same bits on every run
    from paddle_tpu_torch.kernels.rms_norm import _bwd_cuda
    assert torch.equal(_bwd_cuda(x, w, rstd, g)[1],
                       _bwd_cuda(x, w, rstd, g)[1])


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_forward_routes_agree(dev, x_dtype):
    # one aligned input through the register route and through the two-pass
    # kernel (with and without 16-byte loads), and a view off the 16-byte
    # boundary, which the plan sends to the two-pass kernel: each within
    # the rule of test_rms_norm_matches_plain
    from paddle_tpu_torch.kernels.rms_norm import (
        _FwdPlan, _aligned, _fwd_cuda, _fwd_plan, rms_norm_fwd_plain)
    rng = np.random.default_rng(7)
    n, d = 96, 2048
    buf = torch.from_numpy(rng.standard_normal(n * d + 1).astype(
        np.float32)).to(x_dtype).to(dev)
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(d).astype(
        np.float32)).to(dev)
    aligned, off = buf[:-1].view(n, d), buf[1:].view(n, d)
    from paddle_tpu_torch.device import sm_count
    assert _fwd_plan(n, d, x_dtype, _aligned(off, w),
                     sm_count(dev)).route == "two_pass"
    cases = [(aligned, None), (aligned, _FwdPlan("two_pass", vec=True)),
             (aligned, _FwdPlan("two_pass", vec=False)), (off, None)]
    for x, plan in cases:
        out, rstd = _fwd_cuda(x, w, 1e-6, plan)
        ref, ref_rstd = rms_norm_fwd_plain(x, w, 1e-6)
        torch.cuda.synchronize()
        assert _rel_max(rstd, ref_rstd) <= 1e-5
        if x_dtype == torch.bfloat16:
            assert _bf16_steps(out, ref) <= 1
        else:
            assert _rel_max(out, ref) <= 1e-5


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_backward_routes_agree(dev, x_dtype):
    # one aligned input through the register route and through the two-pass
    # kernel (with and without 16-byte loads), and x or g off the 16-byte
    # boundary, which the plan sends to the two-pass kernel: each within
    # the limits of test_rms_norm_matches_plain, dw the same bits twice
    from paddle_tpu_torch.device import sm_count
    from paddle_tpu_torch.kernels.rms_norm import (
        _BwdPlan, _aligned, _bwd_cuda, _bwd_plan, rms_norm_bwd_plain,
        rms_norm_fwd_plain)
    rng = np.random.default_rng(8)
    n, d = 96, 2048
    bufs = [torch.from_numpy(rng.standard_normal(n * d + 1).astype(
        np.float32)).to(x_dtype).to(dev) for _ in range(2)]
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(d).astype(
        np.float32)).to(dev)
    (x, x_off), (g, g_off) = ((b[:-1].view(n, d), b[1:].view(n, d))
                              for b in bufs)
    for xo, go in ((x_off, g), (x, g_off)):
        assert _bwd_plan(n, d, x_dtype, _aligned(xo, w, go),
                         sm_count(dev)).route == "two_pass"
    cases = [(x, g, None), (x, g, _BwdPlan("two_pass", vec=True)),
             (x, g, _BwdPlan("two_pass", vec=False)), (x_off, g, None),
             (x, g_off, None)]
    for xc, gc, plan in cases:
        _, rstd = rms_norm_fwd_plain(xc, w, 1e-6)
        dx, dw = _bwd_cuda(xc, w, rstd, gc, plan)
        ref_dx, ref_dw = rms_norm_bwd_plain(xc, w, rstd, gc)
        torch.cuda.synchronize()
        assert torch.isfinite(dx.float()).all()
        if x_dtype == torch.bfloat16:
            assert _bf16_steps(dx, ref_dx) <= 1
        else:
            assert _rel_max(dx, ref_dx) <= 1e-5
        assert _rel_max(dw, ref_dw) <= 1e-4
        assert torch.equal(dw, _bwd_cuda(xc, w, rstd, gc, plan)[1])


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(333, 2048), (40, 4096)])
def test_rms_norm_backward_register_route_is_its_emulation(dev, x_dtype, n,
                                                           d):
    # the kernel rounds every product and sum where rms_norm_bwd_tiled
    # does, in the same order over the same grid: the same bits
    from paddle_tpu_torch.device import sm_count
    from paddle_tpu_torch.kernels.rms_norm import (
        _DTYPE_CODE, _bwd_cuda, _bwd_plan, _bwd_reg_blocks,
        rms_norm_bwd_tiled, rms_norm_fwd_plain)
    rng = np.random.default_rng(n + d)
    x, g = (torch.from_numpy(rng.standard_normal((n, d)).astype(
        np.float32)).to(x_dtype).to(dev) for _ in range(2))
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(d).astype(
        np.float32)).to(dev)
    _, rstd = rms_norm_fwd_plain(x, w, 1e-6)
    plan = _bwd_plan(n, d, x_dtype, True, sm_count(dev))
    assert plan.route == "registers"
    blocks = _bwd_reg_blocks(n, d, _DTYPE_CODE[x_dtype], 0, plan.vpl,
                             plan.wpr, sm_count(dev))
    dx, dw = _bwd_cuda(x, w, rstd, g)
    want_dx, want_dw = rms_norm_bwd_tiled(x, w, rstd, g, plan, blocks)
    torch.cuda.synchronize()
    assert torch.equal(dx, want_dx) and torch.equal(dw, want_dw)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H", [(2, 37, 3), (1, 128, 8)])
def test_apply_rope_matches_plain(dev, D, dtype, B, S, H):
    from paddle_tpu_torch.kernels.rope import (apply_rope, apply_rope_plain,
                                               rope_cos_sin)
    rng = np.random.default_rng(B * S + H + D)
    x = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)).to(dtype).to(dev)
    g = torch.from_numpy(rng.standard_normal((B, S, D, H)).astype(
        np.float32)).to(dtype).to(dev).transpose(2, 3)   # non-contiguous
    cos, sin = rope_cos_sin(S, D, device=dev)
    n0 = (apply_rope.launches, apply_rope.launches_bwd)
    xx = x.clone().requires_grad_(True)
    out = apply_rope(xx, cos, sin)
    out.backward(g)
    torch.cuda.synchronize()
    assert (apply_rope.launches, apply_rope.launches_bwd) == (n0[0] + 1,
                                                              n0[1] + 1)
    # the kernel rounds each product and the sum one at a time, in the
    # plain formula's order: the same fp32 result
    assert torch.equal(out, apply_rope_plain(x, cos, sin))
    assert torch.equal(xx.grad, apply_rope_plain(g, cos, -sin))


def test_rms_norm_and_rope_refuse_what_the_kernels_do_not_take(dev):
    from paddle_tpu_torch.kernels.rms_norm import rms_norm
    from paddle_tpu_torch.kernels.rope import apply_rope, rope_cos_sin
    cos, sin = rope_cos_sin(4, 8, device=dev)
    with pytest.raises(ValueError, match="D even"):
        apply_rope(torch.zeros((1, 4, 2, 7), device=dev), cos[:, :7],
                   sin[:, :7])
    with pytest.raises(ValueError, match="S, D"):
        apply_rope(torch.zeros((1, 6, 2, 8), device=dev), cos, sin)
    with pytest.raises(ValueError, match="bfloat16"):
        apply_rope(torch.zeros((1, 4, 2, 8), device=dev,
                               dtype=torch.float16), cos, sin)
    with pytest.raises(ValueError, match="bfloat16"):
        rms_norm(torch.zeros((3, 8), device=dev, dtype=torch.float16),
                 torch.ones(8, device=dev))
    with pytest.raises(ValueError, match="does not match"):
        rms_norm(torch.zeros((3, 8), device=dev), torch.ones(7, device=dev))


def test_fused_norm_training_matches_plain_path(dev):
    """fp32, fused norms and RoPE against the plain ones: the loss and every
    gradient leaf, then 3 AdamW steps' losses (chip_smoke.py phase 12's
    limits)."""
    from paddle_tpu_torch.kernels.rms_norm import rms_norm
    from paddle_tpu_torch.kernels.rope import apply_rope
    from paddle_tpu_torch.models.llama import (LlamaConfig, _leaves,
                                               init_params, loss_fn,
                                               make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    base = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, use_kernels=True, remat=True)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 96))).to(dev)
    out = {}
    for fused in (True, False):
        cfg = LlamaConfig(**base, use_fused_norm=fused)
        params = init_params(cfg, seed=2, device=dev)
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        n0 = (rms_norm.launches_bwd, apply_rope.launches_bwd)
        loss = loss_fn(params, ids, ids, cfg)
        grads = torch.autograd.grad(loss, leaves)
        launched = (rms_norm.launches_bwd - n0[0],
                    apply_rope.launches_bwd - n0[1])
        assert launched == ((5, 4) if fused else (0, 0))
        init_opt, step = make_train_step(cfg, lr=1e-3)
        opt = init_opt(params)
        traj = []
        for _ in range(3):
            params, opt, l_ = step(params, opt, ids, ids)
            traj.append(l_.item())
        out[fused] = (loss.item(), grads, traj)
    (lf, gf, tf), (lp, gp, tp) = out[True], out[False]
    assert abs(lf - lp) <= 1e-5 * abs(lp)
    for a, b in zip(gf, gp):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    assert max(abs(a - b) / abs(b) for a, b in zip(tf, tp)) <= 1e-4


@pytest.mark.parametrize("policy,flash", [("save_flash", 1),
                                          ("save_flash_only", 1),
                                          ("save_qkv_attn", 2)])
def test_remat_policy_launches_and_gradients(dev, policy, flash):
    """fp32 on the card: a named remat policy launches the flash forward
    ``flash`` times a layer (once where it keeps the flash residuals, the
    backward then feeding the saved out/lse and, under
    ``save_flash_only``, q/k/v rebuilt by ``regen_inputs``), and its loss
    equals full remat's within 1e-6 relative and its gradient leaves
    within 1e-5 x max|g| (the projections' input gradient is summed in
    another order; chip_smoke.py phase 16 holds its larger config to
    1e-6)."""
    from paddle_tpu_torch.kernels.flash_attention import flash_attention
    from paddle_tpu_torch.models.llama import (LlamaConfig, _leaves,
                                               init_params, loss_fn)
    torch.backends.cuda.matmul.allow_tf32 = False
    base = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, use_kernels=True, remat=True)
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 96))).to(dev)
    out = {}
    for pol in (None, policy):
        cfg = LlamaConfig(**base, remat_policy=pol)
        params = init_params(cfg, seed=4, device=dev)
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        n0 = (flash_attention.launches, flash_attention.launches_bwd_dq)
        loss = loss_fn(params, ids, ids, cfg)
        grads = torch.autograd.grad(loss, leaves)
        out[pol] = (loss.item(), grads,
                    (flash_attention.launches - n0[0],
                     flash_attention.launches_bwd_dq - n0[1]))
    (l0, g0, n0), (l1, g1, n1) = out[None], out[policy]
    assert n0 == (4, 2) and n1 == (2 * flash, 2)
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    for a, b in zip(g1, g0):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("use_kernel", [False, True], ids=["gather", "kernel"])
def test_moe_decode_with_freed_slots_sharing_the_null_block(dev, use_kernel):
    """fp32 MoE decode at a capacity that drops, with twelve freed slots
    (distinct tokens, so distinct K/V) all writing the null block's cell
    (0, 0) ahead of four live slots in the experts' queues: eight runs on
    the card give the same bits, and every row's logits (atol 1e-4) and
    the drop count equal the CPU's. A row's 512 K values fill one block of
    the scatter, so without ``generation._write_src`` the cell would hold
    whichever of the twelve rows' blocks wrote last, run by run."""
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.models.llama import (LlamaConfig, _tree_map,
                                               init_params)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=256, hidden_size=512, intermediate_size=256,
                      num_hidden_layers=3, num_attention_heads=4,
                      moe_num_experts=4, moe_top_k=2,
                      moe_capacity_factor=0.5)
    rng = np.random.default_rng(8)
    M, bs, W = 16, 16, 4
    toks = torch.from_numpy(rng.permutation(256)[:M].astype(np.int32))
    lens = torch.tensor([0] * 12 + [5, 17, 30, 9], dtype=torch.int32)
    tables = torch.zeros((M, W), dtype=torch.int32)
    tables[12:] = torch.arange(1, 1 + 4 * W, dtype=torch.int32).view(4, W)
    act = lens > 0
    params = init_params(cfg, seed=5, device="cpu")
    pool = G.init_paged_pool(cfg, 1 + 4 * W, bs, device="cpu")
    for t in pool.values():
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(
            np.float32)))

    def run(d):
        cast = (lambda t: t.to(d))
        return G.paged_decode_step(
            _tree_map(cast, params), cfg, toks.to(d), lens.to(d),
            tables.to(d), {k: v.to(d) for k, v in pool.items()}, act.to(d),
            use_kernel=use_kernel and d != "cpu")
    want, _, want_drops = run("cpu")
    runs = [run(dev) for _ in range(8)]
    for lg, _, drops in runs:
        assert torch.equal(lg, runs[0][0])
        assert float(drops) == float(want_drops) > 0
    assert (runs[0][0].cpu() - want).abs().max() <= 1e-4


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_lora_decode_matches_cpu(dev, quant):
    """One fp32 decode dispatch with a LoRA operand mixing the base slot
    0 with two loaded adapters (the engine's per-dispatch gather and
    batched matmuls on the card), through the paged-attention kernel and,
    with ``quant``, int8 weights through the int8 matmul and an int8 KV
    pool: the logits equal the CPU's within 1e-4 and both kernels
    launched. Base rows equal the same call without the operand bit for
    bit."""
    from paddle_tpu_torch.kernels.paged_attention import paged_attention
    from paddle_tpu_torch.kernels.quant_matmul import weight_only_matmul
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.models.llama import (LlamaConfig, _tree_map,
                                               ensure_quantized, init_params)
    from paddle_tpu_torch.models.lora import AdapterPool, lora_init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=3, num_attention_heads=4,
                      num_key_value_heads=2)
    rng = np.random.default_rng(9)
    M, bs, W = 6, 16, 4
    toks = torch.from_numpy(rng.integers(0, 256, M).astype(np.int32))
    lens = torch.tensor([5, 17, 30, 9, 0, 40], dtype=torch.int32)
    act = lens > 0
    tables = torch.arange(1, 1 + M * W, dtype=torch.int32).view(M, W)
    ids = torch.tensor([0, 1, 2, 1, 0, 2], dtype=torch.int32)
    params = ensure_quantized(init_params(cfg, seed=6, device="cpu"),
                              "int8" if quant else None)
    pool = G.init_paged_pool(cfg, 1 + M * W, bs, device="cpu",
                             kv_quant="int8" if quant else None)
    for t in pool.values():
        src = rng.standard_normal(t.shape)
        t.copy_(torch.from_numpy(
            (np.clip(src * 40, -127, 127) if t.dtype == torch.int8
             else np.abs(src) * 0.02
             if t.dim() == 4 else src).astype(np.float32)).to(t.dtype))

    def run(d, lora=True):
        ap = AdapterPool(cfg, 8, 2, 2, device=d)
        for i in (1, 2):
            ap.register(f"a{i}", lora_init_params(cfg, 8, seed=i))
            ap.acquire(f"a{i}")
        return G.paged_decode_step(
            _tree_map(lambda t: t.to(d), params), cfg, toks.to(d),
            lens.to(d), tables.to(d), {k: v.to(d) for k, v in pool.items()},
            act.to(d), use_kernel=d != "cpu",
            lora={"ids": ids.to(d), "layers": ap.layers} if lora else None)[0]
    want = run("cpu")
    paged_attention.launches = weight_only_matmul.launches = 0
    got = run(dev)
    assert paged_attention.launches == cfg.num_hidden_layers
    assert weight_only_matmul.launches == (
        7 * cfg.num_hidden_layers + 1 if quant else 0)
    assert (got.cpu() - want).abs().max() <= 1e-4
    base = run(dev, lora=False)
    for m in (0, 4):
        assert torch.equal(got[m], base[m])
    assert not torch.allclose(got[1], base[1], atol=1e-3)


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16", "int8"])
def test_offload_round_trip_on_card(dev, kv_quant):
    """The host offload tier on the card: a block captured from the device
    pool (strided across layers) into pinned host buffers checksums to
    its device bytes, survives the pool slot's reuse (the copy is ordered
    before the overwrite), and a verified take restores it into another
    pool slot in place — the pool's storage unmoved. A corrupted host
    copy misses."""
    from paddle_tpu_torch.inference.serving.offload import block_crc
    from paddle_tpu_torch.inference.serving.paged_cache import PagedKVCache
    from paddle_tpu_torch.models.llama import LlamaConfig
    cfg = LlamaConfig(vocab_size=64, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=3, num_attention_heads=4,
                      num_key_value_heads=2, dtype=torch.bfloat16)
    cache = PagedKVCache(cfg, 2, 64, 16, num_blocks=8, kv_quant=kv_quant,
                         device=dev, offload=True, offload_blocks=4)
    g = torch.Generator(device=dev).manual_seed(0)
    for t in cache.pool.values():
        t.copy_(torch.randn(t.shape, device=dev, generator=g).mul(40)
                .to(t.dtype))
    ptrs = {n: t.data_ptr() for n, t in cache.pool.items()}
    want = {n: t[:, 3].clone() for n, t in cache.pool.items()}
    cap = cache.read_block(3)
    assert all(b.is_pinned() for b in cap.data.values())
    for t in cache.pool.values():          # the slot is reused at once
        t[:, 3].zero_()
    tier = cache.offload
    toks = tuple(range(16))
    tier.put(11, toks, cap)
    tier.flush()
    for n, w in want.items():
        assert tier._entries[11]["crc"][n] == block_crc(w.cpu())
    data = tier.take(11, toks)
    cache.write_block(5, data)
    torch.cuda.synchronize()
    for n, w in want.items():
        assert torch.equal(cache.pool[n][:, 5], w), n
    assert {n: t.data_ptr() for n, t in cache.pool.items()} == ptrs
    tier.put(12, toks, cache.read_block(5))
    tier.corrupt_one(0)
    assert tier.take(12, toks) is None and tier.corrupt_drops == 1


def test_watchdog_fires_over_a_blocked_synchronize(dev):
    """A hang on the card is the main thread blocked in
    ``torch.cuda.synchronize()`` behind a kernel that does not finish:
    the watchdog thread still runs (the binding releases the GIL) and
    fires while the main thread is blocked, naming the open serving
    section."""
    import time
    from paddle_tpu_torch.health import watchdog
    fired = {}

    def on_hang(diag):
        fired["t"] = time.time()
        fired["diag"] = diag

    wd = watchdog.install(0.3, on_hang=on_hang)
    try:
        torch.cuda.synchronize()
        with watchdog.section("serving.decode"):
            torch.cuda._sleep(int(1.5 * 1.98e9))    # ~1.5 s of spinning
            torch.cuda.synchronize()
            back = time.time()
        assert wd.fired.is_set()
    finally:
        watchdog.uninstall()
    assert fired["t"] < back
    assert "serving.decode" in fired["diag"]


def _migration_engines(dev, kv_quant, n=2):
    from paddle_tpu_torch.inference.serving import ServingConfig, ServingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, init_params
    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, dtype=torch.bfloat16)
    params = init_params(cfg, seed=5, device=dev)
    sc = ServingConfig(block_size=16, max_slots=3, max_model_len=128,
                       kv_quant=kv_quant, quantize=kv_quant)
    first = ServingEngine(params, cfg, sc, device=dev)
    return [first] + [ServingEngine(first.prepared_params, cfg, sc,
                                    device=dev) for _ in range(n - 1)]


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16", "int8"])
def test_serialize_adopt_between_engines_on_card(dev, kv_quant):
    """A request moved mid-decode from one engine's pool to another's on
    the card: the payload is host bytes (bf16 as CPU tensors; int8 K/V
    with their fp32 scales), the adopted blocks are byte-equal to the
    origin's, the adopter recomputes nothing and the stream equals the
    origin's uninterrupted run."""
    a, b, ref = _migration_engines(dev, kv_quant, n=3)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 256, size=70)
    want = ref.run([prompt], max_new_tokens=20, eos_token_id=None)[0]
    rid = a.submit(prompt, max_new_tokens=20, eos_token_id=None)
    got = []
    for _ in range(2):
        got += a.step(4).get(rid, [])
    payload = a.serialize_request(rid)
    kv = payload["kv"]
    assert all(t.device.type == "cpu" for t in kv["data"].values())
    assert set(kv["data"]) == ({"k", "v"} if kv_quant is None else
                               {"k", "v", "k_scale", "v_scale"})
    src_blocks = a._sched.find(rid).blocks[:kv["data_blocks"]]
    nr = b.adopt(payload)
    dst_blocks = b._sched.find(nr).blocks[:kv["data_blocks"]]
    torch.cuda.synchronize()
    for name, pool in a.cache.pool.items():
        for sb, db in zip(src_blocks, dst_blocks):
            assert torch.equal(pool[:, sb].view(torch.uint8),
                               b.cache.pool[name][:, db].view(torch.uint8))
    a.cancel(rid)
    while b.pending:
        got += b.step(4).get(nr, [])
    np.testing.assert_array_equal(np.asarray(got), want)
    assert b.stats()["recomputed_tokens"] == 0
    assert a.stats()["blocks_in_use"] == b.stats()["blocks_in_use"] == 0


def test_graft_bf16_chain_on_card(dev):
    """A cached bf16 chain exported from one engine's pool (pinned host
    buffers, CRC32 over the raw bytes) and grafted into another's lands
    byte-equal and is a prefix hit there; a corrupted export grafts
    nothing."""
    from paddle_tpu_torch.inference.serving.offload import block_crc
    from paddle_tpu_torch.inference.serving.paged_cache import \
        prefix_block_chain
    a, b = _migration_engines(dev, None)
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, 256, size=64).astype(np.int32)
    a.run([np.concatenate([prefix, [7, 8]])], max_new_tokens=4,
          eos_token_id=None)
    chain = list(prefix_block_chain(prefix, 16, 64))
    a._corrupt_next_export = True
    bad = a.export_chain(chain)
    assert b.graft_chain(bad) == {"grafted": 0, "present": 0, "corrupt": 1}
    payload = a.export_chain(chain)
    for blk in payload["blocks"]:
        for n, t in blk["data"].items():
            assert t.is_pinned() and block_crc(t) == blk["crc"][n]
    assert b.graft_chain(payload)["grafted"] == 4
    torch.cuda.synchronize()
    for key, toks in chain:
        sa = a.cache.manager.lookup(key, toks)
        sb = b.cache.manager.lookup(key, toks)
        for name, pool in a.cache.pool.items():
            assert torch.equal(pool[:, sa].view(torch.uint8),
                               b.cache.pool[name][:, sb].view(torch.uint8))
    p = np.concatenate([prefix, [9, 10, 11]]).astype(np.int32)
    want = a.run([p], max_new_tokens=6, eos_token_id=None)[0]
    hit0 = b.stats()["prefix_hit_tokens"]
    got = b.run([p], max_new_tokens=6, eos_token_id=None)[0]
    assert b.stats()["prefix_hit_tokens"] - hit0 == 64
    np.testing.assert_array_equal(got, want)


def test_checkpoint_round_trip_on_card(dev, tmp_path):
    """Cell W's checkpoint stack on card tensors: the AsyncCheckpointer
    snapshot is taken before ``save`` returns (an in-place write right
    after it does not reach the file), restore refills the card tensors
    in place, bf16 bit for bit; ``framework.io.load`` lands on the card
    by default."""
    from paddle_tpu_torch.distributed.checkpoint import AsyncCheckpointer
    from paddle_tpu_torch.framework import io as fio
    g = torch.Generator(device=dev).manual_seed(0)
    st = {"w": torch.randn(256, 64, generator=g, device=dev),
          "h": torch.randn(64, generator=g, device=dev).to(torch.bfloat16),
          "step": torch.tensor(3, dtype=torch.int32, device=dev)}
    want = {k: v.clone() for k, v in st.items()}
    ck = AsyncCheckpointer(str(tmp_path / "ck"), keep_last_k=2)
    ck.save(st, 1)
    st["w"].add_(1.0)                       # the next step, in place
    ck.wait()
    w_obj = st["w"]
    assert ck.restore(st) == 1 and st["w"] is w_obj and st["w"].is_cuda
    for k in want:
        assert torch.equal(st[k], want[k]), k
    fio.save(st, str(tmp_path / "m.pdparams"))
    back = fio.load(str(tmp_path / "m.pdparams"))
    assert all(v.is_cuda for v in back.values())
    assert back["h"].dtype == torch.bfloat16
    assert all(torch.equal(back[k], want[k]) for k in want)


def test_prefetch_to_device_on_card(dev):
    """Pinned, non-blocking copies on a side stream; the consumer stream
    waits on each batch's event, so the values are right without a
    synchronize in between."""
    from paddle_tpu_torch.io import DataLoader, Dataset, prefetch_to_device
    from paddle_tpu_torch.testing import chaos

    class Rows(Dataset):
        def __len__(self):
            return 64

        def __getitem__(self, i):
            return np.full((4096,), i, np.int32)

    loader = DataLoader(Rows(), batch_size=8, num_workers=2, timeout=60)
    sums = []
    for b in prefetch_to_device(loader, size=2):
        assert b.is_cuda and b.dtype == torch.int32
        sums.append(b.to(torch.int64).sum())
    got = torch.stack(sums).cpu().tolist()
    assert got == [4096 * sum(range(8 * j, 8 * j + 8)) for j in range(8)]
    x = torch.ones(4, 4, device=dev)
    p = chaos.nan_payload(x, frac=0.5, seed=2)
    assert p.is_cuda and int(torch.isnan(p).sum()) == 8
    assert not torch.isnan(x).any()


# -- the eager tier's kernel callers (paddle_tpu_torch.nn / incubate / ops) --

def _counts():
    from paddle_tpu_torch.kernels.flash_attention import flash_attention
    from paddle_tpu_torch.kernels.quant_matmul import weight_only_matmul
    from paddle_tpu_torch.kernels.rms_norm import rms_norm
    from paddle_tpu_torch.kernels.rope import apply_rope
    return {"flash": (flash_attention.launches,
                      flash_attention.launches_bwd_dq,
                      flash_attention.launches_bwd_dkv),
            "rms_norm": (rms_norm.launches, rms_norm.launches_bwd),
            "rope": (apply_rope.launches, apply_rope.launches_bwd),
            "matmul": (weight_only_matmul.launches,)}


def _risen(before, after):
    return {k: tuple(b - a for a, b in zip(before[k], after[k]))
            for k in after if after[k] != before[k]}


@pytest.fixture
def paddle_gpu(dev):
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu:0")
    return paddle


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("causal", [True, False])
def test_eager_sdpa_takes_flash(paddle_gpu, causal):
    paddle = paddle_gpu
    from paddle_tpu_torch.nn.functional.attention import _sdpa_ref
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((2, 256, 4, 128), generator=g,
                               device="cuda").bfloat16() for _ in range(4))
    ts = [paddle.to_tensor(t, stop_gradient=False) for t in (q, k, v)]
    before = _counts()
    out = paddle.nn.functional.scaled_dot_product_attention(
        *ts, is_causal=causal)
    out.backward(paddle.to_tensor(do))
    torch.cuda.synchronize()
    assert _risen(before, _counts()) == {"flash": (1, 1, 1)}
    fs = [t.float().requires_grad_(True) for t in (q, k, v)]
    ref = _sdpa_ref(*fs, causal=causal)
    grads = torch.autograd.grad(ref, fs, do.float())
    for got, want in zip([out._value] + [t.grad._value for t in ts],
                         [ref, *grads]):
        assert _rel(got, want) <= 1e-2


def test_eager_sdpa_with_mask_takes_the_plain_path(paddle_gpu):
    paddle = paddle_gpu
    q = paddle.to_tensor(torch.randn(1, 128, 2, 128, device="cuda"))
    mask = paddle.to_tensor(torch.ones(128, 128, dtype=torch.bool,
                                       device="cuda").tril()[None, None])
    before = _counts()
    a = paddle.nn.functional.scaled_dot_product_attention(q, q, q,
                                                          attn_mask=mask)
    assert _risen(before, _counts()) == {}
    b = paddle.nn.functional.scaled_dot_product_attention(q, q, q,
                                                          is_causal=True)
    assert _rel(a._value, b._value) <= 1e-5


def test_eager_rms_norm_callers_take_the_kernel(paddle_gpu):
    paddle = paddle_gpu
    from paddle_tpu_torch.kernels.rms_norm import (rms_norm_bwd_plain,
                                                   rms_norm_fwd_plain)
    import paddle_tpu_torch.incubate.nn.functional as IF
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((64, 2048), generator=g, device="cuda").bfloat16()
    w = 1 + 0.1 * torch.randn(2048, generator=g, device="cuda")
    go = torch.randn((64, 2048), generator=g, device="cuda").bfloat16()
    ref, rstd = rms_norm_fwd_plain(x, w, 1e-6)
    rdx, rdw = rms_norm_bwd_plain(x, w, rstd, go)
    layer = paddle.nn.RMSNorm(2048)
    layer.weight.set_value(w)
    for name in ("F", "layer", "fused"):
        xt = paddle.to_tensor(x, stop_gradient=False)
        wt = layer.weight if name == "layer" else \
            paddle.to_tensor(w, stop_gradient=False)
        before = _counts()
        out = {"F": lambda: paddle.nn.functional.rms_norm(xt, wt),
               "layer": lambda: layer(xt),
               "fused": lambda: IF.fused_rms_norm(xt, wt)}[name]()
        out.backward(paddle.to_tensor(go))
        torch.cuda.synchronize()
        assert _risen(before, _counts()) == {"rms_norm": (1, 1)}, name
        for got, want in ((out._value, ref), (xt.grad._value, rdx)):
            step = 2.0 ** -7 * want.float().abs().clamp(min=1e-3)
            assert ((got.float() - want.float()).abs() <= step).all(), name
        assert torch.allclose(wt.grad._value, rdw, rtol=0,
                              atol=1e-4 * rdw.abs().max().item()), name


def test_eager_fused_rope_takes_the_kernel(paddle_gpu):
    paddle = paddle_gpu
    from paddle_tpu_torch.kernels.rope import apply_rope_plain, rope_cos_sin
    import paddle_tpu_torch.incubate.nn.functional as IF
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, gq, gk = (torch.randn((2, 128, 4, 64), generator=g,
                                device="cuda").bfloat16() for _ in range(4))
    cos, sin = rope_cos_sin(128, 64, 10000.0, device="cuda")
    qt, kt = (paddle.to_tensor(t, stop_gradient=False) for t in (q, k))
    before = _counts()
    oq, ok, _ = IF.fused_rotary_position_embedding(qt, kt)
    dq, dk = paddle.grad([oq, ok], [qt, kt],
                         [paddle.to_tensor(gq), paddle.to_tensor(gk)])
    torch.cuda.synchronize()
    assert _risen(before, _counts()) == {"rope": (2, 2)}
    for got, want in ((oq, apply_rope_plain(q, cos, sin)),
                      (ok, apply_rope_plain(k, cos, sin)),
                      (dq, apply_rope_plain(gq, cos, -sin)),
                      (dk, apply_rope_plain(gk, cos, -sin))):
        step = 2.0 ** -7 * want.float().abs().clamp(min=1e-3)
        assert ((got._value.float() - want.float()).abs() <= step).all()


@pytest.mark.parametrize("M", [8, 256])
def test_eager_weight_only_linear_takes_the_kernel(paddle_gpu, M):
    paddle = paddle_gpu
    from paddle_tpu_torch.kernels.quant_matmul import (
        quantize_weights, weight_only_matmul_plain)
    g = torch.Generator(device="cuda").manual_seed(3)
    wq, sc = quantize_weights(torch.randn((512, 384), generator=g,
                                          device="cuda"))
    x = torch.randn((M, 512), generator=g, device="cuda").bfloat16()
    do = torch.randn((M, 384), generator=g, device="cuda").bfloat16()
    xt = paddle.to_tensor(x, stop_gradient=False)
    st = paddle.to_tensor(sc, stop_gradient=False)
    before = _counts()
    out = paddle.weight_only_linear(xt, paddle.to_tensor(wq), st)
    out.backward(paddle.to_tensor(do))
    torch.cuda.synchronize()
    assert _risen(before, _counts()) == {"matmul": (1,)}
    xr, sr = x.clone().requires_grad_(True), sc.clone().requires_grad_(True)
    ref = weight_only_matmul_plain(xr, wq, sr, torch.bfloat16)
    gx, gs = torch.autograd.grad(ref, (xr, sr), do)
    for got, want in ((out._value, ref), (xt.grad._value, gx),
                      (st.grad._value, gs)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 1e-2 * want.float().abs().max().item()


def test_eager_llama_step_matches_functional(paddle_gpu):
    """A small LlamaForCausalLM with the kernels: the eager loss and
    every gradient against the functional loss_fn at fp32."""
    paddle = paddle_gpu
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               LlamaForCausalLM,
                                               _sorted_leaves, _unflatten,
                                               loss_fn)
    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=2, use_kernels=True,
                      use_fused_norm=True, remat=True)
    net = LlamaForCausalLM(cfg, seed=0)
    flat = _sorted_leaves(net.params_pytree())
    leaves = [t.detach().clone().requires_grad_(True) for _, t in flat]
    ids = torch.randint(0, 256, (2, 128), device="cuda")
    ref = loss_fn(_unflatten([p for p, _ in flat], leaves), ids, ids, cfg)
    grads = torch.autograd.grad(ref, leaves)
    before = _counts()
    loss = net(paddle.to_tensor(ids), paddle.to_tensor(ids))
    loss.backward()
    risen = _risen(before, _counts())
    assert risen["flash"] == (4, 2, 2) and risen["rms_norm"] == (9, 5)
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())
    for p, g in zip(net.parameters(), grads):
        assert (p.grad._value - g).abs().max() <= 1e-4 * g.abs().max()


# -- the eager hybrid-parallel decoder (chip_smoke.py phase 46) at mp 2 ----

def _megatron():
    """``chip_smoke.megatron()``: phase 46's decoder from the public
    layers."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke.megatron()


def _mp2_decoder(paddle, cfg, dev, parallel=True):
    from paddle_tpu_torch.distributed import fleet
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 1, "mp_degree": 2 if parallel else 1}
    fleet.init(is_collective=True, strategy=st,
               devices=[dev] * (2 if parallel else 1))
    return _megatron().Llama(cfg, parallel=parallel, use_recompute=False)


def test_megatron_mp2_takes_the_kernels_and_matches_plain(paddle_gpu):
    """The decoder at mp 2 over cuda:0 x 2, fp32: each mp shard's attention
    core launches the flash and RoPE kernels on its heads, every RMSNorm
    the norm kernel; the loss within 1e-5 x |loss| and every gradient
    within 1e-4 x max|g| of the serial twin on the plain path (the CPU)."""
    paddle = paddle_gpu
    from paddle_tpu_torch.distributed.topology import \
        set_hybrid_communicate_group
    from paddle_tpu_torch.models.llama import LlamaConfig, init_params
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=4)
    sd = _megatron().state_dict(init_params(cfg, seed=4, device="cpu"))
    ids = np.random.default_rng(0).integers(0, 512, (2, 128))
    try:
        net = _mp2_decoder(paddle, cfg, "cuda:0")
        net.set_state_dict(sd)
        x = paddle.to_tensor(torch.from_numpy(ids).cuda())
        before = _counts()
        loss = net(x, x)
        loss.backward()
        torch.cuda.synchronize()
        risen = _risen(before, _counts())
        grads = {k: p.grad.numpy() for k, p in net.named_parameters()}
        # per layer: 2 shards x (q, k) RoPE, 2 flash calls; 2 norms a layer
        # and the final one
        assert risen == {"flash": (4, 4, 4), "rope": (8, 8),
                         "rms_norm": (5, 5)}, risen
        paddle.set_device("cpu")
        ser = _mp2_decoder(paddle, cfg, "cpu", parallel=False)
        ser.set_state_dict(sd)
        xc = paddle.to_tensor(ids)
        ref = ser(xc, xc)
        ref.backward()
    finally:
        paddle.set_device("gpu:0")
        set_hybrid_communicate_group(None)
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())
    for k, p in ser.named_parameters():
        want = p.grad.numpy()
        assert np.abs(grads[k] - want).max() <= 1e-4 * np.abs(want).max(), k


def test_megatron_mp2_attention_core_bf16(paddle_gpu):
    """The region's attention core in bf16 at mp 2 (RoPE then causal
    flash on each shard's heads) against the plain RoPE and attention in
    fp32 on the whole heads: output and the q/k/v gradients within 1e-2
    norm-relative (phase 7's rule)."""
    paddle = paddle_gpu
    from paddle_tpu_torch.distributed import PartitionSpec as P, shard_map
    from paddle_tpu_torch.distributed.topology import Mesh
    from paddle_tpu_torch.kernels.rope import apply_rope_plain, rope_cos_sin
    from paddle_tpu_torch.nn.functional.attention import _sdpa_ref
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((2, 256, 4, 128), generator=g,
                               device="cuda").bfloat16() for _ in range(4))
    devs = np.empty(2, dtype=object)
    devs[:] = [torch.device("cuda", 0)] * 2
    mesh = Mesh(devs, ("mp",))
    spec = P(None, None, "mp", None)
    ts = [paddle.to_tensor(t, stop_gradient=False) for t in (q, k, v)]
    before = _counts()
    core = _megatron().attention_core
    out = shard_map(lambda a, b, c: core(a, b, c, 10000.0), mesh,
                    (spec, spec, spec), spec)(*ts)
    out.backward(paddle.to_tensor(do))
    torch.cuda.synchronize()
    assert _risen(before, _counts()) == {"flash": (2, 2, 2),
                                         "rope": (4, 4)}
    cos, sin = rope_cos_sin(256, 128, 10000.0, device="cuda")
    fs = [t.float().requires_grad_(True) for t in (q, k, v)]
    ref = _sdpa_ref(apply_rope_plain(fs[0], cos, sin),
                    apply_rope_plain(fs[1], cos, sin), fs[2], causal=True)
    grads = torch.autograd.grad(ref, fs, do.float())
    for got, want in zip([out._value] + [t.grad._value for t in ts],
                         [ref, *grads]):
        assert _rel(got, want) <= 1e-2


# -- the captured step (jit) -------------------------------------------------

def _bn_net(paddle):
    nn = paddle.nn
    return nn.Sequential(nn.Linear(12, 8), nn.BatchNorm1D(8), nn.ReLU(),
                         nn.Linear(8, 4))


def test_captured_step_replays_equal_eager(paddle_gpu):
    """A Linear + BatchNorm1D + Adam step captured into a CUDA graph and
    replayed against the eager step from the same weights: every loss and
    every state entry within 1e-5, exactly one graph a replay."""
    paddle = paddle_gpu
    paddle.seed(7)
    eager, fused = _bn_net(paddle), _bn_net(paddle)
    fused.set_state_dict({k: v.numpy() for k, v in eager.state_dict().items()})
    loss_fn = paddle.nn.CrossEntropyLoss()
    o1 = paddle.optimizer.Adam(0.01, parameters=eager.parameters())
    o2 = paddle.optimizer.Adam(0.01, parameters=fused.parameters())
    step = paddle.jit.make_train_step(fused, o2, loss_fn)
    assert step.donate is True
    rng = np.random.default_rng(7)
    for _ in range(5):
        x = paddle.to_tensor(rng.standard_normal((4, 12)).astype("float32"))
        y = paddle.to_tensor(rng.integers(0, 4, (4,)).astype("int64"))
        eager.train()
        loss = loss_fn(eager(x), y)
        loss.backward()
        o1.step()
        o1.clear_grad()
        np.testing.assert_allclose(float(step(x, y)), float(loss), rtol=1e-5)
    (prog,) = step._sf._programs.values()
    assert len(prog._steps) == 1 and prog.cuda
    s1, s2 = eager.state_dict(), fused.state_dict()
    for k in s1:
        np.testing.assert_allclose(s2[k].numpy(), s1[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_captured_dropout_and_scheduler(paddle_gpu):
    """Fresh dropout masks on every replay, and a scheduler's lr reaching
    the replays (the update shrinks with it)."""
    paddle = paddle_gpu
    drop = paddle.nn.Dropout(0.5)
    f = paddle.jit.to_static(lambda x: drop(x))
    x = paddle.to_tensor(np.ones((4, 256), np.float32))
    f(x)
    a, b = f(x).numpy(), f(x).numpy()
    assert (a != b).any()
    model = paddle.nn.Linear(4, 1)
    sched = paddle.optimizer.lr.StepDecay(0.5, step_size=1, gamma=0.1)
    opt = paddle.optimizer.SGD(sched, parameters=model.parameters())

    @paddle.jit.to_static
    def train(x):
        loss = model(x).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    x = paddle.to_tensor(np.ones((2, 4), np.float32))
    train(x)
    w0 = model.weight.numpy().copy()
    train(x)
    d1 = np.abs(model.weight.numpy() - w0).max()
    sched.step()
    w0 = model.weight.numpy().copy()
    train(x)
    d2 = np.abs(model.weight.numpy() - w0).max()
    np.testing.assert_allclose(d2, d1 * 0.1, rtol=1e-5)
