"""The port's paged attention (``paddle_tpu_torch.kernels.paged_attention``)
against the JAX package's Pallas kernel (``paddle_tpu.kernels.
paged_attention``, run in interpret mode on the CPU as tests/test_kernels.py
runs it). On CPU tensors the port's wrapper runs its plain PyTorch version;
the CUDA kernel is held to that plain version on the card
(tests/test_torch_cuda_kernels.py).

The CUDA kernel's split over KV (flash-decoding) is held to JAX through
its plain emulation ``paged_attention_split_plain``, with the same
tolerances.

Inputs come from numpy with a seed. Tolerances: fp32 pools rtol = atol =
3e-5 (the JAX suite's own kernel-vs-gather tolerance: both reduce in fp32,
in different orders); int8 pools atol 1e-4 (the same int8 values and
scales dequantize identically, the fp32 reductions differ in order).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.paged_attention import paged_attention as jax_pa
from paddle_tpu.models.generation import _kv_quantize as jax_quantize
from paddle_tpu_torch.kernels.paged_attention import paged_attention

# the module (the package's ``paged_attention`` is the function)
PA = importlib.import_module("paddle_tpu_torch.kernels.paged_attention")

torch.set_num_threads(2)


def _case(seed, multi, quant, poison, G, bs):
    """Numpy inputs for GQA group ``G`` and block size ``bs``: seq lengths
    pinned at block boundaries +-1, tables whose unused tail entries point
    at the null block, optional NaN in every free block."""
    rng = np.random.default_rng(seed)
    Hk = int(rng.choice([1, 2]))
    D = int(rng.choice([8, 16]))
    M = int(rng.integers(1, 4))
    W = int(rng.integers(2, 5))
    Q = int(rng.choice([2, 4, 5])) if multi else 1
    N = M * W + 3
    q = rng.standard_normal((M, Q, Hk * G, D) if multi else (M, Hk * G, D))
    kf = rng.standard_normal((N, bs, Hk, D)).astype(np.float32)
    vf = rng.standard_normal((N, bs, Hk, D)).astype(np.float32)
    cap = W * bs - Q
    picks = [bs - 1, bs, bs + 1, int(rng.integers(0, cap + 1))]
    sl = np.array([min(cap, picks[int(rng.integers(0, 4))])
                   for _ in range(M)], np.int32)
    dl = rng.integers(0, Q, size=M).astype(np.int32) if multi else None
    used = rng.choice(np.arange(1, N), size=(M, W), replace=False)
    tbl = np.zeros((M, W), np.int32)
    for m in range(M):
        nb = (int(sl[m]) + (int(dl[m]) if multi else 0)) // bs + 1
        tbl[m, :nb] = used[m, :nb]
    free = sorted(set(range(1, N)) - set(tbl.reshape(-1).tolist()))
    if quant:
        kq, ks = (np.array(a) for a in jax_quantize(jnp.asarray(kf)))
        vq, vs = (np.array(a) for a in jax_quantize(jnp.asarray(vf)))
        if poison:
            ks[free] = np.nan
            vs[free] = np.nan
        pool = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        if poison:
            kf[free] = np.nan
            vf[free] = np.nan
        pool = {"k": kf, "v": vf}
    return q.astype(np.float32), pool, tbl, sl, dl


def _run_jax(q, pool, tbl, sl, dl):
    kw = {"draft_lens": jnp.asarray(dl)} if dl is not None else {}
    if "k_scale" in pool:
        kw.update(k_scale=jnp.asarray(pool["k_scale"]),
                  v_scale=jnp.asarray(pool["v_scale"]))
    return np.asarray(jax_pa(jnp.asarray(q), jnp.asarray(pool["k"]),
                             jnp.asarray(pool["v"]), jnp.asarray(tbl),
                             jnp.asarray(sl), **kw))


def _run_port(q, pool, tbl, sl, dl):
    t = torch.from_numpy
    kw = {"draft_lens": t(dl)} if dl is not None else {}
    if "k_scale" in pool:
        kw.update(k_scale=t(pool["k_scale"]), v_scale=t(pool["v_scale"]))
    return paged_attention(t(q), t(pool["k"]), t(pool["v"]), t(tbl), t(sl),
                           **kw).numpy()


def _assert_close(out, want, quant):
    assert out.dtype == want.dtype == np.float32
    assert np.isfinite(out).all()
    if quant:
        np.testing.assert_allclose(out, want, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(out, want, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("multi", [False, True], ids=["decode", "multiquery"])
@pytest.mark.parametrize("bs", [4, 8, 16])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_matches_jax_kernel(G, bs, multi, quant):
    args = _case(1000 + 10 * G + bs, multi, quant, poison=False, G=G, bs=bs)
    _assert_close(_run_port(*args), _run_jax(*args), quant)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("multi", [False, True], ids=["decode", "multiquery"])
def test_poisoned_free_blocks_contained(multi, quant):
    """NaN in every free block: outputs stay finite, match JAX, and equal
    the unpoisoned run bit for bit (V is zeroed, not zero-weighted)."""
    seed = 2000 + 2 * multi + quant
    args = _case(seed, multi, quant, poison=True, G=2, bs=8)
    out = _run_port(*args)
    _assert_close(out, _run_jax(*args), quant)
    clean = _run_port(*_case(seed, multi, quant, poison=False, G=2, bs=8))
    np.testing.assert_array_equal(out, clean)


def test_stale_tail_inside_owned_blocks_ignored():
    """NaN past each row's seq_len inside its own blocks (a reused block's
    stale tail) leaves the output unchanged."""
    rng = np.random.default_rng(7)
    M, H, Hk, D, bs, W, N = 2, 4, 2, 8, 4, 3, 8
    q = torch.from_numpy(rng.standard_normal((M, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((N, bs, Hk, D)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((N, bs, Hk, D)).astype(
        np.float32))
    tbl = torch.tensor([[1, 2, 0], [3, 4, 5]], dtype=torch.int32)
    sl = torch.tensor([5, 9], dtype=torch.int32)
    base = paged_attention(q, k, v, tbl, sl)
    k2, v2 = k.clone(), v.clone()
    for blocks, s in (([1, 2], 5), ([3, 4, 5], 9)):
        for i, b in enumerate(blocks):
            for off in range(bs):
                if i * bs + off > s:
                    k2[b, off] = float("nan")
                    v2[b, off] = float("nan")
    assert torch.equal(paged_attention(q, k2, v2, tbl, sl), base)


def test_entry_point_errors():
    q3 = torch.zeros((1, 2, 8))
    q4 = torch.zeros((1, 2, 2, 8))
    pool = torch.zeros((3, 4, 1, 8))
    tbl = torch.zeros((1, 2), dtype=torch.int32)
    sl = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="draft_lens"):
        paged_attention(q4, pool, pool, tbl, sl)
    with pytest.raises(ValueError, match="single-token"):
        paged_attention(q3, pool, pool, tbl, sl, draft_lens=sl)


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("quant,poison", [(False, False), (False, True),
                                          (True, True)],
                         ids=["fp32", "fp32-poison", "int8-poison"])
@pytest.mark.parametrize("multi", [False, True], ids=["decode", "multiquery"])
def test_split_emulation_vs_jax_kernel(multi, quant, poison, splits):
    """The split route's arithmetic (per-split m, l and value sums merged in
    split order) against the JAX kernel. 4-key tiles make several splits
    of these short windows; later splits of a short window hold no key of
    it, and slot 0's empty window (seq_len -1) has l == 0: output 0. NaN
    in every free block stays out. Tolerances as above."""
    seed = 3000 + 10 * splits + 4 * multi + 2 * quant + poison
    q, pool, tbl, sl, dl = _case(seed, multi, quant, poison, G=2, bs=4)
    sl = sl.copy()
    sl[0] = -1
    if dl is not None:
        dl = dl.copy()
        dl[0] = 0
    want = _run_jax(q, pool, tbl, sl, dl)
    t = torch.from_numpy
    kw = {"draft_lens": t(dl)} if dl is not None else {}
    if quant:
        kw.update(k_scale=t(pool["k_scale"]), v_scale=t(pool["v_scale"]))
    got = PA.paged_attention_split_plain(
        t(q), t(pool["k"]), t(pool["v"]), t(tbl), t(sl), splits=splits,
        tile=4, **kw).numpy()
    assert np.all(got[0] == 0)
    _assert_close(got, want, quant)


@pytest.mark.parametrize("M,QG,Hk,C", [(8, 1, 16, 2048), (8, 4, 8, 2048),
                                       (8, 8, 16, 2048), (8, 15, 16, 64),
                                       (8, 16, 16, 2048), (8, 256, 16, 2048)])
def test_plan_routes(M, QG, Hk, C):
    """Q * G < 16 takes the split route with spans of whole 64-key tiles
    covering the capacity once, and at the serving path's decode shape
    (8 slots, 16 kv heads, 2048 keys) at least 2 blocks per SM of a
    132-SM H100; Q * G >= 16 takes the 64-row tiles; fp32 the FMA
    kernel."""
    route, splits, span = PA._plan(M, QG, Hk, C, True, 132)
    if QG >= 16:
        assert (route, splits) == (PA.MULTI_QUERY, 1)
    else:
        assert route == PA.SPLIT and span % 64 == 0
        assert (splits - 1) * span < C <= splits * span
        if C >= 2048:
            assert splits * Hk * M >= 2 * 132
    assert PA._plan(M, QG, Hk, C, False, 132)[0] == PA.FMA
