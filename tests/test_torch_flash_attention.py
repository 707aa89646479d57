"""The port's flash attention (``paddle_tpu_torch.kernels.flash_attention``)
against the JAX package's (``paddle_tpu.kernels.flash_attention``, its
Pallas kernels run in interpret mode on the CPU as tests/test_kernels.py
runs them, with ``block_q = block_k = 8``). On CPU tensors the port's
autograd Function runs its plain forward and its explicit plain backward
(``p`` recomputed from the saved ``lse``); the CUDA kernels are held to
those plain versions on the card (tests/test_torch_cuda_kernels.py).

Inputs, and the output cotangent, come from numpy with a seed. Both sides
reduce in fp32 in different orders, so at fp32: out and lse atol = rtol =
1e-5, dq / dk / dv atol 1e-4 (the fully masked rows' lse is -1e30 on both
sides). The bf16 case checks dtypes (out and dq bf16, dk / dv the input
dtype, lse fp32) and values at 3e-2: both round every output to bf16 once,
after fp32 arithmetic in different orders.

The CPU emulations of the bf16 kernels' tilings (``flash_attention_fwd_tiled``,
``flash_attention_bwd_dq_tiled``, ``flash_attention_bwd_dkv_tiled``: the
producers' tile sequences with the causal limit and the segment skip,
online softmax per key tile, dq scaled once at the end) are held to the JAX
kernels at fp32, atol = rtol = 1e-5, on dense rows, ragged lengths, GQA,
causal Sq < Sk, packed segments cut inside and on tile edges, and query
segments with no key: at fp32 the emulations round nothing the JAX kernels
keep, so the two differ only by the order of fp32 sums (and dq by where the
scale multiplies, ~1e-7 relative), far inside 1e-5.

The lse's cotangent (which ring attention's merge produces and the JAX
kernel's VJP drops) is held to JAX's autodiff of its plain attention at
dq / dk / dv atol 1e-4, through the Function and the tiled emulations.
"""

import importlib


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.flash_attention import \
    flash_attention_with_lse as jax_flash
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd_dkv_tiled,
    flash_attention_bwd_dq_tiled, flash_attention_bwd_plain,
    flash_attention_fwd_plain, flash_attention_fwd_tiled,
    flash_attention_with_lse)

torch.set_num_threads(2)


def _inputs(seed, B, Sq, Sk, H, Hk, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, Sq, H, D), (B, Sk, Hk, D), (B, Sk, Hk, D),
                          (B, Sq, H, D))]


def _run_both(q, k, v, do, causal, seg=None, kv_seg=None, dtype=np.float32):
    """(jax (out, lse, dq, dk, dv), port (...)) as fp32 numpy arrays."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32

    def f(q, k, v):
        o, lse = jax_flash(q, k, v, causal=causal, block_q=8, block_k=8,
                           segment_ids=seg, kv_segment_ids=kv_seg)
        return (o.astype(jnp.float32) * do).sum(), (o, lse)

    (_, (o, lse)), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                              has_aux=True)(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    ref = [np.asarray(x.astype(jnp.float32)) for x in (o, lse, *grads)]

    tq, tk, tv = (torch.tensor(a).to(tdt).requires_grad_(True)
                  for a in (q, k, v))
    to, tlse = flash_attention_with_lse(
        tq, tk, tv, causal=causal,
        segment_ids=None if seg is None else torch.tensor(seg),
        kv_segment_ids=None if kv_seg is None else torch.tensor(kv_seg))
    (to.float() * torch.from_numpy(do)).sum().backward()
    outs = (to, tlse, tq.grad, tk.grad, tv.grad)
    return ref, outs


def _check(ref, outs, tol_out=1e-5, tol_grad=1e-4):
    o, lse, dq, dk, dv = (t.detach().float().numpy() for t in outs)
    np.testing.assert_allclose(o, ref[0], atol=tol_out, rtol=tol_out)
    np.testing.assert_allclose(lse, ref[1], atol=tol_out, rtol=tol_out)
    for got, want in zip((dq, dk, dv), ref[2:]):
        np.testing.assert_allclose(got, want, atol=tol_grad, rtol=tol_out)


# (H, Hk) x (Sq, Sk): every pair once; causal alternates (so each head
# layout and each length pair meets both modes), head_dim per head layout
_GRID = [(hh, ss) for hh in ((4, 4), (4, 2), (8, 2))
         for ss in ((16, 16), (32, 32), (16, 32))]
CASES = [(n % 2 == 0, hh, ss, (8, 16)[n // 3 % 2])
         for n, (hh, ss) in enumerate(_GRID)]


@pytest.mark.parametrize("causal,heads,lens,D", CASES)
def test_dense_matches_jax(causal, heads, lens, D):
    (H, Hk), (Sq, Sk) = heads, lens
    q, k, v, do = _inputs(Sq + Sk + H + Hk + D, 2, Sq, Sk, H, Hk, D)
    _check(*_run_both(q, k, v, do, causal))


def _packed(rng, B, S, n_segs):
    """Non-decreasing segment ids, ``n_segs`` segments per row."""
    rows = []
    for _ in range(B):
        cuts = np.sort(rng.choice(np.arange(1, S), n_segs - 1,
                                  replace=False))
        rows.append(np.searchsorted(cuts, np.arange(S), side="right"))
    return np.asarray(rows, np.int32)


@pytest.mark.parametrize("causal,H,Hk,S,n_segs", [(True, 4, 2, 32, 3),
                                                  (False, 8, 2, 16, 2)])
def test_packed_segments_match_jax(causal, H, Hk, S, n_segs):
    q, k, v, do = _inputs(S * n_segs, 2, S, S, H, Hk, 16)
    seg = _packed(np.random.default_rng(n_segs), 2, S, n_segs)
    _check(*_run_both(q, k, v, do, causal, seg=seg))


def test_cross_segments_with_fully_masked_rows():
    # Sq != Sk with kv_segment_ids given; query segment 7 has no key
    q, k, v, do = _inputs(5, 2, 16, 32, 4, 2, 8)
    seg = np.array([[0] * 6 + [1] * 6 + [7] * 4,
                    [0] * 3 + [7] * 5 + [1] * 8], np.int32)
    kv_seg = np.array([[0] * 16 + [1] * 16, [0] * 10 + [1] * 22], np.int32)
    ref, outs = _run_both(q, k, v, do, True, seg=seg, kv_seg=kv_seg)
    _check(ref, outs)
    masked = seg == 7
    assert masked.sum() == 9
    o, lse = outs[0].detach().numpy(), outs[1].detach().numpy()
    assert (o[masked] == 0).all()
    assert (lse.transpose(0, 2, 1)[masked] == np.float32(-1e30)).all()
    assert (outs[2].numpy()[masked] == 0).all()


def test_bf16_dtypes_and_values():
    q, k, v, do = _inputs(11, 2, 32, 32, 4, 2, 16)
    seg = _packed(np.random.default_rng(3), 2, 32, 2)
    ref, outs = _run_both(q, k, v, do, True, seg=seg, dtype="bf16")
    o, lse, dq, dk, dv = outs
    assert o.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert lse.dtype == torch.float32
    _check(ref, outs, tol_out=3e-2, tol_grad=3e-2)


def test_plain_backward_is_the_functions_backward():
    # the CPU Function's gradient is flash_attention_bwd_plain on the saved
    # forward: same numbers as calling it by hand
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 1, 16, 16, 4, 2,
                                                         8))
    out, lse = flash_attention_fwd_plain(q, k, v, None, None, 0.3, True)
    want = flash_attention_bwd_plain(q, k, v, None, None, out, lse, do, 0.3,
                                     True)
    tq, tk, tv = (t.clone().requires_grad_(True) for t in (q, k, v))
    got_out = flash_attention(tq, tk, tv, causal=True, scale=0.3)
    (got_out * do).sum().backward()
    assert torch.equal(got_out, out)
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert torch.equal(g, w)


def test_cpu_path_launches_no_kernel():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(3, 1, 8, 8, 2, 2, 8))
    counts = (flash_attention.launches, flash_attention.launches_bwd_dq,
              flash_attention.launches_bwd_dkv)
    tq = q.clone().requires_grad_(True)
    (flash_attention(tq, k, v, causal=True) * do).sum().backward()
    assert (flash_attention.launches, flash_attention.launches_bwd_dq,
            flash_attention.launches_bwd_dkv) == counts


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("Sq,Sk,kw", [
    (16, 16, dict(block_q=5)),                                   # blocks
    (32, 16, dict(causal=True)),                                 # Sq > Sk
    (16, 32, dict(segment_ids=np.zeros((1, 16), np.int32))),     # kv segs
])
def test_errors_match_jax(Sq, Sk, kw):
    q, k, v, _ = _inputs(1, 1, Sq, Sk, 2, 2, 8)
    want = _message(lambda: jax_flash(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kw))
    tkw = {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    got = _message(lambda: flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        **tkw))
    assert got == want


def _segs(lens_per_row, ids_per_row=None):
    """[B, S] int32 ids: row b has segments of the given lengths."""
    rows = []
    for n, lens in enumerate(lens_per_row):
        ids = ids_per_row[n] if ids_per_row else range(len(lens))
        rows.append(np.repeat(np.asarray(list(ids)), lens))
    return np.asarray(rows, np.int32)


# tiles: forward and dq 128 query rows x 128 keys, dk/dv 64 keys x 64 query
# rows
TILED_CASES = {
    # ragged lengths (no multiple of either tile), GQA, causal Sq < Sk
    "ragged-gqa": dict(B=2, Sq=200, Sk=333, H=4, Hk=2, causal=True),
    # packed, cuts on tile edges (128, 256, 320) and inside (200, 300)
    "packed-edges": dict(B=2, Sq=384, Sk=384, H=4, Hk=2, causal=True,
                         seg=_segs([[128, 72, 120, 64], [64, 192, 44, 84]])),
    # query segment 7 has no key; key blocks whose ids meet no query tile
    "no-visible-key": dict(B=2, Sq=192, Sk=320, H=4, Hk=4, causal=False,
                           seg=_segs([[64, 64, 64], [100, 92]],
                                     [[0, 7, 1], [1, 7]]),
                           kv_seg=_segs([[100, 220], [320]], [[0, 1], [1]])),
    # dense: whole tiles, every key of every row visible
    "dense": dict(B=2, Sq=256, Sk=256, H=2, Hk=2, causal=False),
}


@pytest.mark.parametrize("name", list(TILED_CASES))
def test_tiled_emulations_match_jax(name):
    c = dict(TILED_CASES[name])
    seg, kv_seg = c.pop("seg", None), c.pop("kv_seg", None)
    B, Sq, Sk, H, Hk, causal = (c[n] for n in ("B", "Sq", "Sk", "H", "Hk",
                                                "causal"))
    q, k, v, do = _inputs(Sq + Sk, B, Sq, Sk, H, Hk, 16)

    def f(q, k, v):
        o, lse = jax_flash(q, k, v, causal=causal, block_q=Sq, block_k=Sk,
                           segment_ids=seg, kv_segment_ids=kv_seg)
        return (o * do).sum(), (o, lse)

    (_, (o, lse)), (dq, dk, dv) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (q, k, v)))

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    sq = None if seg is None else torch.from_numpy(seg)
    sk = sq if kv_seg is None else torch.from_numpy(kv_seg)
    scale = 1.0 / 4.0
    got_o, got_lse = flash_attention_fwd_tiled(tq, tk, tv, sq, sk, scale,
                                               causal)
    got_dq = flash_attention_bwd_dq_tiled(tq, tk, tv, sq, sk, got_o,
                                          got_lse, tdo, scale, causal)
    got_dk, got_dv = flash_attention_bwd_dkv_tiled(
        tq, tk, tv, sq, sk, got_o, got_lse, tdo, scale, causal)
    for got, want in ((got_o, o), (got_lse, lse), (got_dq, dq),
                      (got_dk, dk), (got_dv, dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    if name == "no-visible-key":
        masked = seg == 7
        assert (got_o.numpy()[masked] == 0).all()
        assert (got_lse.numpy().transpose(0, 2, 1)[masked]
                == np.float32(-1e30)).all()


@pytest.mark.parametrize("causal,Sq,Sk", [(False, 40, 40), (True, 40, 40),
                                          (True, 24, 40)])
def test_lse_cotangent_matches_jax_autodiff(causal, Sq, Sk):
    """Both outputs carry gradients: with cotangents on ``out`` and on
    ``lse``, the Function's gradient (its plain backward, ``dlse`` folded
    into ``delta``) and the tiled dq / dk/dv emulations given the same
    ``dlse`` equal JAX's autodiff of its plain attention
    (``distributed.context_parallel._sdpa``, which returns the lse) at
    dq / dk / dv atol 1e-4; through the lse alone (no cotangent on out)
    as well. The JAX kernel's VJP drops ``dlse`` (ROADMAP.md section C),
    so its plain attention is the oracle here."""
    from paddle_tpu.distributed.context_parallel import _sdpa
    q, k, v, do = _inputs(Sq + Sk + causal, 2, Sq, Sk, 4, 4, 16)
    dl = np.random.default_rng(Sq).standard_normal((2, 4, Sq)).astype(
        np.float32)
    for dout in (do, None):
        def f(a, b, c):
            o, lse = _sdpa(a, b, c, causal)
            out = (lse * dl).sum()
            return out if dout is None else out + (o * dout).sum()

        want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                      for a in (q, k, v))
        o, lse = flash_attention_with_lse(tq, tk, tv, causal=causal)
        outs, cots = ((lse,), (torch.from_numpy(dl),)) if dout is None else (
            (o, lse), (torch.from_numpy(dout), torch.from_numpy(dl)))
        got = torch.autograd.grad(outs, (tq, tk, tv), cots)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    od, ld = o.detach(), lse.detach()
    args = (tq.detach(), tk.detach(), tv.detach(), None, None, od, ld,
            torch.from_numpy(do), 0.25, causal, torch.from_numpy(dl))
    plain = flash_attention_bwd_plain(*args)
    tiled = (flash_attention_bwd_dq_tiled(*args),
             *flash_attention_bwd_dkv_tiled(*args))
    for a, b in zip(tiled, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_operands_copy_misaligned_views(dtype):
    # TMA reads each operand from a 16-byte boundary: a view whose storage
    # offset puts it off the boundary is copied, an aligned one is not
    FA = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    shape = (1, 8, 2, 64)
    n = int(np.prod(shape))
    buf = torch.randn(n + 8).to(dtype)
    aligned, off = buf[:n].view(shape), buf[1:n + 1].view(shape)
    assert aligned.data_ptr() % 16 == 0 and off.data_ptr() % 16 != 0
    q, k, v, _, _ = FA._cuda_operands(off, aligned, off, None, None)
    assert q.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
    assert torch.equal(q, off) and torch.equal(v, off)
    assert k.data_ptr() == aligned.data_ptr()
    lse = torch.zeros((1, 2, 8))
    ops = FA._bwd_operands(aligned, aligned, aligned, None, None, aligned,
                           lse, off)
    assert ops[5].data_ptr() % 16 == 0 and torch.equal(ops[5], off)
