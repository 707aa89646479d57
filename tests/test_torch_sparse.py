"""``paddle.sparse`` on the port (``paddle_tpu_torch/sparse``) against the
JAX package's: the constructors, conversions and ``coalesce``; the math
and unary surface on COO and CSR; the row softmax; ``attention`` and
``nn.functional.sparse_attention``; the registry (its sweep over every
``sparse_*`` name both packages register); the host reads the structure
costs; and the records of five reference faults (ROADMAP §C, F1–F5).

Values within ``1e-5 * max|ref|`` of the JAX package's, gradients of the
outputs' sum within ``1e-4 * max(max|g|, 1e-2)`` (``_torch_sweep``'s
rule), indices equal. A sparse output is compared as a coordinate set
sorted by its linear key, its values row by row in that order: a strided
sparse conv keeps Paddle's sorted order on the port and insertion order in
the reference.
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.sparse as JS
import paddle_tpu_torch as T
import paddle_tpu_torch.sparse as TS
from _torch_sweep import GRAD_FLOOR, GRAD_RTOL, JR, TR, close, shared_ops

SPARSE = {J: JS, T: TS}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def coo(p, idx, vals, shape=None, sg=True):
    return SPARSE[p].sparse_coo_tensor(
        np.asarray(idx, np.int64), p.to_tensor(np.asarray(vals, np.float32),
                                               stop_gradient=sg), shape)


def csr(p, crows, cols, vals, shape, sg=True):
    return SPARSE[p].sparse_csr_tensor(
        np.asarray(crows, np.int64), np.asarray(cols, np.int64),
        p.to_tensor(np.asarray(vals, np.float32), stop_gradient=sg), shape)


def canon(sp):
    """(indices sorted by linear key, values in that order) of a sparse
    output (COO; CSR as its crows, cols and values)."""
    if hasattr(sp, "crows"):
        return [np.asarray(sp.crows().numpy()), np.asarray(sp.cols().numpy()),
                np.asarray(sp.values().numpy())]
    idx = np.asarray(sp.indices().numpy()).astype(np.int64)
    order = np.lexsort(idx[::-1])
    return [idx[:, order], np.asarray(sp.values().numpy())[order]]


def leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in leaves(o)]
    if hasattr(out, "indices") or hasattr(out, "crows"):
        return canon(out)
    return [np.asarray(out.numpy())]


def same(got, want, what=""):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, what=f"{what} {i}")


# -- the registry sweep ------------------------------------------------------------

SPARSE_NAMES = sorted(
    ["sparse_" + n for n in (
        "abs", "asin", "asinh", "atan", "atanh", "deg2rad", "expm1",
        "log1p", "neg", "rad2deg", "sin", "sinh", "sqrt", "square", "tan",
        "tanh", "pow", "cast", "divide", "mv", "addmm", "sum", "transpose",
        "reshape", "matmul", "masked_matmul", "add", "subtract", "multiply",
        "relu", "coalesce", "softmax", "relu6", "leaky_relu", "conv3d",
        "subm_conv3d", "max_pool3d", "batch_norm", "attention")])


def test_registries_hold_the_same_sparse_names():
    j = {n for n in JR if n.startswith("sparse_")} - {"sparse_momentum_update"}
    t = {n for n in TR if n.startswith("sparse_")} - {"sparse_momentum_update"}
    assert sorted(j) == sorted(t) == SPARSE_NAMES
    assert shared_ops("sparse") == SPARSE_NAMES


def _public(p, name):
    if name == "sparse_attention":
        return SPARSE[p].nn.functional.attention
    return (JR if p is J else TR)[name].public


def _sweep_call(p, name, args, kwargs):
    """``name``'s public op of package ``p`` on the spec's arguments (the
    reference's sparse tensors rebuilt in ``p``), every float input
    needing a gradient: (output leaves, the gradients of their sum)."""
    ins, call = [], []
    for a in args:
        if isinstance(a, (JS.SparseCooTensor, JS.SparseCsrTensor)):
            v = p.to_tensor(np.asarray(a.values().numpy()),
                            stop_gradient=False)
            ins.append(v)
            if isinstance(a, JS.SparseCooTensor):
                call.append(SPARSE[p].SparseCooTensor(
                    p.to_tensor(np.asarray(a.indices().numpy())), v,
                    a.shape))
            else:
                call.append(SPARSE[p].SparseCsrTensor(
                    p.to_tensor(np.asarray(a.crows().numpy())),
                    p.to_tensor(np.asarray(a.cols().numpy())), v, a.shape))
        elif isinstance(a, np.ndarray):
            t = p.to_tensor(a, stop_gradient=a.dtype.kind != "f")
            if a.dtype.kind == "f":
                ins.append(t)
            call.append(t)
        else:
            call.append(a)
    out = _public(p, name)(*call, **kwargs)
    outs = out if isinstance(out, (tuple, list)) else [out]
    vals = [o.values() if hasattr(o, "values") else o for o in outs]
    vals = [v for v in vals if not v.stop_gradient]
    grads = [np.zeros(x.shape, np.float32) for x in ins]
    if vals and ins:
        total = vals[0].sum()
        for v in vals[1:]:
            total = total + v.sum()
        gs = p.grad([total], ins, allow_unused=True)
        grads = [np.zeros(x.shape, np.float32) if g is None else g.numpy()
                 for g, x in zip(gs, ins)]
    return leaves(out), grads


@pytest.mark.parametrize("name", shared_ops("sparse"))
def test_registry_sweep(name):
    r = np.random.default_rng(sum(map(ord, name)) % 2 ** 31)
    for args, kwargs, _ in JR[name].sweep(r):
        want, gj = _sweep_call(J, name, args, kwargs)
        got, gt = _sweep_call(T, name, args, kwargs)
        same(got, want, name)
        assert len(gt) == len(gj)
        for i, (a, b) in enumerate(zip(gt, gj)):
            close(a, b, rtol=GRAD_RTOL, what=f"{name} grad {i}",
                  floor=GRAD_FLOOR)


# -- containers and conversions --------------------------------------------------

IDX = [[0, 2, 1, 0, 2], [1, 0, 2, 1, 3]]      # (0, 1) twice
VALS = [1.0, -2.0, 3.0, 0.5, 4.0]


def test_coalesce_and_conversions():
    out = {}
    for p in (J, T):
        x = coo(p, IDX, VALS, [3, 4])
        c = x.coalesce()
        r = x.to_sparse_csr()
        out[p] = (canon(c), c.to_dense().numpy(), x.to_dense().numpy(),
                  [np.asarray(r.crows().numpy()), np.asarray(r.cols().numpy()),
                   np.asarray(r.values().numpy())],
                  r.to_dense().numpy(), canon(r.to_sparse_coo()))
        assert str(c.indices().dtype).endswith("int32")
        assert str(r.crows().dtype).endswith("int32")
        assert str(r.cols().dtype).endswith("int32")
    for a, b in zip(out[T], out[J]):
        same(a if isinstance(a, list) else [a], b if isinstance(b, list)
             else [b])
    np.testing.assert_array_equal(out[T][0][0], [[0, 1, 2, 2], [1, 2, 0, 3]])
    np.testing.assert_allclose(out[T][0][1], [1.5, 3.0, -2.0, 4.0])


def test_csr_accessors_and_math():
    """CSR: every accessor, to_dense / to_sparse_coo, the unary family,
    mv and matmul against the JAX package (which takes CSR there)."""
    crows, cols, vals = [0, 2, 2, 5], [0, 3, 1, 2, 3], [.3, -.5, .7, .2, -.9]
    rng = np.random.default_rng(0)
    vec = rng.standard_normal(4).astype(np.float32)
    mat = rng.standard_normal((4, 2)).astype(np.float32)
    res = {}
    for p in (J, T):
        S = SPARSE[p]
        x = csr(p, crows, cols, vals, [3, 4])
        assert x.is_sparse_csr() and not x.is_sparse_coo() and x.nnz() == 5
        res[p] = [x.to_dense().numpy()] + canon(x.to_sparse_coo()) + \
            canon(S.sin(x)) + canon(S.tanh(x)) + canon(S.pow(x, 2.0)) + \
            [S.mv(x, p.to_tensor(vec)).numpy(),
             S.matmul(x, p.to_tensor(mat)).numpy()]
    same(res[T], res[J], "csr")


def test_binary_union_and_products_without_densifying():
    """Patterns that differ: the union, its values; sparse @ dense, the
    sampled product and addmm against JAX. ``multiply`` keeps the union
    too (the reference keeps the nonzero products), so it is held by its
    dense tensor."""
    rng = np.random.default_rng(1)
    a = ([[0, 1, 2, 2], [1, 0, 2, 3]], rng.standard_normal(4))
    b = ([[0, 2, 1], [1, 0, 1]], rng.standard_normal(3))
    dense = rng.standard_normal((4, 3)).astype(np.float32)
    xm = rng.standard_normal((3, 5)).astype(np.float32)
    ym = rng.standard_normal((5, 4)).astype(np.float32)
    res = {}
    for p in (J, T):
        S = SPARSE[p]
        x, y = coo(p, *a, [3, 4]), coo(p, *b, [3, 4])
        res[p] = canon(S.add(x, y)) + canon(S.subtract(x, y)) + \
            [S.multiply(x, y).to_dense().numpy()] + \
            [S.matmul(x, p.to_tensor(dense)).numpy(),
             S.addmm(p.to_tensor(np.ones((3, 3), np.float32)), x,
                     p.to_tensor(dense), beta=0.5, alpha=2.0).numpy()] + \
            canon(S.masked_matmul(p.to_tensor(xm), p.to_tensor(ym), x))
    same(res[T], res[J], "binary")
    # a CSR mask gives a CSR result on the port
    m = csr(T, [0, 1, 1, 3], [2, 0, 3], np.ones(3), [3, 4])
    out = TS.masked_matmul(T.to_tensor(xm), T.to_tensor(ym), m)
    prod = xm @ ym
    close(out.values().numpy(), [prod[0, 2], prod[2, 0], prod[2, 3]])


def test_structure_ops():
    rng = np.random.default_rng(2)
    idx = [[0, 1, 3, 2], [2, 0, 1, 1], [1, 1, 0, 2]]
    vals = rng.standard_normal(4)
    res = {}
    for p in (J, T):
        S = SPARSE[p]
        x = coo(p, idx, vals, [4, 3, 3])
        res[p] = canon(S.transpose(x, [2, 0, 1])) + \
            canon(S.reshape(x, [6, -1])) + \
            [S.sum(x).numpy(), S.sum(x, axis=1).numpy()] + \
            canon(S.cast(x, value_dtype="float64"))
    same(res[T], res[J], "structure")
    x = coo(T, idx, vals, [4, 3, 3])
    y = coo(T, idx, vals * 2 + 3, [4, 3, 3])
    order = np.lexsort(np.asarray(idx)[::-1])
    close(TS.divide(x, y).values().numpy(),
          (vals / (vals * 2 + 3))[order])
    with pytest.raises(ValueError, match="same sparsity"):
        TS.divide(x, coo(T, [[0], [2], [1]], [1.0], [4, 3, 3]))


def test_softmax_coo_and_csr():
    crows, cols = [0, 3, 3, 5], [0, 1, 3, 0, 2]
    vals = np.random.default_rng(3).standard_normal(5)
    res = {}
    for p in (J, T):
        F = SPARSE[p].nn.functional
        x = csr(p, crows, cols, vals, [3, 4], sg=False)
        y = F.softmax(x)
        g = p.grad([(y.values() * p.to_tensor(np.arange(5.0, dtype=np.float32))
                     ).sum()], [x.values()])[0]
        res[p] = canon(y) + canon(SPARSE[p].nn.Softmax()(x.to_sparse_coo())) \
            + [g.numpy()]
    same(res[T], res[J], "softmax")


def _qkv(B, H, S, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(3)]


def _band_csr(S, width, n=1):
    """A banded pattern (|i - j| <= width) as CSR, ``n`` copies one after
    another with each copy's offsets starting at 0 (Paddle's layout)."""
    crows, cols = [], []
    for _ in range(n):
        row = [0]
        for i in range(S):
            js = [j for j in range(S) if abs(i - j) <= width]
            cols += js
            row.append(row[-1] + len(js))
        crows += row
    return np.asarray(crows), np.asarray(cols)


def _dense_attention(q, k, v, mask):
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    s = np.where(mask, s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True)) * mask
    p = p / np.maximum(p.sum(-1, keepdims=True), 1e-30)
    return np.einsum("bhqk,bhkd->bhqd", p, v)


def test_attention_against_jax_and_the_dense_formula():
    B, H, S, D = 2, 2, 8, 4
    q, k, v = _qkv(B, H, S, D, 4)
    crows, cols = _band_csr(S, 1)
    kp = np.ones((B, S), np.float32)
    kp[1, -3:] = 0
    am = np.tril(np.ones((S, S), np.float32))
    am[0, 0] = 0                               # row 0 keeps nothing
    res = {}
    for p in (J, T):
        m = SPARSE[p].sparse_csr_tensor(crows, cols, np.ones(len(cols),
                                                             np.float32),
                                        [S, S])
        ts = [p.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
        out = SPARSE[p].nn.functional.attention(
            *ts, m, key_padding_mask=p.to_tensor(kp),
            attn_mask=p.to_tensor(am))
        gs = p.grad([(out * out).sum()], ts)
        res[p] = [out.numpy()] + [g.numpy() for g in gs]
    same(res[T][:1], res[J][:1], "attention")
    for a, b in zip(res[T][1:], res[J][1:]):
        close(a, b, rtol=GRAD_RTOL, floor=GRAD_FLOOR)
    band = np.abs(np.arange(S)[:, None] - np.arange(S)[None]) <= 1
    mask = band[None, None] & (kp != 0)[:, None, None, :] & (am != 0)
    close(res[T][0], _dense_attention(q, k, v, mask))
    assert np.all(res[T][0][:, :, 0] == 0)     # the all-masked row


def test_attention_per_head_patterns():
    """``[B*H, S, S]`` masks (Paddle's per-matrix offsets from 0) and
    ``nn.functional.sparse_attention``'s ``[B, H, S + 1]`` / ``[B, H,
    nnz]`` layout, against the dense formula; the pattern is cached on
    the mask."""
    B, H, S, D = 2, 3, 8, 4
    q, k, v = _qkv(B, H, S, D, 5)
    widths = [0, 1, 2, 1, 0, 2]
    crows, cols, mask = [], [], np.zeros((B * H, S, S), bool)
    for i, w in enumerate(widths):
        c, cl = _band_csr(S, w)
        crows.append(c)
        cols.append(cl)
        mask[i] = np.abs(np.arange(S)[:, None] - np.arange(S)[None]) <= w
    m = TS.sparse_csr_tensor(np.concatenate(crows), np.concatenate(cols),
                             np.ones(sum(len(c) for c in cols), np.float32),
                             [B * H, S, S])
    want = _dense_attention(q, k, v, mask.reshape(B, H, S, S))
    ts = [T.to_tensor(a) for a in (q, k, v)]
    close(TS.nn.functional.attention(*ts, m).numpy(), want)
    assert m._dense_mask_cache.shape == (B, H, S, S)
    close(TS.nn.functional.attention(*ts, m).numpy(), want)
    # per-head offsets need one nnz a head: the band of width 1 everywhere
    c, cl = _band_csr(S, 1)
    off = np.broadcast_to(c, (B, H, S + 1)).copy()
    colb = np.broadcast_to(cl, (B, H, len(cl))).copy()
    band = np.abs(np.arange(S)[:, None] - np.arange(S)[None]) <= 1
    close(T.nn.functional.sparse_attention(
        *ts, T.to_tensor(off), T.to_tensor(colb)).numpy(),
        _dense_attention(q, k, v, np.broadcast_to(band, (B, H, S, S))))
    # the reference's 1-D form, against the JAX package
    got = T.nn.functional.sparse_attention(*ts, T.to_tensor(c),
                                           T.to_tensor(cl))
    ref = J.nn.functional.sparse_attention(*[J.to_tensor(a)
                                             for a in (q, k, v)],
                                           J.to_tensor(c), J.to_tensor(cl))
    close(got.numpy(), ref.numpy())


def test_host_reads_of_the_structure():
    """Only sizes the data decides reach the host, each counted: one for a
    coalesce or a union, none for a conversion, a unary op or a product."""
    from paddle_tpu_torch.sparse import _keys
    x = coo(T, IDX, VALS, [3, 4])
    before = _keys.syncs
    r = x.to_sparse_csr()
    r.to_dense()
    r.to_sparse_coo()
    TS.sin(r)
    TS.mv(x, T.to_tensor(np.ones(4, np.float32)))
    TS.masked_matmul(T.to_tensor(np.ones((3, 2), np.float32)),
                     T.to_tensor(np.ones((2, 4), np.float32)), r)
    assert _keys.syncs == before
    x.coalesce()
    assert _keys.syncs == before + 1
    TS.add(x, x)
    assert _keys.syncs == before + 2


# -- records of the reference's faults (ROADMAP §C) -----------------------------

def test_f1_shape_inference_keeps_the_dense_dims():
    idx = np.array([[0, 1, 1], [2, 0, 1], [0, 1, 1], [2, 0, 2]])
    vals = np.ones((3, 2), np.float32)
    assert JS.sparse_coo_tensor(idx, vals).shape == [2, 3, 2, 3]
    assert TS.sparse_coo_tensor(idx, vals).shape == [2, 3, 2, 3, 2]


def test_f2_to_dense_of_a_hybrid_tensor():
    idx = np.array([[0, 1, 2], [1, 0, 1]])
    vals = np.arange(6, dtype=np.float32).reshape(3, 2)
    with pytest.raises(Exception, match="sparse_to_dense"):
        JS.sparse_coo_tensor(idx, vals, [3, 2, 2]).to_dense()
    d = TS.sparse_coo_tensor(idx, vals, [3, 2, 2]).to_dense().numpy()
    want = np.zeros((3, 2, 2), np.float32)
    want[idx[0], idx[1]] = vals
    np.testing.assert_array_equal(d, want)


def test_f3_per_head_offsets():
    B, H, S, D = 1, 2, 4, 4
    q, k, v = _qkv(B, H, S, D, 6)
    c, cl = _band_csr(S, 1)
    off = np.broadcast_to(c, (B, H, S + 1)).copy()
    colb = np.broadcast_to(cl, (B, H, len(cl))).copy()
    with pytest.raises(IndexError):
        J.nn.functional.sparse_attention(
            *[J.to_tensor(a) for a in (q, k, v)], J.to_tensor(off),
            J.to_tensor(colb))
    band = np.abs(np.arange(S)[:, None] - np.arange(S)[None]) <= 1
    close(T.nn.functional.sparse_attention(
        *[T.to_tensor(a) for a in (q, k, v)], T.to_tensor(off),
        T.to_tensor(colb)).numpy(),
        _dense_attention(q, k, v, np.broadcast_to(band, (B, H, S, S))))


def test_f4_add_keeps_a_zero_sum():
    idx = [[0, 1], [1, 0]]
    j = JS.add(coo(J, idx, [1.0, 2.0], [2, 2]), coo(J, idx, [-1.0, 3.0],
                                                     [2, 2]))
    t = TS.add(coo(T, idx, [1.0, 2.0], [2, 2]), coo(T, idx, [-1.0, 3.0],
                                                     [2, 2]))
    assert j.nnz() == 1 and t.nnz() == 2
    np.testing.assert_array_equal(t.values().numpy(), [0.0, 5.0])
    close(t.to_dense().numpy(), j.to_dense().numpy())


def test_f5_relu_of_csr():
    crows, cols, vals = [0, 1, 3], [1, 0, 1], [-1.0, 2.0, -3.0]
    with pytest.raises(AttributeError, match="indices_"):
        JS.relu(csr(J, crows, cols, vals, [2, 2]))
    out = TS.relu(csr(T, crows, cols, vals, [2, 2]))
    assert out.is_sparse_csr()
    np.testing.assert_array_equal(out.values().numpy(), [0.0, 2.0, 0.0])
