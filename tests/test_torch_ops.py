"""The port's op surface (``paddle_tpu_torch.ops``) against the JAX
package's.

* The cases of ``tests/test_ops.py`` for the modules this slice ports
  (math, manipulation, the matmul family of linalg, search, logic,
  random), each run through both packages on the same numpy inputs.
* A registry sweep: for every op name registered in BOTH registries, the
  example calls of ``paddle_tpu/ops/sweep_specs.py`` (``attach_specs``)
  for composite ops, and sampled inputs in each op's safe domain for the
  elementwise ``unary`` / ``binary`` ops, go through both public ops.
  Forward fp32 must agree within 1e-5 of the reference's max-abs
  (``max|port - jax| <= 1e-5 * max|jax|``); the gradient of ``sum(out)``
  within ``1e-4 * max(max|g|, 1e-2)`` where the op is differentiable
  (the floor: that gradient is zero analytically for softmax and the
  norms, and both packages return rounding noise), an input that gets no
  gradient counting as a zero one; the samples keep 0.1 away from each
  op's kinks and ties (``KINKS``), so no subgradient choice enters;
  integer and bool outputs exactly (values: JAX's 32-bit default makes some integer
  outputs int32 where Paddle and the port give int64). Ops that draw
  random numbers, run on the host by design, or differ in a documented
  way are listed in ``NOT_SWEPT`` with the reason.
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.distributed.ps  # noqa: F401 — registers its ops
import paddle_tpu.incubate.nn.functional  # noqa: F401 — registers its ops
import paddle_tpu.metric  # noqa: F401
import paddle_tpu.nn.functional  # noqa: F401
import paddle_tpu_torch as T
import paddle_tpu_torch.distributed.ps  # noqa: F401
import paddle_tpu_torch.incubate.nn.functional  # noqa: F401
import paddle_tpu_torch.metric  # noqa: F401
import paddle_tpu_torch.nn.functional  # noqa: F401
from paddle_tpu.core.dispatch import OP_REGISTRY as JR
from paddle_tpu.ops.sweep_specs import attach_specs
from paddle_tpu_torch.core.dispatch import OP_REGISTRY as TR

attach_specs()

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
# the scale of a gradient comparison is at least this: the gradient of
# sum(out) is zero analytically for softmax and the norms, and both
# packages then return rounding noise of ~1e-7
GRAD_FLOOR = 1e-2


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def _leaves(x):
    if x is None:          # flash_attention's softmax slot, in both
        return []
    if isinstance(x, (tuple, list)):
        return [l for e in x for l in _leaves(e)]
    if hasattr(x, "numpy"):
        return [np.asarray(x.numpy())]
    return [np.asarray(x)]


def close(got, want, rtol=FWD_RTOL, what="", floor=1e-30):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu" or got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    want64, got64 = want.astype(np.float64), got.astype(np.float64)
    scale = max(float(np.nanmax(np.abs(want64))) if want.size else 0.0, floor)
    np.testing.assert_array_equal(np.isnan(got64), np.isnan(want64),
                                  err_msg=what)
    ok = ~np.isnan(want64)
    err = float(np.max(np.abs(got64[ok] - want64[ok]), initial=0.0))
    assert err <= rtol * scale, f"{what}: max err {err} > {rtol} * {scale}"


def both(body):
    """``body(paddle)`` on both packages; every returned leaf compared."""
    rj, rt = body(J), body(T)
    lj, lt = _leaves(rj), _leaves(rt)
    assert len(lj) == len(lt)
    for i, (a, b) in enumerate(zip(lj, lt)):
        close(b, a, what=f"leaf {i}")


def t(p, a, sg=True):
    return p.to_tensor(a, stop_gradient=sg)


# -- tests/test_ops.py ------------------------------------------------------

class TestMath:
    def test_reductions(self):
        a = np.random.default_rng(0).random((3, 4, 5)).astype(np.float32)
        both(lambda p: [p.sum(t(p, a), axis=1), p.mean(t(p, a), axis=[0, 2]),
                        p.max(t(p, a), axis=-1, keepdim=True),
                        p.prod(t(p, a), axis=2), p.std(t(p, a)),
                        p.var(t(p, a), unbiased=False),
                        p.logsumexp(t(p, a), axis=0)])

    def test_cumulative(self):
        a = np.random.default_rng(1).random((3, 4)).astype(np.float32)
        both(lambda p: [p.cumsum(t(p, a), axis=1), p.cumprod(t(p, a), dim=0),
                        *p.cummax(t(p, a), axis=1)])

    def test_clip_scale(self):
        a = np.linspace(-2, 2, 10).astype(np.float32)
        both(lambda p: [p.clip(t(p, a), -1, 1), p.scale(t(p, a), 2.0, 1.0),
                        p.scale(t(p, a), 2.0, 1.0, bias_after_scale=False)])

    def test_add_n(self):
        r = np.random.default_rng(2)
        xs = [r.random((2, 2)).astype(np.float32) for _ in range(3)]
        both(lambda p: p.add_n([t(p, x) for x in xs]))

    def test_trig_special(self):
        a = np.random.default_rng(3).random(5).astype(np.float32) * 0.9
        names = ("sin", "cos", "atan", "asin", "erf", "log1p", "expm1", "rsqrt")
        both(lambda p: [getattr(p, n)(t(p, a)) for n in names])


class TestManipulation:
    def test_reshape_transpose(self):
        a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        for p in (J, T):
            assert p.reshape(t(p, a), [0, -1]).shape == [2, 12]
            assert t(p, a).T.shape == [4, 3, 2]
        both(lambda p: [p.reshape(t(p, a), [4, 6]),
                        p.transpose(t(p, a), [2, 0, 1])])

    def test_concat_stack_split(self):
        r = np.random.default_rng(4)
        a, b = (r.random((2, 3)).astype(np.float32) for _ in range(2))
        both(lambda p: [p.concat([t(p, a), t(p, b)], axis=0),
                        p.stack([t(p, a), t(p, b)], axis=1),
                        p.split(t(p, a), [1, 2], axis=1),
                        p.split(t(p, a), [1, -1], axis=1)])

    def test_squeeze_unsqueeze_flatten(self):
        a = np.zeros((1, 3, 1, 2), np.float32)
        for p in (J, T):
            assert p.squeeze(t(p, a)).shape == [3, 2]
            assert p.squeeze(t(p, a), axis=0).shape == [3, 1, 2]
            assert p.unsqueeze(t(p, a), [0, 4]).shape == [1, 1, 3, 1, 1, 2]
            assert p.flatten(t(p, a), 1, 2).shape == [1, 3, 2]

    def test_gather_scatter(self):
        a = np.arange(12, dtype=np.float32).reshape(4, 3)
        idx = np.array([0, 2])
        upd = np.ones((2, 3), np.float32) * 9
        both(lambda p: [p.gather(t(p, a), t(p, idx)),
                        p.scatter(t(p, a), t(p, idx), t(p, upd)),
                        p.scatter(t(p, a), t(p, np.array([1, 1])), t(p, upd),
                                  overwrite=False)])

    def test_gather_nd_take_along(self):
        a = np.random.default_rng(5).random((3, 4)).astype(np.float32)
        idx = np.array([[0, 1], [2, 3]])
        ta = np.array([[0], [1], [0]])
        both(lambda p: [p.gather_nd(t(p, a), t(p, idx)),
                        p.take_along_axis(t(p, a), t(p, ta), axis=1)])

    def test_tile_expand_pad(self):
        a = np.ones((2, 1), np.float32)
        both(lambda p: [p.tile(t(p, a), [2, 3]), p.expand(t(p, a), [2, 5]),
                        p.broadcast_to(t(p, a), [4, 2, 3])])

    def test_flip_roll(self):
        a = np.arange(6, dtype=np.float32).reshape(2, 3)
        both(lambda p: [p.flip(t(p, a), [0]), p.roll(t(p, a), 1, axis=1)])

    def test_masked_dynamic(self):
        a = np.array([1.0, -2.0, 3.0], np.float32)
        both(lambda p: [p.masked_select(t(p, a), t(p, a > 0)),
                        p.unique(t(p, np.array([3, 1, 1, 2])))])

    def test_masked_fill(self):
        a = np.zeros((2, 2), np.float32)
        m = np.array([[True, False], [False, True]])
        both(lambda p: p.masked_fill(t(p, a), t(p, m), 5.0))


class TestLinalg:
    def test_matmul_variants(self):
        r = np.random.default_rng(6)
        a = r.random((2, 3, 4)).astype(np.float32)
        b = r.random((2, 4, 5)).astype(np.float32)
        both(lambda p: [p.matmul(t(p, a), t(p, b)),
                        p.matmul(t(p, a), t(p, b.transpose(0, 2, 1)),
                                 transpose_y=True),
                        p.bmm(t(p, a), t(p, b))])

    def test_norm_einsum(self):
        r = np.random.default_rng(7)
        a = r.random((3, 4)).astype(np.float32)
        b = r.random((4, 5)).astype(np.float32)
        both(lambda p: [p.norm(t(p, a)), p.norm(t(p, a), p=1, axis=1),
                        p.einsum("ij,jk->ik", t(p, a), t(p, b))])

    def test_einsum_grad(self):
        a = np.random.default_rng(8).random((3, 4)).astype(np.float32)

        def body(p):
            x = t(p, a, sg=False)
            p.einsum("ij->j", x).sum().backward()
            return x.grad
        both(body)


class TestSearchLogic:
    def test_argmax_sort_topk(self):
        a = np.random.default_rng(9).random((3, 5)).astype(np.float32)
        both(lambda p: [p.argmax(t(p, a), axis=1), p.sort(t(p, a), axis=1),
                        p.argsort(t(p, a), axis=1), *p.topk(t(p, a), 2, axis=1),
                        *p.topk(t(p, a), 2, axis=1, largest=False)])

    def test_where_nonzero(self):
        a = np.array([[1.0, -1.0], [-2.0, 2.0]], np.float32)
        both(lambda p: [p.where(t(p, a) > 0, t(p, a), t(p, np.zeros_like(a))),
                        p.nonzero(t(p, a) > 0)])

    def test_topk_grad(self):
        a = np.array([[1.0, 3.0, 2.0]], np.float32)

        def body(p):
            x = t(p, a, sg=False)
            vals, _ = p.topk(x, 2)
            vals.sum().backward()
            return x.grad
        both(body)

    def test_comparisons(self):
        a, b = np.array([1, 2, 3]), np.array([3, 2, 1])
        f = a.astype(np.float32)
        both(lambda p: [p.equal(t(p, a), t(p, b)), p.less_than(t(p, a), t(p, b)),
                        p.equal_all(t(p, a), t(p, a)),
                        p.allclose(t(p, f), t(p, f + 1e-9)),
                        p.logical_and(t(p, a > 1), t(p, b > 1))])

    def test_searchsorted(self):
        s = np.array([1.0, 3.0, 5.0], np.float32)
        v = np.array([2.0, 3.0], np.float32)
        both(lambda p: p.searchsorted(t(p, s), t(p, v)))


class TestRandom:
    """Draws are not JAX's (a torch generator per device); each case holds
    the port to what ``tests/test_ops.py`` holds the reference to."""

    def test_seed_determinism(self):
        T.seed(42)
        a = T.randn([4]).numpy()
        T.seed(42)
        np.testing.assert_array_equal(a, T.randn([4]).numpy())

    def test_shapes_and_ranges(self):
        assert T.rand([2, 3]).shape == [2, 3]
        u = T.uniform([1000], min=2.0, max=3.0).numpy()
        assert u.min() >= 2.0 and u.max() < 3.0
        r = T.randint(0, 5, [100]).numpy()
        assert r.min() >= 0 and r.max() < 5 and r.dtype == np.int64
        np.testing.assert_array_equal(np.sort(T.randperm(10).numpy()),
                                      np.arange(10))

    def test_multinomial(self):
        s = T.multinomial(T.to_tensor([0.0, 0.0, 1.0]), 5, replacement=True)
        assert (s.numpy() == 2).all()

    def test_distributions(self):
        T.seed(7)
        z = T.randn([20000]).numpy()
        assert abs(z.mean()) < 0.05 and abs(z.std() - 1) < 0.05
        u = T.rand([20000]).numpy()
        assert abs(u.mean() - 0.5) < 0.02


class TestOpSchema:
    def test_registry_covers_public_surface(self):
        import paddle_tpu_torch.ops as ops
        missing = [n for n in ops.__all__
                   if callable(getattr(ops, n, None))
                   and not isinstance(getattr(ops, n), type)
                   and n not in TR]
        assert not missing, f"ops absent from OP_REGISTRY: {missing[:10]}"

    def test_shared_names_keep_their_categories(self):
        for n in set(JR) & set(TR):
            if JR[n].category in ("unary", "binary"):
                assert TR[n].category == JR[n].category, n


# -- the registry sweep -----------------------------------------------------

# reason each shared op is not swept against JAX
NOT_SWEPT = {
    **{n: "random draws (torch generator, not jax.random)" for n in (
        "rand", "randn", "standard_normal", "normal", "uniform", "randint",
        "randint_like", "randperm", "bernoulli", "bernoulli_", "poisson",
        "multinomial", "exponential_", "uniform_", "normal_", "rand_like",
        "randn_like", "seed", "get_rng_state", "set_rng_state", "dropout",
        "dropout2d", "dropout3d", "alpha_dropout", "gumbel_softmax",
        "rrelu")},
    "empty": "uninitialized in Paddle; both give zeros, checked by value",
    "empty_like": "as empty",
    "create_parameter": "random init",
    "to_tensor": "creation, covered by test_torch_tensor.py",
    "nextafter": "float32 nextafter differs by design between backends "
                 "(XLA flushes denormals)",
    **{n: "takes or returns SelectedRows; held to JAX in test_torch_ps.py"
       for n in ("merge_selected_rows", "get_tensor_from_selected_rows")},
    **{n: "takes a DistributedSparseEmbedding table; held to JAX in "
          "test_torch_ps.py"
       for n in ("distributed_lookup_table", "distributed_push_sparse")},
    "yolo_box": "the reference's boxes are scrambled (ROADMAP §C); held to "
                "a numpy decode and its scores to JAX in "
                "test_torch_vision_ops.py",
}

DOMAINS = {
    "log": (0.3, 3.0), "log2": (0.3, 3.0), "log10": (0.3, 3.0),
    "log1p": (-0.6, 3.0), "sqrt": (0.1, 4.0), "rsqrt": (0.1, 4.0),
    "asin": (-0.9, 0.9), "acos": (-0.9, 0.9), "atanh": (-0.9, 0.9),
    "acosh": (1.1, 3.0), "erfinv": (-0.9, 0.9), "lgamma": (0.2, 3.0),
    "digamma": (0.2, 3.0), "tan": (-1.2, 1.2), "reciprocal": (0.3, 3.0),
    "divide": (0.3, 3.0), "floor_divide": (0.5, 4.0), "remainder": (0.5, 4.0),
    "elementwise_pow": (0.3, 2.0), "fmod": (0.5, 4.0),
}
INT_OPS = {"bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "gcd",
           "lcm", "bitwise_left_shift", "bitwise_right_shift"}
BOOL_OPS = {"logical_and", "logical_or", "logical_xor", "logical_not"}
# where each elementwise op's derivative jumps: samples are pushed at
# least 0.1 away from these, so both backends differentiate the same
# smooth piece and no subgradient choice enters the comparison
KINKS = {"abs": (0.0,), "sign": (0.0,), "heaviside": (0.0,),
         "relu": (0.0,), "relu6": (0.0,), "hardtanh": (-1.0, 1.0),
         "hardshrink": (-0.5, 0.5), "softshrink": (-0.5, 0.5),
         "thresholded_relu": (1.0,), "hardsigmoid": (-3.0, 3.0),
         "hardswish": (-3.0, 3.0),
         **{n: (-2.0, -1.0, 0.0, 1.0, 2.0)
            for n in ("floor", "ceil", "trunc", "frac")},
         "round": (-1.5, -0.5, 0.5, 1.5)}
# ops whose gradient is not compared
NO_GRAD = {
    # in place: the JAX package's paddle.grad counts the gradient of a
    # rebound tensor twice (2 where the derivative is 1)
    "increment"}


def _away(x, kinks, gap=0.1):
    for k in kinks:
        near = np.abs(x - k) < gap
        x = np.where(near, x + np.where(x >= k, 2 * gap, -2 * gap), x)
    return x.astype(np.float32)


def _sample(name, shape=(3, 4), seed=0):
    r = np.random.RandomState(seed + sum(map(ord, name)) % 1000)
    if name in INT_OPS:
        return r.randint(1, 16, shape).astype(np.int32)
    if name in BOOL_OPS:
        return r.rand(*shape) > 0.5
    lo, hi = DOMAINS.get(name, (-2.0, 2.0))
    x = (lo + (hi - lo) * r.rand(*shape)).astype(np.float32)
    return _away(x, KINKS.get(name, ())) if seed == 0 else x


def _public(p, name):
    """The user-facing op of a registry entry: its ``public`` wrapper, or
    the namespace function of that name (factory-registered ops)."""
    d = (JR if p is J else TR)[name]
    if d.public is not None:
        return d.public
    name = {"elementwise_pow": "pow"}.get(name, name)
    return getattr(p, name, None) or getattr(p.nn.functional, name)


def _elementwise_legs(name):
    d = JR[name]
    a = _sample(name)
    if d.category == "unary":
        return [((a,), {})]
    b = _sample(name, seed=1)
    if name in ("maximum", "minimum", "fmax", "fmin"):
        b = _away(b - a, (0.0,)) + a        # no ties
    elif name == "copysign":
        b = _away(b, (0.0,))
    elif name in ("floor_divide", "remainder"):
        b = a / _away(a / b, np.arange(1.0, 9.0))  # a / b off the integers
    if name == "ldexp":
        b = np.random.RandomState(2).randint(-3, 4, (3, 4)).astype(np.int32)
    return [((a, b), {})]


def _spec_legs(name):
    d = JR[name]
    r = np.random.default_rng(sum(map(ord, name)) % 2 ** 31)
    return [(args, kwargs) for args, kwargs, _ in d.sweep(r)]


def _shared_ops():
    names = []
    for n in sorted(set(JR) & set(TR)):
        if n in NOT_SWEPT or n.endswith("_"):
            continue
        d = JR[n]
        if d.category in ("unary", "binary") or callable(d.sweep):
            names.append(n)
    return names


def _call_args(p, args, sg=True):
    out = []
    for a in args:
        if isinstance(a, np.ndarray):
            out.append(p.to_tensor(a, stop_gradient=sg or
                                   a.dtype.kind not in "f"))
        elif isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            out.append([p.to_tensor(x, stop_gradient=sg or
                                    x.dtype.kind not in "f") for x in a])
        else:
            out.append(a)
    return out


def _float_inputs(args):
    flat = []
    for a in args:
        flat += a if isinstance(a, list) else [a]
    return [x for x in flat if hasattr(x, "numpy") and not x.stop_gradient]


def _grads(p, name, args, kwargs):
    """The gradient of sum(out) for each float input. An input that gets
    no gradient (``None`` from ``paddle.grad``, or every output stop-
    gradient) counts as a zero gradient, so a package that drops the graph
    fails wherever the other's gradient is not zero."""
    call = _call_args(p, args, sg=False)
    ins = _float_inputs(call)
    out = _public(p, name)(*call, **kwargs)
    outs = [o for o in (out if isinstance(out, (tuple, list)) else [out])
            if hasattr(o, "stop_gradient") and not o.stop_gradient
            and o.numpy().dtype.kind == "f"]
    gs = [None] * len(ins)
    if outs:
        total = outs[0].sum()
        for o in outs[1:]:
            total = total + o.sum()
        gs = p.grad([total], ins, allow_unused=True)
    return [np.zeros(x.shape, x.numpy().dtype) if g is None else g.numpy()
            for g, x in zip(gs, ins)]


@pytest.mark.parametrize("name", _shared_ops())
def test_registry_sweep(name):
    d = JR[name]
    legs = _elementwise_legs(name) if d.category in ("unary", "binary") \
        else _spec_legs(name)
    for args, kwargs in legs:
        want = _leaves(_public(J, name)(*_call_args(J, args), **kwargs))
        got = _leaves(_public(T, name)(*_call_args(T, args), **kwargs))
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            close(g, w, what=f"{name} output {i}")
        if name in NO_GRAD or not any(
                isinstance(a, np.ndarray) and a.dtype.kind == "f"
                for a in args):
            continue
        gj = _grads(J, name, args, kwargs)
        gt = _grads(T, name, args, kwargs)
        assert len(gt) == len(gj), name
        for i, (a, b) in enumerate(zip(gj, gt)):
            close(b, a, rtol=GRAD_RTOL, what=f"{name} grad {i}",
                  floor=GRAD_FLOOR)
