"""The port's op surface (``paddle_tpu_torch.ops``) against the JAX
package's.

* The cases of ``tests/test_ops.py`` for the earlier modules (math,
  manipulation, the matmul family of linalg, search, logic, random), each
  run through both packages on the same numpy inputs.
* The registry sweep (``_torch_sweep.py``) of the ops that the op
  library's modules do not define; the library's families (``linalg``
  and ``quant`` whole) are swept in ``test_torch_special_ops.py``,
  ``test_torch_extended_ops.py``, ``test_torch_legacy_ops.py`` and
  ``test_torch_linalg.py``.
* The schema: the two registries hold the same names, the reference
  ``Tensor``'s public methods are the port's too, and ``linalg``, ``fft``
  and ``signal`` export the reference's ``__all__``.
"""

import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from _torch_sweep import JR, TR, _leaves, check_sweep, close, shared_ops

@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


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


# the registries and Tensor methods of each package with its op surface
# and namespaces imported, in a process of its own (the test processes
# import more of each package, each registering more names)
_SURFACE = """
import json, sys
import {pkg} as p, {pkg}.fft, {pkg}.signal, {pkg}.linalg
from {pkg}.core.dispatch import OP_REGISTRY
json.dump({{"ops": sorted(OP_REGISTRY), "methods": sorted(
    n for n in dir(p.Tensor) if not n.startswith("_"))}}, sys.stdout)
"""


def _surface(pkg):
    import json
    out = subprocess.run([sys.executable, "-c", _SURFACE.format(pkg=pkg)],
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout)


class TestOpSchema:
    def test_registry_covers_public_surface(self):
        import paddle_tpu_torch.ops as ops
        missing = [n for n in ops.__all__
                   if callable(getattr(ops, n, None))
                   and not isinstance(getattr(ops, n), type)
                   and n not in TR]
        assert not missing, f"ops absent from OP_REGISTRY: {missing[:10]}"
        ref, port = _surface("paddle_tpu"), _surface("paddle_tpu_torch")
        assert set(ref["ops"]) == set(port["ops"]), (
            sorted(set(ref["ops"]) ^ set(port["ops"]))[:20])
        gap = set(ref["methods"]) - set(port["methods"])
        assert not gap, f"Tensor methods the port lacks: {sorted(gap)}"

    def test_shared_names_keep_their_categories(self):
        for n in set(JR) & set(TR):
            if JR[n].category in ("unary", "binary"):
                assert TR[n].category == JR[n].category, n


# -- the registry sweep -----------------------------------------------------


@pytest.mark.parametrize("name", shared_ops())
def test_registry_sweep(name):
    check_sweep(name)
