"""The registry sweep shared by the port's op tests: every op name
registered in BOTH registries goes through both public ops, on the
example calls of ``paddle_tpu/ops/sweep_specs.py`` (``attach_specs``) for
composite ops, and on sampled inputs in each op's safe domain for the
elementwise ``unary`` / ``binary`` ops.

Forward fp32 must agree within 1e-5 of the reference's max-abs
(``max|port - jax| <= 1e-5 * max|jax|``); the gradient of ``sum(out)``
within ``1e-4 * max(max|g|, 1e-2)`` where the op is differentiable (the
floor: that gradient is zero analytically for softmax and the norms, and
both packages return rounding noise), an input that gets no gradient
counting as a zero one; the samples keep 0.1 away from each op's kinks and
ties (``KINKS``), so no subgradient choice enters; integer and bool
outputs exactly (values: JAX's 32-bit default makes some integer outputs
int32 where Paddle and the port give int64). Ops that draw random numbers,
run on the host by design, or differ in a documented way are listed in
``NOT_SWEPT`` with the reason.

``test_torch_ops.py`` sweeps the earlier modules' ops; each family of the
op library (``FAMILIES``) is swept in its own test file, so the workers
share the load.
"""

import numpy as np

import paddle_tpu as J
import paddle_tpu.distributed.fleet.layers.mpu.mp_layers  # noqa: F401
import paddle_tpu.distributed.moe_utils  # noqa: F401 — registers its ops
import paddle_tpu.distributed.ps  # noqa: F401 — registers its ops
import paddle_tpu.incubate.nn.functional  # noqa: F401 — registers its ops
import paddle_tpu.metric  # noqa: F401
import paddle_tpu.nn.functional  # noqa: F401
import paddle_tpu.optimizer.ops  # noqa: F401
import paddle_tpu.vision.ops  # noqa: F401 — registers the detection ops
import paddle_tpu_torch as T
import paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers  # noqa: F401
import paddle_tpu_torch.distributed.moe_utils  # noqa: F401
import paddle_tpu_torch.distributed.ps  # noqa: F401
import paddle_tpu_torch.fft  # noqa: F401
import paddle_tpu_torch.incubate.nn.functional  # noqa: F401
import paddle_tpu_torch.metric  # noqa: F401
import paddle_tpu_torch.nn.functional  # noqa: F401
import paddle_tpu_torch.optimizer.ops  # noqa: F401
import paddle_tpu_torch.signal  # noqa: F401
import paddle_tpu_torch.vision.ops  # noqa: F401
from paddle_tpu.core.dispatch import OP_REGISTRY as JR
from paddle_tpu.ops.sweep_specs import attach_specs
from paddle_tpu_torch.core.dispatch import OP_REGISTRY as TR, op_module

attach_specs()

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
# the scale of a gradient comparison is at least this: the gradient of
# sum(out) is zero analytically for softmax and the norms, and both
# packages then return rounding noise of ~1e-7
GRAD_FLOOR = 1e-2


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


# reason each shared op is not swept against JAX
NOT_SWEPT = {
    **{n: "random draws (torch generator, not jax.random)" for n in (
        "rand", "randn", "standard_normal", "normal", "uniform", "randint",
        "randint_like", "randperm", "bernoulli", "bernoulli_", "poisson",
        "multinomial", "exponential_", "uniform_", "normal_", "rand_like",
        "randn_like", "seed", "get_rng_state", "set_rng_state", "dropout",
        "dropout2d", "dropout3d", "alpha_dropout", "feature_alpha_dropout",
        "gumbel_softmax", "rrelu", "binomial", "standard_gamma",
        "pca_lowrank", "svd_lowrank", "shuffle_batch", "sampling_id",
        "uniform_random_batch_size_like", "gaussian_random_batch_size_like",
        "log_normal")},
    **{n: "order and phase are not unique; held by A V = V diag(w) and "
          "the sorted eigenvalues in test_torch_linalg.py"
       for n in ("eig", "eigvals")},
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
    **{n: "the example call downsamples, where the reference's "
          "jax.image.resize antialiases (and its cubic takes a = -0.5): "
          "ROADMAP §C; held to Paddle's formulas, and to JAX where JAX "
          "follows them, in test_torch_resample.py"
       for n in ("interpolate", "linear_interp", "bilinear_interp",
                 "bicubic_interp", "trilinear_interp")},
}

DOMAINS = {
    "log": (0.3, 3.0), "log2": (0.3, 3.0), "log10": (0.3, 3.0),
    "log1p": (-0.6, 3.0), "sqrt": (0.1, 4.0), "rsqrt": (0.1, 4.0),
    "asin": (-0.9, 0.9), "acos": (-0.9, 0.9), "atanh": (-0.9, 0.9),
    "acosh": (1.1, 3.0), "erfinv": (-0.9, 0.9), "lgamma": (0.2, 3.0),
    "digamma": (0.2, 3.0), "tan": (-1.2, 1.2), "reciprocal": (0.3, 3.0),
    "divide": (0.3, 3.0), "floor_divide": (0.5, 4.0), "remainder": (0.5, 4.0),
    "elementwise_pow": (0.3, 2.0), "fmod": (0.5, 4.0),
    # the special functions' domains (as tests/test_op_sweep.py's): real,
    # finite, and where JAX defines the derivative
    "entr": (0.1, 2.0), "ndtri": (0.1, 0.9), "igamma": (0.3, 3.0),
    "igammac": (0.3, 3.0), "gammainc": (0.3, 3.0), "gammaincc": (0.3, 3.0),
    "xlogy": (0.3, 3.0), "xlog1py": (0.3, 3.0), "kl_div": (0.3, 3.0),
    "rel_entr": (0.3, 3.0), "zeta": (1.5, 3.0), "betaln": (0.3, 3.0),
    "erfcx": (-1.5, 1.5), "logaddexp2": (-2.0, 2.0),
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
    "increment",
    # JAX has no derivative here (it raises): betainc in a and b, and
    # geqrf; betainc's x gradient is held in test_torch_special_ops.py
    "betainc", "geqrf"}


def _no_grad(name, args, kwargs):
    """Whether the gradient of this example call is left uncompared:
    ``NO_GRAD``, and QR where JAX defines no derivative (a wide matrix, or
    the complete factors of a non-square one)."""
    if name in NO_GRAD:
        return True
    if name == "qr":
        m, n = np.shape(args[0])[-2:]
        mode = kwargs.get("mode", args[1] if len(args) > 1 else "reduced")
        return m < n or (mode == "complete" and m != n)
    return False


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


# the test file that sweeps each module of the port's op library, by the
# module that defines the op (``dispatch.op_module``); the other modules'
# ops stay in test_torch_ops.py
FAMILIES = {
    **{"paddle_tpu_torch.ops." + m: f for m, f in (
        ("special", "special"), ("windows", "special"),
        ("extras", "extended"), ("extended", "extended"),
        ("sets", "extended"), ("array", "extended"),
        ("inplace", "extended"), ("legacy", "legacy"),
        ("sequence", "legacy"), ("decode", "legacy"), ("linalg", "linalg"),
        ("quant", "linalg"))},
    "paddle_tpu_torch.fft": "special", "paddle_tpu_torch.signal": "special",
    "paddle_tpu_torch.nn.functional.loss": "losses",
    "paddle_tpu_torch.incubate.nn.functional": "incubate",
    "paddle_tpu_torch.distributed.moe_utils": "incubate",
    # the two registered model-parallel ops sweep beside the MoE ones
    "paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers": "incubate",
    "paddle_tpu_torch.optimizer.ops": "optimizer",
    "paddle_tpu_torch.sparse": "sparse",
    "paddle_tpu_torch.sparse.nn_conv": "sparse"}
# by name, where a module's ops are split: the resampling ops of
# nn.functional.common, the losses test_torch_ops.py swept before the rest
# of their module was ported, and sparse_attention
OP_FAMILIES = {
    **{n: "resample" for n in (
        "interpolate", "upsample", "linear_interp", "bilinear_interp",
        "nearest_interp", "bicubic_interp", "trilinear_interp",
        "pixel_shuffle", "pixel_unshuffle", "channel_shuffle")},
    **{n: None for n in ("cross_entropy", "mse_loss", "ctc_loss")},
    # nn.functional's public name for the sparse package's attention
    "sparse_attention": "sparse"}


def family(name):
    """The sweep file of ``name`` (None: test_torch_ops.py)."""
    if name in OP_FAMILIES:
        return OP_FAMILIES[name]
    return FAMILIES.get(op_module(name))


def shared_ops(fam=None):
    """The swept names of one family (None: the earlier modules')."""
    names = []
    for n in sorted(set(JR) & set(TR)):
        if n in NOT_SWEPT or n.endswith("_") or family(n) != fam:
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


def check_sweep(name):
    """One registry-sweep case: ``name`` through both packages' public ops
    on each of its example calls, outputs and gradients compared."""
    d = JR[name]
    legs = _elementwise_legs(name) if d.category in ("unary", "binary") \
        else _spec_legs(name)
    for args, kwargs in legs:
        want = _leaves(_public(J, name)(*_call_args(J, args), **kwargs))
        got = _leaves(_public(T, name)(*_call_args(T, args), **kwargs))
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            close(g, w, what=f"{name} output {i}")
        if _no_grad(name, args, kwargs) or not any(
                isinstance(a, np.ndarray) and a.dtype.kind == "f"
                for a in args):
            continue
        gj = _grads(J, name, args, kwargs)
        gt = _grads(T, name, args, kwargs)
        assert len(gt) == len(gj), name
        for i, (a, b) in enumerate(zip(gj, gt)):
            close(b, a, rtol=GRAD_RTOL, what=f"{name} grad {i}",
                  floor=GRAD_FLOOR)
