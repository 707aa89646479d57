"""The port's ``amp`` (``auto_cast``, ``GradScaler``, ``decorate``)
against the JAX package's, case for case with ``tests/test_amp.py``.

Both packages run each case on the same numpy inputs and the same weights
(the port's layers loaded from the JAX layers' ``state_dict()``). The
auto_cast cases check the dtype each op yields in both and the values:
an input cast to bf16 has the same bits in both, bf16 products agree
within one bf16 step of their magnitude (``BF16``: both round an fp32
accumulation once, and the two CPU GEMMs may sum in another order). The
scaler and ``decorate`` cases hold weights, gradients and the scale to
the JAX package's (fp32: ``rtol=1e-6``). ``auto_cast`` over the port's
``LlamaForCausalLM`` at E's width (hidden 512, 8 / 4 heads, 4 layers;
vocab cut to 512) gives a loss within ``5e-3 * |loss|`` and every
gradient within ``5e-3 * max|g|`` of the JAX model's under the same
``auto_cast``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as J
import paddle_tpu_torch as T

BF16 = 2.0 ** -7      # one bf16 step, relative


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def dt(x):
    """The dtype's name in either package."""
    return str(x.dtype).replace("torch.", "")


def f32(x):
    v = x.numpy()
    return np.asarray(v, np.float32)


def both(build):
    """``build(paddle)`` in each package, the port's weights set from the
    JAX layer's."""
    J.seed(0)
    jl = build(J)
    tl = build(T)
    tl.set_state_dict(jl.state_dict())
    return jl, tl


def rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class TestAutoCast:
    def test_white_op_casts_to_bf16(self):
        a, b = rand(4, 8), rand(8, 8, seed=1)
        outs = {}
        for p in (J, T):
            x, w = p.to_tensor(a), p.to_tensor(b)
            with p.amp.auto_cast():
                y = p.matmul(x, w)
                xc = p.cast(x, "float32")      # neither list: unchanged
            assert dt(y) == "bfloat16"
            assert dt(xc) == "float32"
            assert dt(p.matmul(x, w)) == "float32"   # state restored
            outs[p] = f32(y)
        # the inputs cast to bf16 have the same bits in both packages
        jb = np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        import torch
        tb = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(tb, jb)
        err = np.abs(outs[T] - outs[J]).max()
        assert err <= BF16 * np.abs(outs[J]).max(), err

    def test_black_op_stays_fp32(self):
        a = rand(4, 8)
        for p in (J, T):
            x = p.to_tensor(a)
            with p.amp.auto_cast():
                h = p.nn.functional.relu(x)      # neither list
                s = p.nn.functional.softmax(x)   # black: fp32
            assert dt(h) == "float32" and dt(s) == "float32"
        np.testing.assert_allclose(
            f32(T.nn.functional.softmax(T.to_tensor(a))),
            f32(J.nn.functional.softmax(J.to_tensor(a))), rtol=1e-6)

    def test_black_op_upcasts_bf16_input(self):
        a = rand(4, 8)
        outs = []
        for p in (J, T):
            x = p.to_tensor(a).astype("bfloat16")
            with p.amp.auto_cast():
                s = p.nn.functional.softmax(x)
            assert dt(s) == "float32"
            outs.append(f32(s))
        np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-7)

    def test_o2_casts_everything_but_black(self):
        a = rand(4, 8)
        outs = []
        for p in (J, T):
            x = p.to_tensor(a)
            with p.amp.auto_cast(level="O2"):
                h = p.nn.functional.relu(x)
                s = p.nn.functional.softmax(x)
            assert dt(h) == "bfloat16" and dt(s) == "float32"
            outs.append(f32(h))
        np.testing.assert_array_equal(outs[1], outs[0])

    def test_custom_lists(self):
        a = rand(4, 8)
        for p in (J, T):
            x = p.to_tensor(a)
            with p.amp.auto_cast(custom_white_list={"relu"}):
                h = p.nn.functional.relu(x)
            assert dt(h) == "bfloat16"
            with p.amp.auto_cast(custom_black_list={"matmul"}):
                y = p.matmul(x, p.transpose(x, [1, 0]))
            assert dt(y) == "float32"

    def test_disable(self):
        a = rand(4, 8)
        outs = []
        for p in (J, T):
            x = p.to_tensor(a)
            with p.amp.auto_cast(enable=False):
                y = p.matmul(x, p.transpose(x, [1, 0]))
            assert dt(y) == "float32"
            outs.append(f32(y))
        np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("kw", [{"level": "O9"}, {"dtype": "int8"}])
    def test_level_validation(self, kw):
        for p in (J, T):
            with pytest.raises(ValueError):
                with p.amp.auto_cast(**kw):
                    pass

    def test_backward_through_autocast(self):
        jl, tl = both(lambda p: p.nn.Linear(8, 8))
        a = rand(4, 8, seed=2)
        grads = []
        for p, lin in ((J, jl), (T, tl)):
            x = p.to_tensor(a)
            with p.amp.auto_cast():
                loss = (lin(x) ** 2).mean()
            loss.backward()
            g = f32(lin.weight.grad)
            assert dt(lin.weight.grad) == "float32"
            assert np.isfinite(g).all()
            grads.append(g)
        err = np.abs(grads[1] - grads[0]).max()
        assert err <= 2 * BF16 * np.abs(grads[0]).max(), err

    def test_distributed_region_sees_cast_inputs(self):
        """The hook acts on forward_op's region route too: a matmul inside
        ``shard_map`` yields bf16 at every coordinate."""
        from paddle_tpu_torch.distributed.dist_tensor import shard_map
        from paddle_tpu_torch.distributed.topology import build_mesh
        mesh = build_mesh({"dp": 2}, devices=["cpu", "cpu"])
        x = T.to_tensor(rand(4, 8))
        w = T.to_tensor(rand(8, 8, seed=1))

        def body(xs, ws):
            return T.matmul(xs, ws)

        f = shard_map(body, mesh=mesh, in_specs=(("dp", None), (None, None)),
                      out_specs=("dp", None))
        with T.amp.auto_cast():
            y = f(x, w)
        assert dt(y) == "bfloat16"
        want = f32(J.matmul(J.to_tensor(rand(4, 8)).astype("bfloat16"),
                            J.to_tensor(rand(8, 8, seed=1)).astype(
                                "bfloat16")))
        err = np.abs(f32(y) - want).max()
        assert err <= BF16 * np.abs(want).max(), err


def scaler_twins():
    jl, tl = both(lambda p: p.nn.Linear(4, 4))
    jo = J.optimizer.SGD(learning_rate=0.1, parameters=jl.parameters())
    to = T.optimizer.SGD(learning_rate=0.1, parameters=tl.parameters())
    return (J, jl, jo), (T, tl, to)


class TestGradScaler:
    def test_scale_and_step(self):
        a = rand(2, 4, seed=3)
        ws = []
        for p, lin, opt in scaler_twins():
            scaler = p.amp.GradScaler(init_loss_scaling=128.0)
            w0 = f32(lin.weight).copy()
            loss = (lin(p.to_tensor(a)) ** 2).mean()
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            assert not np.allclose(f32(lin.weight), w0)
            ws.append(f32(lin.weight))
        np.testing.assert_allclose(ws[1], ws[0], rtol=1e-6, atol=1e-7)

    def test_unscale_restores_grad_magnitude(self):
        a = rand(2, 4, seed=4)
        gs = []
        for p, lin, opt in scaler_twins():
            scaler = p.amp.GradScaler(init_loss_scaling=1024.0)
            loss = (lin(p.to_tensor(a)) ** 2).mean()
            scaler.scale(loss).backward()
            g_scaled = f32(lin.weight.grad).copy()
            scaler.unscale_(opt)
            np.testing.assert_allclose(f32(lin.weight.grad),
                                       g_scaled / 1024.0, rtol=1e-6)
            gs.append(f32(lin.weight.grad))
        np.testing.assert_allclose(gs[1], gs[0], rtol=1e-6, atol=1e-8)

    def test_inf_skips_step_and_shrinks_scale(self):
        a = rand(2, 4, seed=5)
        for p, lin, opt in scaler_twins():
            scaler = p.amp.GradScaler(init_loss_scaling=256.0)
            w0 = f32(lin.weight).copy()
            loss = (lin(p.to_tensor(a)) ** 2).mean()
            loss.backward()
            lin.weight.grad.set_value(
                np.full_like(f32(lin.weight.grad), np.inf))
            scaler.step(opt)
            scaler.update()
            np.testing.assert_array_equal(f32(lin.weight), w0)  # skipped
            assert scaler.get_init_loss_scaling() == 128.0  # 256 * 0.5

    def test_scale_grows_after_n_good_steps(self):
        a = rand(2, 4, seed=6)
        ws = []
        for p, lin, opt in scaler_twins():
            scaler = p.amp.GradScaler(init_loss_scaling=2.0,
                                      incr_every_n_steps=2)
            for _ in range(2):
                loss = (lin(p.to_tensor(a)) ** 2).mean()
                scaler.scale(loss).backward()
                scaler.step(opt)
                scaler.update()
                opt.clear_grad()
            assert scaler.get_init_loss_scaling() == 4.0
            ws.append(f32(lin.weight))
        np.testing.assert_allclose(ws[1], ws[0], rtol=1e-6, atol=1e-7)

    def test_disabled_passthrough(self):
        a = rand(2, 4, seed=7)
        ws = []
        for p, lin, opt in scaler_twins():
            scaler = p.amp.GradScaler(enable=False)
            loss = (lin(p.to_tensor(a)) ** 2).mean()
            assert scaler.scale(loss) is loss
            loss.backward()
            scaler.step(opt)  # plain step
            scaler.update()
            ws.append(f32(lin.weight))
        np.testing.assert_allclose(ws[1], ws[0], rtol=1e-6, atol=1e-7)

    def test_state_dict_roundtrip(self):
        sds = []
        for p in (J, T):
            s1 = p.amp.GradScaler(init_loss_scaling=99.0)
            s2 = p.amp.GradScaler()
            s2.load_state_dict(s1.state_dict())
            assert s2.get_init_loss_scaling() == 99.0
            sds.append(s2.state_dict())
        assert {k: float(v) for k, v in sds[1].items()} == \
            {k: float(v) for k, v in sds[0].items()}
        # a state written by the JAX package loads into the port's
        s3 = T.amp.GradScaler()
        s3.load_state_dict(sds[0])
        assert s3.get_init_loss_scaling() == 99.0


class TestDecorate:
    def test_o2_casts_params_and_master_weights(self):
        def build(p):
            return p.nn.Sequential(p.nn.Linear(8, 16), p.nn.GELU(),
                                   p.nn.Linear(16, 4))
        jm, tm = both(build)
        a = rand(4, 8, seed=8)
        res = []
        for p, model in ((J, jm), (T, tm)):
            opt = p.optimizer.AdamW(learning_rate=1e-2,
                                    parameters=model.parameters())
            model, opt = p.amp.decorate(model, opt, level="O2")
            assert dt(model[0].weight) == "bfloat16"
            assert opt._multi_precision
            with p.amp.auto_cast(level="O2"):
                loss = (model(p.to_tensor(a)).astype("float32") ** 2).mean()
            loss.backward()
            opt.step()
            assert opt._master_weights
            for mw in opt._master_weights.values():
                assert dt(mw) == "float32"
            res.append((float(loss), [f32(mw) for mw in
                                      opt._master_weights.values()]))
        assert abs(res[1][0] - res[0][0]) <= 2 * BF16 * abs(res[0][0])
        for got, want in zip(res[1][1], res[0][1]):
            # one AdamW step at lr 1e-2 moves a weight by ~lr whatever
            # the gradient's rounding: hold the masters to lr
            assert np.abs(got - want).max() <= 1e-2 + 1e-6

    def test_norm_layers_stay_fp32(self):
        for p in (J, T):
            model = p.nn.Sequential(p.nn.Linear(8, 8), p.nn.LayerNorm(8))
            p.amp.decorate(model, level="O2")
            assert dt(model[0].weight) == "bfloat16"
            assert dt(model[1].weight) == "float32"


class TestEndToEnd:
    def test_amp_training_matches_jax(self):
        """bf16-autocast training in both packages from the same weights:
        the port's losses track the JAX package's (and fp32's)."""
        rng = np.random.default_rng(0)
        xs = rng.standard_normal((5, 8, 16)).astype("float32")
        ys = rng.standard_normal((5, 8, 1)).astype("float32")

        def run(p, m, use_amp):
            o = p.optimizer.SGD(learning_rate=0.05,
                                parameters=m.parameters())
            losses = []
            scaler = p.amp.GradScaler(enable=use_amp)
            for i in range(5):
                x, y = p.to_tensor(xs[i]), p.to_tensor(ys[i])
                with p.amp.auto_cast(enable=use_amp):
                    loss = ((m(x) - y) ** 2).mean()
                scaler.scale(loss).backward()
                scaler.step(o)
                scaler.update()
                o.clear_grad()
                losses.append(float(loss))
            return losses

        def build(p):
            return p.nn.Sequential(p.nn.Linear(16, 32), p.nn.GELU(),
                                   p.nn.Linear(32, 1))
        jm, tm = both(build)
        mixed_j, mixed_t = run(J, jm, True), run(T, tm, True)
        jm, tm = both(build)
        fp32_t = run(T, tm, False)
        assert mixed_t[-1] < mixed_t[0]
        np.testing.assert_allclose(mixed_t, mixed_j, rtol=2e-2, atol=1e-3)
        np.testing.assert_allclose(mixed_t, fp32_t, rtol=0.1, atol=0.05)


def test_supported_answers_for_the_device_asked():
    assert T.amp.is_bfloat16_supported("cpu")
    assert T.amp.is_float16_supported("cpu")
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            T.amp.is_bfloat16_supported("gpu:0")


def test_llama_under_auto_cast_matches_jax():
    from paddle_tpu.models import llama as JL
    from paddle_tpu_torch.models import llama as TL
    from paddle_tpu_torch.models.convert import config_from_jax
    jcfg = JL.LlamaConfig(vocab_size=512, hidden_size=512,
                          intermediate_size=1376, num_hidden_layers=4,
                          num_attention_heads=8, num_key_value_heads=4,
                          max_position_embeddings=64)
    jnet = JL.LlamaForCausalLM(jcfg, key=jax.random.PRNGKey(0))
    tnet = TL.LlamaForCausalLM(config_from_jax(jcfg))
    tnet.set_state_dict(jnet.state_dict())
    r = np.random.default_rng(0)
    ids = r.integers(0, 512, (2, 16)).astype(np.int32)
    labels = r.integers(0, 512, (2, 16)).astype(np.int32)
    out = []
    for p, net in ((J, jnet), (T, tnet)):
        with p.amp.auto_cast():
            loss = net(p.to_tensor(ids), p.to_tensor(labels))
        loss.backward()
        out.append((float(loss), {n: f32(q.grad) for n, q in
                                  net.named_parameters()}))
    (lj, gj), (lt, gt) = out
    assert abs(lt - lj) <= 5e-3 * abs(lj), (lt, lj)
    assert gt.keys() == gj.keys()
    for n in gj:
        err = np.abs(gt[n] - gj[n]).max()
        assert err <= 5e-3 * np.abs(gj[n]).max(), (n, err)
