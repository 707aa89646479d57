"""The port's tensor-parallel layers, sequence parallelism, the RNG
tracker and recompute against the JAX package, case for case with
``tests/test_mp.py`` (its 34 tests).

Both packages run the hybrid mesh dp 2 x mp 4: the JAX package on its
8-device CPU mesh, the port over the placement ``["cpu"] * 8``. Each case
builds the JAX layer, loads its weights into the port's twin by name
(``set_state_dict``: an mp layer's state dict is the full logical
weight), feeds both the same numpy inputs from a seed and compares, and
also holds the port to the reference test's own oracle (the serial
layer). The reference's ``shard_map`` cases run through the port's
per-coordinate region (``distributed.shard_map``), whose transpose rules
are JAX's. Tolerances: forwards and gradients within 1e-5 absolute (the
reference's own), the CE through the region within 1e-4 (the
reference's), exact equality where the reference asserts it.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import paddle_tpu as J
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.jax_compat import shard_map as jshard_map
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet.layers import mpu as jmpu
from paddle_tpu.distributed.fleet.layers.mpu import mp_ops as jmp_ops
from paddle_tpu.distributed.fleet.utils import sequence_parallel_utils as jspu
from paddle_tpu.distributed.fleet.recompute import recompute as jrecompute
from paddle_tpu.distributed.topology import \
    set_hybrid_communicate_group as jset_hcg

import paddle_tpu_torch as T
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.distributed import PartitionSpec as P, shard_map
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.fleet.layers import mpu as tmpu
from paddle_tpu_torch.distributed.fleet.layers.mpu import mp_ops as tmp_ops
from paddle_tpu_torch.distributed.fleet.utils import \
    sequence_parallel_utils as tspu
from paddle_tpu_torch.distributed.fleet.recompute import recompute
from paddle_tpu_torch.distributed.topology import \
    set_hybrid_communicate_group as tset_hcg

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


@pytest.fixture
def mp_mesh():
    """dp 2 x mp 4 on both packages; yields the port's group."""
    for fl, dev in ((jfleet, None), (tfleet, ["cpu"] * 8)):
        st = fl.DistributedStrategy()
        st.hybrid_configs = {"dp_degree": 2, "mp_degree": 4, "pp_degree": 1}
        if dev is None:
            fl.init(is_collective=True, strategy=st)
        else:
            fl.init(is_collective=True, strategy=st, devices=dev)
    yield tfleet.get_hybrid_communicate_group()
    jset_hcg(None)
    tset_hcg(None)


def rng(seed=0):
    return np.random.default_rng(seed)


def twin(jl, tl):
    tl.set_state_dict(jl.state_dict())
    return jl, tl


def clone_linear(p, nn, src, in_f, out_f):
    dst = nn.Linear(in_f, out_f)
    dst.weight.set_value(src.weight.numpy())
    dst.bias.set_value(src.bias.numpy())
    return dst


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


class TestColumnRowParallel:
    def test_column_gather_fwd_bwd(self, mp_mesh):
        J.seed(0)
        jc, tc = twin(jmpu.ColumnParallelLinear(16, 32, gather_output=True),
                      tmpu.ColumnParallelLinear(16, 32, gather_output=True))
        ts = clone_linear(T, tnn, tc, 16, 32)
        a = rng().standard_normal((4, 16)).astype("float32")
        outs = []
        for p, layer in ((J, jc), (T, tc), (T, ts)):
            x = p.to_tensor(a, stop_gradient=False)
            y = layer(x)
            y.sum().backward()
            outs.append((y.numpy(), layer.weight.grad.numpy(),
                         layer.bias.grad.numpy(), x.grad.numpy()))
        for got, want in zip(outs[1], outs[0]):
            close(got, want)
        for got, want in zip(outs[1], outs[2]):
            close(got, want)
        # each mp coordinate holds only its column block
        assert {tuple(v.shape) for v in tc.weight.locals.values()} == {(16, 8)}

    def test_column_row_pair(self, mp_mesh):
        J.seed(0)
        jc, tc = twin(jmpu.ColumnParallelLinear(16, 32, gather_output=False),
                      tmpu.ColumnParallelLinear(16, 32, gather_output=False))
        jr, tr = twin(jmpu.RowParallelLinear(32, 16, input_is_parallel=True),
                      tmpu.RowParallelLinear(32, 16, input_is_parallel=True))
        s1, s2 = clone_linear(T, tnn, tc, 16, 32), clone_linear(T, tnn, tr, 32, 16)
        a = rng(1).standard_normal((4, 16)).astype("float32")
        want = jr(JF.relu(jc(J.to_tensor(a)))).numpy()
        got = tr(TF.relu(tc(T.to_tensor(a)))).numpy()
        close(got, want)
        close(got, s2(TF.relu(s1(T.to_tensor(a)))).numpy())

    def test_row_standalone(self, mp_mesh):
        J.seed(0)
        jr, tr = twin(jmpu.RowParallelLinear(32, 16, input_is_parallel=False),
                      tmpu.RowParallelLinear(32, 16, input_is_parallel=False))
        ser = clone_linear(T, tnn, tr, 32, 16)
        a = rng(2).standard_normal((4, 32)).astype("float32")
        got = tr(T.to_tensor(a)).numpy()
        close(got, jr(J.to_tensor(a)).numpy())
        close(got, ser(T.to_tensor(a)).numpy())

    def test_divisibility_check(self, mp_mesh):
        for mpu in (jmpu, tmpu):
            with pytest.raises(ValueError, match="not divisible"):
                mpu.ColumnParallelLinear(16, 30)
            with pytest.raises(ValueError, match="not divisible"):
                mpu.RowParallelLinear(30, 16)

    def test_mp_transformer_trains_identically(self, mp_mesh):
        """An MLP block at mp 4 and serial, three SGD steps, on both
        packages: the four loss trajectories agree."""
        def block(p, nn, mpu, F, parallel):
            class Block(nn.Layer):
                def __init__(self):
                    super().__init__()
                    if parallel:
                        self.fc1 = mpu.ColumnParallelLinear(
                            16, 64, gather_output=False)
                        self.fc2 = mpu.RowParallelLinear(
                            64, 16, input_is_parallel=True)
                    else:
                        self.fc1 = nn.Linear(16, 64)
                        self.fc2 = nn.Linear(64, 16)

                def forward(self, x):
                    return self.fc2(F.gelu(self.fc1(x)))
            return Block()

        J.seed(3)
        jm = block(J, jnn, jmpu, JF, True)
        sd = {k: v.numpy() for k, v in jm.state_dict().items()}
        models = [(J, jm), (J, block(J, jnn, jmpu, JF, False)),
                  (T, block(T, tnn, tmpu, TF, True)),
                  (T, block(T, tnn, tmpu, TF, False))]
        xs = rng(4).standard_normal((3, 8, 16)).astype("float32")
        losses = []
        for p, m in models:
            m.set_state_dict(sd)
            opt = p.optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
            rec = []
            for i in range(3):
                loss = (m(p.to_tensor(xs[i])) ** 2).mean()
                loss.backward()
                opt.step()
                opt.clear_grad()
                rec.append(float(loss))
            losses.append(rec)
        for rec in losses[1:]:
            close(rec, losses[0])
        # the distributed weights stepped as the serial ones did
        for k, v in models[2][1].state_dict().items():
            close(v.numpy(), models[3][1].state_dict()[k].numpy())


class TestVocabParallelEmbedding:
    def test_parity(self, mp_mesh):
        J.seed(0)
        je, te = twin(jmpu.VocabParallelEmbedding(64, 8),
                      tmpu.VocabParallelEmbedding(64, 8))
        ser = tnn.Embedding(64, 8)
        ser.weight.set_value(te.weight.numpy())
        ids = rng(5).integers(0, 64, (4, 7))
        got = te(T.to_tensor(ids)).numpy()
        np.testing.assert_array_equal(got, je(J.to_tensor(ids)).numpy())
        np.testing.assert_array_equal(got, ser(T.to_tensor(ids)).numpy())
        assert {tuple(v.shape) for v in te.weight.locals.values()} == {(16, 8)}

    def test_vocab_divisibility(self, mp_mesh):
        for mpu in (jmpu, tmpu):
            with pytest.raises(ValueError, match="not divisible"):
                mpu.VocabParallelEmbedding(63, 8)

    def test_shard_map_masked_lookup(self, mp_mesh):
        """The Megatron masked lookup inside an explicit region, the layer
        given the region's local weight."""
        J.seed(0)
        je = jmpu.VocabParallelEmbedding(64, 8)
        full_w = je.weight.numpy()
        ids = rng(6).integers(0, 64, (4, 7))

        def make(p, nn, cls, w):
            emb = object.__new__(cls)
            nn.Layer.__init__(emb)
            emb.axis, emb.num_embeddings = "mp", 64
            emb.embedding_dim, emb.world_size = 8, 4
            emb._parameters["weight"] = w
            return emb

        def jbody(w_local, ids_rep):
            from paddle_tpu.core.tensor import _wrap_value
            emb = make(J, jnn, jmpu.VocabParallelEmbedding, _wrap_value(w_local))
            return emb(_wrap_value(ids_rep))._raw

        want = jshard_map(jbody, mesh=jfleet.get_hybrid_communicate_group().mesh,
                          in_specs=(JP("mp", None), JP()), out_specs=JP(),
                          check_vma=False)(jnp.asarray(full_w), jnp.asarray(ids))

        def tbody(w_local, ids_rep):
            return make(T, tnn, tmpu.VocabParallelEmbedding, w_local)(ids_rep)

        got = shard_map(tbody, mesh=mp_mesh.mesh,
                        in_specs=(P("mp", None), P()), out_specs=P())(
            T.to_tensor(full_w), T.to_tensor(ids))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), full_w[ids])


class TestParallelCrossEntropy:
    def test_parity_gspmd(self, mp_mesh):
        logits = rng(7).standard_normal((6, 64)).astype("float32")
        lab = rng(8).integers(0, 64, (6, 1))
        want = jmpu.ParallelCrossEntropy()(J.to_tensor(logits),
                                           J.to_tensor(lab)).numpy()
        got = tmpu.ParallelCrossEntropy()(T.to_tensor(logits),
                                          T.to_tensor(lab))
        assert list(got.shape) == [6, 1]
        close(got.numpy(), want)
        close(got.numpy()[:, 0], TF.cross_entropy(
            T.to_tensor(logits), T.to_tensor(lab), reduction="none").numpy())

    def test_parity_shard_map(self, mp_mesh):
        logits = rng(9).standard_normal((6, 64)).astype("float32")
        lab = rng(10).integers(0, 64, (6, 1))

        def jbody(lg_local, lb):
            from paddle_tpu.core.tensor import _wrap_value
            return jmpu.ParallelCrossEntropy()(_wrap_value(lg_local),
                                               _wrap_value(lb))._raw

        want = jshard_map(jbody, mesh=jfleet.get_hybrid_communicate_group().mesh,
                          in_specs=(JP(None, "mp"), JP()), out_specs=JP(),
                          check_vma=False)(jnp.asarray(logits), jnp.asarray(lab))
        got = shard_map(lambda lg, lb: tmpu.ParallelCrossEntropy()(lg, lb),
                        mesh=mp_mesh.mesh, in_specs=(P(None, "mp"), P()),
                        out_specs=P())(T.to_tensor(logits), T.to_tensor(lab))
        close(got.numpy(), np.asarray(want), 1e-4)
        close(got.numpy()[:, 0], TF.cross_entropy(
            T.to_tensor(logits), T.to_tensor(lab), reduction="none").numpy(),
            1e-4)


class TestMpOpsShardMap:
    def test_split_concat_roundtrip_and_grads(self, mp_mesh):
        x = rng(11).standard_normal((4, 32)).astype("float32")

        def jf(v):
            def body(vl):
                return jmp_ops._concat_last(jmp_ops._split_last(vl, "mp"), "mp")
            return jshard_map(body, mesh=jfleet.get_hybrid_communicate_group().mesh,
                              in_specs=JP(), out_specs=JP(),
                              check_vma=False)(v).sum()

        want = jax.grad(jf)(jnp.asarray(x))
        xt = T.to_tensor(x, stop_gradient=False)
        out = shard_map(lambda v: tmp_ops._concat_last(
            tmp_ops._split_last(v, "mp"), "mp"), mesh=mp_mesh.mesh,
            in_specs=P(), out_specs=P())(xt)
        close(out.numpy(), x)
        out.sum().backward()
        close(xt.grad.numpy(), np.asarray(want), 1e-6)
        close(xt.grad.numpy(), np.ones_like(x), 1e-6)

    def test_identity_psum_pairing(self, mp_mesh):
        """c_identity: forward x, backward psum over mp (4 ranks: x4)."""
        x = rng(12).standard_normal(8).astype("float32")

        def jf(v):
            return jshard_map(lambda vl: jmp_ops._identity_psum_bwd(vl, "mp").sum(),
                              mesh=jfleet.get_hybrid_communicate_group().mesh,
                              in_specs=JP(), out_specs=JP(), check_vma=False)(v)

        want = jax.grad(lambda v: jf(v).sum())(jnp.asarray(x))
        xt = T.to_tensor(x, stop_gradient=False)
        shard_map(lambda v: tmp_ops._identity_psum_bwd(v, "mp").sum(),
                  mesh=mp_mesh.mesh, in_specs=P(), out_specs=P())(xt).backward()
        close(xt.grad.numpy(), np.asarray(want), 1e-6)
        close(xt.grad.numpy(), 4.0 * np.ones_like(x), 1e-6)


class TestSequenceParallel:
    def test_scatter_gather_gspmd(self, mp_mesh):
        a = rng(13).standard_normal((8, 4, 6)).astype("float32")
        for spu, p in ((jspu, J), (tspu, T)):
            x = p.to_tensor(a)
            s = spu.ScatterOp.apply(x, axis=0)
            assert list(s.shape) == [8, 4, 6]  # the full logical value
            np.testing.assert_array_equal(spu.GatherOp.apply(s, axis=0).numpy(),
                                          a)

    def test_allgather_reducescatter_shard_map(self, mp_mesh):
        x = rng(14).standard_normal((8, 4)).astype("float32")

        def jbody(vl):
            return jspu._rs_ag(jspu._allgather_rs(vl, "mp", 0), "mp", 0)

        want = jshard_map(jbody, mesh=jfleet.get_hybrid_communicate_group().mesh,
                          in_specs=JP("mp", None), out_specs=JP("mp", None),
                          check_vma=False)(jnp.asarray(x))
        got = shard_map(lambda v: tmp_ops._rs_ag(tmp_ops._allgather_rs(
            v, "mp", 0), "mp", 0), mesh=mp_mesh.mesh,
            in_specs=P("mp", None), out_specs=P("mp", None))(T.to_tensor(x))
        close(got.numpy(), np.asarray(want))
        close(got.numpy(), 4.0 * x)

    def test_sequence_parallel_linears_parity(self, mp_mesh):
        J.seed(0)
        jc, tc = twin(jspu.ColumnSequenceParallelLinear(16, 32, gather_output=False,
                                                        seq_axis=0),
                      tspu.ColumnSequenceParallelLinear(16, 32, gather_output=False,
                                                        seq_axis=0))
        jr, tr = twin(jspu.RowSequenceParallelLinear(32, 16, input_is_parallel=True,
                                                     seq_axis=0),
                      tspu.RowSequenceParallelLinear(32, 16, input_is_parallel=True,
                                                     seq_axis=0))
        s1, s2 = clone_linear(T, tnn, tc, 16, 32), clone_linear(T, tnn, tr, 32, 16)
        a = rng(15).standard_normal((8, 4, 16)).astype("float32")
        outs = []
        for p, spu, F, c, r in ((J, jspu, JF, jc, jr), (T, tspu, TF, tc, tr)):
            o = r(F.relu(c(spu.ScatterOp.apply(p.to_tensor(a), axis=0))))
            outs.append(spu.GatherOp.apply(o, axis=0).numpy())
        close(outs[1], outs[0])
        close(outs[1], s2(TF.relu(s1(T.to_tensor(a)))).numpy())

    def test_mark_parameter(self, mp_mesh):
        for spu, p in ((jspu, J), (tspu, T)):
            t = p.to_tensor(np.zeros(3, np.float32))
            assert not spu.is_sequence_parallel_parameter(t)
            spu.mark_as_sequence_parallel_parameter(t)
            assert spu.is_sequence_parallel_parameter(t)


class TestRNGTracker:
    def test_tracker_streams(self, mp_mesh):
        tmpu.model_parallel_random_seed(1234)
        tr = tmpu.get_rng_state_tracker()
        k1 = tr.next_key()              # the global stream
        with tr.rng_state():
            k2 = tr.next_key()
        k3 = tr.next_key()
        assert len({int(k1), int(k2), int(k3)}) == 3
        # reseeding replays both streams exactly
        tmpu.model_parallel_random_seed(1234)
        assert int(tr.next_key()) == int(k1)
        with tr.rng_state():
            assert int(tr.next_key()) == int(k2)
        # dropout inside rng_state draws from the tracker's stream, which
        # the global stream does not move
        x = T.ones([64])
        tmpu.model_parallel_random_seed(1234)
        with tr.rng_state():
            m1 = TF.dropout(x, 0.5).numpy()
        tmpu.model_parallel_random_seed(1234)
        TF.dropout(x, 0.5)
        with tr.rng_state():
            np.testing.assert_array_equal(TF.dropout(x, 0.5).numpy(), m1)
        # inside a region each mp rank's key differs by its rank
        seen = []

        def body(v):
            seen.append(tr.next_key())
            return v

        shard_map(body, mesh=mp_mesh.mesh, in_specs=P(),
                  out_specs=P())(T.zeros([1]))
        vals = seen[0].vals
        for c, k in vals.items():
            assert int(k) - int(vals[(0,) * 6]) == c[-1]
        # JAX's tracker gives three distinct keys too (the reference oracle)
        jmpu.model_parallel_random_seed(1234)
        jt = jmpu.get_rng_state_tracker()
        j1 = jt.next_key()
        with jt.rng_state():
            j2 = jt.next_key()
        assert not np.array_equal(jax.random.key_data(j1),
                                  jax.random.key_data(j2))

    def test_duplicate_seed_rejected(self, mp_mesh):
        for mpu in (jmpu, tmpu):
            tr = mpu.get_rng_state_tracker()
            tr.reset()
            tr.add("a", 7)
            with pytest.raises(ValueError, match="already exists"):
                tr.add("b", 7)
            with pytest.raises(ValueError, match="already exists"):
                tr.add("a", 8)


def _mlp(p, nn):
    return nn.Sequential(nn.Linear(8, 32), nn.GELU(), nn.Linear(32, 8))


class TestRecompute:
    def test_forward_backward_parity(self):
        J.seed(0)
        jm, tm = twin(_mlp(J, jnn), _mlp(T, tnn))
        a = rng(16).standard_normal((4, 8)).astype("float32")
        res = []
        for p, m, rc in ((J, jm, jrecompute), (T, tm, recompute), (T, tm, None)):
            for q in m.parameters():
                q.clear_grad()
            x = p.to_tensor(a, stop_gradient=False)
            y = rc(m, x) if rc else m(x)
            y.sum().backward()
            res.append([y.numpy(), x.grad.numpy()] +
                       [q.grad.numpy() for q in m.parameters()])
        for got, want in zip(res[1], res[0]):
            close(got, want)
        for got, want in zip(res[1], res[2]):
            close(got, want, 1e-6)

    def test_no_grad_passthrough(self):
        m = _mlp(T, tnn)
        with T.no_grad():
            y = recompute(m, T.to_tensor(np.ones((4, 8), np.float32)))
        assert y.shape == [4, 8] and y.stop_gradient

    def test_dropout_consistent_forward_backward(self):
        """The recomputed pass draws the forward's mask: the gradient is
        nonzero exactly where the output is."""
        for p, nn, rc in ((J, jnn, jrecompute), (T, tnn, recompute)):
            drop = nn.Dropout(0.5)
            drop.train()
            x = p.to_tensor(np.ones((64,), np.float32), stop_gradient=False)
            y = rc(lambda v: drop(v) * 2.0, x)
            y.sum().backward()
            np.testing.assert_array_equal(y.numpy() != 0, x.grad.numpy() != 0)
            np.testing.assert_allclose(x.grad.numpy()[y.numpy() != 0], 4.0)
            assert 0 < (y.numpy() != 0).sum() < 64

    def test_recompute_sequential(self):
        J.seed(0)
        jm, tm = twin(_mlp(J, jnn), _mlp(T, tnn))
        a = rng(17).standard_normal((4, 8)).astype("float32")
        from paddle_tpu.distributed.fleet.recompute import \
            recompute_sequential as jrs
        from paddle_tpu_torch.distributed.fleet.recompute import \
            recompute_sequential as trs
        got = trs({"segments": 2}, list(tm), T.to_tensor(a)).numpy()
        close(got, jrs({"segments": 2}, list(jm), J.to_tensor(a)).numpy())
        close(got, tm(T.to_tensor(a)).numpy(), 1e-6)

    def test_mutating_function_falls_back(self):
        for p, rc in ((J, jrecompute), (T, recompute)):
            state = p.to_tensor(np.zeros(1, np.float32))

            def fn(v):
                state.set_value(state.numpy() + 1)
                return v * 2

            x = p.to_tensor(np.ones(3, np.float32), stop_gradient=False)
            with pytest.warns(RuntimeWarning, match="mutates"):
                y = rc(fn, x)
            close(y.numpy(), 2 * np.ones(3), 1e-6)
            assert float(state.numpy()[0]) == 1.0     # written once


class TestRegionsAndRecompute:
    def test_fleet_recompute_callable_after_utils_import(self):
        import paddle_tpu_torch.distributed.fleet.utils  # noqa: F401
        from paddle_tpu_torch.distributed.fleet.utils import recompute as utils_rc
        assert callable(utils_rc)
        assert callable(tfleet.recompute.recompute)
        assert callable(jfleet.recompute.recompute)

    def test_normally_constructed_layers_in_shard_map(self, mp_mesh):
        """Layers built normally are used inside a region: each coordinate
        computes with its shard."""
        J.seed(0)
        jc, tc = twin(jmpu.ColumnParallelLinear(16, 32, gather_output=False),
                      tmpu.ColumnParallelLinear(16, 32, gather_output=False))
        jr, tr = twin(jmpu.RowParallelLinear(32, 16, input_is_parallel=True),
                      tmpu.RowParallelLinear(32, 16, input_is_parallel=True))
        s1, s2 = clone_linear(T, tnn, tc, 16, 32), clone_linear(T, tnn, tr, 32, 16)
        x = rng(18).standard_normal((4, 16)).astype("float32")

        def jbody(xv):
            from paddle_tpu.core.tensor import _wrap_value
            return jr(JF.relu(jc(_wrap_value(xv))))._raw

        want = jshard_map(jbody, mesh=jfleet.get_hybrid_communicate_group().mesh,
                          in_specs=JP(), out_specs=JP(),
                          check_vma=False)(jnp.asarray(x))
        got = shard_map(lambda v: tr(TF.relu(tc(v))), mesh=mp_mesh.mesh,
                        in_specs=P(), out_specs=P())(T.to_tensor(x)).numpy()
        close(got, np.asarray(want))
        close(got, s2(TF.relu(s1(T.to_tensor(x)))).numpy())

    def test_vocab_embedding_closure_in_shard_map(self, mp_mesh):
        J.seed(0)
        je, te = twin(jmpu.VocabParallelEmbedding(64, 8),
                      tmpu.VocabParallelEmbedding(64, 8))
        ids = rng(19).integers(0, 64, (4, 7))

        def jbody(iv):
            from paddle_tpu.core.tensor import _wrap_value
            return je(_wrap_value(iv))._raw

        want = jshard_map(jbody, mesh=jfleet.get_hybrid_communicate_group().mesh,
                          in_specs=JP(), out_specs=JP(),
                          check_vma=False)(jnp.asarray(ids))
        got = shard_map(lambda v: te(v), mesh=mp_mesh.mesh, in_specs=P(),
                        out_specs=P())(T.to_tensor(ids)).numpy()
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got, te.weight.numpy()[ids])

    def test_parallel_ce_ignore_index_shard_map(self, mp_mesh):
        logits = rng(20).standard_normal((6, 64)).astype("float32")
        lab = rng(21).integers(0, 64, (6, 1))
        lab[2, 0] = -100
        got = shard_map(lambda lg, lb: tmpu.ParallelCrossEntropy()(lg, lb),
                        mesh=mp_mesh.mesh, in_specs=(P(None, "mp"), P()),
                        out_specs=P())(T.to_tensor(logits),
                                       T.to_tensor(lab)).numpy()
        assert got[2, 0] == 0.0
        want = jmpu.ParallelCrossEntropy()(J.to_tensor(logits),
                                           J.to_tensor(lab)).numpy()
        assert want[2, 0] == 0.0
        close(got, want, 1e-4)
        # outside a region too
        got2 = tmpu.ParallelCrossEntropy()(T.to_tensor(logits),
                                           T.to_tensor(lab)).numpy()
        assert got2[2, 0] == 0.0
        close(got2, want)

    def test_recompute_state_cache_hit(self):
        from paddle_tpu_torch.distributed.fleet.recompute.recompute import (
            _STATE_CACHE, _cache_entry)
        m = tnn.Sequential(tnn.Linear(4, 8), tnn.GELU(), tnn.Linear(8, 4))
        x = T.to_tensor(rng(22).standard_normal((2, 4)).astype("float32"))
        recompute(m, x)
        key, sub = _cache_entry(m)
        assert key in _STATE_CACHE and sub in _STATE_CACHE[key]
        y2 = recompute(m, x)        # the cache-hit path
        close(y2.numpy(), m(x).numpy(), 1e-6)

    def test_recompute_raw_output_leaf(self):
        lin = tnn.Linear(4, 4)

        def fn(v):
            y = lin(v)
            return y, y._value * 2      # the second leaf is a raw torch value

        x = T.to_tensor(rng(23).standard_normal((2, 4)).astype("float32"))
        y, raw = recompute(fn, x)
        assert isinstance(y, T.Tensor)
        assert not isinstance(raw, T.Tensor)
        close(raw.detach().numpy(), 2 * y.numpy(), 1e-6)

    def test_recompute_sequential_rejects_multi_args(self):
        from paddle_tpu_torch.distributed.fleet.recompute import \
            recompute_sequential
        m = tnn.Sequential(tnn.Linear(4, 4))
        x = T.to_tensor(np.ones((2, 4), np.float32))
        with pytest.raises(ValueError, match="single activation"):
            recompute_sequential({"segments": 1}, list(m), x, x)

    def test_recompute_sequential_segment_count(self):
        import importlib
        rmod = importlib.import_module(
            "paddle_tpu_torch.distributed.fleet.recompute.recompute")

        class Probe(tnn.Layer):
            def forward(self, x):
                return x + 1

        layers = [Probe() for _ in range(8)]
        n_chunks = []
        real_rc = rmod.recompute
        try:
            rmod.recompute = lambda f, x, **k: (n_chunks.append(1),
                                                real_rc(f, x, **k))[1]
            y = rmod.recompute_sequential(
                {"segments": 3}, layers, T.to_tensor(np.zeros((2, 2), np.float32)))
        finally:
            rmod.recompute = real_rc
        assert len(n_chunks) == 3       # ceil(8 / 3) = 3 a chunk
        close(y.numpy(), 8 * np.ones((2, 2)), 1e-6)


class TestRegionGradients:
    def test_seq_parallel_column_grads_not_scaled(self, mp_mesh):
        """In a region AllGatherOp's reduce-scatter backward replaces
        c_identity's psum (it does not stack on it)."""
        J.seed(0)
        jc, tc = twin(jspu.ColumnSequenceParallelLinear(16, 32, gather_output=False,
                                                        seq_axis=0),
                      tspu.ColumnSequenceParallelLinear(16, 32, gather_output=False,
                                                        seq_axis=0))
        ser = clone_linear(T, tnn, tc, 16, 32)
        x = rng(24).standard_normal((8, 4, 16)).astype("float32")

        def jf(v):
            def body(vl):
                from paddle_tpu.core.tensor import _wrap_value
                return jc(_wrap_value(vl))._raw
            out = jshard_map(body, mesh=jfleet.get_hybrid_communicate_group().mesh,
                             in_specs=JP("mp", None, None),
                             out_specs=JP("mp", None, None), check_vma=False)(v)
            return (out ** 2).sum()

        want = jax.grad(jf)(jnp.asarray(x))
        xt = T.to_tensor(x, stop_gradient=False)
        out = shard_map(lambda v: tc(v), mesh=mp_mesh.mesh,
                        in_specs=P("mp", None, None),
                        out_specs=P("mp", None, None))(xt)
        (out ** 2).sum().backward()
        close(xt.grad.numpy(), np.asarray(want), 1e-4)
        xs = T.to_tensor(x, stop_gradient=False)
        (TF.linear(xs, ser.weight, ser.bias) ** 2).sum().backward()
        close(xt.grad.numpy(), xs.grad.numpy(), 1e-4)

    def test_parallel_ce_trainable_logits_shard_map(self, mp_mesh):
        """The region's max shift is outside the graph, so the CE
        differentiates: d(sum CE)/dlogits = softmax - onehot."""
        logits = rng(25).standard_normal((6, 64)).astype("float32")
        lab = rng(26).integers(0, 64, (6, 1))
        lt = T.to_tensor(logits, stop_gradient=False)
        shard_map(lambda lg, lb: tmpu.ParallelCrossEntropy()(lg, lb),
                  mesh=mp_mesh.mesh, in_specs=(P(None, "mp"), P()),
                  out_specs=P())(lt, T.to_tensor(lab)).sum().backward()

        def jf(lg):
            def body(lg_local, lb):
                from paddle_tpu.core.tensor import _wrap_value
                return jmpu.ParallelCrossEntropy()(
                    _wrap_value(lg_local, stop_gradient=False),
                    _wrap_value(lb))._raw
            return jshard_map(body, mesh=jfleet.get_hybrid_communicate_group().mesh,
                              in_specs=(JP(None, "mp"), JP()), out_specs=JP(),
                              check_vma=False)(lg, jnp.asarray(lab)).sum()

        want = jax.grad(jf)(jnp.asarray(logits))
        close(lt.grad.numpy(), np.asarray(want), 1e-4)
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        close(lt.grad.numpy(), p - np.eye(64)[lab[:, 0]], 1e-4)

    def test_recompute_two_methods_same_object(self, mp_mesh):
        """The state cache keys (object, method): the second method of one
        object is checked and trained on its own."""
        class TwoHeads(tnn.Layer):
            def __init__(self):
                super().__init__()
                self.fc1 = tnn.Linear(8, 8)
                self.fc2 = tnn.Linear(8, 8)

            def head1(self, x):
                return self.fc1(x)

            def head2(self, x):
                return self.fc2(x)

        m = TwoHeads()
        x = T.to_tensor(rng(27).standard_normal((4, 8)).astype("float32"))
        (recompute(m.head1, x) ** 2).mean().backward()
        assert m.fc1.weight.grad is not None and m.fc2.weight.grad is None
        (recompute(m.head2, x) ** 2).mean().backward()
        assert m.fc2.weight.grad is not None
        assert float(np.abs(m.fc2.weight.grad.numpy()).sum()) > 0
        from paddle_tpu_torch.distributed.fleet.recompute.recompute import \
            _STATE_CACHE
        assert len(_STATE_CACHE[m]) == 2
