"""The port's parameter-server tables (``distributed/ps.py``) against the
JAX package's, case for case with ``tests/test_ps.py``.

Tables are drawn from ``numpy.random.default_rng(seed)`` in both
packages, so they start bit-equal. Each case runs both packages on the
same ids: SelectedRows ``merge`` / ``to_dense``; the sparse gradient
against a dense ``nn.Embedding`` oracle and against the JAX package's,
for a host table and a table on the (CPU) device; the rows-gradient's
shape for a 100k-row table with no device bytes; each sparse optimizer
moving only the touched rows, to the JAX package's values (``1e-6``);
SGD against the dense oracle; lazy Adam's per-row step counts;
``AsyncLookup``; the recsys end-to-end losses against the JAX package's
(``1e-6`` relative) and the dense oracle; the single-process
``DistributedSparseEmbedding``. The 2-process vocab-sharded lookup and
push go through the port's launcher over gloo (marked ``slow``, as the
reference's is): the looked-up rows and the trained table equal the
single-process JAX run's within 1e-6.
"""

import json
import os
import textwrap

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.distributed import ps as JP
from paddle_tpu_torch.distributed import ps as TP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ((J, JP), (T, TP))


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def rows_np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


class TestSelectedRows:
    def test_merge_accumulates_duplicates(self):
        for _, ps in PKGS:
            m = ps.SelectedRows([3, 1, 3], np.array([[1.0], [2.0], [4.0]]),
                                height=5).merge()
            assert m.ids.tolist() == [1, 3]
            np.testing.assert_allclose(rows_np(m.rows), [[2.0], [5.0]])

    def test_merge_on_device_rows(self):
        import torch
        m = TP.SelectedRows(torch.tensor([3, 1, 3]),
                            torch.tensor([[1.0], [2.0], [4.0]]), 5).merge()
        assert isinstance(m.rows, torch.Tensor)
        assert m.ids.tolist() == [1, 3]
        np.testing.assert_allclose(m.to_dense()[[1, 3]], [[2.0], [5.0]])

    def test_to_dense(self):
        for p, ps in PKGS:
            sel = ps.SelectedRows([0, 2], np.array([[1.0, 1.0], [2.0, 2.0]]),
                                  height=4)
            d = sel.to_dense()
            assert d.shape == (4, 2)
            assert d[1].tolist() == [0, 0] and d[2].tolist() == [2, 2]
            np.testing.assert_array_equal(
                ps.get_tensor_from_selected_rows(sel).numpy(), d)


class TestSparseEmbedding:
    @pytest.mark.parametrize("host", [True, False])
    def test_sparse_grad_matches_dense_oracle_and_jax(self, host):
        V, D = 200, 6
        ids = np.array([[5, 9, 5], [150, 0, 9]])
        grads = []
        for p, ps in PKGS:
            emb = ps.SparseEmbedding(V, D, host=host, seed=3)
            dense = p.nn.Embedding(V, D)
            dense.weight.set_value(emb.weight.copy())
            out = emb(p.to_tensor(ids))
            np.testing.assert_allclose(out.numpy(),
                                       dense(p.to_tensor(ids)).numpy(),
                                       rtol=1e-6)
            (out * out).sum().backward()
            sd = emb.sparse_grad().merge().to_dense()
            out_d = dense(p.to_tensor(ids))
            (out_d * out_d).sum().backward()
            np.testing.assert_allclose(sd, dense.weight.grad.numpy(),
                                       rtol=1e-5, atol=1e-6)
            grads.append(sd)
        np.testing.assert_allclose(grads[1], grads[0], rtol=1e-6, atol=1e-8)

    def test_dense_gradient_never_materialized(self):
        """The rows-gradient has O(batch) shape, not O(vocab)."""
        for p, ps in PKGS:
            emb = ps.SparseEmbedding(100000, 16, host=True)
            out = emb(p.to_tensor(np.array([1, 2, 3])))
            out.sum().backward()
            sel = emb.sparse_grad()
            assert tuple(sel.rows.shape) == (3, 16)
            assert emb.device_bytes() == 0
        dev = TP.SparseEmbedding(1000, 16, host=False)
        assert dev.device_bytes() == 1000 * 16 * 4

    def test_padding_free_forward_shapes(self):
        for p, ps in PKGS:
            emb = ps.SparseEmbedding(10, 4)
            out = emb(p.to_tensor(np.array([[1, 2], [3, 4], [5, 6]])))
            assert list(out.shape) == [3, 2, 4]


class TestSparseOptimizers:
    @pytest.mark.parametrize("host", [True, False])
    @pytest.mark.parametrize("opt", ["SparseSGD", "SparseAdagrad",
                                     "SparseAdam"])
    def test_only_touched_rows_change(self, opt, host):
        after = []
        for p, ps in PKGS:
            emb = ps.SparseEmbedding(50, 4, host=host, seed=5)
            before = emb.weight.copy()
            out = emb(p.to_tensor(np.array([2, 7, 2])))
            (out * out).sum().backward()
            getattr(ps, opt)(emb, learning_rate=0.1).step()
            diff = np.abs(emb.weight - before).sum(1)
            assert set(np.where(diff > 0)[0].tolist()) == {2, 7}
            after.append(emb.weight)
        np.testing.assert_allclose(after[1], after[0], rtol=1e-6, atol=1e-8)

    def test_sgd_matches_dense_oracle(self):
        V, D, lr = 30, 4, 0.05
        ids = np.array([1, 4, 1, 9])
        for p, ps in PKGS:
            emb = ps.SparseEmbedding(V, D, host=True, seed=9)
            dense = p.nn.Embedding(V, D)
            dense.weight.set_value(emb.weight.copy())
            opt_d = p.optimizer.SGD(learning_rate=lr,
                                    parameters=dense.parameters())
            for _ in range(3):
                out = emb(p.to_tensor(ids))
                (out * out).sum().backward()
                ps.SparseSGD(emb, lr).step()
                out_d = dense(p.to_tensor(ids))
                (out_d * out_d).sum().backward()
                opt_d.step()
                opt_d.clear_grad()
            np.testing.assert_allclose(emb.weight, dense.weight.numpy(),
                                       rtol=1e-4, atol=1e-6)

    @pytest.mark.parametrize("host", [True, False])
    def test_adam_lazy_rows_advance_independently(self, host):
        for p, ps in PKGS:
            if p is J and not host:
                continue
            emb = ps.SparseEmbedding(10, 2, host=host, seed=0)
            opt = ps.SparseAdam(emb, learning_rate=0.1)
            for ids in ([1, 2], [1]):
                out = emb(p.to_tensor(np.array(ids)))
                out.sum().backward()
                opt.step()
            t = rows_np(opt._t)
            assert t[1] == 2 and t[2] == 1 and t[3] == 0


class TestAsyncLookup:
    def test_prefetch_roundtrip(self):
        for _, ps in PKGS:
            emb = ps.SparseEmbedding(20, 3, host=True, seed=2)
            al = ps.AsyncLookup(emb)
            al.prefetch(np.array([4, 5]))
            with pytest.raises(RuntimeError):
                al.prefetch(np.array([1]))     # one in flight at a time
            ids, rows = al.take()
            np.testing.assert_allclose(rows.numpy(), emb.weight[[4, 5]],
                                       rtol=1e-6)
            with pytest.raises(RuntimeError):
                al.take()

    def test_worker_error_reraises_from_take(self):
        emb = TP.SparseEmbedding(20, 3, host=True, seed=2)
        al = TP.AsyncLookup(emb)
        emb._table = None                 # the worker's gather fails
        al.prefetch(np.array([1]))
        with pytest.raises(TypeError):
            al.take()


def recsys(p, ps, host, steps=5, V=64, D=8, H=16):
    """tests/test_ps.py's recsys model: a sparse embedding and a dense
    tower trained with SGD; returns the losses and the final table."""
    rng = np.random.default_rng(0)
    xs = rng.integers(0, V, (20, 3)).astype(np.int64)
    ys = rng.random((20, 1)).astype(np.float32)
    p.seed(42)
    tower = p.nn.Sequential(p.nn.Linear(3 * D, H), p.nn.ReLU(),
                            p.nn.Linear(H, 1))
    emb = ps.SparseEmbedding(V, D, host=host, seed=11)
    opt = p.optimizer.SGD(learning_rate=0.1, parameters=tower.parameters())
    emb_opt = ps.SparseSGD(emb, 0.1)
    return tower, emb, opt, emb_opt, xs, ys


class TestRecsysEndToEnd:
    @pytest.mark.parametrize("host", [True, False])
    def test_losses_match_jax_and_dense_oracle(self, host):
        runs = []
        J.seed(42)
        jt = J.nn.Sequential(J.nn.Linear(24, 16), J.nn.ReLU(),
                             J.nn.Linear(16, 1))
        sd = {k: np.array(v.numpy()) for k, v in jt.state_dict().items()}
        for p, ps in PKGS:
            tower, emb, opt, emb_opt, xs, ys = recsys(p, ps, host)
            tower.set_state_dict(sd)
            losses = []
            for _ in range(5):
                e = emb(p.to_tensor(xs))
                pred = tower(p.reshape(e, [20, 24]))
                loss = ((pred - p.to_tensor(ys)) ** 2).mean()
                loss.backward()
                emb_opt.step()
                opt.step()
                opt.clear_grad()
                losses.append(float(loss.numpy()))
            runs.append((losses, emb.weight))
        (lj, wj), (lt, wt) = runs
        np.testing.assert_allclose(lt, lj, rtol=1e-6)
        np.testing.assert_allclose(wt, wj, rtol=1e-6, atol=1e-9)
        assert lt[-1] < lt[0]

        # the port's dense oracle: nn.Embedding in the SGD's parameters
        tower, emb, _, _, xs, ys = recsys(T, TP, host)
        tower.set_state_dict(sd)
        emb_d = T.nn.Embedding(64, 8)
        emb_d.weight.set_value(emb.weight.copy())
        opt_d = T.optimizer.SGD(learning_rate=0.1, parameters=list(
            tower.parameters()) + [emb_d.weight])
        dense = []
        for _ in range(5):
            pred = tower(T.reshape(emb_d(T.to_tensor(xs)), [20, 24]))
            loss = ((pred - T.to_tensor(ys)) ** 2).mean()
            loss.backward()
            opt_d.step()
            opt_d.clear_grad()
            dense.append(float(loss.numpy()))
        np.testing.assert_allclose(lt, dense, rtol=1e-4, atol=1e-6)


class TestDistributedSparseEmbedding:
    def test_single_process_matches_local(self):
        rng = np.random.default_rng(3)
        full = (rng.standard_normal((32, 4)) * 0.01).astype(np.float32)
        for p, ps in PKGS:
            d = ps.DistributedSparseEmbedding(32, 4, host=True, seed=3)
            np.testing.assert_allclose(d.local.weight, full, rtol=1e-6)
            ids = p.to_tensor(np.array([1, 31, 5]))
            out = ps.distributed_lookup_table(d, ids)
            np.testing.assert_allclose(out.numpy(), full[[1, 31, 5]],
                                       rtol=1e-6)
            (out * out).sum().backward()
            ps.distributed_push_sparse(d, ps.SparseSGD(d.local, 0.1))
            np.testing.assert_allclose(d.weight_full()[1],
                                       full[1] * (1 - 0.2), rtol=1e-6)

    @pytest.mark.slow
    def test_two_process_sharded_lookup_and_push(self, tmp_path):
        """2 ranks through the port's launcher over gloo: vocab sharded,
        the lookup summed by all_reduce, each rank pushing its own rows;
        rows and trained table equal the single-process JAX run's."""
        from paddle_tpu_torch.distributed.launch.main import (_parse,
                                                              launch_procs)
        script = tmp_path / "ps_train.py"
        script.write_text(textwrap.dedent(f"""
            import json, sys
            sys.path.insert(0, {REPO!r})
            import numpy as np
            import torch
            torch.set_num_threads(1)
            import paddle_tpu_torch as paddle
            from paddle_tpu_torch.distributed import collective as C
            from paddle_tpu_torch.distributed.ps import (
                DistributedSparseEmbedding, SparseSGD,
                distributed_push_sparse)
            paddle.set_device("cpu")
            C.init_parallel_env(timeout=60)
            table = DistributedSparseEmbedding(16, 4, host=True, seed=21)
            ids = paddle.to_tensor(np.array([1, 9, 1, 14]))
            rows = []
            for _ in range(3):
                out = table(ids)
                rows.append(out.numpy().tolist())
                (out * out).sum().backward()
                distributed_push_sparse(table, SparseSGD(table.local, 0.1))
            got = table.weight_full()
            with open({str(tmp_path)!r} + f"/out{{C.get_rank()}}.json",
                      "w") as f:
                json.dump({{"rows": rows, "table": got.tolist()}}, f)
            C.barrier()
        """))
        rc = launch_procs(_parse(["--nproc_per_node", "2", "--max_restart",
                                  "0", "--elastic_timeout", "60",
                                  "--log_dir", str(tmp_path / "log"),
                                  str(script)]))
        logs = [(tmp_path / "log" / f"workerlog.{k}").read_text()
                for k in range(2)]
        assert rc == 0, logs
        emb = JP.SparseEmbedding(16, 4, host=True, seed=21)
        rng = np.random.default_rng(21)
        emb.set_weight((rng.standard_normal((16, 4)) * 0.01).astype(
            np.float32))
        want_rows = []
        for _ in range(3):
            out = emb(J.to_tensor(np.array([1, 9, 1, 14])))
            want_rows.append(out.numpy())
            (out * out).sum().backward()
            JP.SparseSGD(emb, 0.1).step()
        for k in range(2):
            o = json.loads((tmp_path / f"out{k}.json").read_text())
            np.testing.assert_allclose(o["rows"], want_rows, rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(o["table"], emb.weight, rtol=0,
                                       atol=1e-6)
