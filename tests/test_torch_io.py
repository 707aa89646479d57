"""The port's datasets, samplers and DataLoader (``paddle_tpu_torch.io``)
against the JAX package's (``paddle_tpu.io``), and the loader's
self-healing under the training chaos injectors.

* Datasets and samplers (``tests/test_io.py``): the same items, lengths,
  orders and, with one seed, the same draws (``random_split``,
  ``RandomSampler``, ``SubsetRandomSampler``, ``DistributedBatchSampler``
  by epoch).
* DataLoader: with ``shuffle=False`` the port yields the batches JAX's
  loader yields (single process and 2 forked workers, both transports,
  ``drop_last``, dicts, iterable datasets split over workers) as CPU
  torch tensors, exactly; worker exceptions, ``get_worker_info`` and
  ``worker_init_fn`` behave as the reference's.
* Chaos (``tests/test_chaos.py:268-363``): a transient bad sample healed
  by a retry; a deterministic one quarantined once and dropped in later
  epochs, across forked-worker epochs without being fetched again; a
  fully quarantined batch skipped; a raise without opt-in; a killed
  worker resurrected with its in-flight batches re-queued (every index
  once, on both transports) or failing fast with its signal named; a
  stalled worker failing at the loader's ``timeout``. Every forked-worker
  test bounds its own wait with ``timeout=``.
* ``prefetch_to_device``: a plain loop on the CPU that closes its source,
  and no quiet CPU run when no device is named and no card exists.
"""

import os
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import io as JIO
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch import io as TIO
from paddle_tpu_torch.testing import chaos as tchaos

torch.set_num_threads(2)

WAIT = 60          # every forked-worker loader's bound on one batch wait


def _square(M):
    class SquareDataset(M.Dataset):
        def __init__(self, n=20):
            self.n = n

        def __getitem__(self, i):
            return np.float32(i), np.float32(i * i)

        def __len__(self):
            return self.n
    return SquareDataset


def _stream(M):
    class Stream(M.IterableDataset):
        def __init__(self, n=17):
            self.n = n

        def __iter__(self):
            for i in range(self.n):
                yield np.float32(i)
    return Stream


def _iota(M):
    class Iota(M.Dataset):
        def __init__(self, n=32, dim=3):
            self.n, self.dim = n, dim

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            return np.full((self.dim,), float(i), np.float32)
    return Iota


def _host(batch):
    """A batch of either package as a tree of numpy arrays."""
    if isinstance(batch, dict):
        return {k: _host(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return [_host(v) for v in batch]
    if isinstance(batch, torch.Tensor):
        return batch.numpy()
    return np.asarray(batch.numpy() if isinstance(batch, paddle.Tensor)
                      else batch)


def _assert_same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert set(x) == set(y)
            _assert_same_batches([x[k] for k in sorted(x)],
                                 [y[k] for k in sorted(y)])
        elif isinstance(x, list):
            _assert_same_batches(x, y)
        else:
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


class TestDatasets:
    def test_tensor_dataset(self):
        a = np.arange(12).reshape(6, 2).astype("float32")
        b = np.arange(6).astype("int64")
        ds = TIO.TensorDataset([torch.from_numpy(a), b])
        jds = JIO.TensorDataset([paddle.to_tensor(a), b])
        assert len(ds) == len(jds) == 6
        for i in range(6):
            _assert_same_batches(list(ds[i]), list(jds[i]))
        with pytest.raises(ValueError):
            TIO.TensorDataset([np.zeros((3, 2)), np.zeros((4,))])
        h = TIO.TensorDataset([torch.ones(2, 2, dtype=torch.bfloat16)])
        assert h[0][0].dtype == np.float32

    def test_concat_subset_split_match_jax(self):
        out = {}
        for side, M in (("jax", JIO), ("port", TIO)):
            sq = _square(M)
            cat = M.ConcatDataset([sq(5), sq(7)])
            sub = M.Subset(cat, [0, 6, 11])
            parts = M.random_split(sq(10), [7, 3],
                                   generator=np.random.default_rng(5))
            fparts = M.random_split(sq(10), [0.5, 0.5],
                                    generator=np.random.default_rng(6))
            out[side] = (len(cat), cat[6], cat[-1], len(sub), sub[1],
                         [p.indices for p in parts],
                         [p.indices for p in fparts])
        assert out["port"] == out["jax"]
        with pytest.raises(ValueError):
            TIO.random_split(_square(TIO)(10), [4, 4])
        with pytest.raises(IndexError):
            TIO.ConcatDataset([_square(TIO)(2)])[5]

    def test_compose_chain(self):
        comp = TIO.ComposeDataset([_square(TIO)(4), _square(TIO)(4)])
        assert len(comp[2]) == 4
        ch = TIO.ChainDataset([_stream(TIO)(3), _stream(TIO)(2)])
        assert len(list(ch)) == 5
        with pytest.raises(TypeError):
            len(_stream(TIO)(3))
        with pytest.raises(ValueError, match="lengths differ"):
            TIO.ComposeDataset([_square(TIO)(4), _square(TIO)(5)])


class TestSamplers:
    def test_orders_and_draws_match_jax(self):
        out = {}
        for side, M in (("jax", JIO), ("port", TIO)):
            ds = _square(M)(10)
            rs = list(M.RandomSampler(ds, generator=np.random.default_rng(1)))
            rr = list(M.RandomSampler(ds, replacement=True, num_samples=6,
                                      generator=np.random.default_rng(2)))
            ss = list(M.SubsetRandomSampler(
                [3, 5, 7, 9], generator=np.random.default_rng(3)))
            bs = [list(M.BatchSampler(ds, batch_size=3, drop_last=d))
                  for d in (False, True)]
            w = list(M.WeightedRandomSampler([0.0, 0.0, 1.0], 8))
            dist = []
            for rank in range(3):
                s = M.DistributedBatchSampler(ds, batch_size=2,
                                              num_replicas=3, rank=rank,
                                              shuffle=True)
                for e in (0, 1):
                    s.set_epoch(e)
                    dist.append([list(b) for b in s])
            out[side] = (list(M.SequenceSampler(ds)), rs, rr, ss, bs, w,
                         dist, len(M.BatchSampler(ds, batch_size=3,
                                                  drop_last=True)))
        assert out["port"] == out["jax"]

    def test_distributed_sampler_defaults_to_one_rank(self):
        """The default replica count is the hybrid group's dp degree, as in
        the reference: one replica with no group set on a CPU-only host
        (dp over the one device the process drives); under a dp-8 group
        (the port's over ``["cpu"] * 8``, JAX's ``fleet.init`` on the
        8-device mesh) both samplers report 8 replicas and rank 0 and
        yield ``[0, 8]`` of 10 items at batch 4."""
        from paddle_tpu.distributed import fleet as jfleet
        from paddle_tpu.distributed.topology import (
            set_hybrid_communicate_group as jset)
        from paddle_tpu_torch.distributed import fleet as tfleet
        from paddle_tpu_torch.distributed.topology import (
            set_hybrid_communicate_group as tset)
        tset(None)
        s = TIO.DistributedBatchSampler(_square(TIO)(10), batch_size=4)
        assert (s.nranks, s.local_rank) == (1, 0)
        assert [i for b in s for i in b] == list(range(10))
        try:
            jfleet.init(is_collective=True)
            tfleet.init(is_collective=True, devices=["cpu"] * 8)
            got = {}
            for side, M in (("port", TIO), ("jax", JIO)):
                s = M.DistributedBatchSampler(_square(M)(10), batch_size=4)
                got[side] = (s.nranks, s.local_rank,
                             [i for b in s for i in b])
            assert got["port"] == got["jax"] == (8, 0, [0, 8])
        finally:
            jset(None)
            tset(None)
        with pytest.raises(ValueError, match="out of range"):
            TIO.DistributedBatchSampler(_square(TIO)(10), batch_size=2,
                                        num_replicas=2, rank=2)


def _jax_batches(ds_fn, **kw):
    """The JAX loader's collated numpy batches (before its Tensor wrap,
    which narrows int64 to int32 with x64 off)."""
    return [_host(b) for b in JIO.DataLoader(ds_fn(JIO), **kw)._raw_batches()]


class TestDataLoader:
    @pytest.mark.parametrize("case", [
        "single", "workers-shared", "workers-pickled", "drop-last",
        "dict", "iterable", "iterable-workers"])
    def test_batches_match_jax(self, case):
        def dict_ds(M):
            class D(M.Dataset):
                def __getitem__(self, i):
                    return {"x": np.float32(i), "y": np.int64(i % 2),
                            "v": np.full((2,), i, np.int32)}

                def __len__(self):
                    return 7
            return D()

        kw, ds = {"batch_size": 5}, (lambda M: _square(M)(23))
        if case == "workers-shared":
            kw.update(num_workers=2, use_shared_memory=True)
        elif case == "workers-pickled":
            kw.update(num_workers=2, use_shared_memory=False)
        elif case == "drop-last":
            kw.update(drop_last=True)
        elif case == "dict":
            kw, ds = {"batch_size": 3}, dict_ds
        elif case.startswith("iterable"):
            kw, ds = {"batch_size": 4}, (lambda M: _stream(M)(21))
            if case.endswith("workers"):
                kw["num_workers"] = 2
        if kw.get("num_workers"):
            kw["timeout"] = WAIT
        want = _jax_batches(ds, **kw)
        got_raw = list(TIO.DataLoader(ds(TIO), **kw))
        leaf = got_raw[0]
        while isinstance(leaf, (list, tuple, dict)):
            leaf = list(leaf.values())[0] if isinstance(leaf, dict) \
                else leaf[0]
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
        _assert_same_batches([_host(b) for b in got_raw], want)

    @pytest.mark.parametrize("shared", [True, False])
    def test_workers_after_parallel_parent_work(self, shared):
        """A parent that ran parallel CPU work before forking (its OpenMP
        pool does not survive the fork) still gets batches large enough
        that a copy of them is split over threads."""
        a = torch.randn(512, 512)
        (a @ a).sum()
        torch.empty(1 << 20).copy_(torch.randn(1 << 20))

        class Rows(TIO.Dataset):
            def __len__(self):
                return 32

            def __getitem__(self, i):
                return np.full((8193,), i, np.int32)

        dl = TIO.DataLoader(Rows(), batch_size=8, num_workers=2,
                            use_shared_memory=shared, timeout=WAIT)
        got = [int(b[:, 0].sum()) for b in dl]
        assert got == [sum(range(8 * j, 8 * j + 8)) for j in range(4)]

    def test_worker_exception_propagates(self):
        class Bad(TIO.Dataset):
            def __getitem__(self, i):
                if i == 3:
                    raise ValueError("boom at 3")
                return np.float32(i)

            def __len__(self):
                return 6

        for shared in (True, False):
            dl = TIO.DataLoader(Bad(), batch_size=2, num_workers=2,
                                use_shared_memory=shared, timeout=WAIT)
            with pytest.raises(RuntimeError, match="boom at 3"):
                list(dl)

    def test_worker_info_and_init_fn(self, tmp_path):
        class WhoAmI(TIO.Dataset):
            def __getitem__(self, i):
                info = TIO.get_worker_info()
                return np.int64(-1 if info is None else info.id)

            def __len__(self):
                return 8

        def init(wid):
            (tmp_path / f"init{wid}").touch()

        ids = np.concatenate([b.numpy() for b in TIO.DataLoader(
            WhoAmI(), batch_size=2, num_workers=2, worker_init_fn=init,
            timeout=WAIT)])
        assert set(ids.tolist()) <= {0, 1}
        assert sorted(os.listdir(tmp_path)) == ["init0", "init1"]
        ids0 = np.concatenate([b.numpy() for b in TIO.DataLoader(
            WhoAmI(), batch_size=2)])
        assert set(ids0.tolist()) == {-1}

        def bad_init(wid):
            raise OSError("no shard for this worker")

        with pytest.raises(RuntimeError, match="no shard"):
            list(TIO.DataLoader(WhoAmI(), batch_size=2, num_workers=2,
                                worker_init_fn=bad_init, timeout=WAIT))

    def test_shuffle_len_and_exclusive_args(self):
        dl = TIO.DataLoader(_square(TIO)(12), batch_size=4, shuffle=True)
        xs = np.concatenate([b[0].numpy() for b in dl])
        assert sorted(xs.tolist()) == list(range(12))
        assert len(TIO.DataLoader(_square(TIO)(10), batch_size=3)) == 4
        with pytest.raises(TypeError):
            len(TIO.DataLoader(_stream(TIO)(10), batch_size=3))
        with pytest.raises(ValueError):
            TIO.DataLoader(_square(TIO)(10), batch_sampler=TIO.BatchSampler(
                _square(TIO)(10), batch_size=2), batch_size=4)
        with pytest.raises(ValueError):
            TIO.DataLoader(_stream(TIO)(10), shuffle=True)

    def test_prefetch_to_device_cpu(self):
        """``prefetch_to_device(device="cpu")`` is a plain convert loop;
        closing the prefetcher closes its source (a loader's workers stop
        with it)."""
        dl = TIO.DataLoader(_square(TIO)(10), batch_size=4, places="cpu")
        got = list(TIO.prefetch_to_device(dl, device="cpu"))
        assert got[0][0].tolist() == [0.0, 1.0, 2.0, 3.0]
        closed = []

        def src():
            try:
                for i in range(5):
                    yield {"a": np.full((2,), i), "b": [torch.ones(1) * i]}
            finally:
                closed.append(True)

        it = TIO.prefetch_to_device(src(), size=2, device="cpu")
        first = next(it)
        assert isinstance(first["a"], torch.Tensor)
        assert first["b"][0].item() == 0
        it.close()
        assert closed == [True]
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                next(TIO.prefetch_to_device(src()))


# ---------------------------------------------------------------------------
# loader chaos (tests/test_chaos.py:268-363) on the port, beside the JAX
# loader where the outcome can be compared
# ---------------------------------------------------------------------------

@pytest.mark.chaos
class TestLoaderChaos:
    def test_bad_sample_transient_healed_by_retry(self):
        for workers in (0, 2):
            ds = tchaos.bad_sample(_iota(TIO)(), [5], fails_each=2)
            dl = TIO.DataLoader(ds, batch_size=4, num_workers=workers,
                                sample_retries=3, sample_retry_backoff=0.001,
                                timeout=WAIT)
            batches = list(dl)
            assert len(batches) == 8 and all(b.shape[0] == 4
                                             for b in batches)
            assert not dl._quarantined

    def test_bad_sample_deterministic_quarantined(self):
        out = {}
        for side, M, C in (("jax", JIO, jchaos), ("port", TIO, tchaos)):
            ds = C.bad_sample(_iota(M)(), [6], fails_each=None)
            kw = {"use_buffer_reader": False} if M is JIO else {}
            dl = M.DataLoader(ds, batch_size=4, sample_retries=1,
                              sample_retry_backoff=0.001, **kw)
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                sizes = [b.shape[0] for b in dl]
                sizes2 = [b.shape[0] for b in dl]
            msgs = [str(x.message) for x in w]
            out[side] = (sizes, sizes2,
                         sum("quarantined" in m for m in msgs),
                         sorted(dl._quarantined))
        assert out["port"] == out["jax"]
        assert out["port"][0].count(3) == 1 and out["port"][2] == 1

    def test_bad_sample_quarantine_persists_across_mp_epochs(self, tmp_path):
        access_dir = tmp_path / "accesses"
        access_dir.mkdir()

        class _Tracked(TIO.Dataset):
            def __len__(self):
                return 32

            def __getitem__(self, i):
                if int(i) == 6:    # fork-shared access ledger on disk
                    n = len(list(access_dir.iterdir()))
                    (access_dir / f"a{n}").touch()
                    raise ValueError("always bad")
                return np.full((3,), float(i), np.float32)

        dl = TIO.DataLoader(_Tracked(), batch_size=4, num_workers=2,
                            sample_retries=1, sample_retry_backoff=0.001,
                            timeout=WAIT)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sizes1 = [b.shape[0] for b in dl]
            assert sizes1.count(3) == 1 and dl._quarantined == {6}
            hits = len(list(access_dir.iterdir()))
            assert hits == 2           # 1 try + 1 retry, then quarantine
            sizes2 = [b.shape[0] for b in dl]
        assert sizes2.count(3) == 1
        assert len(list(access_dir.iterdir())) == hits   # never refetched

    def test_fully_quarantined_batch_skipped_not_fatal(self):
        out = {}
        for side, M, C in (("jax", JIO, jchaos), ("port", TIO, tchaos)):
            ds = C.bad_sample(_iota(M)(), [4, 5, 6, 7], fails_each=None)
            for workers in (0, 2):
                kw = {"timeout": WAIT}
                if M is JIO:
                    kw["use_buffer_reader"] = False
                dl = M.DataLoader(ds, batch_size=4, num_workers=workers,
                                  sample_retries=0,
                                  sample_retry_backoff=0.001,
                                  quarantine_bad_samples=True, **kw)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    f1 = sorted(float(_host(b).ravel()[0]) for b in dl)
                    f2 = sorted(float(_host(b).ravel()[0]) for b in dl)
                assert f1 == f2 and len(f1) == 7 and 4.0 not in f1
                out[(side, workers)] = f1
        assert out[("port", 0)] == out[("port", 2)] == out[("jax", 0)]

    def test_bad_sample_raises_without_optin(self):
        for workers in (0, 2):
            ds = tchaos.bad_sample(_iota(TIO)(), [2], fails_each=None)
            dl = TIO.DataLoader(ds, batch_size=4, num_workers=workers,
                                timeout=WAIT)
            with pytest.raises((ValueError, RuntimeError),
                               match="injected bad sample"):
                list(dl)

    @pytest.mark.parametrize("shared", [True, False])
    def test_dead_worker_resurrected_mid_epoch(self, tmp_path, shared):
        """A SIGKILLed worker is replaced and its in-flight batches
        re-queued: every batch once, in order."""
        ds = tchaos.dead_worker(_iota(TIO)(), at_index=9,
                                marker=str(tmp_path / "died"))
        dl = TIO.DataLoader(ds, batch_size=4, num_workers=2,
                            worker_restarts=2, use_shared_memory=shared,
                            timeout=WAIT)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            firsts = [float(b[0, 0]) for b in dl]
        assert firsts == [0.0, 4.0, 8.0, 12.0, 16.0, 20.0, 24.0, 28.0]
        assert (tmp_path / "died").exists()
        assert any("resurrecting" in str(x.message) for x in w)

    def test_dead_worker_fail_fast_names_signal(self, tmp_path):
        ds = tchaos.dead_worker(_iota(TIO)(), at_index=3,
                                marker=str(tmp_path / "died"))
        dl = TIO.DataLoader(ds, batch_size=4, num_workers=2, timeout=WAIT)
        with pytest.raises(RuntimeError, match="SIGKILL"):
            list(dl)

    def test_stalled_worker_hits_timeout(self):
        class Slow(TIO.Dataset):
            def __len__(self):
                return 8

            def __getitem__(self, i):
                if i == 4:
                    time.sleep(30)
                return np.float32(i)

        dl = TIO.DataLoader(Slow(), batch_size=4, num_workers=2, timeout=1.5)
        t0 = time.time()
        with pytest.raises(RuntimeError, match="timed out after 1.5s"):
            list(dl)
        assert time.time() - t0 < 15
