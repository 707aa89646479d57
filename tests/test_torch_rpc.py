"""The port's ``distributed.rpc`` against ``tests/test_surface.py``'s
``TestRPC`` (a forked second worker: sync, async, a self-call, a remote
error, the worker infos), and the store's blocking calls (``wait``,
``add``, ``check``, ``barrier``) beside its non-blocking ``get``.

The child is forked and does no torch compute (a forked child that runs
torch's thread pool can hang): it runs only store traffic and Python
arithmetic. Every join and every wait has a timeout.
"""

import multiprocessing as mp
import threading
import time

import pytest

from paddle_tpu_torch.distributed import rpc
from paddle_tpu_torch.distributed.store import TCPStore


def _rpc_double(x):
    return x * 2


def _rpc_raise():
    raise ValueError("remote boom")


def _free_port() -> int:
    probe = TCPStore("127.0.0.1", 0, is_master=True)
    port = probe.port
    probe.close()
    return port


class TestRPC:
    def test_sync_async_and_errors(self):
        ep = f"127.0.0.1:{_free_port()}"

        def child():
            rpc.init_rpc("worker1", rank=1, world_size=2, master_endpoint=ep)
            rpc.shutdown()

        p = mp.get_context("fork").Process(target=child)
        p.start()
        rpc.init_rpc("worker0", rank=0, world_size=2, master_endpoint=ep)
        try:
            assert rpc.rpc_sync("worker1", _rpc_double, args=(21,)) == 42
            fut = rpc.rpc_async("worker1", _rpc_double, args=(5,))
            assert fut.wait() == 10
            assert rpc.rpc_sync("worker0", _rpc_double, args=(1,)) == 2
            with pytest.raises(RuntimeError, match="remote boom"):
                rpc.rpc_sync("worker1", _rpc_raise)
            with pytest.raises(ValueError, match="unknown worker"):
                rpc.rpc_sync("worker9", _rpc_double, args=(1,))
            infos = rpc.get_all_worker_infos()
            assert [w.name for w in infos] == ["worker0", "worker1"]
            assert rpc.get_worker_info().rank == 0
            assert rpc.get_worker_info("worker1").rank == 1
        finally:
            rpc.shutdown()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        assert p.exitcode == 0
        with pytest.raises(RuntimeError, match="init_rpc first"):
            rpc.rpc_sync("worker1", _rpc_double, args=(1,))


class TestStoreBlockingCalls:
    def test_wait_add_check_barrier(self):
        master = TCPStore("127.0.0.1", 0, is_master=True, timeout=10)
        client = TCPStore("127.0.0.1", master.port, timeout=10)
        try:
            # get stays non-blocking: a missing key raises at once
            t0 = time.monotonic()
            with pytest.raises(KeyError):
                client.get("missing")
            assert time.monotonic() - t0 < 5
            assert not client.check("k")
            with pytest.raises(TimeoutError):
                client.wait("k", timeout=0.2)
            threading.Timer(0.2, lambda: master.set("k", b"v")).start()
            client.wait(["k"], timeout=10)
            assert client.check("k") and client.get("k") == b"v"
            assert client.add("n", 2) == 2 and master.add("n", 3) == 5
            assert client.add("n", 0) == 5
            # a two-party barrier releases both
            done = []
            th = threading.Thread(target=lambda: (
                master.barrier("b", 2, timeout=10), done.append(1)))
            th.start()
            time.sleep(0.1)
            assert not done
            client.barrier("b", 2, timeout=10)
            th.join(timeout=10)
            assert done == [1]
        finally:
            client.close()
            master.close()
