"""``paddle.distributed.rpc`` — counterpart of
``paddle_tpu/distributed/rpc.py`` (``init_rpc``, ``rpc_sync``,
``rpc_async``, ``shutdown``, ``get_worker_info``,
``get_all_worker_infos``).

The transport is the rendezvous store (:mod:`.store`): requests and
responses are pickled payloads under store keys, and each worker runs a
serving thread that takes its numbered requests in order. Every thread
opens its own client connection (a connection carries one request at a
time). Functions travel by reference, so they must be module-level.
Every wait is bounded: a reply not there within ``timeout`` seconds (120
by default) raises ``TimeoutError``.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional

from .store import TCPStore

__all__ = ["init_rpc", "rpc_sync", "rpc_async", "shutdown",
           "get_worker_info", "get_all_worker_infos", "WorkerInfo"]

_DEFAULT_TIMEOUT = 120.0
_POLL = 1.0


@dataclass
class WorkerInfo:
    name: str
    rank: int
    ip: str = "127.0.0.1"
    port: int = 0


class _RpcState:
    def __init__(self):
        self.store = None          # rank 0's also hosts the server
        self.host = None
        self.port = 0
        self.name = None
        self.rank = -1
        self.world_size = 0
        self.server_thread = None
        self.workers: Dict[str, WorkerInfo] = {}
        self.tls = threading.local()


_state = _RpcState()


def _client() -> TCPStore:
    """This thread's own store connection."""
    c = getattr(_state.tls, "client", None)
    if c is None:
        c = TCPStore(_state.host, _state.port)
        _state.tls.client = c
    return c


def _take(store: TCPStore, key: str, timeout: Optional[float]) -> bytes:
    """Wait for ``key`` (at most ``timeout`` s; None: forever, polling),
    read it and delete it."""
    if timeout is None:
        while True:
            try:
                store.wait(key, _POLL)
                break
            except TimeoutError:
                continue
    else:
        store.wait(key, timeout)
    raw = store.get(key)
    store.delete_key(key)
    return raw


def _serve(state: _RpcState):
    store = _client()
    seq = 0
    while True:
        req = pickle.loads(_take(store, f"__rpc/{state.name}/req/{seq}",
                                 None))
        if req.get("op") == "__shutdown__":
            return
        try:
            fn = req["fn"]
            result = ("ok", fn(*req.get("args", ()), **req.get("kwargs", {})))
        except Exception as e:  # noqa: BLE001 — errors travel to the caller
            result = ("err", f"{type(e).__name__}: {e}")
        store.set(f"__rpc/{state.name}/res/{seq}", pickle.dumps(result))
        seq += 1


def init_rpc(name: str, rank: Optional[int] = None,
             world_size: Optional[int] = None,
             master_endpoint: Optional[str] = None) -> None:
    """Join the RPC group. Rank 0 hosts the store at ``master_endpoint``
    (``host:port``; port 0 picks a free one on the host)."""
    if _state.store is not None:
        raise RuntimeError("init_rpc already called; shutdown() first")
    rank = int(rank if rank is not None
               else os.environ.get("PADDLE_TRAINER_ID", 0))
    world_size = int(world_size if world_size is not None
                     else os.environ.get("PADDLE_TRAINERS_NUM", 1))
    endpoint = master_endpoint or os.environ.get("PADDLE_MASTER",
                                                 "127.0.0.1:0")
    host, port = endpoint.rsplit(":", 1)
    store = TCPStore(host, int(port), is_master=(rank == 0))
    _state.store = store
    _state.host = host
    _state.port = store.port
    _state.tls = threading.local()
    _state.tls.client = store       # the main thread keeps this connection
    _state.name = name
    _state.rank = rank
    _state.world_size = world_size
    store.set(f"__rpc/worker/{rank}",
              pickle.dumps(WorkerInfo(name, rank, host, store.port)))
    _state.server_thread = threading.Thread(
        target=_serve, args=(_state,), daemon=True)
    _state.server_thread.start()
    for r in range(world_size):
        key = f"__rpc/worker/{r}"
        store.wait(key, _DEFAULT_TIMEOUT)
        info: WorkerInfo = pickle.loads(store.get(key))
        _state.workers[info.name] = info
    store.barrier("__rpc_init", world_size, _DEFAULT_TIMEOUT)


def _check_ready():
    if _state.store is None:
        raise RuntimeError("call paddle.distributed.rpc.init_rpc first")


def _send(to: str, fn, args, kwargs) -> int:
    _check_ready()
    if to not in _state.workers:
        raise ValueError(f"unknown worker {to!r}; known: "
                         f"{sorted(_state.workers)}")
    c = _client()
    seq = c.add(f"__rpc/{to}/seq", 1) - 1
    c.set(f"__rpc/{to}/req/{seq}",
          pickle.dumps({"fn": fn, "args": args, "kwargs": kwargs or {}}))
    return seq


def _recv(to: str, seq: int, timeout: float):
    t = _DEFAULT_TIMEOUT if timeout is None or timeout < 0 else timeout
    status, value = pickle.loads(_take(_client(), f"__rpc/{to}/res/{seq}", t))
    if status == "err":
        raise RuntimeError(f"rpc to {to!r} failed remotely: {value}")
    return value


def rpc_sync(to: str, fn, args=(), kwargs=None, timeout: float = -1):
    """Run ``fn(*args, **kwargs)`` on worker ``to`` and return its
    result."""
    return _recv(to, _send(to, fn, args, kwargs), timeout)


def rpc_async(to: str, fn, args=(), kwargs=None, timeout: float = -1) -> Future:
    """Like ``rpc_sync`` but returns a Future (``.wait()`` /
    ``.result()``)."""
    seq = _send(to, fn, args, kwargs)
    fut: Future = Future()

    def waiter():
        try:
            fut.set_result(_recv(to, seq, timeout))
        except Exception as e:  # noqa: BLE001
            fut.set_exception(e)

    threading.Thread(target=waiter, daemon=True).start()
    fut.wait = fut.result       # the reference's name
    return fut


def get_worker_info(name: Optional[str] = None) -> WorkerInfo:
    _check_ready()
    return _state.workers[_state.name if name is None else name]


def get_all_worker_infos() -> List[WorkerInfo]:
    _check_ready()
    return sorted(_state.workers.values(), key=lambda w: w.rank)


def shutdown(graceful: bool = True) -> None:
    """Stop serving, after every worker got here when ``graceful``; rank 0
    keeps the store up until every worker has stopped its server."""
    if _state.store is None:
        return
    store = _state.store
    if graceful:
        store.barrier("__rpc_shutdown", _state.world_size, _DEFAULT_TIMEOUT)
    seq = store.add(f"__rpc/{_state.name}/seq", 1) - 1
    store.set(f"__rpc/{_state.name}/req/{seq}",
              pickle.dumps({"op": "__shutdown__"}))
    _state.server_thread.join(timeout=10)
    if graceful:
        store.barrier("__rpc_shutdown_done", _state.world_size,
                      _DEFAULT_TIMEOUT)
        if _state.rank == 0:        # the server outlives every client's wait
            while store.add("__rpc_closed", 0) < _state.world_size - 1:
                time.sleep(0.01)
        else:
            store.add("__rpc_closed", 1)
    store.close()
    _state.store = None
    _state.workers.clear()
    _state.tls = threading.local()
