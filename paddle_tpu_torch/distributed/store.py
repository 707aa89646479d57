"""The rendezvous key-value store — counterpart of the JAX package's native
``TCPStore`` (``native/tcp_store.cc``, reached through
``paddle_tpu.native``).

The port runs ``torch.distributed.TCPStore``: the launcher hosts it
(``is_master=True`` on port 0, the real port read back) and every worker
connects as a client. :class:`TCPStore` keeps the reference's spelling of
the calls :mod:`.elastic`, the launcher and :mod:`.rpc` make: ``set`` /
``get`` / ``delete_key`` / ``close`` and the ``port`` attribute, and the
blocking ``wait`` / ``barrier`` with the counter ``add`` and the probe
``check``. ``get`` of a missing key raises ``KeyError`` at once (torch's
``get`` would block until the key appears); to block for a key, ``wait``
for it first. Every blocking call ends in ``TimeoutError`` after its
timeout (the store's own when none is given).
"""

from __future__ import annotations

import datetime
from typing import Optional, Union

__all__ = ["TCPStore"]


class TCPStore:
    """A client of (or, with ``is_master``, the server of) a TCP store on
    ``host:port``. ``timeout`` bounds the connect and every blocking
    call, in seconds."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, timeout: float = 30.0):
        from torch.distributed import TCPStore as _Store
        self._store = _Store(host, int(port), is_master=is_master,
                             timeout=datetime.timedelta(seconds=timeout),
                             wait_for_workers=False)
        self.host = host
        self.port = int(self._store.port)
        self.timeout = float(timeout)

    def _live(self):
        if self._store is None:
            raise RuntimeError("TCPStore is closed")
        return self._store

    def set(self, key: str, value: Union[str, bytes]) -> None:
        self._live().set(key, value)

    def get(self, key: str) -> bytes:
        store = self._live()
        if not store.check([key]):
            raise KeyError(key)
        return store.get(key)

    def add(self, key: str, amount: int = 1) -> int:
        """Add ``amount`` to the integer at ``key`` (0 when missing);
        returns the new value."""
        return int(self._live().add(key, int(amount)))

    def check(self, key: str) -> bool:
        """Whether ``key`` is set (never blocks)."""
        return bool(self._live().check([key]))

    def wait(self, keys, timeout: Optional[float] = None) -> None:
        """Block until every key of ``keys`` (a key or a list) is set, at
        most ``timeout`` seconds."""
        keys = [keys] if isinstance(keys, str) else list(keys)
        t = self.timeout if timeout is None else float(timeout)
        try:
            self._live().wait(keys, datetime.timedelta(seconds=t))
        except RuntimeError as e:
            if "imeout" not in str(e) and "timed out" not in str(e):
                raise
            raise TimeoutError(f"TCPStore.wait: {keys} not set within "
                               f"{t} s") from e

    def barrier(self, name: str, world_size: int,
                timeout: Optional[float] = None) -> None:
        """Return once ``world_size`` participants have called it."""
        n = self.add(f"__barrier/{name}", 1)
        if n == world_size:
            self.set(f"__barrier/{name}/done", b"1")
        else:
            self.wait(f"__barrier/{name}/done", timeout)

    def delete_key(self, key: str) -> bool:
        return bool(self._live().delete_key(key))

    def close(self) -> None:
        """Drop the connection (the server stops with the master's
        object). Idempotent."""
        self._store = None
