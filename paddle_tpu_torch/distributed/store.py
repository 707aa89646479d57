"""The rendezvous key-value store — counterpart of the JAX package's native
``TCPStore`` (``native/tcp_store.cc``, reached through
``paddle_tpu.native``).

The port runs ``torch.distributed.TCPStore``: the launcher hosts it
(``is_master=True`` on port 0, the real port read back) and every worker
connects as a client. :class:`TCPStore` keeps the reference's spelling of
the calls :mod:`.elastic` and the launcher make: ``set`` / ``get`` /
``delete_key`` / ``close`` and the ``port`` attribute. ``get`` of a missing key raises ``KeyError`` at once
(torch's ``get`` would block until the key appears).
"""

from __future__ import annotations

import datetime
from typing import Union

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

    def delete_key(self, key: str) -> bool:
        return bool(self._live().delete_key(key))

    def close(self) -> None:
        """Drop the connection (the server stops with the master's
        object). Idempotent."""
        self._store = None
