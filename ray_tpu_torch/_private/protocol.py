"""Async RPC protocol used by every cross-process control-plane connection.

The reference uses gRPC + protobuf for all control-plane services (reference
``src/ray/rpc/grpc_server.h``, ``src/ray/protobuf/*.proto``).  We use a
leaner design suited to a Python/asyncio control plane: length-prefixed
msgpack frames over unix-domain or TCP sockets, with three frame kinds —

    REQUEST  {rid, method, payload}   -> awaits a RESPONSE
    RESPONSE {rid, ok, payload|error}
    PUSH     {method, payload}        -> one-way server->client notification
                                         (carries pubsub messages; role of the
                                         reference's long-poll pubsub,
                                         src/ray/pubsub/)

Binary payload values pass through msgpack untouched; rich Python values are
pickled by the caller where needed.  The framing layer never pickles.
"""

from __future__ import annotations

import asyncio
import itertools
import struct
from typing import Any, Awaitable, Callable, Dict, Optional

from ray_tpu_torch._private._vendor import msgpack

_LEN = struct.Struct("<I")

REQUEST = 0
RESPONSE = 1
PUSH = 2

MAX_FRAME = 512 * 1024 * 1024


class RpcError(Exception):
    """Remote handler raised; .remote_traceback carries the server's trace."""

    def __init__(self, message: str, remote_traceback: str = ""):
        super().__init__(message)
        self.remote_traceback = remote_traceback


class ConnectionLost(Exception):
    pass


def _pack(obj) -> bytes:
    body = msgpack.packb(obj, use_bin_type=True)
    return _LEN.pack(len(body)) + body


async def _read_frame(reader: asyncio.StreamReader):
    header = await reader.readexactly(_LEN.size)
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME:
        raise ConnectionLost(f"frame too large: {n}")
    body = await reader.readexactly(n)
    return msgpack.unpackb(body, raw=False)


class Connection:
    """One bidirectional framed connection; usable by clients and servers."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self._rid = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._push_handler: Optional[Callable[[str, Any], None]] = None
        self._request_handler: Optional[
            Callable[[str, Any], Awaitable[Any]]
        ] = None
        self._closed = False
        self._recv_task: Optional[asyncio.Task] = None
        self._send_lock = asyncio.Lock()
        self.on_close: Optional[Callable[["Connection"], None]] = None

    def start(self):
        self._recv_task = asyncio.get_running_loop().create_task(self._recv_loop())

    def set_push_handler(self, fn: Callable[[str, Any], None]):
        self._push_handler = fn

    def set_request_handler(self, fn: Callable[[str, Any], Awaitable[Any]]):
        self._request_handler = fn

    @property
    def closed(self) -> bool:
        return self._closed

    async def call(self, method: str, payload: Any = None, timeout: float | None = None) -> Any:
        if self._closed:
            raise ConnectionLost("connection closed")
        rid = next(self._rid)
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        try:
            await self._send([REQUEST, rid, method, payload])
            return await (
                asyncio.wait_for(fut, timeout) if timeout is not None else fut
            )
        finally:
            self._pending.pop(rid, None)
            if not fut.done():
                fut.cancel()

    async def call_send(self, method: str, payload: Any = None):
        """Send a request and return an awaitable for the response.  Lets a
        caller serialize the *send* (e.g. for ordered actor pushes) while
        awaiting replies concurrently."""
        if self._closed:
            raise ConnectionLost("connection closed")
        rid = next(self._rid)
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut

        async def waiter():
            try:
                return await fut
            finally:
                self._pending.pop(rid, None)

        try:
            await self._send([REQUEST, rid, method, payload])
        except Exception:
            self._pending.pop(rid, None)
            raise
        return waiter()

    async def push(self, method: str, payload: Any = None) -> None:
        if self._closed:
            return
        await self._send([PUSH, 0, method, payload])

    async def _send(self, frame):
        data = _pack(frame)
        async with self._send_lock:
            self.writer.write(data)
            await self.writer.drain()

    async def _recv_loop(self):
        try:
            while True:
                kind, rid, a, b = await _read_frame(self.reader)
                if kind == RESPONSE:
                    fut = self._pending.get(rid)
                    if fut is not None and not fut.done():
                        ok, payload = a, b
                        if ok:
                            fut.set_result(payload)
                        else:
                            err = payload or {}
                            fut.set_exception(
                                RpcError(err.get("message", "remote error"),
                                         err.get("traceback", ""))
                            )
                elif kind == REQUEST:
                    asyncio.get_running_loop().create_task(
                        self._handle_request(rid, a, b)
                    )
                elif kind == PUSH:
                    if self._push_handler is not None:
                        try:
                            self._push_handler(a, b)
                        except Exception:  # noqa: BLE001 - push handlers must not kill the loop
                            pass
        except (asyncio.IncompleteReadError, ConnectionResetError,
                ConnectionLost, BrokenPipeError, OSError):
            pass
        finally:
            await self._shutdown()

    async def _handle_request(self, rid: int, method: str, payload):
        if self._request_handler is None:
            await self._respond(rid, False, {"message": f"no handler for {method}"})
            return
        try:
            result = await self._request_handler(method, payload)
            await self._respond(rid, True, result)
        except Exception as e:  # noqa: BLE001 - errors are returned to the caller
            import traceback

            try:
                await self._respond(
                    rid, False,
                    {"message": f"{type(e).__name__}: {e}",
                     "traceback": traceback.format_exc()},
                )
            except Exception:  # noqa: BLE001
                pass

    async def _respond(self, rid: int, ok: bool, payload):
        try:
            await self._send([RESPONSE, rid, ok, payload])
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass

    async def _shutdown(self):
        if self._closed:
            return
        self._closed = True
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionLost("connection closed"))
        self._pending.clear()
        try:
            self.writer.close()
        except Exception:  # noqa: BLE001
            pass
        if self.on_close is not None:
            try:
                self.on_close(self)
            except Exception:  # noqa: BLE001
                pass

    async def close(self):
        await self._shutdown()
        if self._recv_task is not None:
            self._recv_task.cancel()


class Server:
    """Accepts connections and dispatches REQUEST frames to method handlers.

    Handlers are async callables registered per method name; ``conn`` is
    passed so services can track which client asked (for leases, pubsub
    subscriptions, liveness).
    """

    def __init__(self):
        self._handlers: Dict[str, Callable[[Connection, Any], Awaitable[Any]]] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self.connections: set[Connection] = set()
        self.on_disconnect: Optional[Callable[[Connection], None]] = None

    def route(self, method: str):
        def deco(fn):
            self._handlers[method] = fn
            return fn

        return deco

    def add_routes(self, obj):
        """Register every ``rpc_<name>`` coroutine method of obj as <name>."""
        for attr in dir(obj):
            if attr.startswith("rpc_"):
                self._handlers[attr[4:]] = getattr(obj, attr)

    async def start_unix(self, path: str):
        self._server = await asyncio.start_unix_server(self._on_client, path=path)

    async def start_tcp(self, host: str, port: int) -> int:
        self._server = await asyncio.start_server(self._on_client, host=host, port=port)
        return self._server.sockets[0].getsockname()[1]

    async def _on_client(self, reader, writer):
        conn = Connection(reader, writer)
        self.connections.add(conn)

        async def handle(method, payload):
            fn = self._handlers.get(method)
            if fn is None:
                raise RpcError(f"unknown method {method!r}")
            return await fn(conn, payload)

        def closed(c):
            self.connections.discard(c)
            if self.on_disconnect is not None:
                self.on_disconnect(c)

        conn.set_request_handler(handle)
        conn.on_close = closed
        conn.start()

    async def close(self):
        # Connections first: a handler may be awaiting something that
        # never resolves (a lease grant, a dead peer), and since 3.12
        # Server.wait_closed waits for handlers — closing the transports
        # wakes every remote caller with ConnectionLost immediately.
        for conn in list(self.connections):
            await conn.close()
        if self._server is not None:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(),
                                       timeout=2.0)
            except asyncio.TimeoutError:
                pass  # stuck handler; transports are already closed


async def connect_unix(path: str) -> Connection:
    reader, writer = await asyncio.open_unix_connection(path)
    conn = Connection(reader, writer)
    conn.start()
    return conn


async def connect_tcp(host: str, port: int) -> Connection:
    reader, writer = await asyncio.open_connection(host, port)
    conn = Connection(reader, writer)
    conn.start()
    return conn
