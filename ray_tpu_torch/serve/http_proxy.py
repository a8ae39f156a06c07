"""HTTP ingress: an HTTP/1.1 server inside an actor, routing requests to
deployment replicas via DeploymentHandles.

Reference analog: serve/_private/http_proxy.py:189,333 HTTPProxyActor
(uvicorn ASGI there; aiohttp in the JAX package's copy,
``ray_tpu/serve/http_proxy.py``).  The port's is written on the standard
library's ``asyncio.start_server``, since the card's machine has no
aiohttp, and answers as the JAX package's does for the same request:

* routing by the longest route prefix, ``"/"`` the catch-all; a path no
  route takes gives 404 ``{"error": "no route for <path>"}``;
* a body is passed as JSON, or as text where it is not JSON; a bodiless
  request passes its query as a dict (first value of a repeated key),
  or None;
* the reply is ``{"result": result}`` for a JSON-able result and
  ``{"result": repr(result)}`` otherwise; a deployment's exception gives
  500 ``{"error": repr(e)}``.  Bodies are ``json.dumps`` of the object,
  as aiohttp's ``json_response`` writes them.

The server speaks HTTP/1.1 with keep-alive (HTTP/1.0 closes unless the
client asks to keep alive), ``Content-Length`` and chunked request
bodies and ``Expect: 100-continue``; each connection is one task, so
requests on different connections run at once, each blocking
``handle.call`` on the loop's executor.  Like the rest of the serve
control plane, this module imports no torch.
"""

from __future__ import annotations

import asyncio
import http
import json
import threading
import urllib.parse
from typing import Any, Dict, Optional, Tuple

#: the longest request head (request line and headers) accepted
_MAX_HEAD = 64 * 1024
#: a request's body, whole, at most
_MAX_BODY = 64 * 1024 * 1024


class _BadRequest(Exception):
    pass


def _match_route(routes: Dict[str, str], path: str) -> Optional[str]:
    """The deployment of the longest prefix that takes ``path``."""
    for prefix, dep in sorted(routes.items(), key=lambda kv: -len(kv[0])):
        if path == prefix or path.startswith(
                prefix.rstrip("/") + "/") or prefix == "/":
            return dep
    return None


def _json_body(obj: Any) -> bytes:
    return json.dumps(obj).encode("utf-8")


async def _read_head(reader: asyncio.StreamReader
                     ) -> Optional[Tuple[str, str, str, Dict[str, str]]]:
    """(method, target, version, headers) of the next request on the
    connection; None at a clean end of the stream."""
    try:
        raw = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial.strip():
            return None
        raise _BadRequest("truncated request head")
    except asyncio.LimitOverrunError:
        raise _BadRequest("request head too long")
    lines = raw.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise _BadRequest(f"bad request line {lines[0]!r}")
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep or not name or name != name.strip():
            raise _BadRequest(f"bad header line {line!r}")
        key = name.lower()
        value = value.strip()
        headers[key] = (headers[key] + ", " + value) if key in headers \
            else value
    return parts[0], parts[1], parts[2], headers


async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
    body = bytearray()
    while True:
        line = await reader.readuntil(b"\r\n")
        size_text = line.split(b";", 1)[0].strip()
        try:
            size = int(size_text, 16)
        except ValueError:
            raise _BadRequest(f"bad chunk size {size_text!r}")
        if size == 0:
            # trailers, up to the blank line that ends the body
            while (await reader.readuntil(b"\r\n")) != b"\r\n":
                pass
            return bytes(body)
        if len(body) + size > _MAX_BODY:
            raise _BadRequest("request body too large")
        body += await reader.readexactly(size)
        if await reader.readexactly(2) != b"\r\n":
            raise _BadRequest("chunk not ended by CRLF")


async def _read_body(reader: asyncio.StreamReader, headers: Dict[str, str]
                     ) -> Optional[bytes]:
    """The request's body, or None where it has none (aiohttp's
    ``can_read_body`` false: no length, a zero length, or no chunk)."""
    if "chunked" in headers.get("transfer-encoding", "").lower():
        body = await _read_chunked(reader)
        return body or None
    length = headers.get("content-length")
    if length is None:
        return None
    try:
        n = int(length)
    except ValueError:
        raise _BadRequest(f"bad Content-Length {length!r}")
    if n < 0 or n > _MAX_BODY:
        raise _BadRequest(f"bad Content-Length {n}")
    return (await reader.readexactly(n)) if n else None


def _response(status: int, body: bytes, keep_alive: bool,
              content_type: str = "application/json; charset=utf-8"
              ) -> bytes:
    head = [f"HTTP/1.1 {status} {http.HTTPStatus(status).phrase}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}"]
    if not keep_alive:
        head.append("Connection: close")
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body


class HTTPProxyActor:
    def __init__(self, controller, host: str = "127.0.0.1",
                 port: int = 8000):
        self._controller = controller
        self.host = host
        self.port = port
        self._handles: Dict[str, Any] = {}
        self._routes: Dict[str, str] = {}
        self._routes_at = 0.0
        self._routes_ttl = 2.0
        self._routes_lock = threading.Lock()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._error: Optional[BaseException] = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="http_proxy")
        self._thread.start()
        self._started.wait(timeout=30)
        if self._error is not None:
            raise self._error

    def _refresh_routes(self):
        """Blocking controller round trip — call off the event loop."""
        import time

        import ray_tpu_torch

        with self._routes_lock:
            if time.monotonic() - self._routes_at < self._routes_ttl:
                return
            table = ray_tpu_torch.get(
                self._controller.get_routing_table.remote(), timeout=30)
            self._routes = table["routes"]
            self._routes_at = time.monotonic()

    def _handle_for(self, deployment: str):
        from ray_tpu_torch.serve.handle import DeploymentHandle

        if deployment not in self._handles:
            self._handles[deployment] = DeploymentHandle(
                deployment, self._controller)
        return self._handles[deployment]

    async def _dispatch(self, target: str, body: Optional[bytes]
                        ) -> Tuple[int, bytes]:
        loop = asyncio.get_running_loop()
        split = urllib.parse.urlsplit(target)
        path = urllib.parse.unquote(split.path) or "/"
        await loop.run_in_executor(None, self._refresh_routes)
        dep = _match_route(self._routes, path)
        if dep is None:
            return 404, _json_body({"error": f"no route for {path}"})
        if body is not None:
            try:
                payload = json.loads(body.decode("utf-8"))
            except (UnicodeDecodeError, ValueError):
                payload = body.decode()
        else:
            query: Dict[str, str] = {}
            for k, v in urllib.parse.parse_qsl(split.query,
                                               keep_blank_values=True):
                query.setdefault(k, v)
            payload = query or None
        handle = self._handle_for(dep)
        try:
            result = await loop.run_in_executor(
                None, lambda: handle.call(payload, timeout=60))
        except Exception as e:  # noqa: BLE001 - the caller's 500
            return 500, _json_body({"error": repr(e)})
        if isinstance(result, (dict, list, str, int, float, bool,
                               type(None))):
            return 200, _json_body({"result": result})
        return 200, _json_body({"result": repr(result)})

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    head = await _read_head(reader)
                    if head is None:
                        return
                    method, target, version, headers = head
                    conn = headers.get("connection", "").lower()
                    keep_alive = ("close" not in conn) if \
                        version == "HTTP/1.1" else ("keep-alive" in conn)
                    if headers.get("expect", "").lower() == \
                            "100-continue":
                        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                    body = await _read_body(reader, headers)
                except (_BadRequest, asyncio.IncompleteReadError,
                        asyncio.LimitOverrunError) as e:
                    writer.write(_response(
                        400, f"Bad Request: {e}".encode(), False,
                        "text/plain; charset=utf-8"))
                    await writer.drain()
                    return
                try:
                    status, out = await self._dispatch(target, body)
                except UnicodeDecodeError:
                    # a body that is neither JSON nor UTF-8 text
                    status, out = 500, b"500 Internal Server Error"
                writer.write(_response(status, out, keep_alive))
                await writer.drain()
                if not keep_alive:
                    return
        except ConnectionError:
            return
        finally:
            writer.close()

    def _serve(self):
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            self._server = loop.run_until_complete(asyncio.start_server(
                self._connection, self.host, self.port, limit=_MAX_HEAD,
                reuse_address=True))
        except OSError as e:  # the port is taken: the actor fails
            self._error = e
            self._started.set()
            return
        if self.port == 0:  # bound to a free port: report it
            self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        loop.run_forever()

    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def ping(self) -> bool:
        return self._started.is_set() and self._error is None
