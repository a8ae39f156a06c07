"""A small HTTP/1.1 server on the standard library's asyncio streams,
shared by the serve proxy (``serve/http_proxy.py``) and the dashboard
(``dashboard/app.py``): the card's machine has no aiohttp, which the JAX
package's copies of both run on.

The server reads a request's head and body, hands a :class:`Request` to
a handler coroutine and writes the :class:`Response` it returns:

* HTTP/1.1 with keep-alive (HTTP/1.0 closes unless the client asks to
  keep alive), ``Content-Length`` and chunked request bodies, and
  ``Expect: 100-continue``;
* a malformed request gets 400 and the connection is closed;
* a handler's unhandled exception gets aiohttp's 500
  (``500 Internal Server Error\\n\\nServer got itself in trouble``,
  ``Connection: close``);
* each connection is one task, so requests on different connections run
  at once.

:class:`Router` routes by method and path as aiohttp's ``UrlDispatcher``
does for the routes the dashboard adds: path parameters ``{name}`` take
one segment (percent-decoded), a GET route also takes HEAD (the body is
left out), a path that no route takes gives ``404: Not Found`` and a
path whose routes take other methods gives ``405: Method Not Allowed``
with an ``Allow`` header.  :class:`ServerThread` runs a handler on its
own event loop in a daemon thread, as both actors do.  This module
imports no torch.
"""

from __future__ import annotations

import asyncio
import http
import json
import threading
import urllib.parse
from typing import (Any, Awaitable, Callable, Dict, List, Optional, Tuple)

#: the longest request head (request line and headers) accepted
MAX_HEAD = 64 * 1024
#: a request's body, whole, at most
MAX_BODY = 64 * 1024 * 1024

JSON_TYPE = "application/json; charset=utf-8"


class BadRequest(Exception):
    pass


class Request:
    """One request as the handler sees it: ``method``, ``headers``
    (lower-case names), ``body`` (None where it has none), ``raw_path``,
    ``path`` (percent-decoded), ``query`` (the first value of each key)
    and ``match_info`` (the route's path parameters, set by
    :class:`Router`)."""

    def __init__(self, method: str, target: str, headers: Dict[str, str],
                 body: Optional[bytes]):
        self.method = method
        self.headers = headers
        self.body = body
        split = urllib.parse.urlsplit(target)
        self.raw_path = split.path or "/"
        self.path = urllib.parse.unquote(self.raw_path)
        self.query: Dict[str, str] = {}
        for k, v in urllib.parse.parse_qsl(split.query,
                                           keep_blank_values=True):
            self.query.setdefault(k, v)
        self.match_info: Dict[str, str] = {}

    def json(self) -> Any:
        """The body as JSON; raises ValueError on an empty or malformed
        body, as aiohttp's ``request.json()`` does."""
        return json.loads((self.body or b"").decode("utf-8"))


class Response:
    def __init__(self, status: int, body: bytes,
                 content_type: str = JSON_TYPE,
                 headers: Optional[List[Tuple[str, str]]] = None):
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = list(headers or [])


def json_response(data: Any, status: int = 200) -> Response:
    """``json.dumps`` of ``data``, as aiohttp's ``json_response``."""
    return Response(status, json.dumps(data).encode("utf-8"))


def text_response(text: str, status: int = 200,
                  content_type: str = "text/plain") -> Response:
    return Response(status, text.encode("utf-8"),
                    f"{content_type}; charset=utf-8")


Handler = Callable[[Request], Awaitable[Response]]


async def read_head(reader: asyncio.StreamReader
                    ) -> Optional[Tuple[str, str, str, Dict[str, str]]]:
    """(method, target, version, headers) of the next request on the
    connection; None at a clean end of the stream."""
    try:
        raw = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial.strip():
            return None
        raise BadRequest("truncated request head")
    except asyncio.LimitOverrunError:
        raise BadRequest("request head too long")
    lines = raw.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise BadRequest(f"bad request line {lines[0]!r}")
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep or not name or name != name.strip():
            raise BadRequest(f"bad header line {line!r}")
        key = name.lower()
        value = value.strip()
        headers[key] = (headers[key] + ", " + value) if key in headers \
            else value
    return parts[0], parts[1], parts[2], headers


async def read_chunked(reader: asyncio.StreamReader) -> bytes:
    body = bytearray()
    while True:
        line = await reader.readuntil(b"\r\n")
        size_text = line.split(b";", 1)[0].strip()
        try:
            size = int(size_text, 16)
        except ValueError:
            raise BadRequest(f"bad chunk size {size_text!r}")
        if size == 0:
            # trailers, up to the blank line that ends the body
            while (await reader.readuntil(b"\r\n")) != b"\r\n":
                pass
            return bytes(body)
        if len(body) + size > MAX_BODY:
            raise BadRequest("request body too large")
        body += await reader.readexactly(size)
        if await reader.readexactly(2) != b"\r\n":
            raise BadRequest("chunk not ended by CRLF")


async def read_body(reader: asyncio.StreamReader, headers: Dict[str, str]
                    ) -> Optional[bytes]:
    """The request's body, or None where it has none (aiohttp's
    ``can_read_body`` false: no length, a zero length, or no chunk)."""
    if "chunked" in headers.get("transfer-encoding", "").lower():
        body = await read_chunked(reader)
        return body or None
    length = headers.get("content-length")
    if length is None:
        return None
    try:
        n = int(length)
    except ValueError:
        raise BadRequest(f"bad Content-Length {length!r}")
    if n < 0 or n > MAX_BODY:
        raise BadRequest(f"bad Content-Length {n}")
    return (await reader.readexactly(n)) if n else None


def encode_response(resp: Response, keep_alive: bool,
                    head_only: bool = False) -> bytes:
    head = [f"HTTP/1.1 {resp.status} {http.HTTPStatus(resp.status).phrase}",
            f"Content-Type: {resp.content_type}"]
    head += [f"{k}: {v}" for k, v in resp.headers]
    head.append(f"Content-Length: {len(resp.body)}")
    if not keep_alive:
        head.append("Connection: close")
    return (("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
            + (b"" if head_only else resp.body))


#: aiohttp's reply to a handler's unhandled exception
_INTERNAL_ERROR = text_response(
    "500 Internal Server Error\n\nServer got itself in trouble", 500)


async def serve_connection(handler: Handler, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
    """Requests on one connection, one after another, until it closes."""
    try:
        while True:
            try:
                head = await read_head(reader)
                if head is None:
                    return
                method, target, version, headers = head
                conn = headers.get("connection", "").lower()
                keep_alive = ("close" not in conn) if \
                    version == "HTTP/1.1" else ("keep-alive" in conn)
                if headers.get("expect", "").lower() == "100-continue":
                    writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                body = await read_body(reader, headers)
            except (BadRequest, asyncio.IncompleteReadError,
                    asyncio.LimitOverrunError) as e:
                writer.write(encode_response(text_response(
                    f"Bad Request: {e}", 400), False))
                await writer.drain()
                return
            try:
                resp = await handler(Request(method, target, headers, body))
            except Exception:  # noqa: BLE001 - the client's 500
                resp, keep_alive = _INTERNAL_ERROR, False
            writer.write(encode_response(resp, keep_alive,
                                         head_only=method == "HEAD"))
            await writer.drain()
            if not keep_alive:
                return
    except ConnectionError:
        return
    finally:
        writer.close()


class Router:
    """Routes by method and path (module docstring)."""

    def __init__(self):
        self._routes: List[Tuple[str, List[str], Handler]] = []

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        self._routes.append((method.upper(), pattern.split("/"), handler))

    def add_get(self, pattern: str, handler: Handler) -> None:
        self.add("GET", pattern, handler)

    def add_post(self, pattern: str, handler: Handler) -> None:
        self.add("POST", pattern, handler)

    def add_put(self, pattern: str, handler: Handler) -> None:
        self.add("PUT", pattern, handler)

    @staticmethod
    def _match(parts: List[str], segs: List[str]
               ) -> Optional[Dict[str, str]]:
        if len(parts) != len(segs):
            return None
        info: Dict[str, str] = {}
        for part, seg in zip(parts, segs):
            if part.startswith("{") and part.endswith("}"):
                if not seg:
                    return None
                info[part[1:-1]] = urllib.parse.unquote(seg)
            elif part != urllib.parse.unquote(seg):
                return None
        return info

    async def __call__(self, request: Request) -> Response:
        segs = request.raw_path.split("/")
        allowed = set()
        for method, parts, handler in self._routes:
            info = self._match(parts, segs)
            if info is None:
                continue
            if request.method == method or (
                    method == "GET" and request.method == "HEAD"):
                request.match_info = info
                return await handler(request)
            allowed.add(method)
            if method == "GET":
                allowed.add("HEAD")
        if allowed:
            return Response(405, b"405: Method Not Allowed",
                            "text/plain; charset=utf-8",
                            [("Allow", ",".join(sorted(allowed)))])
        return text_response("404: Not Found", 404)


class ServerThread:
    """``handler`` served on ``host:port`` from an event loop of its own
    in a daemon thread.  Port 0 binds a free port; ``port`` then holds
    it.  A port that will not bind raises the OSError here."""

    def __init__(self, handler: Handler, host: str, port: int,
                 name: str = "http"):
        self.host = host
        self.port = port
        self._handler = handler
        self._error: Optional[BaseException] = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=name)
        self._thread.start()
        self._started.wait(timeout=30)
        if self._error is not None:
            raise self._error

    def _serve(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)

        async def connection(reader, writer):
            await serve_connection(self._handler, reader, writer)

        try:
            server = loop.run_until_complete(asyncio.start_server(
                connection, self.host, self.port, limit=MAX_HEAD,
                reuse_address=True))
        except OSError as e:  # the port is taken
            self._error = e
            self._started.set()
            return
        if self.port == 0:  # bound to a free port: report it
            self.port = server.sockets[0].getsockname()[1]
        self._started.set()
        loop.run_forever()

    def started(self) -> bool:
        return self._started.is_set() and self._error is None
