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

The server (``_private/http_server.py``, shared with the dashboard)
speaks HTTP/1.1 with keep-alive (HTTP/1.0 closes unless the client asks
to keep alive), ``Content-Length`` and chunked request bodies and
``Expect: 100-continue``; each connection is one task, so requests on
different connections run at once, each blocking ``handle.call`` on the
loop's executor.  Like the rest of the serve
control plane, this module imports no torch.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch._private.http_server import (Request, Response,
                                                ServerThread, json_response)


def _match_route(routes: Dict[str, str], path: str) -> Optional[str]:
    """The deployment of the longest prefix that takes ``path``."""
    for prefix, dep in sorted(routes.items(), key=lambda kv: -len(kv[0])):
        if path == prefix or path.startswith(
                prefix.rstrip("/") + "/") or prefix == "/":
            return dep
    return None


class HTTPProxyActor:
    def __init__(self, controller, host: str = "127.0.0.1",
                 port: int = 8000):
        self._controller = controller
        self.host = host
        self._handles: Dict[str, Any] = {}
        self._routes: Dict[str, str] = {}
        self._routes_at = 0.0
        self._routes_ttl = 2.0
        self._routes_lock = threading.Lock()
        # a port that will not bind raises here: the actor fails
        self._server = ServerThread(self._handle, host, port, "http_proxy")
        self.port = self._server.port

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

    async def _handle(self, request: Request) -> Response:
        try:
            return await self._dispatch(request)
        except UnicodeDecodeError:
            # a body that is neither JSON nor UTF-8 text
            return Response(500, b"500 Internal Server Error")

    async def _dispatch(self, request: Request) -> Response:
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self._refresh_routes)
        dep = _match_route(self._routes, request.path)
        if dep is None:
            return json_response({"error": f"no route for {request.path}"},
                                 404)
        body = request.body
        if body is not None:
            try:
                payload = json.loads(body.decode("utf-8"))
            except (UnicodeDecodeError, ValueError):
                payload = body.decode()
        else:
            payload = request.query or None
        handle = self._handle_for(dep)
        try:
            result = await loop.run_in_executor(
                None, lambda: handle.call(payload, timeout=60))
        except Exception as e:  # noqa: BLE001 - the caller's 500
            return json_response({"error": repr(e)}, 500)
        if isinstance(result, (dict, list, str, int, float, bool,
                               type(None))):
            return json_response({"result": result})
        return json_response({"result": repr(result)})

    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def ping(self) -> bool:
        return self._server.started()
