"""The dashboard: not ported yet.

The JAX package's ``ray_tpu/dashboard/`` (``app.py``'s
``DashboardActor`` with its state, serve, jobs and ``/metrics`` routes,
``frontend.py``'s page) runs on aiohttp, which the card's machine does
not have, and its perf routes read modules the port does not have yet
(``tools/autopilot``, ``tools/graftcheck/programs.py``, ``workflow``).
It comes next on the HTTP layer of ``serve/http_proxy.py``; until then
``start_dashboard`` raises NotImplementedError naming ``DASHBOARD_ITEM``.
What the dashboard would show is reachable without it:
``ray_tpu_torch.util.state``, ``serve.status()``, ``ray_tpu_torch.job``
and ``util.metrics.collect_cluster_metrics``.
"""

#: what the dashboard waits for
DASHBOARD_ITEM = "ROADMAP.md queue 1 item 6b (the dashboard)"


def start_dashboard(port: int = 8265, host: str = "127.0.0.1") -> str:
    """The JAX package's ``start_dashboard`` (``ray_tpu/dashboard/
    app.py:638``); raises NotImplementedError naming its item."""
    raise NotImplementedError(
        f"the dashboard ({host}:{port}) is not ported yet: "
        f"{DASHBOARD_ITEM}")
