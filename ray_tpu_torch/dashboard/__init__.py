"""Dashboard-lite (reference analog: dashboard/ head + modules): a JSON
state API + Prometheus metrics endpoint on the port's own HTTP layer
(``_private/http_server.py``).  A copy of ``ray_tpu/dashboard/``."""

from ray_tpu_torch.dashboard.app import start_dashboard

__all__ = ["start_dashboard"]
