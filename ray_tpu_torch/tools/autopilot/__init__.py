"""Closed-loop perf autopilot over the observatory + ledger, the
counterpart of ``ray_tpu/tools/autopilot``.

observatory → **attribute** → **plan** → sweep → ledger → **verdict**
(and the verdict's report embeds the next plan, closing the loop).
Three stages behind ``python -m ray_tpu_torch.tools.autopilot``.  The
observatory is the port's program registry and cost model
(``_private/device_stats.py``), the ledger the port's
(``tools/perfledger.py``, ``BENCH_HISTORY_TORCH.jsonl``).  ``plan``
prints the JAX package's grid; the port has no sweep runner over
``python -m ray_tpu_torch.bench`` yet (ROADMAP.md queue 1), so running
it waits for one.  graftcheck's ``autopilot-attribution`` rule pins
this package to the program catalogs.
"""

from ray_tpu_torch.tools.autopilot.attribution import (
    PROGRAM_KNOBS, attribute, attribute_registry, classify)
from ray_tpu_torch.tools.autopilot.planner import (CANDIDATES,
                                                   mirror_variant, plan)
from ray_tpu_torch.tools.autopilot.verdict import (build_verdict,
                                                   render_markdown,
                                                   write_reports)

__all__ = [
    "PROGRAM_KNOBS", "attribute", "attribute_registry", "classify",
    "CANDIDATES", "mirror_variant", "plan",
    "build_verdict", "render_markdown", "write_reports",
]
