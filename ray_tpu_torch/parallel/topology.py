"""TPU topology model: a copy of ``ray_tpu/parallel/topology.py``,
which imports no JAX (the port keeps its own copy of such modules).

Accelerator strings ("v5e-8", "v4-32"), slices, ICI domains and the
6N MFU helper, as the JAX package's scheduler and trainer read them.
The generation table holds the TPU data sheets' numbers; none of them
describes the card the port runs on (the H100's peak rates live in
``_private/device_stats.py`` ``H100_SXM``).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class TpuGeneration:
    """Static facts about one TPU generation."""

    name: str
    chips_per_host: int          # chips visible to one host VM
    cores_per_chip: int
    hbm_gib_per_chip: float
    # Peak dense bf16 TFLOP/s per chip (public spec sheet numbers).
    bf16_tflops: float
    # Max chips reachable over ICI in one slice.
    max_slice_chips: int
    # ICI is a 2D/3D torus for v2-v4/v5p; v5e/v6e are 2D.
    torus_dims: int


GENERATIONS: Dict[str, TpuGeneration] = {
    "v2": TpuGeneration("v2", 4, 2, 8.0, 45.0, 512, 2),
    "v3": TpuGeneration("v3", 4, 2, 16.0, 123.0, 2048, 2),
    "v4": TpuGeneration("v4", 4, 2, 32.0, 275.0, 4096, 3),
    "v5e": TpuGeneration("v5e", 4, 1, 16.0, 197.0, 256, 2),
    "v5p": TpuGeneration("v5p", 4, 2, 95.0, 459.0, 8960, 3),
    "v6e": TpuGeneration("v6e", 4, 1, 32.0, 918.0, 256, 2),
}


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """One ICI-connected slice: `num_chips` chips of `generation`, spread
    over `num_hosts` host VMs.  A multislice job is a list of these glued
    by DCN."""

    generation: TpuGeneration
    num_chips: int

    @property
    def num_hosts(self) -> int:
        return max(1, self.num_chips // self.generation.chips_per_host)

    @property
    def chips_per_host(self) -> int:
        return min(self.num_chips, self.generation.chips_per_host)

    @property
    def bf16_tflops(self) -> float:
        return self.num_chips * self.generation.bf16_tflops

    @property
    def hbm_gib(self) -> float:
        return self.num_chips * self.generation.hbm_gib_per_chip

    def mesh_shape2d(self) -> Tuple[int, int]:
        """Near-square 2D factorization of the slice, the natural layout
        for (fsdp, tp)-style meshes on a torus."""
        n = self.num_chips
        a = int(math.isqrt(n))
        while n % a:
            a -= 1
        return (n // a, a)

    def __str__(self) -> str:
        return f"{self.generation.name}-{self.num_chips}"


_ACC_RE = re.compile(r"^(v\d+[ep]?)[-_](\d+)$")


def parse_accelerator_type(acc: str) -> SliceTopology:
    """Parse "v5e-8" / "v4-32" style accelerator strings.

    Note: for v2/v3 the suffix is cores, for v4+ it is chips, matching
    GCE naming; we normalize to chips.
    """
    m = _ACC_RE.match(acc.strip().lower())
    if not m:
        raise ValueError(f"unrecognized accelerator type: {acc!r}")
    gen_name, count = m.group(1), int(m.group(2))
    gen = GENERATIONS.get(gen_name)
    if gen is None:
        raise ValueError(f"unknown TPU generation {gen_name!r} in {acc!r}")
    chips = count // gen.cores_per_chip if gen_name in ("v2", "v3") else count
    return SliceTopology(gen, max(1, chips))


def parse_topology(generation: str, topology: str) -> SliceTopology:
    """Parse a generation + "4x4"-style ICI topology (the GKE/kuberay TPU
    naming: dims multiply to the chip count)."""
    gen = GENERATIONS.get(generation.strip().lower())
    if gen is None:
        raise ValueError(f"unknown TPU generation {generation!r}")
    try:
        dims = [int(d) for d in topology.strip().lower().split("x")]
        chips = math.prod(dims)
    except ValueError:
        raise ValueError(f"unrecognized topology {topology!r} "
                         f"(want e.g. '2x4' or '4x4x4')") from None
    if len(dims) > gen.torus_dims:
        raise ValueError(f"{generation} ICI is {gen.torus_dims}-D; "
                         f"topology {topology!r} has {len(dims)} dims")
    return SliceTopology(gen, max(1, chips))


def ici_domains(nodes: Sequence[dict]) -> Dict[str, List[dict]]:
    """Group node-info dicts by ICI domain (slice id).

    Nodes report a `tpu_slice_id` label when they join (set from the
    TPU metadata server or TPU_WORKER_HOSTNAMES); nodes in the same
    slice share ICI and should be gang-placed together.  Nodes without
    TPUs go to the "" domain.
    """
    domains: Dict[str, List[dict]] = {}
    for n in nodes:
        labels = n.get("labels") or {}
        dom = labels.get("tpu_slice_id", "") if n.get(
            "resources_total", {}).get("TPU", 0) else ""
        domains.setdefault(dom, []).append(n)
    return domains


def flops_per_token(n_params: int) -> float:
    """Standard 6N flops/token estimate for transformer training."""
    return 6.0 * n_params


def mfu(tokens_per_sec: float, n_params: int, topo: SliceTopology) -> float:
    """Model FLOPs utilization against the slice's peak bf16 throughput."""
    return (tokens_per_sec * flops_per_token(n_params)) / (
        topo.bf16_tflops * 1e12)
