"""Device placement for the port's entry points.

Every entry point that creates tensors takes a ``device`` argument.
``None`` means the first CUDA device: the port is written for the card,
and a run that silently lands on the CPU would report CPU numbers under
a GPU's name.  Tests and tools that want the CPU say so explicitly with
``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda:0``; an explicit device is taken as given.

    Raises RuntimeError when CUDA is asked for (explicitly or by
    default) and no CUDA device is present."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU explicitly")
    return dev
