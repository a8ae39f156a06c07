"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

The JAX package ``ray_tpu`` is the reference and stays unchanged; this
package mirrors its module paths (``ops/attention.py``,
``models/gpt2_decode.py``, ``serve/llm.py``, ...) so each module's
counterpart is easy to find.  It imports torch and numpy only, never
jax and never ``ray_tpu``.

Kernels that the JAX package wrote in Pallas for the TPU are written
by hand in CUDA C++ for ``sm_90a`` (``ops/csrc/``), built with nvcc at
first use and bound through ctypes (``ops/_kernels.py``).  Each keeps a
plain PyTorch version beside it: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises.
"""

from ray_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
