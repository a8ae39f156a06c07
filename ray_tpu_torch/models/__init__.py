"""Model zoo of the port: the GPT-2 family (config, init, decode)."""

from ray_tpu_torch.models.convert import (gpt2_params_from_numpy,
                                          gpt2_params_to_numpy)
from ray_tpu_torch.models.gpt2 import (GPT2Config, gpt2_config, gpt2_init,
                                       gpt2_param_count)

__all__ = ["GPT2Config", "gpt2_config", "gpt2_init", "gpt2_param_count",
           "gpt2_params_from_numpy", "gpt2_params_to_numpy"]
