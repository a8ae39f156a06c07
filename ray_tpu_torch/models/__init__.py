"""Model zoo of the port: the GPT-2 and llama families (config, init,
training forward and loss, decode, logical sharding axes), the
mixture-of-experts block, the MLP classifier, and the image models:
the Vision Transformer (ViT) and ResNet."""

from ray_tpu_torch.models.convert import (gpt2_params_from_numpy,
                                          gpt2_params_to_numpy,
                                          llama_params_from_numpy,
                                          llama_params_to_numpy,
                                          mlp_params_from_numpy,
                                          mlp_params_to_numpy,
                                          resnet_params_from_numpy,
                                          resnet_params_to_numpy,
                                          resnet_state_from_numpy,
                                          vit_params_from_numpy,
                                          vit_params_to_numpy)
from ray_tpu_torch.models.gpt2 import (GPT2Config, gpt2_config, gpt2_init,
                                       gpt2_logical_axes, gpt2_loss,
                                       gpt2_param_count)
from ray_tpu_torch.models.llama import (LlamaConfig, llama_config,
                                        llama_forward, llama_init,
                                        llama_logical_axes, llama_loss,
                                        llama_param_count)
from ray_tpu_torch.models.mlp import (MLPConfig, mlp_forward, mlp_init,
                                      mlp_logical_axes, mlp_loss)
from ray_tpu_torch.models.moe import (MoEConfig, moe_apply, moe_init,
                                      moe_logical_axes)
from ray_tpu_torch.models.resnet import (ResNetConfig, resnet_config,
                                         resnet_forward, resnet_init,
                                         resnet_logical_axes, resnet_loss)
from ray_tpu_torch.models.vit import (ViTConfig, vit_config, vit_forward,
                                      vit_init, vit_logical_axes, vit_loss,
                                      vit_param_count)
from ray_tpu_torch.models.llama_decode import (llama_decode_step,
                                               llama_generate,
                                               llama_init_cache,
                                               llama_prefill)

__all__ = ["GPT2Config", "gpt2_config", "gpt2_init", "gpt2_param_count",
           "gpt2_logical_axes", "gpt2_loss", "llama_logical_axes",
           "MoEConfig", "moe_init", "moe_apply", "moe_logical_axes",
           "gpt2_params_from_numpy", "gpt2_params_to_numpy",
           "LlamaConfig", "llama_config", "llama_init", "llama_forward",
           "llama_loss", "llama_param_count", "llama_init_cache",
           "llama_decode_step", "llama_generate", "llama_prefill",
           "llama_params_from_numpy", "llama_params_to_numpy",
           "MLPConfig", "mlp_init", "mlp_forward", "mlp_loss",
           "mlp_logical_axes", "mlp_params_from_numpy",
           "mlp_params_to_numpy", "ViTConfig", "vit_config", "vit_init",
           "vit_forward", "vit_loss", "vit_param_count",
           "vit_logical_axes", "vit_params_from_numpy",
           "vit_params_to_numpy", "ResNetConfig", "resnet_config",
           "resnet_init", "resnet_forward", "resnet_loss",
           "resnet_logical_axes", "resnet_params_from_numpy",
           "resnet_params_to_numpy", "resnet_state_from_numpy"]
