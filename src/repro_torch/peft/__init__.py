from repro_torch.peft.ia3 import IA3Config, apply_ia3, init_ia3
from repro_torch.peft.lora import (LoraConfig, apply_lora, base_shapes_of,
                                   init_lora, lora_delta)
from repro_torch.peft.task_vector import (ExpertArtifact, apply_task_vector,
                                          compress_expert, reconstruct_expert,
                                          task_vector)

__all__ = ["IA3Config", "apply_ia3", "init_ia3", "LoraConfig", "apply_lora",
           "base_shapes_of", "init_lora", "lora_delta", "ExpertArtifact",
           "apply_task_vector", "compress_expert", "reconstruct_expert",
           "task_vector"]
