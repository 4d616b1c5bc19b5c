"""Hand-written CUDA kernels (sources in ``ml_trainer_tpu_torch/csrc/``).

Each kernel's wrapper takes its plain PyTorch version for a CPU tensor and
launches the kernel for a CUDA tensor (or raises); ``_build`` compiles the
sources with ``nvcc`` at first use.
"""

from ml_trainer_tpu_torch.ops.kernels.fused_adam import (
    adam_scalars,
    fused_adam_update,
    fused_adam_update_list,
    fused_adam_update_list_reference,
    fused_adam_update_reference,
    unscale_sqsum,
    unscale_sqsum_list,
    unscale_sqsum_list_reference,
    unscale_sqsum_reference,
)
from ml_trainer_tpu_torch.ops.kernels.int8_matmul import (
    int8_matmul,
    int8_matmul_reference,
    quantize_per_channel,
    quantize_tree,
)
from ml_trainer_tpu_torch.ops.kernels.paged_attention import (
    paged_attention,
    paged_attention_reference,
)

__all__ = ["adam_scalars", "fused_adam_update", "fused_adam_update_list",
           "fused_adam_update_list_reference", "fused_adam_update_reference",
           "int8_matmul", "int8_matmul_reference",
           "paged_attention", "paged_attention_reference",
           "quantize_per_channel", "quantize_tree", "unscale_sqsum",
           "unscale_sqsum_list", "unscale_sqsum_list_reference",
           "unscale_sqsum_reference"]
