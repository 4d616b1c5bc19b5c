"""ml_trainer_tpu_torch: the PyTorch/CUDA port of ``ml_trainer_tpu``.

The JAX package beside it stays the reference; this package imports
``torch`` and numpy only.  Its entry points (``Server``,
``SlotDecodeEngine``, ``generate``, ``Trainer``, the model constructors)
run on the CUDA card unless the caller passes ``device="cpu"``, and raise
when no card is visible.  The model zoo holds MLModel, ResNet-18/50/101/
152, ViT, BERT, GPT-2 and Llama (``models.available_models()``; GPT-2's
and Llama's ``loss_chunk`` never holds the [B, S, V] logits; Llama
trains and generates, the serving engine refuses it), with the input paths
of ``data``: the CIFAR-10 transforms (``custom_pre_process_function``),
the C++ ``NativeLoader`` (built with ``g++`` at first use), memory-mapped
image shards, and the BPE/WordPiece tokenizers and text datasets.  The
TPU's Pallas kernels on the serving, int8 decode and training paths are
hand-written CUDA kernels here (``csrc/``), built with ``nvcc`` at first
use; ``launch_counts()`` shows how often each one ran.  Data-parallel
training runs its replicas on one device, or one process per card over
``torch.distributed`` (``parallel/``, ``create_mesh``; ``torchrun``).  ``Trainer(precision="bf16")`` trains in bf16 against
float32 master parameters with dynamic loss scaling (``precision``).
``fit()`` writes full-state checkpoints in the JAX package's format
(``checkpoint``) and ``fit(resume=True)`` continues from them bit for
bit, also after a SIGTERM or an injected fault (``resilience``).
``generate()`` samples with ``top_k``/``top_p`` and decodes
speculatively with ``spec_k`` (``speculative``: an n-gram or draft-model
drafter); ``beam_search`` and ``generate_ragged`` are its other modes,
and ``Server`` takes ``spec_k`` and ``prefill_chunk`` (chunked prefill).
``Server`` serves over HTTP (``http_port``, ``serve_http``) through a
weighted multi-tenant scheduler (``TenantConfig``), with SLO accounting
(``SloPolicy``), the overload ladder (``set_degradation``,
``DegradationConfig``) and a decode watchdog; ``Router`` spreads it over
replicas (KV migrating prefill -> decode) and rolls them onto new weights
under traffic (``Router.deploy``: canary, shadow, rollback), beside the
``serving.Autoscaler`` and the open-loop load generator
(``serving.run_open_loop``); ``telemetry`` holds the metrics registry
that ``GET /metrics`` exposes, the flight recorder, the Watchtower store
and the alert engine.
``Trainer(lora=LoraConfig(...))`` trains a LoRA adapter on a frozen
GPT-2 base; ``export_lora`` writes it in the JAX package's artifact
format (``lora``) and ``Server(adapters=AdapterConfig(...))`` serves it
from a pool of adapter slots (``serving/adapter_pool.py``);
``export_torch`` and ``save_model`` write a flat model's ``model.pth``
in the reference's layout, which ``load_model`` reads back (as the JAX
package does; ``utils/utils.py``), and ``plot_history`` draws a run's
history.  The notebook flows run as scripts in
``examples/torch_port/``.
"""

from ml_trainer_tpu_torch import parallel, precision
from ml_trainer_tpu_torch.convert import (
    adam_state_from_jax,
    init_gpt2,
    init_model,
    params_from_jax,
    quant_from_jax,
    state_from_jax,
    variables_to_jax,
)
from ml_trainer_tpu_torch.data import (
    ArrayDataset,
    Loader,
    SyntheticCIFAR10,
    SyntheticTokens,
)
from ml_trainer_tpu_torch.device import (
    launch_counts,
    reset_launch_counts,
    resolve_device,
)
from ml_trainer_tpu_torch.generate import (
    beam_search,
    generate,
    generate_ragged,
)
from ml_trainer_tpu_torch.lora import LoraConfig
from ml_trainer_tpu_torch.models import (
    GPT2,
    LlamaLM,
    MLModel,
    get_model,
    suggested_draft,
)
from ml_trainer_tpu_torch.ops.kernels import (
    int8_matmul,
    quantize_per_channel,
    quantize_tree,
)
from ml_trainer_tpu_torch.parallel import create_mesh
from ml_trainer_tpu_torch.serving import (
    AdapterConfig,
    AdapterPool,
    AdapterPoolExhausted,
    DegradationConfig,
    Router,
    Server,
    SloPolicy,
    SlotDecodeEngine,
    TenantConfig,
    UnknownAdapter,
)
from ml_trainer_tpu_torch.speculative import (
    DraftModelDrafter,
    NgramDrafter,
    speculative_generate,
)
from ml_trainer_tpu_torch.trainer import Trainer
from ml_trainer_tpu_torch.utils import (
    custom_pre_process_function,
    load_history,
    load_model,
    plot_history,
)

__version__ = "0.1.0"

__all__ = [
    "AdapterConfig", "AdapterPool", "AdapterPoolExhausted",
    "ArrayDataset", "DegradationConfig", "DraftModelDrafter", "GPT2",
    "LlamaLM", "Loader", "LoraConfig", "MLModel", "NgramDrafter", "Router",
    "Server", "SloPolicy", "SlotDecodeEngine", "SyntheticCIFAR10",
    "SyntheticTokens", "TenantConfig", "Trainer",
    "adam_state_from_jax", "beam_search", "create_mesh",
    "custom_pre_process_function", "generate", "generate_ragged",
    "get_model", "init_gpt2", "init_model", "int8_matmul",
    "launch_counts", "load_history", "load_model", "parallel",
    "params_from_jax", "plot_history", "precision", "quant_from_jax",
    "quantize_per_channel", "quantize_tree", "reset_launch_counts",
    "resolve_device", "speculative_generate", "state_from_jax",
    "suggested_draft", "UnknownAdapter", "variables_to_jax",
]
