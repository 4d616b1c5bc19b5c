"""GPT-2 pretraining on the port, the north-star LM config
(BASELINE.json configs[4]: gradient accumulation and checkpoint
save/restore; ``examples/04_gpt2_pretrain.py`` is the JAX package's).

    python examples/torch_port/04_gpt2_pretrain.py             # tiny model
    MODEL=gpt2 SEQ_LEN=1024 BATCH=8 ACCUM=4 REMAT=1 K=4 \
        python examples/torch_port/04_gpt2_pretrain.py         # the real one
    RESUME=1 python examples/torch_port/04_gpt2_pretrain.py    # continue

Levers (env vars): ACCUM (microbatches an update), REMAT (recompute
each block in the backward), K (steps a dispatch: on the card one CUDA
graph replay), ZERO1 (the sharded update, ZeRO-1 moments; needs
PARALLEL=1, which runs REPLICAS replicas (2) on the one device), TP (a
tensor axis: refused, ROADMAP.md Queue A 6), EPOCHS, SYNTH_SIZE, BATCH,
SEQ_LEN, LR, VOCAB.

Data: a synthetic text corpus tokenized by the in-tree byte-level BPE
tokenizer (the repo's fixture vocab unless the published GPT-2 files
are in data/tokenizer/ or ML_TRAINER_TPU_VOCAB_DIR) packed into
next-token blocks; TOKENIZER=synth takes raw synthetic token ids.
"""

import _bootstrap  # noqa: F401  (repo root onto sys.path)
import os

from ml_trainer_tpu_torch import SyntheticTokens, Trainer, generate, init_model

MODEL = os.environ.get("MODEL", "gpt2_tiny")
SEQ_LEN = int(os.environ.get("SEQ_LEN", "128"))
BATCH = int(os.environ.get("BATCH", "16"))
EPOCHS = int(os.environ.get("EPOCHS", "2"))
ACCUM = int(os.environ.get("ACCUM", "2"))
TP = int(os.environ.get("TP", "1"))
REPLICAS = int(os.environ.get("REPLICAS", "2"))
MODEL_DIR = os.environ.get("MODEL_DIR", "model_output_gpt2")
TOKENIZER = os.environ.get("TOKENIZER", "bpe")  # 'synth': raw token ids
DEVICE = _bootstrap.device()


def build_datasets(n, n_val, vocab):
    """(vocab_size, (train, val)): BPE-packed blocks by default, raw
    synthetic token ids with TOKENIZER=synth."""
    from ml_trainer_tpu_torch.data.tokenizers import (
        load_tokenizer,
        resolve_vocab_dir,
    )

    tok = None if TOKENIZER == "synth" else load_tokenizer(
        resolve_vocab_dir())
    if tok is None:
        # Causal-LM pairs: SyntheticTokens shifts the labels itself.
        return vocab, (
            SyntheticTokens(size=n, seq_len=SEQ_LEN, vocab_size=vocab),
            SyntheticTokens(size=n_val, seq_len=SEQ_LEN, vocab_size=vocab,
                            seed=1),
        )
    import numpy as np

    from ml_trainer_tpu_torch.data import PackedLMDataset

    vocab = max(vocab, tok.vocab_size)
    need = (n + n_val) * SEQ_LEN + 2
    stream = []
    i = 0
    while len(stream) < need:
        stream.extend(tok.encode(
            f"training step {i}: the tiny gpt model fits the mesh "
            "and the loss goes down. "
        ))
        i += 1
    stream = np.asarray(stream[:need], np.int32)
    split = n * SEQ_LEN + 1
    return vocab, (
        PackedLMDataset(stream[:split], SEQ_LEN),
        PackedLMDataset(stream[split - 1:], SEQ_LEN),
    )


def main():
    n = int(os.environ.get("SYNTH_SIZE", "512"))
    vocab, datasets = build_datasets(
        n, max(n // 8, 32), int(os.environ.get("VOCAB", "1024")))
    model_kw = dict(remat=os.environ.get("REMAT") == "1")
    if MODEL == "gpt2_tiny":
        model_kw.update(vocab_size=vocab, max_len=SEQ_LEN)
    parallel = os.environ.get("PARALLEL") == "1"
    zero1 = os.environ.get("ZERO1") == "1"
    if zero1 and not parallel:
        raise ValueError("ZERO1=1 shards the update over the replicas: "
                         "it needs PARALLEL=1")
    mesh_shape = None
    if TP > 1:
        mesh_shape = {"data": REPLICAS // TP, "tensor": TP}
    trainer = Trainer(
        init_model(MODEL, seed=32, device=DEVICE, **model_kw),
        datasets=datasets,
        epochs=EPOCHS,
        batch_size=BATCH,
        is_parallel=parallel,
        save_history=True,
        grad_accum_steps=ACCUM,
        steps_per_execution=int(os.environ.get("K", "1")),
        dp_update="sharded" if zero1 else "fused",
        mesh_shape=mesh_shape,
        device=[DEVICE] * REPLICAS if parallel else DEVICE,
        optimizer="adamw",
        lr=float(os.environ.get("LR", "3e-4")),
        weight_decay=0.01,
        criterion="cross_entropy",
        scheduler="CosineAnnealingWarmRestarts",
        model_dir=MODEL_DIR,
    )
    trainer.fit(resume=os.environ.get("RESUME") == "1")
    print({k: (v[-1] if isinstance(v, list) and v else v)
           for k, v in trainer.history.items()})

    # A short continuation with the trained weights, from a KV cache.
    prompt = [[1, 2, 3, 4]]
    out = generate(trainer.model, prompt, max_new_tokens=16,
                   temperature=0.8, rng=0, device=trainer.device)
    sampled = out[0, len(prompt[0]):].tolist()
    print("sampled continuation:", sampled)
    return trainer, sampled


if __name__ == "__main__":
    main()
