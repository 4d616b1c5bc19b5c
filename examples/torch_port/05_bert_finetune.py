"""BERT sequence-classification fine-tune on the port, the SST-2
north-star config (BASELINE.json configs[2]: BERT-base SST-2 fine-tune;
``examples/05_bert_finetune.py`` is the JAX package's).

The GLUE SST-2 TSVs when present (DATA_DIR/train.tsv and dev.tsv),
otherwise a small synthetic sentiment set through the same tokenize ->
TokenizedDataset -> Trainer path.  The in-tree WordPiece tokenizer
encodes (the repo's fixture vocab.txt unless the published BERT vocab
is in data/tokenizer/ or ML_TRAINER_TPU_VOCAB_DIR); TOKENIZER=hash
takes the deterministic hash stand-in.  The model is built
``right_padded``: the padding masks compress to per-row key lengths and
the flash kernels run their ``kv_lens`` path.

    python examples/torch_port/05_bert_finetune.py                # tiny
    MODEL=bert_base DATA_DIR=data/sst2 EPOCHS=3 BATCH=32 \
        python examples/torch_port/05_bert_finetune.py            # real
"""

import _bootstrap  # noqa: F401  (repo root onto sys.path)
import os

from ml_trainer_tpu_torch import Trainer, init_model
from ml_trainer_tpu_torch.data import TokenizedDataset, load_sst2_tsv

MODEL = os.environ.get("MODEL", "bert_tiny")
DATA_DIR = os.environ.get("DATA_DIR", "data/sst2")
MODEL_DIR = os.environ.get("MODEL_DIR", "model_output_bert")
MAX_LEN = int(os.environ.get("MAX_LEN", "64"))
DEVICE = _bootstrap.device()

SYNTH = [
    ("a joyous, generous film that deserves every award", 1),
    ("warm and funny from the first scene to the last", 1),
    ("an absolute delight, sharp writing and great heart", 1),
    ("the best surprise of the year, simply wonderful", 1),
    ("tedious, joyless and far too long", 0),
    ("a dull mess with nothing to say", 0),
    ("painfully bad acting sinks every scene", 0),
    ("a waste of a talented cast, avoid it", 0),
] * 16

# WordPiece is the BERT-shaped encoding; 'hash' takes the stand-in.
TOKENIZER = os.environ.get("TOKENIZER", "wordpiece")


def build_datasets(vocab_size):
    try:
        return (
            load_sst2_tsv(os.path.join(DATA_DIR, "train.tsv"),
                          max_len=MAX_LEN, vocab_size=vocab_size,
                          tokenizer=TOKENIZER),
            load_sst2_tsv(os.path.join(DATA_DIR, "dev.tsv"),
                          max_len=MAX_LEN, vocab_size=vocab_size,
                          tokenizer=TOKENIZER),
        )
    except (FileNotFoundError, OSError):
        print("SST-2 TSVs not on disk; using the synthetic sentiment set")
        texts, labels = zip(*SYNTH)
        n = len(texts) * 3 // 4

        def make(t, labels_):
            return TokenizedDataset.from_texts(
                t, labels_, max_len=MAX_LEN, vocab_size=vocab_size,
                tokenizer=TOKENIZER)

        return make(texts[:n], labels[:n]), make(texts[n:], labels[n:])


def main():
    model_kw = {"num_classes": 2, "right_padded": True}
    vocab_size = 30522
    if MODEL == "bert_tiny":
        vocab_size = 2048
        model_kw.update(vocab_size=vocab_size, max_len=MAX_LEN)
    datasets = build_datasets(vocab_size)
    trainer = Trainer(
        init_model(MODEL, seed=32, device=DEVICE, **model_kw),
        datasets=datasets,
        epochs=int(os.environ.get("EPOCHS", "3")),
        batch_size=int(os.environ.get("BATCH", "16")),
        save_history=True,
        device=DEVICE,
        optimizer="adamw",
        lr=float(os.environ.get("LR", "2e-4")),
        weight_decay=0.01,
        criterion="cross_entropy",
        metric="accuracy",
        pred_function="softmax",
        model_dir=MODEL_DIR,
    )
    trainer.fit()
    print({k: (v[-1] if isinstance(v, list) and v else v)
           for k, v in trainer.history.items()})
    return trainer


if __name__ == "__main__":
    main()
