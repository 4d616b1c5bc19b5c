"""BERT encoder with a sequence-classification head (the JAX package's
``models/bert.py``): the SST-2 fine-tune config, ``BASELINE.json``
configs[2].

Token, position and segment embeddings, ``embed_ln``, post-norm
``TransformerBlock``s (``layers.{i}``), then a tanh ``pooler`` on the
first position and the ``classifier``.  The padding mask comes from
``input_ids != pad_token_id`` unless ``attention_mask`` is given.

``right_padded=True`` declares every mask a contiguous prefix (a
right-padded tokenizer's output): the mask is then also summarised into
per-row valid-key counts ``kv_lens = max(sum(mask), 1)``, which the
flash kernels fuse (K1 forward, K2/K3 backward), so a padded batch keeps
the kernel.  The mask still goes along for the plain path.  A mask with
holes under ``right_padded=True`` would be mis-masked on the kernel path,
as in the JAX package, so the default is False.

``dtype`` is the compute dtype (``models/layers.py``): the embedding sum
is cast to it and the encoder computes in it; the ``pooler`` and the
``classifier`` compute in float32, as in the JAX package.  Parameters
stay float32.  ``dropout_rate`` drops the embeddings after ``embed_ln``
and each layer's attention and MLP outputs in training mode; ``remat``
runs each layer under ``layers.remat_call`` (``remat_policy`` 'none' or
'dots').
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ml_trainer_tpu_torch.device import resolve_device
from ml_trainer_tpu_torch.models.layers import (
    LN_EPS,
    Dense,
    Dropout,
    LayerNorm,
    TransformerBlock,
    _cast,
    attach_dropout,
    check_remat_policy,
    compute_dtype,
    remat_call,
)
from ml_trainer_tpu_torch.models.registry import register_model


class BertEncoder(nn.Module):
    def __init__(self, vocab_size: int = 30522, max_len: int = 512,
                 type_vocab_size: int = 2, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_dim: int = 3072,
                 dropout_rate: float = 0.0,
                 num_classes: Optional[int] = 2, pad_token_id: int = 0,
                 attention_impl: str = "auto", remat: bool = False,
                 remat_policy: str = "none", right_padded: bool = False,
                 device=None, dtype=torch.float32):
        super().__init__()
        if remat:
            check_remat_policy(remat_policy)
        self.remat, self.remat_policy = bool(remat), remat_policy
        device = resolve_device(device)
        self.dtype = dtype
        cdt = compute_dtype(dtype)
        # The pooler and classifier compute in float32 (flax's
        # Dense(dtype=float32)); with no policy they cast nothing.
        head = None if cdt is None else torch.float32
        kw = dict(device=device, dtype=cdt)
        self.depth = depth
        self.num_classes = num_classes
        self.pad_token_id = pad_token_id
        self.right_padded = right_padded
        # 'auto' | 'xla' | 'flash', as in GPT2.
        self.attention_impl = attention_impl
        self.tok_embed = nn.Embedding(vocab_size, embed_dim, device=device)
        self.pos_embed = nn.Embedding(max_len, embed_dim, device=device)
        self.seg_embed = nn.Embedding(type_vocab_size, embed_dim,
                                      device=device)
        self.embed_ln = LayerNorm(embed_dim, eps=LN_EPS, **kw)
        self.embed_drop = Dropout(dropout_rate)
        self.layers = nn.ModuleList(
            TransformerBlock(embed_dim, num_heads, mlp_dim, post_norm=True,
                             dropout_rate=dropout_rate, **kw)
            for _ in range(depth))
        if num_classes is not None:
            self.pooler = Dense(embed_dim, embed_dim, device=device,
                                dtype=head)
            self.classifier = Dense(embed_dim, num_classes, device=device,
                                    dtype=head)
        attach_dropout(self)

    def _segments(self, token_type_ids):
        """``seg_embed(token_type_ids)`` as a one-hot product: the same
        rows, exactly, and a backward that is one matmul.  The embedding's
        own backward on CUDA adds every position into this table's two
        rows in an order that changes from run to run (measured on the
        H100), which would break bit-for-bit repeats of a step."""
        w = self.seg_embed.weight
        return F.one_hot(token_type_ids.long(), w.shape[0]).to(w.dtype) @ w

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        s = input_ids.shape[1]
        if attention_mask is None:
            attention_mask = (input_ids != self.pad_token_id).to(torch.int32)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos_ids = torch.arange(s, device=input_ids.device)[None, :]
        x = _cast(self.tok_embed(input_ids) + self.pos_embed(pos_ids)
                  + self._segments(token_type_ids), compute_dtype(self.dtype))
        x = self.embed_drop(self.embed_ln(x))
        mask = attention_mask[:, None, None, :].to(torch.bool)
        kv_lens = None
        if self.right_padded:
            kv_lens = torch.clamp(
                attention_mask.to(torch.int32).sum(dim=-1), min=1)
        for layer in self.layers:
            x = remat_call(layer, self.remat, self.remat_policy, x,
                           mask=mask, kv_lens=kv_lens,
                           attention_impl=self.attention_impl)
        if self.num_classes is None:
            return x  # the sequence output
        return self.classifier(torch.tanh(self.pooler(x[:, 0])))


@register_model("bert_base")
def bert_base(num_classes: int = 2, **kw) -> BertEncoder:
    """BERT-base: 12 layers, 768 wide, 12 heads (SST-2 head by default)."""
    return BertEncoder(num_classes=num_classes, **kw)


@register_model("bert_large")
def bert_large(num_classes: int = 2, **kw) -> BertEncoder:
    """BERT-large: 24 layers, 1024 wide, 16 heads."""
    kw.setdefault("embed_dim", 1024)
    kw.setdefault("depth", 24)
    kw.setdefault("num_heads", 16)
    kw.setdefault("mlp_dim", 4096)
    return BertEncoder(num_classes=num_classes, **kw)


@register_model("bert_tiny")
def bert_tiny(num_classes: int = 2, **kw) -> BertEncoder:
    """Small BERT for tests: 2 layers, 128 wide."""
    kw.setdefault("vocab_size", 1024)
    kw.setdefault("embed_dim", 128)
    kw.setdefault("depth", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("mlp_dim", 256)
    kw.setdefault("max_len", 128)
    return BertEncoder(num_classes=num_classes, **kw)
