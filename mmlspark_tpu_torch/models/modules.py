"""Model zoo of the PyTorch port + declarative model configs.

The port of ``mmlspark_tpu/models/modules.py``, transformer family first:
a model is described by a small JSON-able config dict and built into an
``nn.Module`` by :func:`build_model`. Every module supports layer-name
truncation: ``forward(x, output_layer=name)`` returns that intermediate
activation (reference: ImageFeaturizer.scala:117-142), and
``layer_names()`` lists the valid names in forward order.

Numerics follow the flax modules so the same weights give the same scores
and train the same way: every parameter is held in float32 (flax's
``param_dtype``) and cast to the compute dtype at each call — a bf16 master
weight would swallow Adam's small updates. Dense layers compute
``F.linear(x, w.to(dt), b.to(dt))``; embeddings gather rows from the f32
table and cast them (flax casts the table, then gathers: the same values
forward, but the backward accumulates repeated tokens in f32 where flax
scatter-adds in bf16). LayerNorm computes its statistics in f32 with
epsilon 1e-6, GELU is the tanh approximation, and mean-pooling sums in f32.
``remat=True`` recomputes each block's forward during the backward
(``torch.utils.checkpoint``, non-reentrant), as flax's ``nn.remat`` does.

The other families (MLP, ConvNet, ResNet, BiLSTM) are ROADMAP.md Queue 1
item 2; ``build_model`` raises NotImplementedError for them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def resolve_dtype(name) -> torch.dtype:
    """A config's ``dtype`` entry ("bfloat16", "float32", ...) as a torch
    dtype; bfloat16 when absent, as in the JAX package."""
    key = name or "bfloat16"
    if key not in _DTYPES:
        raise ValueError(f"unsupported model dtype {name!r}; "
                         f"have {sorted(_DTYPES)}")
    return _DTYPES[key]


class _LayerTap:
    """Collects named activations and answers early-exit queries: the
    forward pass stops at the tapped layer (the reference's AsComposite
    truncation)."""

    def __init__(self, output_layer: Optional[str]):
        self.target = output_layer
        self.result = None

    def tap(self, name: str, value):
        if self.target is not None and name == self.target and self.result is None:
            self.result = value
        return value

    @property
    def done(self) -> bool:
        return self.result is not None


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` semantics: statistics, scale and bias in f32,
    epsilon 1e-6 (torch's default is 1e-5), output cast to the compute
    dtype. flax takes the variance as E[x^2] - E[x]^2 and torch by a
    two-pass sum; in f32 the two agree far inside the tests' tolerance."""

    def __init__(self, d: int, dtype: torch.dtype, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.dtype)


class Dense(nn.Linear):
    """flax ``nn.Dense`` semantics: float32 weight and bias (``nn.Linear``'s
    state_dict names), cast to the compute dtype at each call."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 bias: bool = True):
        super().__init__(d_in, d_out, bias=bias, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Embed(nn.Embedding):
    """flax ``nn.Embed``: a float32 table whose gathered rows are cast to
    the compute dtype."""

    def __init__(self, num: int, d: int, dtype: torch.dtype):
        super().__init__(num, d, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, ids):
        return F.embedding(ids, self.weight).to(self.compute_dtype)


class _EncoderBlock(nn.Module):
    """One pre-norm transformer block: attention + dense FFN."""

    def __init__(self, d_model: int, heads: int, mlp_ratio: int,
                 dtype: torch.dtype, attention: Callable):
        super().__init__()
        self.heads = heads
        self.attention = attention     # (q, k, v) -> o, from the encoder
        hidden = mlp_ratio * d_model
        self.ln1 = LayerNorm(d_model, dtype)
        self.qkv = Dense(d_model, 3 * d_model, dtype, bias=False)
        self.proj = Dense(d_model, d_model, dtype, bias=False)
        self.ln2 = LayerNorm(d_model, dtype)
        self.fc1 = Dense(d_model, hidden, dtype)
        self.fc2 = Dense(hidden, d_model, dtype)

    def forward(self, x):
        B, T, d = x.shape
        H = self.heads
        qkv = self.qkv(self.ln1(x)).view(B, T, 3 * H, d // H)
        q, k, v = qkv.split(H, dim=2)       # head-major thirds, as in flax
        a = self.attention(q, k, v).reshape(B, T, d)
        x = x + self.proj(a)
        h = self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))
        return x + h


class TransformerEncoder(nn.Module):
    """Transformer encoder (the port of the JAX ``TransformerEncoder``).

    ``attn_impl``: ``flash`` runs the hand-written CUDA kernel on CUDA
    inputs (its plain PyTorch version on CPU inputs), ``blockwise`` the
    plain-PyTorch FlashAttention recurrence (honours ``block_size``), and
    ``auto`` picks flash on a CUDA device and blockwise on the CPU.

    ``remat``: under grad mode each block runs inside a non-reentrant
    checkpoint, so its activations are recomputed during the backward
    instead of kept (O(T) activation memory per layer instead of O(layers
    x T), at the price of a second forward of every block).

    Input: int token ids (B, T). Output: (B, num_classes) float32 when
    ``pool='mean'``, else per-token (B, T, num_classes).
    """

    def __init__(self, vocab_size: int = 10000, d_model: int = 128,
                 heads: int = 4, layers: int = 2, mlp_ratio: int = 4,
                 num_classes: int = 2, max_len: int = 2048,
                 causal: bool = False, pool: str = "mean",
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "auto", block_size: int = 512,
                 remat: bool = False):
        super().__init__()
        if d_model % heads != 0:
            raise ValueError(f"d_model ({d_model}) must be divisible "
                             f"by heads ({heads})")
        if pool not in ("mean", "none"):
            raise ValueError(f"pool must be 'mean' or 'none', got {pool!r}")
        if attn_impl not in ("auto", "blockwise", "flash"):
            raise ValueError(f"attn_impl must be auto|blockwise|flash, "
                             f"got {attn_impl!r}")
        self.layers = layers
        self.max_len = max_len
        self.causal = causal
        self.pool = pool
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.block_size = block_size
        self.remat = remat
        self.tok_embed = Embed(vocab_size, d_model, dtype)
        self.pos_embed = Embed(max_len, d_model, dtype)
        self.blocks = nn.ModuleList(
            _EncoderBlock(d_model, heads, mlp_ratio, dtype, self._attention)
            for _ in range(layers))
        self.ln_f = LayerNorm(d_model, dtype)
        self.head = Dense(d_model, num_classes, dtype)

    def layer_names(self):
        return ["embed"] + [f"block{i}" for i in range(self.layers)] + ["logits"]

    def _attention(self, q, k, v):
        impl = self.attn_impl
        if impl == "auto":
            impl = "flash" if q.device.type == "cuda" else "blockwise"
        if impl == "flash":
            from ..ops.flash_attention import flash_attention
            return flash_attention(q, k, v, causal=self.causal)
        from ..parallel.sequence import blockwise_attention
        return blockwise_attention(q, k, v, block_size=self.block_size,
                                   causal=self.causal)

    def forward(self, tokens, output_layer: Optional[str] = None):
        tap = _LayerTap(output_layer)
        B, T = tokens.shape
        if T > self.max_len:
            raise ValueError(f"sequence length {T} exceeds max_len "
                             f"{self.max_len}")
        pos = torch.arange(T, device=tokens.device)
        x = tap.tap("embed", self.tok_embed(tokens) + self.pos_embed(pos)[None])
        if tap.done:
            return tap.result.float()
        remat = self.remat and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            x = tap.tap(f"block{i}",
                        checkpoint(blk, x, use_reentrant=False) if remat
                        else blk(x))
            if tap.done:
                return tap.result.float()
        x = self.ln_f(x)
        if self.pool == "mean":
            x = x.float().mean(dim=1).to(self.dtype)   # f32 sum, as jnp.mean
        x = tap.tap("logits", self.head(x))
        return x.float()


# ---------------------------------------------------------------- registry

# families whose input is int token ids (callers must cast features to ints)
TOKEN_MODELS = ("bilstm", "transformer")


def _build_transformer(cfg: dict) -> TransformerEncoder:
    if cfg.get("num_experts", 0) > 0:
        raise NotImplementedError(
            "MoE transformer blocks (num_experts > 0) wait for their own "
            "slice with models/moe.py (ROADMAP.md Queue 1 item 12)")
    return TransformerEncoder(
        vocab_size=cfg.get("vocab_size", 10000),
        d_model=cfg.get("d_model", 128),
        heads=cfg.get("heads", 4),
        layers=cfg.get("layers", 2),
        mlp_ratio=cfg.get("mlp_ratio", 4),
        num_classes=cfg.get("num_classes", 2),
        max_len=cfg.get("max_len", 2048),
        causal=cfg.get("causal", False),
        pool=cfg.get("pool", "mean"),
        block_size=cfg.get("block_size", 512),
        attn_impl=cfg.get("attn_impl", "auto"),
        remat=cfg.get("remat", False),
        dtype=resolve_dtype(cfg.get("dtype")))


def _not_ported(family: str):
    def build(cfg):
        raise NotImplementedError(
            f"model family {family!r} is not ported yet (ROADMAP.md Queue 1 "
            f"item 2); the port serves 'transformer'")
    return build


MODEL_BUILDERS: dict[str, Callable[[dict], nn.Module]] = {
    "transformer": _build_transformer,
    **{f: _not_ported(f)
       for f in ("mlp", "convnet", "resnet", "resnet50", "bilstm")},
}


def build_model(config: dict) -> nn.Module:
    """config: {"type": <family>, ...family kwargs...} -> nn.Module (on the
    current default device; callers move it with ``.to(device)``)."""
    cfg = dict(config)
    mtype = cfg.pop("type")
    if mtype not in MODEL_BUILDERS:
        raise KeyError(f"unknown model type {mtype!r}; "
                       f"have {sorted(MODEL_BUILDERS)}")
    return MODEL_BUILDERS[mtype](cfg)


def example_input(config: dict, batch: int = 2) -> torch.Tensor:
    """A tiny correctly-shaped input for shape checks."""
    mtype = config["type"]
    if mtype in TOKEN_MODELS:
        return torch.zeros((batch, config.get("seq_len", 16)),
                           dtype=torch.long)
    if mtype in MODEL_BUILDERS:
        MODEL_BUILDERS[mtype](config)      # raises: family not ported
    raise KeyError(mtype)
