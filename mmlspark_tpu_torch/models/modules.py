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

The image families (MLP, ConvNet, ResNet) take NHWC input, as the JAX
package does, cast it to the compute dtype (uint8 images included: no
/255) and run on the NCHW view ``x.permute(0, 3, 1, 2)``, whose strides
are channels-last, so cuDNN takes its NHWC convolutions as they are. Every
tapped activation comes back NHWC. Convolutions pad as flax does: "SAME"
(``Conv2d``, ``_same_pads``) puts the odd pixel of padding at the high
end, so a stride-2 conv of an even input pads (0, 1), which is padded by
hand before an unpadded conv; ``padding="torch"`` pads k//2 each side, as
an imported torchvision net needs. GroupNorm is flax's one group over
(H, W, C) with epsilon 1e-6 and f32 statistics. The BiLSTM's recurrence
runs in float32 on every device (``BiLSTMTagger``).

Sizes that flax infers from the first input (an MLP's input width, a
ConvNet's flattened width, the input channels) are config keys here
(``input_dim``, ``height``/``width``, ``channels_in``, with the JAX
``example_input``'s defaults); ``sized_for`` fills them in from the data's
shape, as ``TorchModel`` and ``TorchLearner`` do.
"""

from __future__ import annotations

import math
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

    #: the ``model`` group when this layer's weight holds one column
    #: shard of the flax kernel (TP, parallel/plan.py); None: whole
    tp_group = None

    def forward(self, x):
        dt = self.compute_dtype
        if self.tp_group is None:
            b = None if self.bias is None else self.bias.to(dt)
            return F.linear(x.to(dt), self.weight.to(dt), b)
        # column-parallel: this rank's output columns, all-gathered into
        # the replicated activation; the input's gradient sums the shards'
        from ..parallel import collectives as coll
        y = F.linear(coll.copy_in(x.to(dt), self.tp_group),
                     self.weight.to(dt))
        y = coll.gather(y, -1, self.tp_group)
        return y if self.bias is None else y + self.bias.to(dt)


class Embed(nn.Embedding):
    """flax ``nn.Embed``: a float32 table whose gathered rows are cast to
    the compute dtype."""

    def __init__(self, num: int, d: int, dtype: torch.dtype):
        super().__init__(num, d, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, ids):
        return F.embedding(ids, self.weight).to(self.compute_dtype)


# ------------------------------------------------------------ image layers

def _same_pads(n: int, k: int, stride: int) -> tuple:
    """XLA's "SAME" padding of one spatial dim: out = ceil(n / stride), and
    the total padding's odd pixel goes to the high end."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pads(padding: str, n: int, k: int, stride: int) -> tuple:
    if padding == "same":
        return _same_pads(n, k, stride)
    if padding == "torch":
        return k // 2, k // 2
    return 0, 0                                          # "valid"


def _nhwc(x):
    """An NCHW activation as the NHWC float32 tensor a tap returns."""
    return x.permute(0, 2, 3, 1).float().contiguous()


def _tap_out(x):
    return _nhwc(x) if x.dim() == 4 else x.float()


class Conv2d(nn.Module):
    """flax ``nn.Conv`` on the NCHW (channels-last) view: a float32 OIHW
    weight (flax's HWIO, transposed) and optional bias cast to the compute
    dtype at each call. ``padding``: "same" (flax's default, XLA's SAME),
    "torch" (k//2 each side) or "valid". Symmetric padding is the conv's
    own; asymmetric padding is added by ``F.pad`` first."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 padding: str = "same", bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None
        self.k, self.stride, self.padding = k, stride, padding
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        ph = _pads(self.padding, x.shape[2], self.k, self.stride)
        pw = _pads(self.padding, x.shape[3], self.k, self.stride)
        x = x.to(dt)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            pad = 0
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x, self.weight.to(dt), b, self.stride, pad)


def _max_pool(x, k: int, stride: int, padding: str):
    """flax ``nn.max_pool`` on the NCHW view; padding pads with -inf."""
    ph = _pads(padding, x.shape[2], k, stride)
    pw = _pads(padding, x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.max_pool2d(x, k, stride, (ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, k, stride)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=None, group_size=C)``: one group over
    (H, W, C) of each sample, statistics, scale and bias in f32, epsilon
    1e-6 (torch's default is 1e-5), output cast to the compute dtype.

    One group over every element of a sample is a layer norm over the
    sample's (H, W, C), so it runs as ``F.layer_norm`` on the NHWC view
    (contiguous for a channels-last activation) with the per-channel
    affine broadcast over (H, W): the activation stays channels-last for
    the next conv (``F.group_norm`` returns NCHW-contiguous tensors, which
    cuDNN transposes back around every conv)."""

    def __init__(self, c: int, dtype: torch.dtype, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        _, c, h, w = x.shape
        y = F.layer_norm(x.permute(0, 2, 3, 1).float(), (h, w, c),
                         self.weight.float().expand(h, w, c),
                         self.bias.float().expand(h, w, c), self.eps)
        return y.to(self.dtype).permute(0, 3, 1, 2)


class FrozenAffine(nn.Module):
    """The JAX package's ``_FrozenAffine``: BatchNorm in eval mode as a
    per-channel ``x * weight + bias`` (flax's scale and bias) in the compute
    dtype; ``models.import_weights`` folds running statistics into it."""

    def __init__(self, c: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.dtype = dtype

    def forward(self, x):
        shape = (1, -1, 1, 1)
        return (x * self.weight.to(self.dtype).view(shape)
                + self.bias.to(self.dtype).view(shape))


def _norm_layer(norm: str, c: int, dtype):
    return FrozenAffine(c, dtype) if norm == "frozen" else GroupNorm(c, dtype)


class MLPNet(nn.Module):
    """Multilayer perceptron (the JAX package's ``MLPNet``): the input,
    flattened in its own order (NHWC for images), through ReLU Dense
    layers to a Dense head."""

    def __init__(self, hidden=(128, 64), num_classes: int = 2,
                 input_dim: int = 16, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        dims = [input_dim, *hidden]
        self.dtype = dtype
        self.hidden = nn.ModuleList(Dense(a, b, dtype)
                                    for a, b in zip(dims, dims[1:]))
        self.head = Dense(dims[-1], num_classes, dtype)

    def layer_names(self):
        return [f"dense{i}" for i in range(len(self.hidden))] + ["logits"]

    def forward(self, x, output_layer: Optional[str] = None):
        tap = _LayerTap(output_layer)
        x = x.to(self.dtype).reshape(x.shape[0], -1)
        for i, layer in enumerate(self.hidden):
            x = tap.tap(f"dense{i}", F.relu(layer(x)))
            if tap.done:
                return tap.result.float()
        return tap.tap("logits", self.head(x)).float()


class ConvNet(nn.Module):
    """CIFAR-style ConvNet (the JAX package's ``ConvNet``): 3x3 SAME convs
    with bias and ReLU, a VALID 2x2 max-pool after every second one, the
    NHWC flattening, a ReLU Dense and a Dense head. The Dense's input width
    follows from ``height``, ``width`` and the pools (flax infers it)."""

    def __init__(self, channels=(32, 32, 64, 64), dense: int = 512,
                 num_classes: int = 10, height: int = 32, width: int = 32,
                 channels_in: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        dims = [channels_in, *channels]
        self.dtype = dtype
        self.convs = nn.ModuleList(
            Conv2d(a, b, 3, bias=True, dtype=dtype)
            for a, b in zip(dims, dims[1:]))
        pools = len(channels) // 2
        h, w = height, width
        for _ in range(pools):
            h, w = h // 2, w // 2
        self.dense = Dense(h * w * dims[-1], dense, dtype)
        self.head = Dense(dense, num_classes, dtype)

    def layer_names(self):
        names = [f"conv{i}" for i in range(len(self.convs))]
        return names + ["dense", "logits"]

    def forward(self, x, output_layer: Optional[str] = None):
        tap = _LayerTap(output_layer)
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for i, conv in enumerate(self.convs):
            x = tap.tap(f"conv{i}", F.relu(conv(x)))
            if tap.done:
                return _tap_out(tap.result)
            if i % 2 == 1:
                x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC order
        x = tap.tap("dense", F.relu(self.dense(x)))
        if tap.done:
            return tap.result.float()
        return tap.tap("logits", self.head(x)).float()


class _BasicBlock(nn.Module):
    """3x3 -> 3x3 residual block. A 1x1 projection (and, frozen, its
    affine) joins when the shape changes; flax decides that from the
    traced shapes, the port from the channels and stride."""

    def __init__(self, c_in: int, filters: int, stride: int, dtype,
                 norm: str = "group", padding: str = "same"):
        super().__init__()
        self.conv1 = Conv2d(c_in, filters, 3, stride, padding, dtype=dtype)
        self.norm1 = _norm_layer(norm, filters, dtype)
        self.conv2 = Conv2d(filters, filters, 3, 1, padding, dtype=dtype)
        self.norm2 = _norm_layer(norm, filters, dtype)
        self.proj, self.proj_norm = _projection(c_in, filters, stride, dtype,
                                                norm)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        return F.relu(_shortcut(self, x) + y)


class _BottleneckBlock(nn.Module):
    """1x1 reduce -> 3x3 -> 1x1 expand (ResNet-50-family block);
    ``filters`` is the expanded width."""

    def __init__(self, c_in: int, filters: int, stride: int, dtype,
                 norm: str = "group", padding: str = "same"):
        super().__init__()
        inner = filters // 4
        self.conv1 = Conv2d(c_in, inner, 1, dtype=dtype)
        self.norm1 = _norm_layer(norm, inner, dtype)
        self.conv2 = Conv2d(inner, inner, 3, stride, padding, dtype=dtype)
        self.norm2 = _norm_layer(norm, inner, dtype)
        self.conv3 = Conv2d(inner, filters, 1, dtype=dtype)
        self.norm3 = _norm_layer(norm, filters, dtype)
        self.proj, self.proj_norm = _projection(c_in, filters, stride, dtype,
                                                norm)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        return F.relu(_shortcut(self, x) + y)


def _projection(c_in, filters, stride, dtype, norm):
    if c_in == filters and stride == 1:
        return None, None
    # torch normalises the projection too; the group-norm nets do not
    return (Conv2d(c_in, filters, 1, stride, dtype=dtype),
            FrozenAffine(filters, dtype) if norm == "frozen" else None)


def _shortcut(block, x):
    if block.proj is None:
        return x
    x = block.proj(x)
    return x if block.proj_norm is None else block.proj_norm(x)


class ResNet(nn.Module):
    """ResNet family (the JAX package's ``ResNet``): the CIFAR ResNet by
    default (depth 6n+2), or with ``block="bottleneck"``, per-stage depths
    and the ImageNet stem (7x7/2 conv, 3x3/2 max-pool) the ResNet-50 class.
    ``norm`` "group" (trains) or "frozen" (an imported eval-mode net);
    ``padding`` "same" or "torch"; ``input_norm`` a per-channel affine of
    the raw input ahead of the stem, where imported nets fold their
    preprocessing."""

    def __init__(self, blocks_per_stage=3, widths=(16, 32, 64),
                 num_classes: int = 10, block: str = "basic",
                 stem: str = "cifar", dtype: torch.dtype = torch.bfloat16,
                 norm: str = "group", padding: str = "same",
                 input_norm: bool = False, channels_in: int = 3):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"block must be basic|bottleneck, got {block!r}")
        if stem not in ("cifar", "imagenet"):
            raise ValueError(f"stem must be cifar|imagenet, got {stem!r}")
        if norm not in ("group", "frozen"):
            raise ValueError(f"norm must be group|frozen, got {norm!r}")
        if padding not in ("same", "torch"):
            raise ValueError(f"padding must be same|torch, got {padding!r}")
        self.widths = list(widths)
        self.depths = _stage_depths(blocks_per_stage, self.widths)
        self.stem_kind, self.padding, self.dtype = stem, padding, dtype
        Block = _BasicBlock if block == "basic" else _BottleneckBlock
        stem_width = widths[0] // 4 if block == "bottleneck" else widths[0]
        self.input_norm = (FrozenAffine(channels_in, dtype) if input_norm
                           else None)
        self.stem = (Conv2d(channels_in, stem_width, 7, 2, padding,
                            dtype=dtype) if stem == "imagenet"
                     else Conv2d(channels_in, stem_width, 3, 1, padding,
                                 dtype=dtype))
        self.stem_norm = _norm_layer(norm, stem_width, dtype)
        blocks, c = [], stem_width
        for s, (width, depth) in enumerate(zip(self.widths, self.depths)):
            for b in range(depth):
                blocks.append(Block(c, width, 2 if (s > 0 and b == 0) else 1,
                                    dtype, norm, padding))
                c = width
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(c, num_classes, dtype)

    def layer_names(self):
        names = ["stem"]
        for s, depth in enumerate(self.depths):
            names += [f"stage{s}_block{b}" for b in range(depth)]
        return names + ["pool", "logits"]

    def forward(self, x, output_layer: Optional[str] = None):
        tap = _LayerTap(output_layer)
        x = x.to(self.dtype).permute(0, 3, 1, 2)     # channels-last NCHW
        if self.input_norm is not None:
            x = self.input_norm(x)
        x = F.relu(self.stem_norm(self.stem(x)))
        if self.stem_kind == "imagenet":
            x = _max_pool(x, 3, 2, self.padding)
        x = tap.tap("stem", x)
        if tap.done:
            return _tap_out(tap.result)
        for name, blk in zip(self.layer_names()[1:-2], self.blocks):
            x = tap.tap(name, blk(x))
            if tap.done:
                return _tap_out(tap.result)
        # f32 sum, as jnp.mean of bf16
        x = tap.tap("pool", x.float().mean(dim=(2, 3)).to(self.dtype))
        if tap.done:
            return tap.result.float()
        return tap.tap("logits", self.head(x)).float()


def _stage_depths(blocks_per_stage, widths) -> list:
    if isinstance(blocks_per_stage, int):
        return [blocks_per_stage] * len(widths)
    depths = list(blocks_per_stage)
    if len(depths) != len(widths):
        raise ValueError(
            f"blocks_per_stage has {len(depths)} stages but widths has "
            f"{len(widths)} — set both (e.g. resnet50: "
            f"blocks_per_stage=[3,4,6,3], widths=[256,512,1024,2048])")
    return depths


class _LSTM(nn.LSTM):
    """``nn.LSTM`` that reads its weights from its parameter slots at each
    call, so weights bound in place (the trainer's ``_bind``) are the ones
    used."""

    def forward(self, x):
        self._flat_weights = [self._parameters[n]
                              for n in self._flat_weights_names]
        return super().forward(x)


class BiLSTMTagger(nn.Module):
    """Bidirectional LSTM sequence tagger (the JAX package's
    ``BiLSTMTagger``): int token ids (B, T) -> per-token logits
    (B, T, classes).

    flax's ``LSTMCell`` has unbiased input kernels (ii, if, ig, io) and
    biased hidden ones (hi, hf, hg, ho); torch's LSTM packs the gates
    (i, f, g, o) and has two biases, so the hidden biases go in
    ``bias_hh`` and ``bias_ih`` stays zero. The recurrence runs in float32
    whatever the compute dtype (flax keeps the carry in float32 too; its
    gate products are in the compute dtype): the embedding and the head
    run in the compute dtype."""

    def __init__(self, vocab_size: int = 10000, embed_dim: int = 128,
                 hidden: int = 128, num_classes: int = 8,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.embed = Embed(vocab_size, embed_dim, dtype)
        self.lstm = _LSTM(embed_dim, hidden, batch_first=True,
                          bidirectional=True, dtype=torch.float32)
        self.head = Dense(2 * hidden, num_classes, dtype)

    def layer_names(self):
        return ["embed", "bilstm", "logits"]

    def forward(self, tokens, output_layer: Optional[str] = None):
        tap = _LayerTap(output_layer)
        x = tap.tap("embed", self.embed(tokens))
        if tap.done:
            return tap.result.float()
        x = tap.tap("bilstm", self.lstm(x.float())[0])
        if tap.done:
            return tap.result.float()
        return tap.tap("logits", self.head(x)).float()


class _EncoderBlock(nn.Module):
    """One pre-norm transformer block: attention + (dense | MoE) FFN."""

    def __init__(self, d_model: int, heads: int, mlp_ratio: int,
                 dtype: torch.dtype, attention: Callable,
                 num_experts: int = 0, expert_top_k: int = 2,
                 capacity_factor: float = 1.25):
        super().__init__()
        self.heads = heads
        self.attention = attention     # (q, k, v) -> o, from the encoder
        hidden = mlp_ratio * d_model
        self.ln1 = LayerNorm(d_model, dtype)
        self.qkv = Dense(d_model, 3 * d_model, dtype, bias=False)
        self.proj = Dense(d_model, d_model, dtype, bias=False)
        self.ln2 = LayerNorm(d_model, dtype)
        if num_experts > 0:
            from .moe import MoEMLP
            self.moe = MoEMLP(num_experts, hidden, top_k=expert_top_k,
                              capacity_factor=capacity_factor, dtype=dtype,
                              d_model=d_model)
        else:
            self.moe = None
            self.fc1 = Dense(d_model, hidden, dtype)
            self.fc2 = Dense(hidden, d_model, dtype)

    def forward(self, x, row_mask=None, aux=None):
        B, T, d = x.shape
        H = self.heads
        qkv = self.qkv(self.ln1(x)).view(B, T, 3 * H, d // H)
        q, k, v = qkv.split(H, dim=2)       # head-major thirds, as in flax
        a = self.attention(q, k, v).reshape(B, T, d)
        x = x + self.proj(a)
        if self.moe is not None:
            return x + self.moe(self.ln2(x), row_mask=row_mask, aux=aux)
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
    x T), at the price of a second forward of every block). MoE blocks
    refuse it, as in the JAX package.

    ``num_experts > 0`` swaps each block's FFN for a :class:`~.moe.MoEMLP`
    (``expert_top_k``, ``capacity_factor``); ``forward`` then takes a
    ``row_mask`` (B,) of row weights (0: padding, which claims no expert
    capacity) and a ``moe_aux`` list each block appends its aux loss to.
    ``attn_fn`` injects an attention callable (q, k, v) -> o in place of
    ``attn_impl``'s, e.g. a sequence-parallel form
    (``parallel.sequence.make_sp_attention``).

    Input: int token ids (B, T). Output: (B, num_classes) float32 when
    ``pool='mean'``, else per-token (B, T, num_classes).
    """

    def __init__(self, vocab_size: int = 10000, d_model: int = 128,
                 heads: int = 4, layers: int = 2, mlp_ratio: int = 4,
                 num_classes: int = 2, max_len: int = 2048,
                 causal: bool = False, pool: str = "mean",
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "auto", block_size: int = 512,
                 remat: bool = False, num_experts: int = 0,
                 expert_top_k: int = 2, capacity_factor: float = 1.25,
                 attn_fn: Optional[Callable] = None):
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
        self.num_experts = num_experts
        self.attn_fn = attn_fn
        self.tok_embed = Embed(vocab_size, d_model, dtype)
        self.pos_embed = Embed(max_len, d_model, dtype)
        self.blocks = nn.ModuleList(
            _EncoderBlock(d_model, heads, mlp_ratio, dtype, self._attention,
                          num_experts, expert_top_k, capacity_factor)
            for _ in range(layers))
        self.ln_f = LayerNorm(d_model, dtype)
        self.head = Dense(d_model, num_classes, dtype)

    def layer_names(self):
        return ["embed"] + [f"block{i}" for i in range(self.layers)] + ["logits"]

    def _attention(self, q, k, v):
        if self.attn_fn is not None:
            return self.attn_fn(q, k, v)
        impl = self.attn_impl
        if impl == "auto":
            impl = "flash" if q.device.type == "cuda" else "blockwise"
        if impl == "flash":
            from ..ops.flash_attention import flash_attention
            return flash_attention(q, k, v, causal=self.causal)
        from ..parallel.sequence import blockwise_attention
        return blockwise_attention(q, k, v, block_size=self.block_size,
                                   causal=self.causal)

    def embed(self, tokens):
        """The embedding sum (B, T, d) in the compute dtype."""
        B, T = tokens.shape
        if T > self.max_len:
            raise ValueError(f"sequence length {T} exceeds max_len "
                             f"{self.max_len}")
        pos = torch.arange(T, device=tokens.device)
        return self.tok_embed(tokens) + self.pos_embed(pos)[None]

    def head_out(self, x):
        """Final norm, pooling and head: (B, T, d) -> float32 logits."""
        x = self.ln_f(x)
        if self.pool == "mean":
            x = x.float().mean(dim=1).to(self.dtype)   # f32 sum, as jnp.mean
        return self.head(x).float()

    def forward(self, tokens, output_layer: Optional[str] = None,
                row_mask=None, moe_aux: Optional[list] = None):
        tap = _LayerTap(output_layer)
        if self.remat and self.num_experts > 0:
            raise ValueError("remat with MoE blocks is unsupported (the sown "
                             "aux loss does not survive rematerialization)")
        x = tap.tap("embed", self.embed(tokens))
        if tap.done:
            return tap.result.float()
        remat = self.remat and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            x = tap.tap(f"block{i}",
                        checkpoint(blk, x, use_reentrant=False) if remat
                        else blk(x, row_mask, moe_aux))
            if tap.done:
                return tap.result.float()
        return tap.tap("logits", self.head_out(x))


# ---------------------------------------------------------------- registry

# families whose input is int token ids (callers must cast features to ints)
TOKEN_MODELS = ("bilstm", "transformer")


def _build_transformer(cfg: dict, attn_fn=None) -> TransformerEncoder:
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
        num_experts=cfg.get("num_experts", 0),
        expert_top_k=cfg.get("expert_top_k", 2),
        capacity_factor=cfg.get("capacity_factor", 1.25),
        dtype=resolve_dtype(cfg.get("dtype")), attn_fn=attn_fn)


def _dtype(cfg):
    return resolve_dtype(cfg.get("dtype"))


MODEL_BUILDERS: dict[str, Callable[[dict], nn.Module]] = {
    "mlp": lambda cfg: MLPNet(
        hidden=tuple(cfg.get("hidden", (128, 64))),
        num_classes=cfg.get("num_classes", 2),
        input_dim=cfg.get("input_dim", 16), dtype=_dtype(cfg)),
    "convnet": lambda cfg: ConvNet(
        channels=tuple(cfg.get("channels", (32, 32, 64, 64))),
        dense=cfg.get("dense", 512),
        num_classes=cfg.get("num_classes", 10),
        height=cfg.get("height", 32), width=cfg.get("width", 32),
        channels_in=cfg.get("channels_in", 3), dtype=_dtype(cfg)),
    "resnet": lambda cfg: ResNet(
        blocks_per_stage=cfg.get("blocks_per_stage", 3),
        widths=tuple(cfg.get("widths", (16, 32, 64))),
        num_classes=cfg.get("num_classes", 10),
        block=cfg.get("block", "basic"), stem=cfg.get("stem", "cifar"),
        dtype=_dtype(cfg), norm=cfg.get("norm", "group"),
        padding=cfg.get("padding", "same"),
        input_norm=cfg.get("input_norm", False),
        channels_in=cfg.get("channels_in", 3)),
    # the reference ImageFeaturizer's headline model (ResNet-50, ImageNet)
    "resnet50": lambda cfg: ResNet(
        blocks_per_stage=tuple(cfg.get("blocks_per_stage", (3, 4, 6, 3))),
        widths=tuple(cfg.get("widths", (256, 512, 1024, 2048))),
        num_classes=cfg.get("num_classes", 1000),
        block="bottleneck", stem="imagenet", dtype=_dtype(cfg),
        norm=cfg.get("norm", "group"), padding=cfg.get("padding", "same"),
        input_norm=cfg.get("input_norm", False),
        channels_in=cfg.get("channels_in", 3)),
    "bilstm": lambda cfg: BiLSTMTagger(
        vocab_size=cfg.get("vocab_size", 10000),
        embed_dim=cfg.get("embed_dim", 128),
        hidden=cfg.get("hidden", 128),
        num_classes=cfg.get("num_classes", 8), dtype=_dtype(cfg)),
    "transformer": _build_transformer,
}

IMAGE_MODELS = ("convnet", "resnet", "resnet50")


def build_model(config: dict, attn_fn: Optional[Callable] = None
                ) -> nn.Module:
    """config: {"type": <family>, ...family kwargs...} -> nn.Module (on the
    current default device; callers move it with ``.to(device)``).

    ``attn_fn`` (transformer only): inject an attention callable, e.g. a
    sequence-parallel form (parallel.sequence.make_sp_attention) — kept
    out of the config dict so configs stay JSON-serialisable. Only the
    transformer reads ``num_experts``; a stray one on another family is
    ignored."""
    cfg = dict(config)
    mtype = cfg.pop("type")
    if mtype not in MODEL_BUILDERS:
        raise KeyError(f"unknown model type {mtype!r}; "
                       f"have {sorted(MODEL_BUILDERS)}")
    if mtype == "transformer":
        return MODEL_BUILDERS[mtype](cfg, attn_fn=attn_fn)
    return MODEL_BUILDERS[mtype](cfg)


def sized_for(config: dict, input_shape) -> dict:
    """``config`` with the sizes flax infers from the first input taken
    from ``input_shape`` (batch first): an MLP's ``input_dim``, a ConvNet's
    ``height``, ``width`` and ``channels_in``, a ResNet's ``channels_in``.
    Token models and empty shapes leave it as it is."""
    cfg = dict(config)
    shape = tuple(input_shape)
    mtype = cfg.get("type")
    if len(shape) < 2 or mtype in TOKEN_MODELS:
        return cfg
    if mtype == "mlp":
        cfg["input_dim"] = math.prod(shape[1:])
    elif mtype in IMAGE_MODELS and len(shape) == 4:
        if mtype == "convnet":
            cfg["height"], cfg["width"] = shape[1], shape[2]
        cfg["channels_in"] = shape[3]
    return cfg


def example_input(config: dict, batch: int = 2) -> torch.Tensor:
    """A tiny correctly-shaped input for shape checks."""
    mtype = config["type"]
    if mtype == "mlp":
        return torch.zeros((batch, config.get("input_dim", 16)))
    if mtype in IMAGE_MODELS:
        default_hw = 64 if mtype == "resnet50" else 32
        return torch.zeros((batch, config.get("height", default_hw),
                            config.get("width", default_hw),
                            config.get("channels_in", 3)))
    if mtype in TOKEN_MODELS:
        return torch.zeros((batch, config.get("seq_len", 16)),
                           dtype=torch.long)
    raise KeyError(mtype)
