"""Seeded synthetic data for the port's tests and its smoke run: the port's
copies of ``mmlspark_tpu/testing/datagen.py``'s shapes10 corpus and
torchvision-layout ResNet checkpoint (pure numpy; the same seed gives the
same arrays, bit for bit).

* **shapes10** — a procedural image-classification corpus (the zoo's
  ``ResNet20_shapes10`` was trained on ``make_shapes10(20000, seed=7)`` and
  scored on ``make_shapes10(4000, seed=8)``): 10 geometric classes with
  randomized position, scale, colors and noise.
* ``make_torchvision_state`` — a synthetic checkpoint in torchvision's
  ResNet state-dict layout, for ``models.import_weights.import_resnet50``
  without downloaded weights.
"""

from __future__ import annotations

import numpy as np

SHAPES10_CLASSES = ("circle", "square", "triangle", "cross", "hstripes",
                    "vstripes", "ring", "diamond", "checker", "dots")


def _shape_mask(cls: int, size: int, rng) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cy = rng.uniform(size * 0.35, size * 0.65)
    cx = rng.uniform(size * 0.35, size * 0.65)
    r = rng.uniform(size * 0.18, size * 0.32)
    dy, dx = yy - cy, xx - cx
    if cls == 0:      # circle
        return dy * dy + dx * dx <= r * r
    if cls == 1:      # square
        return (np.abs(dy) <= r) & (np.abs(dx) <= r)
    if cls == 2:      # triangle
        return (dy >= -r) & (dy <= r) & (np.abs(dx) <= (dy + r) * 0.6)
    if cls == 3:      # cross
        w = r * 0.35
        return ((np.abs(dy) <= w) & (np.abs(dx) <= r)) | \
               ((np.abs(dx) <= w) & (np.abs(dy) <= r))
    if cls == 4:      # horizontal stripes
        period = max(2.0, r * 0.8)
        return ((yy / period).astype(np.int32) % 2 == 0)
    if cls == 5:      # vertical stripes
        period = max(2.0, r * 0.8)
        return ((xx / period).astype(np.int32) % 2 == 0)
    if cls == 6:      # ring
        d2 = dy * dy + dx * dx
        return (d2 <= r * r) & (d2 >= (0.55 * r) ** 2)
    if cls == 7:      # diamond
        return np.abs(dy) + np.abs(dx) <= r * 1.2
    if cls == 8:      # checkerboard
        period = max(2.0, r * 0.9)
        return (((yy / period).astype(np.int32)
                 + (xx / period).astype(np.int32)) % 2 == 0)
    # dots grid
    period = max(3.0, r * 0.9)
    return (np.mod(yy, period) <= period * 0.4) & \
        (np.mod(xx, period) <= period * 0.4) & \
        (dy * dy + dx * dx <= (size * 0.45) ** 2)


def make_shapes10(n: int, size: int = 32, num_classes: int = 10,
                  seed: int = 0, class_offset: int = 0):
    """(x uint8 (n, size, size, 3), y int64 (n,)) — the shapes10 corpus.

    ``class_offset`` rotates which of the 10 shape families map to labels
    (transfer-learning examples hold some families out of pretraining)."""
    rng = np.random.default_rng(seed)
    x = np.empty((n, size, size, 3), dtype=np.uint8)
    y = rng.integers(0, num_classes, size=n)
    for i in range(n):
        cls = (int(y[i]) + class_offset) % len(SHAPES10_CLASSES)
        bg = rng.uniform(0, 120, 3)
        fg = rng.uniform(135, 255, 3)
        if rng.random() < 0.5:
            bg, fg = fg, bg
        mask = _shape_mask(cls, size, rng)
        img = np.where(mask[..., None], fg[None, None], bg[None, None])
        img = img + rng.normal(0, 18, img.shape)
        x[i] = np.clip(img, 0, 255).astype(np.uint8)
    return x, y.astype(np.int64)


def make_torchvision_state(depths=(3, 4, 6, 3),
                           widths=(256, 512, 1024, 2048),
                           num_classes: int = 1000, seed: int = 1,
                           conv_scale: float = 0.05) -> dict:
    """A synthetic checkpoint in torchvision's ResNet state-dict LAYOUT
    (conv1/bn1/layer{L}.{B}.conv*/bn*/downsample/fc keys, torch OIHW conv
    shapes, BN running stats) — the single source for exercising
    ``models.import_weights.import_resnet50`` in tests and examples
    without real downloaded weights."""
    rng = np.random.default_rng(seed)

    def conv(o, i, k):
        return (rng.normal(size=(o, i, k, k)) * conv_scale).astype(np.float32)

    def bn(c, prefix, state):
        state[f"{prefix}.weight"] = np.abs(
            rng.normal(size=c).astype(np.float32)) + 0.5
        state[f"{prefix}.bias"] = rng.normal(size=c).astype(np.float32) * .1
        state[f"{prefix}.running_mean"] = rng.normal(
            size=c).astype(np.float32) * .1
        state[f"{prefix}.running_var"] = np.abs(
            rng.normal(size=c).astype(np.float32)) + 1.0
        state[f"{prefix}.num_batches_tracked"] = np.array(1, np.int64)

    state = {"conv1.weight": conv(widths[0] // 4, 3, 7)}
    bn(widths[0] // 4, "bn1", state)
    cin = widths[0] // 4
    for li, (w, d) in enumerate(zip(widths, depths), start=1):
        for b in range(d):
            t = f"layer{li}.{b}"
            state[f"{t}.conv1.weight"] = conv(w // 4, cin, 1)
            bn(w // 4, f"{t}.bn1", state)
            state[f"{t}.conv2.weight"] = conv(w // 4, w // 4, 3)
            bn(w // 4, f"{t}.bn2", state)
            state[f"{t}.conv3.weight"] = conv(w, w // 4, 1)
            bn(w, f"{t}.bn3", state)
            if b == 0:
                state[f"{t}.downsample.0.weight"] = conv(w, cin, 1)
                bn(w, f"{t}.downsample.1", state)
            cin = w
    state["fc.weight"] = rng.normal(size=(num_classes, cin)).astype(
        np.float32) * 0.01
    state["fc.bias"] = np.zeros(num_classes, np.float32)
    return state
