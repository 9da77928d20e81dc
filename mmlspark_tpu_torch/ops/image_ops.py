"""Batched image ops as plain torch functions on NHWC float32 tensors.

The port of ``mmlspark_tpu/ops/image_ops.py`` (reference:
src/image-transformer/src/main/scala/ImageTransformer.scala:21-210 —
ResizeImage:34, CropImage:66, ColorFormat:92, Flip:111, Blur:136,
Threshold:159, GaussianKernel:185). Every op works on a whole batch
(N, H, W, C) on the tensor's device; the stages group rows by shape and run
one chain per shape bucket, with one host -> device copy and one copy back.

Convention: images are float32 in [0, 255], channel order as stored (OpenCV
BGR for decoded files). Flip codes match OpenCV: 0 = up/down, 1 =
left/right, -1 = both.

Against ``jax.image.resize`` (bilinear, antialiased when it shrinks),
``F.interpolate(..., antialias=True)`` agrees within 3e-4 on a 0..255 scale
(the tests hold it at 1e-3); without antialiasing a downscale is off by up
to ~116.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.env import resolve_device


def _nchw(batch):
    return batch.permute(0, 3, 1, 2)


def _nhwc(batch):
    return batch.permute(0, 2, 3, 1)


def resize(batch: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize, antialiased when it shrinks, as
    ``jax.image.resize(..., "bilinear")``."""
    out = F.interpolate(_nchw(batch), size=(int(height), int(width)),
                        mode="bilinear", align_corners=False, antialias=True)
    return _nhwc(out)


def crop(batch: torch.Tensor, x: int, y: int, height: int,
         width: int) -> torch.Tensor:
    """Crop with OpenCV Rect(x, y, w, h) semantics — x is the column offset,
    y the row offset. An out-of-bounds rect is an error, as OpenCV's
    Mat(image, rect), not a silent truncation."""
    _, h, w, _ = batch.shape
    if height <= 0 or width <= 0 or x < 0 or y < 0 \
            or y + height > h or x + width > w:
        raise ValueError(f"crop rect (x={x}, y={y}, h={height}, w={width}) "
                         f"exceeds image bounds {h}x{w}")
    return batch[:, y:y + height, x:x + width, :]


def flip(batch: torch.Tensor, flip_code: int) -> torch.Tensor:
    if flip_code == 0:
        return torch.flip(batch, dims=(1,))
    if flip_code == 1:
        return torch.flip(batch, dims=(2,))
    if flip_code == -1:
        return torch.flip(batch, dims=(1, 2))
    raise ValueError(f"flipCode must be 0, 1 or -1, got {flip_code}")


def color_format(batch: torch.Tensor, conversion: str) -> torch.Tensor:
    """Channel-order / colorspace conversion. Supported: BGR2RGB, RGB2BGR,
    BGR2GRAY, RGB2GRAY, GRAY2BGR, GRAY2RGB."""
    conv = conversion.upper()
    if conv in ("BGR2RGB", "RGB2BGR"):
        return torch.flip(batch, dims=(3,))
    if conv in ("BGR2GRAY", "RGB2GRAY"):
        # ITU-R BT.601 luma weights, as OpenCV uses
        w = torch.tensor([0.114, 0.587, 0.299] if conv == "BGR2GRAY"
                         else [0.299, 0.587, 0.114], dtype=batch.dtype,
                         device=batch.device)
        return torch.tensordot(batch, w, dims=([3], [0]))[..., None]
    if conv in ("GRAY2BGR", "GRAY2RGB"):
        return batch.repeat_interleave(3, dim=3)
    raise ValueError(f"unsupported color conversion {conversion!r}")


def _depthwise_conv(batch: torch.Tensor, kernel2d: np.ndarray) -> torch.Tensor:
    """Depthwise SAME correlation with reflect-101 padding (OpenCV's default
    border; numpy's and torch's "reflect"); an even kernel pads k//2 low
    and k-1-k//2 high. Images smaller than the pad take edge padding
    (torch's "replicate"), as OpenCV never fails on them."""
    kh, kw = kernel2d.shape
    _, h, w, c = batch.shape
    ph, pw = kh // 2, kw // 2
    pads = (pw, kw - 1 - pw, ph, kh - 1 - ph)
    mode = ("reflect" if max(ph, kh - 1 - ph) < h
            and max(pw, kw - 1 - pw) < w else "replicate")
    x = F.pad(_nchw(batch), pads, mode=mode)
    k = torch.as_tensor(kernel2d, dtype=batch.dtype, device=batch.device)
    out = F.conv2d(x, k.expand(c, 1, kh, kw), groups=c)
    return _nhwc(out)


def blur(batch: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Normalized box filter. The reference passes ``new Size(height,
    width)`` to Imgproc.blur, and OpenCV's Size is (width, height) — so the
    reference's ``height`` param is the kernel's horizontal extent:
    kernel rows = the width param, kernel cols = the height param."""
    h, w = int(height), int(width)
    return _depthwise_conv(batch, np.full((w, h), 1.0 / (h * w), np.float32))


def gaussian_kernel_1d(aperture: int, sigma: float) -> np.ndarray:
    """OpenCV getGaussianKernel: if sigma<=0, sigma = 0.3*((ksize-1)*0.5-1)+0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((aperture - 1) * 0.5 - 1) + 0.8
    xs = np.arange(aperture, dtype=np.float64) - (aperture - 1) / 2.0
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(batch: torch.Tensor, aperture: int,
                  sigma: float) -> torch.Tensor:
    """The reference applies a 1-D gaussian column kernel via filter2D
    (GaussianKernel stage): it filters along H only."""
    return _depthwise_conv(batch, gaussian_kernel_1d(aperture, sigma)[:, None])


def threshold(batch: torch.Tensor, thresh: float, max_val: float,
              threshold_type: str = "binary") -> torch.Tensor:
    """OpenCV threshold types on batched images."""
    t = threshold_type.lower()
    above = batch > thresh
    if t == "binary":
        return torch.where(above, max_val, 0.0).to(batch.dtype)
    if t == "binary_inv":
        return torch.where(above, 0.0, max_val).to(batch.dtype)
    if t == "trunc":
        return torch.clamp(batch, max=thresh)
    if t == "tozero":
        return torch.where(above, batch, 0.0)
    if t == "tozero_inv":
        return torch.where(above, 0.0, batch)
    raise ValueError(f"unknown threshold type {threshold_type!r}")


def unroll(batch: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, C*H*W) in CHW order, the layout deep-net inputs
    expect (reference: UnrollImage.scala:18-43)."""
    return _nchw(batch).reshape(batch.shape[0], -1)


# op registry: name -> (fn, param names); drives ImageTransformer stage lists
OP_TABLE = {
    "resize": (resize, ("height", "width")),
    "crop": (crop, ("x", "y", "height", "width")),
    "flip": (flip, ("flipCode",)),
    "colorformat": (color_format, ("format",)),
    "blur": (blur, ("height", "width")),
    "gaussiankernel": (gaussian_blur, ("appertureSize", "sigma")),
    "threshold": (threshold, ("threshold", "maxVal", "type")),
}


def run_chain(batch: torch.Tensor, ops: list) -> torch.Tensor:
    """Apply a list of ``{'op': name, **params}`` dicts to an NHWC float32
    tensor, on its device."""
    for d in ops:
        fn, argnames = OP_TABLE[d["op"]]
        batch = fn(batch, *[d[a] for a in argnames])
    return batch


def apply_op_chain(batch_np: np.ndarray, ops: list,
                   device: str = "cuda") -> np.ndarray:
    """Apply a list of ``{'op': name, **params}`` dicts to an NHWC
    uint8/float batch on ``device``; returns float32. One host -> device
    copy, the chain, one copy back."""
    dev = resolve_device(device, "apply_op_chain")
    x = torch.from_numpy(np.ascontiguousarray(batch_np)).to(dev)
    return run_chain(x.float(), ops).cpu().numpy()
