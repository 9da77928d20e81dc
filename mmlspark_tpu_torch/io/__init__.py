"""IO layer of the PyTorch port (reference: src/io): the port of
``mmlspark_tpu/io``. ``readImages``/``readBinaryFiles`` mirror the
reference's session implicits (io/src/main/scala/Readers.scala:14-45).

* :mod:`binary` — files and zip entries as BinaryFileSchema rows;
* :mod:`image` — ImageSchema rows (HWC uint8 BGR) decoded by the native
  runtime, and ``write_images`` with the port's own PNG, BMP and PPM
  encoders;
* :mod:`csv` — the native threaded CSV parser;
* :mod:`loader` — fixed-shape image batches from files, and
  ``device_image_batches``: pinned staging and non-blocking copies to the
  card;
* :mod:`arrow` — Arrow record batches to device tensors
  (``arrow_feature_batches``) and DataFrames;
* :mod:`http` — the HTTP source, sink and serving loops, the worker
  process and the client stages (over ``urllib``);
* :mod:`serving` — continuous batching with one CUDA graph per bucket,
  and the serving bundle;
* :mod:`powerbi` — the PowerBI stream writer.
"""

from . import arrow, binary, csv, http, image, loader, powerbi, serving
from .arrow import (arrow_feature_batches, arrow_frames, batch_to_matrix,
                    frame_from_arrow_stream)
from .binary import read_binary_files, recurse_path
from .csv import read_csv, read_csv_matrix
from .image import decode_image, read_images, write_images
from .loader import device_image_batches, image_batches, list_images

readImages = read_images
readBinaryFiles = read_binary_files

__all__ = ["arrow", "binary", "csv", "http", "image", "loader", "powerbi",
           "serving",
           "arrow_feature_batches", "arrow_frames", "batch_to_matrix",
           "frame_from_arrow_stream", "read_binary_files", "recurse_path",
           "read_csv", "read_csv_matrix", "decode_image", "read_images",
           "write_images", "device_image_batches", "image_batches",
           "list_images", "readImages", "readBinaryFiles"]
