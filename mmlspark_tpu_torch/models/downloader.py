"""Model repository + downloader: the port of ``mmlspark_tpu/models/
downloader.py`` (reference: src/downloader/src/main/scala/ — Schema.scala:
16-72, ModelDownloader.scala:23-230).

A model artifact is one ``<name>_<dataset>.model`` zip holding
``config.json`` (the declarative config of ``models.build_model``) and
``params.msgpack``: a flax param tree in flax's msgpack format, so the zoo
and the JAX package read the port's artifacts and the port reads theirs.
The port has neither flax nor the ``msgpack`` package; it keeps a reader
and a writer of the subset flax writes for a param tree
(:func:`read_flax_msgpack`, :func:`write_flax_msgpack`): maps with str
keys, arrays as ext type 1 whose payload is the msgpack of ``(shape,
dtype name, C-order bytes)``, numbers as msgpack ints and floats or ext
type 3 (a numpy scalar). Anything else raises.

Every transfer is checked against the schema's sha256 (reference:
Schema.scala:34-40). The HTTP repository (``RemoteRepo``, a ``server_url``)
waits for the port of ``io/`` (ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import zipfile
from dataclasses import asdict, dataclass, field, replace
from typing import Iterable, Optional

import numpy as np

MANIFEST = "MANIFEST"

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ------------------------------------------------------- flax msgpack

class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xc4: "B", 0xc5: "H", 0xc6: "I"}          # bin
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        ext = {0xc7: "B", 0xc8: "H", 0xc9: "I"}
        if b in ext:
            n = self.unpack(ext[b])
            return self.ext(self.unpack("b"), n)
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(self.unpack("b"), fixext[b])
        numbers = {0xca: "f", 0xcb: "d", 0xcc: "B", 0xcd: "H", 0xce: "I",
                   0xcf: "Q", 0xd0: "b", 0xd1: "h", 0xd2: "i", 0xd3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        strs = {0xd9: "B", 0xda: "H", 0xdb: "I"}
        if b in strs:
            return str(self.take(self.unpack(strs[b])), "utf-8")
        if b in (0xdc, 0xdd):
            n = self.unpack("H" if b == 0xdc else "I")
            return [self.value() for _ in range(n)]
        if b in (0xde, 0xdf):
            return self.map(self.unpack("H" if b == 0xde else "I"))
        raise ValueError(f"msgpack type byte {b:#x} is outside the subset "
                         f"flax writes for a param tree")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, str):
                raise ValueError(f"msgpack map key {k!r} is not a str")
            out[k] = self.value()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("chunked arrays (over 1 GiB) are not read")
        return out

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is outside the subset "
                             f"flax writes for a param tree")
        inner = _Reader(payload)
        shape, name, buf = inner.value()
        try:
            dtype = np.dtype(name)
        except TypeError:
            raise ValueError(f"array dtype {name!r} is not a numpy dtype") \
                from None
        arr = np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
        return arr[()] if code == _EXT_NPSCALAR else arr


def read_flax_msgpack(data: bytes):
    """flax ``msgpack_restore`` of a param tree: nested dicts of numpy
    arrays (and scalars)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack value")
    return out


def _head(small: int, codes: tuple, n: int) -> bytes:
    """The header of a sized msgpack value: a fix form below ``small``, else
    the 8/16/32-bit length form (``codes``; None where the type has none)."""
    if n < small:
        return bytes([codes[0] | n])
    for code, fmt, limit in zip(codes[1:], "BHI", (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(">" + fmt, n)
    raise ValueError(f"msgpack value of length {n} is too long")


def _pack(v, out: list):
    if isinstance(v, dict):
        out.append(_head(16, (0x80, None, 0xde, 0xdf), len(v)))
        if not all(isinstance(k, str) for k in v):
            raise ValueError(f"param tree keys {list(v)} are not all str")
        for k in sorted(v):                    # flax writes keys sorted
            _pack(k, out)
            _pack(v[k], out)
    elif isinstance(v, (list, tuple)):
        out.append(_head(16, (0x90, None, 0xdc, 0xdd), len(v)))
        for x in v:
            _pack(x, out)
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        out.append(_head(32, (0xa0, 0xd9, 0xda, 0xdb), len(raw)) + raw)
    elif isinstance(v, bytes):
        out.append(_head(0, (0, 0xc4, 0xc5, 0xc6), len(v)) + v)
    elif v is None or isinstance(v, bool):
        out.append(bytes([{None: 0xc0, False: 0xc2, True: 0xc3}[v]]))
    elif isinstance(v, int):
        out.append(_pack_int(v))
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    else:
        arr, code = _as_array(v)
        if arr.nbytes > 1 << 30:
            raise ValueError(f"an array of {arr.nbytes} bytes would be "
                             f"chunked by flax; not supported")
        inner: list = []
        _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], inner)
        payload = b"".join(inner)
        fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        head = (bytes([fixed[len(payload)]]) if len(payload) in fixed
                else _head(0, (0, 0xc7, 0xc8, 0xc9), len(payload)))
        out.append(head + struct.pack(">b", code) + payload)


def _pack_int(v: int) -> bytes:
    """The shortest msgpack form of an int, as msgpack-python packs it."""
    if 0 <= v <= 0x7f or -32 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    forms = ((0xcc, "B"), (0xcd, "H"), (0xce, "I"), (0xcf, "Q")) if v > 0 \
        else ((0xd0, "b"), (0xd1, "h"), (0xd2, "i"), (0xd3, "q"))
    for code, fmt in forms:
        try:
            return bytes([code]) + struct.pack(">" + fmt, v)
        except struct.error:
            continue
    raise ValueError(f"int {v} does not fit 64 bits")


def _as_array(v):
    if isinstance(v, np.generic):
        return np.asarray(v), _EXT_NPSCALAR
    if isinstance(v, np.ndarray):
        return v, _EXT_NDARRAY
    if hasattr(v, "detach"):                              # a torch tensor
        return v.detach().cpu().numpy(), _EXT_NDARRAY
    raise ValueError(f"cannot write a {type(v).__name__} into a param tree")


def write_flax_msgpack(tree) -> bytes:
    """A param tree of dicts and arrays as the bytes flax's
    ``msgpack_serialize`` gives it, bit for bit (arrays above 1 GiB, which
    flax writes in chunks, are not supported)."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


# ------------------------------------------------------------- schemas

def canonical_model_filename(name: str, dataset: str) -> str:
    """NamingConventions.canonicalModelFilename (Schema.scala:16-21)."""
    return f"{name}_{dataset}.model"


@dataclass
class ModelSchema:
    """Schema of a repository model (reference: Schema.scala:54-72)."""
    name: str
    dataset: str = ""
    modelType: str = "image"
    uri: str = ""
    hash: str = ""
    size: int = 0
    inputNode: int = 0
    numLayers: int = 0
    layerNames: list = field(default_factory=list)

    def toJson(self) -> str:
        return json.dumps(asdict(self), indent=2)

    @staticmethod
    def fromJson(s: str) -> "ModelSchema":
        return ModelSchema(**json.loads(s))

    def updateURI(self, uri: str) -> "ModelSchema":
        return replace(self, uri=uri)

    def assertMatchingHash(self, data: bytes):
        """sha256 gate on every transfer (reference: Schema.scala:34-40)."""
        got = hashlib.sha256(data).hexdigest()
        if got != self.hash:
            raise ValueError(
                f"downloaded hash: {got} does not match given hash: {self.hash}")


class ModelNotFoundException(FileNotFoundError):
    pass


# ------------------------------------------------------------- artifacts

def pack_model(config: dict, params) -> bytes:
    """{config, params} -> one .model zip blob. ``params`` is a flax tree
    or the port's state_dict, which is written as the flax tree of
    ``config`` (``models.weights.to_flax_params``)."""
    from .weights import is_flax_tree, to_flax_params
    tree = params if is_flax_tree(params) else to_flax_params(params, config)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("config.json", json.dumps(config))
        z.writestr("params.msgpack", write_flax_msgpack(tree))
    return buf.getvalue()


def unpack_model(blob: bytes) -> tuple:
    """A .model blob -> (config, flax param tree of numpy arrays)."""
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        config = json.loads(z.read("config.json"))
        params = read_flax_msgpack(z.read("params.msgpack"))
    return config, params


# ----------------------------------------------------------- repositories

class Repository:
    """listSchemas/getBytes/addBytes contract (ModelDownloader.scala:23-35)."""

    def listSchemas(self) -> Iterable[ModelSchema]:
        raise NotImplementedError

    def getBytes(self, schema: ModelSchema) -> bytes:
        raise NotImplementedError

    def addBytes(self, schema: ModelSchema, data: bytes) -> ModelSchema:
        raise NotImplementedError


class LocalRepo(Repository):
    """Directory of ``*.model`` blobs + ``*.model.meta`` schema JSONs (the
    HDFSRepo analog, ModelDownloader.scala:39-106, on a plain
    filesystem)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def listSchemas(self) -> list:
        out = []
        for fn in sorted(os.listdir(self.root)):
            if fn.endswith(".meta"):
                with open(os.path.join(self.root, fn)) as f:
                    s = ModelSchema.fromJson(f.read())
                # metas store the relative canonical filename, so a repo
                # directory is portable; resolve it for callers
                if s.uri and not os.path.isabs(s.uri):
                    s = s.updateURI(os.path.join(self.root, s.uri))
                out.append(s)
        return out

    def getBytes(self, schema: ModelSchema) -> bytes:
        path = schema.uri if os.path.isabs(schema.uri) else \
            os.path.join(self.root, os.path.basename(schema.uri))
        if not os.path.exists(path):
            raise ModelNotFoundException(path)
        with open(path, "rb") as f:
            return f.read()

    def addBytes(self, schema: ModelSchema, data: bytes) -> ModelSchema:
        fn = canonical_model_filename(schema.name, schema.dataset)
        path = os.path.join(self.root, fn)
        with open(path, "wb") as f:
            f.write(data)
        with open(path, "rb") as f:    # verify the write, as the reference
            schema.assertMatchingHash(f.read())
        with open(path + ".meta", "w") as f:
            f.write(schema.updateURI(fn).toJson())
        return schema.updateURI(path)


def _no_http():
    return NotImplementedError(
        "the HTTP model repository (RemoteRepo, server_url) waits for the "
        "port of io/ (ROADMAP.md Queue 1 item 10); use a local repository "
        "directory")


class RemoteRepo(Repository):
    """The HTTP repository (DefaultModelRepo, ModelDownloader.scala:109-155):
    not ported yet."""

    def __init__(self, base_url: str, timeout: float = 60.0):
        raise _no_http()


# ------------------------------------------------------------- downloader

class ModelDownloader:
    """Hands repository models to TorchModel / ImageFeaturizer with hash
    verification (reference: ModelDownloader.scala:157-230).
    ``local_path`` is the local repository directory."""

    def __init__(self, local_path: str, server_url: Optional[str] = None):
        if server_url:
            raise _no_http()
        self.local = LocalRepo(local_path)

    def localModels(self) -> list:
        return self.local.listSchemas()

    def remoteModels(self) -> list:
        raise _no_http()

    def downloadModel(self, schema: ModelSchema) -> ModelSchema:
        """The local copy of ``schema``, its bytes checked against the
        schema's sha256; written into the local repository when absent."""
        for have in self.local.listSchemas():
            if (have.name, have.dataset, have.hash) == \
                    (schema.name, schema.dataset, schema.hash):
                have.assertMatchingHash(self.local.getBytes(have))
                return have
        data = self.local.getBytes(schema)
        schema.assertMatchingHash(data)
        return self.local.addBytes(schema, data)

    def downloadByName(self, name: str, dataset: str = "") -> ModelSchema:
        for s in self.localModels():
            if s.name == name and (not dataset or s.dataset == dataset):
                return self.downloadModel(s)
        raise ModelNotFoundException(f"{name} (dataset={dataset!r})")

    def publish(self, config: dict, params, name: str, dataset: str = "",
                modelType: str = "image") -> ModelSchema:
        """Pack and register a model in the local repository; layerNames
        and numLayers come from the module, so ImageFeaturizer can cut by
        name."""
        import torch

        from .modules import build_model
        data = pack_model(config, params)
        with torch.device("meta"):
            layer_names = build_model(config).layer_names()
        schema = ModelSchema(
            name=name, dataset=dataset, modelType=modelType,
            hash=hashlib.sha256(data).hexdigest(), size=len(data),
            inputNode=0, numLayers=len(layer_names), layerNames=layer_names)
        return self.local.addBytes(schema, data)
