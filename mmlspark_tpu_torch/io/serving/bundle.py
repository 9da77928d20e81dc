"""Versioned model + capture bundles: the warm-start artifact of the port
(the port of ``mmlspark_tpu/io/serving/bundle.py``, same layout).

A serving worker's cold start pays, per shape bucket, the first load of
its kernel libraries (an ``nvcc`` build where none is on disk) and a
CUDA graph capture, paid by whichever requests arrive first. The bundle
closes that hole: next to the model config and params it commits, for
every bucket, the record of that bucket's capture, and a restarting
worker captures every bucket again inside :func:`load_bundle`, before its
source opens. torch cannot serialize a CUDA graph, so the per-bucket shard
holds what a capture needs and what it must give: the bucket's signature
(shape, wire dtype, device type), the kernel libraries its capture loaded
(their ``ops/_build`` file names, which hash the sources and flags), and
the kernels and launch counts it captured. A bucket is loaded warm only
where every one of those libraries is already built: a warm load runs no
``nvcc``.

Commit protocol — the sharded-checkpoint manifest format of
:mod:`mmlspark_tpu_torch.resilience.ckpt`, as the JAX package uses it:

* every component (``bundle_meta.json``, ``bundle_model.msgpack`` — the
  flax param tree, written by the port's own codec
  ``models.downloader.write_flax_msgpack`` — or, for a pipeline composite
  (``kind == "pipeline"``, ``FusedServingStep.from_pipeline``),
  ``bundle_pipeline.bin`` — the pickled ``PipelineModel``, stages and
  fitted params, without its device caches — and one
  ``bundle_exec_b<rows>.bin`` per bucket) is committed as a SHARD:
  tmp-write + fsync + atomic rename (fault site ``ckpt.shard``);
* the head (``serving_bundle.json``) + ``manifest.json`` commit LAST,
  recording every shard's size + sha256 — a crash mid-publish leaves a
  directory the loader treats as absent, never a half-trusted bundle.

Load-time integrity is graded, not all-or-nothing:

* torn/missing **model or meta** shard -> the bundle is unusable;
  :func:`load_bundle` raises :class:`~...resilience.ckpt.CorruptCheckpoint`
  (there is nothing to serve); no committed head -> ``FileNotFoundError``;
* torn/missing **capture** shard, a kernel library that is not built, a
  different card, torch or CUDA, or an injected ``serving.bundle_load``
  fault -> that bucket is cold: counted on
  ``mmlspark_serving_bundle_exec_failures_total`` and captured at its
  first use — degraded warmth, never an error and never a wrong answer.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional

from ... import telemetry
from ...core.utils import get_logger
from ...resilience import ckpt, faults
from .batcher import BucketPolicy
from .step import FusedServingStep

log = get_logger("io.serving")

#: the bundle head's canonical name (the manifest's multi-shard record)
BUNDLE_HEAD = "serving_bundle.json"
SCHEMA = "mmlspark-serving-bundle/v1"
#: the pipeline composite's model-component shard (kind == "pipeline")
_PIPELINE_SHARD = "bundle_pipeline.bin"

_m_bundle_loads = telemetry.registry.counter(
    "mmlspark_serving_bundle_loads_total",
    "bundle load attempts by outcome: warm (every bucket's executable "
    "deserialized), partial (some buckets fell back to cold compile), "
    "cold (no executable usable), absent (no committed bundle found)",
    labels=("result",))
_m_exec_failures = telemetry.registry.counter(
    "mmlspark_serving_bundle_exec_failures_total",
    "bucket executables that could not be loaded from the bundle (torn "
    "shard, deserialize error, backend mismatch, injected fault) — each "
    "one is a cold compile at first use of that bucket")
_m_execs_loaded = telemetry.registry.counter(
    "mmlspark_serving_bundle_execs_loaded_total",
    "bucket executables deserialized warm from a bundle")


def _exec_shard(bucket: int) -> str:
    return f"bundle_exec_b{bucket}.bin"


def runtime(device) -> dict:
    """What a bundle's captures depend on, for ``device``: the backend
    ("cuda" or "cpu"), torch's and CUDA's versions, and on CUDA the card's
    name, compute capability and the device count."""
    import torch
    out = {"backend": device.type, "torch": torch.__version__,
           "cuda": torch.version.cuda}
    if device.type == "cuda":
        out.update(device_name=torch.cuda.get_device_name(device),
                   capability=list(torch.cuda.get_device_capability(device)),
                   device_count=torch.cuda.device_count())
    else:
        out.update(device_name="cpu", capability=None, device_count=1)
    return out


def _record_of(step: FusedServingStep, bucket: int) -> dict:
    """The capture record of one bucket: its signature, the ``_build``
    library files its kernels came from, and its launches a replay."""
    from ...ops import _build
    spec = step.bucket_spec(bucket)
    ex = step.compile_bucket(bucket)
    rec = ex.record.summary() if ex.record is not None \
        else {"launches": {}, "libraries": []}
    return {"bucket": bucket,
            "signature": {"shape": list(spec.shape),
                          "dtype": str(spec.dtype),
                          "device": spec.device.type},
            "libraries": [_build.library_path(n).name
                          for n in rec["libraries"]],
            "launches": rec["launches"]}


def save_bundle(directory: str, step: FusedServingStep,
                extra_meta: Optional[dict] = None) -> str:
    """Capture every bucket of ``step`` (no-op for already-warm ones)
    and commit the versioned model + capture bundle into ``directory``.
    Returns the head path. Safe to re-run: a newer save atomically
    replaces the head + manifest."""
    from ...models.downloader import write_flax_msgpack
    from ...models.weights import is_flax_tree, to_flax_params
    os.makedirs(directory, exist_ok=True)
    step.compile_buckets()
    kind = getattr(step, "bundle_kind", "model")
    meta = {
        "schema": SCHEMA,
        "version": 1,
        "kind": kind,
        **runtime(step.device),
        "model_config": step.model_config,
        "row_shape": list(step.row_shape),
        "in_dtype": step.in_dtype.name,
        "output": step.output,
        "min_bucket": step.policy.min_bucket,
        "max_batch": step.policy.max_batch,
        "buckets": list(step.policy.buckets),
    }
    if kind == "pipeline":
        # a pipeline composite's "model" component is the PipelineModel
        # itself (stages + fitted params); the fused body and its placed
        # params are rebuilt from it at load time
        meta["input_col"] = step.input_col
        meta["score_col"] = step.score_col
        model_shard = (_PIPELINE_SHARD, pickle.dumps(step.pipeline))
    else:
        tree = step.params if is_flax_tree(step.params) \
            else to_flax_params(step.params, step.model_config)
        model_shard = ("bundle_model.msgpack", write_flax_msgpack(tree))
    if extra_meta:
        meta.update(extra_meta)
    shards = [("bundle_meta.json",
               json.dumps(meta, sort_keys=True).encode("utf-8")),
              model_shard]
    for b in step.policy.buckets:
        shards.append((_exec_shard(b), json.dumps(
            _record_of(step, b), sort_keys=True).encode("utf-8")))
    names = []
    with telemetry.trace.span("serving/bundle_save",
                              buckets=len(step.policy.buckets)):
        for name, data in shards:
            ckpt.write_shard(os.path.join(directory, name), data)
            names.append(name)
        head = os.path.join(directory, BUNDLE_HEAD)
        ckpt.commit_sharded(head, names)
    log.info("serving bundle committed: %s (%d buckets, backend=%s)",
             head, len(step.policy.buckets), meta["backend"])
    return head


def _read_shard(directory: str, name: str) -> Optional[bytes]:
    """One shard's bytes, content-verified against the manifest (via the
    head's shards map); None when torn/missing."""
    try:
        with open(os.path.join(directory, name), "rb") as f:
            data = f.read()
    except OSError:
        return None
    if not ckpt.verify_bytes(directory, name, data):
        return None
    return data


def _check_record(blob: Optional[bytes], bucket: int,
                  step: FusedServingStep):
    """Raise why the bucket's capture record cannot load warm, if it
    cannot."""
    from ...ops import _build
    if blob is None:
        raise RuntimeError(f"capture shard for bucket {bucket} torn or "
                           f"missing")
    rec = json.loads(blob.decode("utf-8"))
    spec = step.bucket_spec(bucket)
    want = {"shape": list(spec.shape), "dtype": str(spec.dtype),
            "device": spec.device.type}
    if rec.get("signature") != want:
        raise RuntimeError(f"bucket {bucket} was captured for "
                           f"{rec.get('signature')}, this step takes {want}")
    missing = [n for n in rec.get("libraries", ())
               if not (_build.BUILD_DIR / n).exists()]
    if missing:
        raise RuntimeError(f"kernel libraries {missing} are not built (a "
                           f"warm load runs no nvcc)")


def load_bundle(directory: str, policy: Optional[BucketPolicy] = None,
                **step_kwargs) -> FusedServingStep:
    """Rebuild a :class:`FusedServingStep` from a committed bundle and
    capture every bucket whose record is intact and whose kernels are
    built, here, before any traffic. ``step_kwargs`` go to the step
    (``device`` among them, "cuda" by default).

    Raises ``FileNotFoundError`` when no committed bundle exists and
    :class:`~...resilience.ckpt.CorruptCheckpoint` when the model/meta
    shards are torn — both counted. Every other failure of a bucket
    degrades it to a capture at first use (counted), never an error: a
    worker with intact weights must come up even if warmth was lost.
    """
    from ...models.downloader import read_flax_msgpack
    # graded integrity: verify the HEAD itself (its content hash via the
    # manifest), then each shard individually — ckpt.verify()'s whole-
    # candidate semantics would let one torn capture record take down a
    # bundle whose weights are perfectly intact
    try:
        with open(os.path.join(directory, BUNDLE_HEAD), "rb") as f:
            head_blob = f.read()
    except OSError:
        head_blob = None
    files = ckpt.load_manifest(directory) or {}
    if (head_blob is None or BUNDLE_HEAD not in files
            or not ckpt.verify_bytes(directory, BUNDLE_HEAD, head_blob)):
        _m_bundle_loads.labels(result="absent").inc()
        raise FileNotFoundError(
            f"no committed serving bundle in {directory} (head "
            f"{BUNDLE_HEAD} missing or failed manifest verification)")
    meta_blob = _read_shard(directory, "bundle_meta.json")
    if meta_blob is None:
        _m_bundle_loads.labels(result="cold").inc()
        ckpt.note_corrupt(BUNDLE_HEAD, "model/meta shard torn")
        raise ckpt.CorruptCheckpoint(
            f"serving bundle in {directory} has a torn meta shard")
    meta = json.loads(meta_blob.decode("utf-8"))
    kind = meta.get("kind", "model")
    model_blob = _read_shard(
        directory,
        _PIPELINE_SHARD if kind == "pipeline" else "bundle_model.msgpack")
    if model_blob is None:
        _m_bundle_loads.labels(result="cold").inc()
        ckpt.note_corrupt(BUNDLE_HEAD, "model/meta shard torn")
        raise ckpt.CorruptCheckpoint(
            f"serving bundle in {directory} has a torn model/meta shard")
    if policy is None:
        policy = BucketPolicy(max_batch=meta["max_batch"],
                              min_bucket=meta["min_bucket"])
    import numpy as np
    if kind == "pipeline":
        step = FusedServingStep.from_pipeline(
            pickle.loads(model_blob), input_col=meta["input_col"],
            score_col=meta["score_col"], policy=policy,
            row_shape=tuple(meta["row_shape"]),
            in_dtype=np.dtype(meta["in_dtype"]),
            output=meta["output"], **step_kwargs)
    else:
        step = FusedServingStep(meta["model_config"],
                                read_flax_msgpack(model_blob), policy=policy,
                                row_shape=tuple(meta["row_shape"]),
                                in_dtype=np.dtype(meta["in_dtype"]),
                                output=meta["output"], **step_kwargs)
    here = runtime(step.device)
    stale = {k: (meta.get(k), v) for k, v in here.items()
             if meta.get(k) != v}
    loaded = 0
    with telemetry.trace.span("serving/bundle_load",
                              buckets=len(policy.buckets)):
        for b in policy.buckets:
            if b not in set(meta.get("buckets", ())):
                _m_exec_failures.inc()
                continue
            try:
                # the chaos site: an injected fault here means "this
                # bucket's capture could not be restored" — the recovery
                # path is a capture at first use, nothing worse
                faults.inject("serving.bundle_load")
                if stale:
                    raise RuntimeError(
                        f"bundle captured under a different runtime "
                        f"(bundle, here): {stale}")
                _check_record(_read_shard(directory, _exec_shard(b)), b,
                              step)
                step.preload_bucket(b)
                loaded += 1
                _m_execs_loaded.inc()
            except Exception as e:
                _m_exec_failures.inc()
                log.warning("bundle capture for bucket %d unusable "
                            "(captured at first use): %s", b, e)
    result = ("warm" if loaded == len(policy.buckets)
              else "partial" if loaded else "cold")
    _m_bundle_loads.labels(result=result).inc()
    log.info("serving bundle loaded %s from %s: %d/%d buckets captured "
             "warm", result, directory, loaded, len(policy.buckets))
    return step
