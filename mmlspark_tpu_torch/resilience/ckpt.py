"""Async non-blocking checkpoints with a torn-write-proof commit protocol.

The port of ``mmlspark_tpu/resilience/ckpt.py``: the same files, manifest
and metric names, so a checkpoint directory moves between the packages.
A save splits into the two halves that have different costs:

* **snapshot** (the fit): the training state copied from the card into
  host memory — the trainer orders that copy after the step that produced
  the tensors (models/trainer.py ``_Snapshot``);
* **serialize + publish** (background thread): msgpack the host tree and
  run the commit protocol below, overlapped with the next steps.

The queue is bounded at depth 1 with **newest-wins coalescing**: when the
step loop outruns the disk, intermediate snapshots are dropped (counted on
``mmlspark_ckpt_coalesced_total``) rather than back-pressuring the fit —
a checkpoint's only job is to bound the replay window, and the newest one
bounds it best.  :meth:`AsyncCheckpointWriter.wait` is the barrier the
trainer takes at epoch end and fit exit, so an epoch boundary or a fit
return never races its own pending write.

Commit protocol (shared by the synchronous path — ``publish()``):

1. write ``<path>.tmp.<pid>`` (fault site ``ckpt.write``), flush + fsync;
2. ``os.replace`` tmp -> final (fault site ``ckpt.rename``) — atomic, so
   a *partial* file can never carry the final name;
3. commit ``manifest.json`` LAST (its own write-then-fsync-then-rename),
   recording the file's size + sha256.

A crash anywhere in 1-3 therefore leaves either no file, or a complete
file that is **not in the manifest** — and resume treats "exists but
unverified" exactly like "corrupt": skip it, warn, count it on
``mmlspark_ckpt_corrupt_total``, and fall back to the previous
checkpoint.

**Sharded checkpoints** extend the same protocol: the training state
(flattened to ``path -> leaf``) is split into N byte-balanced shards, each
committed as its own ``<stem>.shard_<i>.msgpack`` file (fault site
``ckpt.shard``, same tmp-write + fsync + rename discipline, NO per-shard
manifest entry), a small **head** file under the canonical
``ckpt_E[_sS].msgpack`` name records the shard list, and the manifest —
still committed LAST, after every shard is verified present with size +
sha256 — becomes the multi-shard commit record (the head's manifest entry
carries a ``shards`` map). Resume reads the head, then every shard
(content-hashed against the manifest), and reassembles the tree. **A torn
shard disqualifies the whole candidate**: verify() fails the head, the
resume falls back to the previous committed checkpoint, and the skip is
counted.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Callable, Optional

from .. import telemetry
from ..core.utils import get_logger
from . import faults

log = get_logger("resilience.ckpt")

_m_write_seconds = telemetry.registry.histogram(
    "mmlspark_ckpt_write_seconds",
    "background serialize + write + fsync + rename + manifest-commit time "
    "per published checkpoint")
_m_coalesced = telemetry.registry.counter(
    "mmlspark_ckpt_coalesced_total",
    "checkpoint snapshots dropped by newest-wins coalescing (the step "
    "loop outran the disk; the newest snapshot bounds the replay window "
    "best, so nothing durable is lost)")
_m_corrupt = telemetry.registry.counter(
    "mmlspark_ckpt_corrupt_total",
    "checkpoint files skipped at resume because they were partial, "
    "corrupt, or not committed to the manifest (each skip falls back to "
    "the previous checkpoint)")
_m_wait_seconds = telemetry.registry.histogram(
    "mmlspark_ckpt_wait_seconds",
    "time the fit actually blocked on the async-checkpoint barrier "
    "(epoch end / fit exit); ~0 when the disk keeps up")
_m_shards_written = telemetry.registry.counter(
    "mmlspark_ckpt_shards_written_total",
    "checkpoint shard files committed (tmp-write + fsync + rename; the "
    "head + manifest commit follows once every shard landed)")

MANIFEST = "manifest.json"


class CorruptCheckpoint(RuntimeError):
    """A checkpoint file failed content verification (manifest digest
    mismatch or undecodable payload). Resume catches it and falls back to
    the previous checkpoint."""


def note_corrupt(name: str, reason: str):
    """Count + trace one corrupt-checkpoint sighting (callers that decode
    the payload themselves — e.g. a msgpack parse failure on a
    pre-manifest file — report through here so the counter stays the one
    place to alert on)."""
    _m_corrupt.inc()
    telemetry.trace.instant("ckpt/corrupt", file=name, reason=reason)
    log.warning("checkpoint %s is corrupt (%s) — falling back to the "
                "previous checkpoint", name, reason)


def manifest_path(directory: str) -> str:
    return os.path.join(directory, MANIFEST)


def load_manifest(directory: str) -> Optional[dict]:
    """The committed manifest's ``files`` map, or None when the directory
    predates manifests (every file passes verification then — old
    checkpoint dirs stay resumable)."""
    try:
        with open(manifest_path(directory), "r", encoding="utf-8") as f:
            doc = json.load(f)
        return dict(doc.get("files", {}))
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        # an unreadable manifest must not brick the resume outright: warn
        # and fall back to manifest-less verification
        log.warning("checkpoint manifest %s unreadable; skipping "
                    "verification", manifest_path(directory))
        return None


def _commit_manifest(directory: str, files: dict):
    """Write-then-fsync-then-rename the manifest — the LAST step of the
    commit protocol, so its presence implies every listed file landed."""
    path = manifest_path(directory)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "files": files}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def publish(path: str, data: bytes, extra: Optional[dict] = None):
    """Commit one checkpoint file: tmp write + fsync (site ``ckpt.write``),
    atomic rename (site ``ckpt.rename``), manifest entry committed last.
    ``extra`` merges additional JSON-able keys into the manifest entry —
    e.g. the trainer's fused-fit ``featurize_digest``, which resume uses
    to reject candidates written under a different featurize plan."""
    directory, name = os.path.split(path)
    t0 = time.perf_counter()
    with telemetry.trace.span("ckpt/write", file=name, bytes=len(data)):
        faults.inject("ckpt.write")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        faults.inject("ckpt.rename")
        os.replace(tmp, path)
        files = load_manifest(directory) or {}
        files[name] = {"size": len(data),
                       "sha256": hashlib.sha256(data).hexdigest(),
                       **(extra or {})}
        _commit_manifest(directory, files)
    _m_write_seconds.observe(time.perf_counter() - t0)


def verify(directory: str, name: str) -> bool:
    """Is ``name`` a legitimate consensus candidate? True when the
    directory has no manifest (pre-manifest checkpoints), or when the
    manifest lists the file with a matching on-disk size — and, for a
    sharded checkpoint, every shard the head's manifest entry records is
    present with its committed size. A file the manifest doesn't know,
    a size that disagrees, or ANY torn/missing shard disqualifies the
    whole candidate: count it and skip it."""
    files = load_manifest(directory)
    if files is None:
        return True
    entry = files.get(name)
    try:
        size = os.path.getsize(os.path.join(directory, name))
    except OSError:
        return False
    if entry is None or int(entry.get("size", -1)) != size:
        _m_corrupt.inc()
        telemetry.trace.instant("ckpt/corrupt", file=name,
                                reason="unlisted" if entry is None
                                else "size")
        log.warning(
            "checkpoint %s is %s — skipping it as a resume candidate "
            "(falling back to the previous checkpoint)", name,
            "not committed to the manifest (torn write?)" if entry is None
            else f"{size} bytes but the manifest recorded "
                 f"{entry.get('size')}")
        return False
    for sname, sentry in (entry.get("shards") or {}).items():
        try:
            ssize = os.path.getsize(os.path.join(directory, sname))
        except OSError:
            ssize = -1
        if int(sentry.get("size", -1)) != ssize:
            _m_corrupt.inc()
            telemetry.trace.instant("ckpt/corrupt", file=sname,
                                    reason="shard")
            log.warning(
                "checkpoint %s shard %s is %s — the torn shard "
                "disqualifies the whole candidate (falling back to the "
                "previous checkpoint)", name, sname,
                "missing" if ssize < 0
                else f"{ssize} bytes vs {sentry.get('size')} committed")
            return False
    return True


# ---- sharded checkpoints ---------------------------------------------------

def shard_name(name: str, index: int) -> str:
    """``ckpt_E[_sS].msgpack`` -> ``ckpt_E[_sS].shard_<i>.msgpack``. The
    shard suffix keeps the stem non-numeric, so shard files are never
    mistaken for standalone resume candidates by the trainer's
    checkpoint-name parser."""
    stem = name[:-len(".msgpack")] if name.endswith(".msgpack") else name
    return f"{stem}.shard_{index}.msgpack"


def write_shard(path: str, data: bytes):
    """Commit ONE shard file: tmp write + fsync (fault site
    ``ckpt.shard``) then atomic rename. Deliberately no manifest entry —
    a shard only becomes part of a durable checkpoint when the head +
    manifest commit (``commit_sharded``) lands after verifying every
    shard."""
    name = os.path.basename(path)
    with telemetry.trace.span("ckpt/write", file=name, bytes=len(data)):
        faults.inject("ckpt.shard")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    _m_shards_written.inc()


def head_payload(shard_names) -> bytes:
    """The head file's bytes: a tiny JSON document naming the shards.
    Committed under the canonical checkpoint name so the existing
    candidate discovery finds sharded checkpoints unchanged."""
    return json.dumps({"sharded": {"version": 1,
                                   "shards": list(shard_names)}},
                      sort_keys=True).encode("utf-8")


def parse_head(data: bytes):
    """The shard list when ``data`` is a sharded-checkpoint head, else
    None (a regular msgpack checkpoint)."""
    if not data.startswith(b'{"sharded"'):
        return None
    try:
        return list(json.loads(data.decode("utf-8"))["sharded"]["shards"])
    except (ValueError, KeyError, TypeError):
        return None


def commit_sharded(path: str, shard_names,
                   extra: Optional[dict] = None) -> None:
    """The LAST step of a sharded save: verify every shard
    on disk (size + sha256 recorded into the manifest), publish the head
    under the canonical name, then commit the manifest whose head entry
    carries the ``shards`` map (plus any ``extra`` keys, as
    :func:`publish`). Raises OSError when a shard vanished —
    the save fails loudly rather than committing a torn record."""
    directory, name = os.path.split(path)
    shards = {}
    for sname in shard_names:
        with open(os.path.join(directory, sname), "rb") as f:
            blob = f.read()
        shards[sname] = {"size": len(blob),
                         "sha256": hashlib.sha256(blob).hexdigest()}
    data = head_payload(shard_names)
    with telemetry.trace.span("ckpt/write", file=name, bytes=len(data),
                              shards=len(shards)):
        faults.inject("ckpt.write")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        faults.inject("ckpt.rename")
        os.replace(tmp, path)
        files = load_manifest(directory) or {}
        files[name] = {"size": len(data),
                       "sha256": hashlib.sha256(data).hexdigest(),
                       "shards": shards, **(extra or {})}
        _commit_manifest(directory, files)


def publish_sharded(path: str, shard_payloads,
                    extra: Optional[dict] = None) -> None:
    """Single-writer sharded commit: write every shard, then the head +
    manifest commit. The layout is the JAX package's multi-host one, so
    either package resumes it."""
    t0 = time.perf_counter()
    names = []
    for i, data in enumerate(shard_payloads):
        sname = shard_name(os.path.basename(path), i)
        write_shard(os.path.join(os.path.dirname(path), sname), data)
        names.append(sname)
    commit_sharded(path, names, extra=extra)
    _m_write_seconds.observe(time.perf_counter() - t0)


def read_shards(directory: str, shard_names) -> list:
    """Read + content-verify every shard of a committed checkpoint.
    Raises :class:`CorruptCheckpoint` on a digest mismatch — resume
    falls back to the previous candidate."""
    blobs = []
    for sname in shard_names:
        try:
            with open(os.path.join(directory, sname), "rb") as f:
                blob = f.read()
        except OSError as e:
            note_corrupt(sname, f"shard unreadable: {e}")
            raise CorruptCheckpoint(sname) from e
        if not verify_bytes(directory, sname, blob):
            raise CorruptCheckpoint(sname)
        blobs.append(blob)
    return blobs


_EMPTY = "__mmlspark_empty_dict__"


def flatten_state(nested, _prefix=()) -> dict:
    """Flatten a flax state dict into ``{"a/b/c": leaf}`` (empty dicts
    kept via a sentinel so the round trip is exact) — the unit sharded
    checkpoints partition."""
    out = {}
    if isinstance(nested, dict):
        if not nested:
            out["/".join(_prefix)] = _EMPTY
        for k, v in nested.items():
            out.update(flatten_state(v, _prefix + (str(k),)))
        return out
    out["/".join(_prefix)] = nested
    return out


def unflatten_state(flat: dict):
    """Inverse of :func:`flatten_state`."""
    nested: dict = {}
    for key in sorted(flat):
        val = flat[key]
        parts = key.split("/")
        d = nested
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = {} if (isinstance(val, str) and val == _EMPTY) \
            else val
    return nested


def partition_leaves(sizes, n_shards: int) -> list:
    """Contiguous partition of ``len(sizes)`` leaves into ``n_shards``
    byte-balanced groups (greedy cut at the running-total boundaries).
    Deterministic given (sizes, n_shards) — every host computes the
    identical split, so host i can serialize shard i alone."""
    n_shards = max(1, min(int(n_shards), max(1, len(sizes))))
    total = float(sum(sizes)) or 1.0
    bounds = []
    acc = 0.0
    cut = 1
    for i, s in enumerate(sizes):
        acc += s
        while cut < n_shards and acc >= total * cut / n_shards:
            bounds.append(i + 1)
            cut += 1
    starts = [0] + bounds
    ends = bounds + [len(sizes)]
    return [list(range(a, b)) for a, b in zip(starts, ends)]


def _manifest_entry(files: dict, name: str) -> Optional[dict]:
    """The manifest record for ``name``: a top-level file entry, or a
    shard entry found under some head's ``shards`` map."""
    entry = files.get(name)
    if entry is not None:
        return entry
    for head in files.values():
        sentry = (head.get("shards") or {}).get(name)
        if sentry is not None:
            return sentry
    return None


def verify_bytes(directory: str, name: str, data: bytes) -> bool:
    """Content check at restore time: the read bytes must hash to the
    manifest's digest (bit-rot / concurrent-truncation defense beyond the
    size check). Shard files resolve their digest through the head's
    ``shards`` map."""
    files = load_manifest(directory)
    if files is None:
        return True      # unverifiable dirs already passed verify()
    entry = _manifest_entry(files, name)
    if entry is None:
        return True
    digest = entry.get("sha256")
    if digest and hashlib.sha256(data).hexdigest() != digest:
        _m_corrupt.inc()
        telemetry.trace.instant("ckpt/corrupt", file=name, reason="sha256")
        log.warning("checkpoint %s content does not match its manifest "
                    "digest — skipping it", name)
        return False
    return True


def prune(directory: str, names) -> None:
    """Remove checkpoint files AND their manifest entries (one manifest
    commit for the batch). A sharded checkpoint's head takes its shard
    files with it. Missing files are fine — another process may have
    pruned first on shared storage."""
    names = [n for n in names]
    if not names:
        return
    files = load_manifest(directory)
    for n in list(names):
        entry = (files or {}).get(n) or {}
        names.extend((entry.get("shards") or {}).keys())
    for n in names:
        try:
            os.remove(os.path.join(directory, n))
        except OSError:
            pass
    if files:
        kept = {k: v for k, v in files.items() if k not in set(names)}
        if len(kept) != len(files):
            try:
                _commit_manifest(directory, kept)
            except OSError as e:
                log.warning("manifest prune failed (kept stale entries, "
                            "harmless): %s", e)


class AsyncCheckpointWriter:
    """Depth-1, newest-wins background checkpoint publisher.

    ``submit(path, payload_fn, on_commit)`` enqueues one checkpoint whose
    bytes are produced by ``payload_fn()`` ON THE WRITER THREAD (that's
    where the msgpack serialization cost goes); a submit that finds a
    not-yet-started entry replaces it (newest-wins — the superseded
    snapshot's ``on_commit`` never fires, mirroring that it never became
    durable). ``on_commit`` runs on the writer thread strictly AFTER the
    rename + manifest commit — the trainer's pruning of older step
    checkpoints rides it, so it only ever acts on durable state.

    A write error is remembered and re-raised at the next :meth:`submit`
    or :meth:`wait` (the step loop must learn its durability story broke,
    not train on thinking it has checkpoints it doesn't).
    """

    def __init__(self, name: str = "ckpt"):
        self._cond = threading.Condition()
        self._pending: Optional[tuple] = None  # guarded-by: _cond
        self._in_flight = False                # guarded-by: _cond
        self._error: Optional[BaseException] = None  # guarded-by: _cond
        self._closed = False                   # guarded-by: _cond
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"ckpt-writer-{name}")
        self._thread.start()

    def submit(self, path: str, payload_fn: Callable[[], bytes],
               on_commit: Optional[Callable[[], None]] = None,
               publish_fn: Optional[Callable] = None):
        """``publish_fn(path, payload)`` overrides the single-file
        :func:`publish` commit — sharded saves pass
        :func:`publish_sharded`."""
        with self._cond:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            if self._closed:
                raise RuntimeError("AsyncCheckpointWriter is closed")
            coalesced = self._pending is not None
            self._pending = (path, payload_fn, on_commit, publish_fn)
            self._cond.notify_all()
        if coalesced:
            _m_coalesced.inc()
            log.info("checkpoint %s coalesced away by a newer snapshot",
                     os.path.basename(path))

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Barrier: block until no checkpoint is pending or in flight.
        Returns False on timeout. Re-raises a writer-thread error."""
        t0 = time.perf_counter()
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._pending is not None or self._in_flight:
                remain = (None if deadline is None
                          else deadline - time.monotonic())
                if remain is not None and remain <= 0:
                    return False
                self._cond.wait(remain if remain is not None else 0.5)
            if self._error is not None:
                err, self._error = self._error, None
                raise err
        _m_wait_seconds.observe(time.perf_counter() - t0)
        return True

    def close(self):
        """Flush and stop. Swallows nothing: a pending error surfaces."""
        try:
            self.wait()
        finally:
            with self._cond:
                self._closed = True
                self._cond.notify_all()
            if self._thread.is_alive():
                self._thread.join(timeout=5)

    def _run(self):
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    self._cond.wait(0.5)
                if self._pending is None and self._closed:
                    return
                entry, self._pending = self._pending, None
                self._in_flight = True
            # serialize + IO happen OUTSIDE the lock: submit() stays a
            # dict swap while a write is in flight
            path, payload_fn, on_commit, publish_fn = entry
            try:
                (publish_fn or publish)(path, payload_fn())
                if on_commit is not None:
                    on_commit()
            except BaseException as e:
                log.warning("async checkpoint %s failed: %s",
                            os.path.basename(path), e)
                with self._cond:
                    self._error = e
            finally:
                with self._cond:
                    self._in_flight = False
                    self._cond.notify_all()
