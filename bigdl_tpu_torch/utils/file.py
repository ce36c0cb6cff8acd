"""Checkpoint persistence, local and single-file (counterpart of the local
``.npz`` half of ``bigdl_tpu/utils/file.py``).

The on-disk format is the reference's, byte for byte in layout: a tree
of dicts, lists, tuples, python scalars and numpy arrays is written as
one ``.npz`` whose ``__structure__`` member is the JSON structure
descriptor (format version 2) and whose ``a<i>`` members are the arrays.
No pickle anywhere.  So a checkpoint written by either package loads in
the other.  This module reads and writes numpy only.

:class:`CheckpointManager` keeps generation-numbered checkpoints: the
payload is committed atomically (tmp + fsync + rename), then a manifest
recording its CRC32 and size, which is the commit marker;
``latest_good()`` walks back past torn or uncommitted generations, and
``keep_n`` retention never counts a torn generation.

Left for ROADMAP.md queue 1, item 11 (parallelism): sharded (orbax)
checkpoints, remote (``gs://``, ``s3://``, ...) paths and restoring onto
another topology.  Each raises ``NotImplementedError`` naming it; a
manifest that records a sharded payload is still validated by its
commit markers, which are plain files.
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from bigdl_tpu_torch.utils import chaos

__all__ = ["PYTREE_FORMAT_VERSION", "save_pytree", "load_pytree",
           "save_checkpoint", "load_checkpoint", "checkpoint_manifest_path",
           "pipeline_state_path", "load_pipeline_state",
           "CheckpointManager"]

logger = logging.getLogger("bigdl_tpu_torch.utils.file")

PYTREE_FORMAT_VERSION = 2
MANIFEST_FORMAT = 1

_ITEM_11 = "ROADMAP.md queue 1, item 11 (parallelism)"
_TMP_MARKER = ".tmp-"
# the files orbax leaves at a committed sharded checkpoint's root
_ORBAX_COMMIT_MARKERS = ("commit_success.txt", "_CHECKPOINT_METADATA")


def _local(path: str) -> str:
    """``path`` without a ``file://`` scheme; any other scheme raises."""
    if path.startswith("file://"):
        return path[len("file://"):]
    if "://" in path:
        raise NotImplementedError(
            f"remote checkpoint path {path!r} is not ported yet "
            f"({_ITEM_11})")
    return path


def _is_sharded(path: str) -> bool:
    """An ``*.orbax`` path, or a directory holding orbax's markers; any
    other directory raises ValueError."""
    if path.rstrip("/").endswith(".orbax"):
        return True
    if os.path.isdir(path):
        if any(os.path.exists(os.path.join(path, m))
               for m in _ORBAX_COMMIT_MARKERS):
            return True
        raise ValueError(
            f"{path!r} is a directory but not a sharded checkpoint; pass "
            f"the .npz checkpoint file itself")
    return False


def _encode(node: Any, arrays: List[np.ndarray], path: str):
    """Plain tree → JSON-able structure with array references."""
    if node is None:
        return {"t": "none"}
    if isinstance(node, (bool, int, float, str)) \
            and not isinstance(node, np.generic):
        return {"t": "py", "v": node}
    if isinstance(node, dict):
        return {"t": "dict", "items": [
            [_encode(k, arrays, path), _encode(v, arrays, f"{path}.{k}")]
            for k, v in node.items()]}
    if isinstance(node, (list, tuple)):
        return {"t": "list" if isinstance(node, list) else "tuple",
                "v": [_encode(v, arrays, f"{path}[{i}]")
                      for i, v in enumerate(node)]}
    arr = np.asarray(node)
    if arr.dtype == object:
        raise TypeError(
            f"save_pytree: unserializable value of type "
            f"{type(node).__name__} at {path} (plain trees of numpy "
            f"arrays and python scalars only)")
    arrays.append(arr)
    return {"t": "arr", "i": len(arrays) - 1}


def _decode(entry, z):
    t = entry["t"]
    if t == "none":
        return None
    if t == "py":
        return entry["v"]
    if t == "dict":
        return {_decode(k, z): _decode(v, z) for k, v in entry["items"]}
    if t == "list":
        return [_decode(v, z) for v in entry["v"]]
    if t == "tuple":
        return tuple(_decode(v, z) for v in entry["v"])
    if t == "arr":
        return z[f"a{entry['i']}"]
    raise ValueError(f"load_pytree: unknown node tag {t!r}")


def _crc_and_size(path: str) -> Tuple[int, int]:
    """CRC32 and byte size of a file, read back in 1 MiB chunks: reading
    the payload after writing it verifies that the bytes are there before
    a manifest declares them committed."""
    crc, size = 0, 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return crc & 0xFFFFFFFF, size


def _fsync_dir(dirpath: str) -> None:
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:  # pragma: no cover - a platform without dir handles
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


def _atomic_write_local(path: str, write_fn) -> Tuple[int, int]:
    """tmp + fsync + atomic rename, then the directory fsync'd: a crash
    at any point leaves the previous file or the complete new one at
    ``path``.  Returns (crc32, size) of the payload, read back from the
    tmp file before the rename."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    chaos.on_io_write(path)
    tmp = os.path.join(
        d, f".{os.path.basename(path)}{_TMP_MARKER}"
           f"{os.getpid()}-{secrets.token_hex(4)}")
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        crc, size = _crc_and_size(tmp)
        os.replace(tmp, path)
    except BaseException:
        # a kill -9 leaves the tmp behind (CheckpointManager.gc sweeps
        # those); a raised error tidies up after itself
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(d)
    return crc, size


def save_pytree(tree: Any, path: str) -> Tuple[int, int]:
    """Write ``tree`` atomically; returns (crc32, size) of the payload."""
    arrays: List[np.ndarray] = []
    structure = _encode(tree, arrays, "root")
    payload = {f"a{i}": a for i, a in enumerate(arrays)}
    meta = json.dumps({"format": PYTREE_FORMAT_VERSION, "root": structure})

    def write(f):
        np.savez(f, __structure__=np.frombuffer(meta.encode("utf-8"),
                                                np.uint8), **payload)

    return _atomic_write_local(_local(path), write)


def load_pytree(path: str) -> Any:
    with np.load(_local(path), allow_pickle=False) as z:
        if "__treedef__" in z.files:
            raise ValueError(
                "this file uses the legacy pickle-based layout; it cannot "
                "be loaded safely")
        meta = json.loads(z["__structure__"].tobytes().decode("utf-8"))
        if meta.get("format") != PYTREE_FORMAT_VERSION:
            raise ValueError(
                f"unsupported pytree format {meta.get('format')} "
                f"(supported: {PYTREE_FORMAT_VERSION})")
        return _decode(meta["root"], z)


def save_checkpoint(path: str, model_state: Dict, optim_state: Any,
                    loop_state: Dict) -> Tuple[int, int]:
    """Write a training checkpoint, ``{"model", "optim", "driver"}`` with
    every scalar of the training loop's state as a 0-dim array; returns
    (crc32, size)."""
    return save_pytree({"model": model_state, "optim": optim_state,
                        "driver": {k: np.asarray(v)
                                   for k, v in loop_state.items()}},
                       path)


def load_checkpoint(path: str) -> Tuple[Dict, Any, Dict]:
    """(model state, optim state, the loop's scalars as python scalars) of a
    ``.npz`` checkpoint; a sharded checkpoint raises."""
    p = _local(path)
    if _is_sharded(p):
        raise NotImplementedError(
            f"{path!r} is a sharded checkpoint; sharded checkpoints are "
            f"not ported yet ({_ITEM_11})")
    tree = load_pytree(p)
    scalars = {k: v.item() if np.ndim(v) == 0 else v
               for k, v in tree["driver"].items()}
    return tree["model"], tree["optim"], scalars


def _sidecar(payload_path: str, suffix: str) -> str:
    stem = _local(payload_path).rstrip("/")
    for suf in (".npz", ".orbax"):
        if stem.endswith(suf):
            stem = stem[:-len(suf)]
            break
    return stem + suffix


def checkpoint_manifest_path(payload_path: str) -> str:
    """``checkpoint.<gen>.npz`` → ``checkpoint.<gen>.manifest.json``."""
    return _sidecar(payload_path, ".manifest.json")


def pipeline_state_path(payload_path: str) -> str:
    """``checkpoint.<gen>.npz`` → ``checkpoint.<gen>.pipeline.json``: the
    input pipeline's position (``data/pipeline.py``), CRC'd in the same
    manifest as the payload."""
    return _sidecar(payload_path, ".pipeline.json")


def load_pipeline_state(payload_path: str) -> Optional[Dict]:
    """The pipeline sidecar beside a payload, or None when it is absent
    or unparseable (a resume then replays the epoch from its start)."""
    path = pipeline_state_path(payload_path)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            state = json.loads(f.read().decode("utf-8"))
    except Exception:
        logger.warning("unreadable pipeline state sidecar %s (resume will "
                       "replay the epoch from its start)", path,
                       exc_info=True)
        return None
    return state if isinstance(state, dict) else None


class CheckpointManager:
    """Atomic, verifiable training checkpoints with retention.

    Layout under ``directory``::

        checkpoint.<gen>.npz            numbered payload
        checkpoint.<gen>.manifest.json  commit marker: CRC32 and size
        checkpoint.<gen>.pipeline.json  the input pipeline's position
        checkpoint.npz                  the overwritten payload
        checkpoint.manifest.json        (still records the generation)

    The payload is written first, then the pipeline sidecar, then the
    manifest: a generation without a manifest was never committed.  The
    manifest's CRC tells a committed and intact payload from one torn
    after the commit, so ``latest_good()`` falls back generation by
    generation to the newest one that loads.
    """

    prefix = "checkpoint"

    def __init__(self, directory: str, keep_n: Optional[int] = None):
        self.directory = directory
        self._root = _local(directory)
        self.keep_n = keep_n
        # the writer's fence token, claimed on its first save as the
        # highest on disk + 1: latest_good() prefers the highest fence
        # before the generation, so a stale writer's larger generation
        # numbers cannot shadow the live writer's lineage
        self._fence: Optional[int] = None

    def claim_fence(self) -> int:
        if self._fence is None:
            prior = [int(m.get("fence") or 0) for m in self._manifests()]
            self._fence = (max(prior) if prior else 0) + 1
        return self._fence

    @staticmethod
    def _lineage_key(man: Dict) -> Tuple:
        """Fence first (legacy manifests rank as fence 0), then
        generation, then commit time."""
        return (int(man.get("fence") or 0), man.get("generation", -1),
                man.get("time", 0.0))

    def _join(self, name: str) -> str:
        return os.path.join(self._root, name)

    def _listdir(self) -> List[str]:
        return os.listdir(self._root) if os.path.isdir(self._root) else []

    @staticmethod
    def _delete(path: str) -> None:
        if os.path.isdir(path):
            import shutil
            shutil.rmtree(path, ignore_errors=True)
        else:
            try:
                os.remove(path)
            except FileNotFoundError:
                pass

    def payload_name(self, generation: Optional[int],
                     sharded: bool = False) -> str:
        tag = "" if generation is None else f".{generation}"
        return f"{self.prefix}{tag}" + (".orbax" if sharded else ".npz")

    # ---- save ------------------------------------------------------------

    def save(self, model_state: Dict, optim_state: Any,
             loop_state: Dict, *, generation: int,
             overwrite: bool = False, sharded: bool = False,
             pipeline_state: Optional[Dict] = None) -> str:
        """Write one generation: the payload, the pipeline sidecar, the
        manifest recording both CRCs, then retention.  With ``overwrite``
        the payload's name is fixed (``checkpoint.npz``) but the manifest
        records the generation."""
        if sharded:
            raise NotImplementedError(
                f"sharded checkpoints are not ported yet ({_ITEM_11})")
        name = self.payload_name(None if overwrite else generation)
        path = self._join(name)
        crc, size = save_checkpoint(path, model_state, optim_state,
                                    loop_state)
        chaos.on_checkpoint_payload(path)
        pinfo = None
        if pipeline_state is not None:
            pname = pipeline_state_path(name)
            data = json.dumps(pipeline_state, sort_keys=True).encode("utf-8")
            pcrc, psize = _atomic_write_local(self._join(pname),
                                              lambda f: f.write(data))
            pinfo = {"file": pname, "crc32": pcrc, "size": psize}
        self._write_manifest(name, generation, crc, size, False,
                             pipeline=pinfo)
        if self.keep_n:
            self.gc()
        return path

    def _write_manifest(self, payload_name: str, generation: int,
                        crc: Optional[int], size: Optional[int],
                        sharded: bool,
                        pipeline: Optional[Dict] = None) -> None:
        manifest = {"format": MANIFEST_FORMAT, "generation": int(generation),
                    "payload": payload_name, "sharded": bool(sharded),
                    "crc32": crc, "size": size, "time": time.time(),
                    "fence": self.claim_fence()}
        if pipeline is not None:
            manifest["pipeline"] = pipeline
        data = json.dumps(manifest, sort_keys=True).encode("utf-8")
        _atomic_write_local(self._join(checkpoint_manifest_path(
            payload_name)), lambda f: f.write(data))

    # ---- inspection and walk-back ------------------------------------------

    def _manifests(self) -> List[Dict]:
        """Every parseable manifest, unordered; an unparseable one is an
        uncommitted generation and is skipped."""
        out = []
        for n in self._listdir():
            if not (n.startswith(self.prefix)
                    and n.endswith(".manifest.json")):
                continue
            try:
                with open(self._join(n), "rb") as f:
                    man = json.loads(f.read().decode("utf-8"))
                man["_manifest_name"] = n
                out.append(man)
            except Exception:
                logger.warning("unreadable checkpoint manifest %s "
                               "(treating its generation as uncommitted)",
                               n, exc_info=True)
        return out

    def generations(self) -> List[int]:
        """Committed generation numbers, ascending (no CRC check)."""
        return sorted(m.get("generation", -1) for m in self._manifests())

    @staticmethod
    def _matches(path: str, rec: Dict) -> bool:
        if not os.path.exists(path):
            return False
        crc, size = _crc_and_size(path)
        return ((rec.get("size") is None or size == rec["size"])
                and (rec.get("crc32") is None or crc == rec["crc32"]))

    def validate(self, manifest: Dict) -> bool:
        """Do the manifest's payload (a sharded one: its commit markers)
        and its pipeline sidecar exist and match their size and CRC?"""
        path = self._join(manifest["payload"])
        try:
            rec = manifest.get("pipeline")
            if rec and not self._matches(self._join(rec["file"]), rec):
                return False
            if manifest.get("sharded"):
                return self._orbax_committed(path)
            return self._matches(path, manifest)
        except Exception:
            logger.warning("error validating checkpoint %s", path,
                           exc_info=True)
            return False

    def latest_good(self) -> Optional[str]:
        """The newest committed and intact checkpoint, walking back past
        torn and uncommitted generations; then, over every payload newest
        first, the first that loads (manifest-less files, and an
        overwritten payload whose manifest went stale in a crash between
        the two writes).  None if nothing survives."""
        manifested = set()
        for man in sorted(self._manifests(), key=self._lineage_key,
                          reverse=True):
            manifested.add(man["payload"])
            if self.validate(man):
                return self._join(man["payload"])
            logger.warning(
                "checkpoint generation %s (%s) failed validation "
                "(truncated or uncommitted write?); falling back to the "
                "previous generation", man.get("generation"),
                man["payload"])
        for path in self._legacy_candidates():
            if self._probe_loadable(path):
                if os.path.basename(path.rstrip("/")) in manifested:
                    logger.warning(
                        "checkpoint %s fails its manifest CRC (stale "
                        "manifest from an interrupted commit?) but loads "
                        "cleanly; using it", path)
                return path
            logger.warning("checkpoint %s is unreadable; falling back",
                           path)
        return None

    def _legacy_candidates(self) -> List[str]:
        """Every checkpoint payload, newest first by mtime."""
        names = [n for n in self._listdir()
                 if n.startswith(self.prefix) and not n.startswith(".")
                 and _TMP_MARKER not in n
                 and (n.endswith(".npz") or n.rstrip("/").endswith(".orbax"))]
        return sorted((self._join(n) for n in names),
                      key=os.path.getmtime, reverse=True)

    def _orbax_committed(self, path: str) -> bool:
        """A sharded checkpoint committed when orbax left its markers at
        its root or under ``tree``."""
        base = path.rstrip("/")
        return any(os.path.exists(f"{base}{sub}/{m}")
                   for sub in ("", "/tree") for m in _ORBAX_COMMIT_MARKERS)

    def _probe_loadable(self, path: str) -> bool:
        try:
            if path.rstrip("/").endswith(".orbax"):
                return self._orbax_committed(path)
            # a truncated .npz is a torn zip: np.load raises on it
            with np.load(path, allow_pickle=False) as z:
                return "__structure__" in z.files
        except Exception:
            return False

    # ---- retention ---------------------------------------------------------

    def _present_and_sized(self, man: Dict) -> bool:
        """Cheap goodness for retention (the CRC is read at resume): the
        payload present with its recorded size (a sharded one marked)."""
        p = self._join(man["payload"])
        if not os.path.exists(p):
            return False
        if man.get("sharded"):
            return self._orbax_committed(p)
        if man.get("size") is None:
            return True
        try:
            return os.path.getsize(p) == man["size"]
        except OSError:
            return False

    def gc(self) -> List[str]:
        """Keep the newest ``keep_n`` present-and-sized numbered
        generations, delete older payloads with their manifests and
        sidecars (never a bad generation newer than every good one: that
        is latest_good()'s to report), and sweep tmp files older than
        five minutes.  The overwritten payload is never collected."""
        removed: List[str] = []
        if self.keep_n:
            fixed = {self.payload_name(None), self.payload_name(None, True)}
            entries = sorted((m for m in self._manifests()
                              if m["payload"] not in fixed),
                             key=self._lineage_key, reverse=True)
            good = [m for m in entries
                    if self._present_and_sized(m)][:self.keep_n]
            keep = {m["payload"] for m in good}
            newest_good = self._lineage_key(good[0]) if good else None
            for man in entries:
                if man["payload"] in keep or (
                        newest_good is not None
                        and self._lineage_key(man) > newest_good):
                    continue
                for name in (man["payload"], man["_manifest_name"],
                             pipeline_state_path(man["payload"])):
                    p = self._join(name)
                    if name.endswith(".pipeline.json") \
                            and not os.path.exists(p):
                        continue  # the generation had no sidecar
                    try:
                        self._delete(p)
                        removed.append(p)
                    except OSError:
                        logger.warning("checkpoint GC could not delete %s",
                                       p, exc_info=True)
        now = time.time()
        for n in self._listdir():
            if _TMP_MARKER not in n:
                continue
            p = self._join(n)
            try:
                # a file's age against its mtime, which only the wall
                # clock compares to
                if now - os.path.getmtime(p) > 300.0:
                    os.remove(p)
                    removed.append(p)
            except OSError:
                pass
        return removed
