"""Pluggable storage: one interface over local paths and ``gs://`` URIs.

The port's own copy of the framework's storage seam (the training input
reads ``gs://`` data files through it).

The reference reaches every durable byte — staging uploads, history
files, localized resources — through Hadoop's ``FileSystem`` abstraction
(reference: TonyClient.java:163-192 staging, util/HdfsUtils.java scan/
read helpers, events/EventHandler.java HDFS writer). This package has
no HDFS; its two substrates are the local filesystem (laptop runs, the
local fake-cluster backend) and GCS (cloud fleets, whose hosts share no
filesystem with the submit host). This module is the one seam:
callers hold plain path strings (``/x/y`` or ``gs://bucket/x/y``) and the
scheme picks the implementation.

GCS is driven through the ``gsutil`` CLI rather than a client library —
the library is not in the image, the CLI is on every cloud VM, and a
subprocess boundary lets the test suite substitute a fake ``gsutil`` on
PATH (the same trick the reference's MiniDFS plays for HDFS). Override
the binary with ``TONY_GSUTIL``.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import subprocess
import threading

__all__ = [
    "Storage", "LocalStorage", "GcsStorage", "StorageError",
    "storage_for", "register_storage", "scheme_of",
    "sjoin", "sdirname", "sbasename", "is_remote",
    "sopen", "ssize",
]

_SCHEME_RE = re.compile(r"^([a-z][a-z0-9+.-]*)://")


class StorageError(OSError):
    """Backend (gsutil/...) operation failure. Subclasses OSError so
    callers guarding filesystem IO naturally cover remote storage too."""


def scheme_of(path: str) -> str:
    """'' for local paths, 'gs' for gs://... etc."""
    m = _SCHEME_RE.match(path)
    return m.group(1) if m else ""


def is_remote(path: str) -> bool:
    return bool(scheme_of(path))


def sjoin(base: str, *parts: str) -> str:
    """Path join that keeps URI schemes intact (os.path.join would treat
    'gs://b' fine on posix, but be explicit and platform-independent)."""
    if is_remote(base):
        out = base.rstrip("/")
        for p in parts:
            out += "/" + p.strip("/")
        return out
    return os.path.join(base, *parts)


def sdirname(path: str) -> str:
    if is_remote(path):
        scheme, _, rest = path.partition("://")
        head, _, _ = rest.rstrip("/").rpartition("/")
        return f"{scheme}://{head}"
    return os.path.dirname(path)


def sbasename(path: str) -> str:
    if is_remote(path):
        return path.rstrip("/").rpartition("/")[2]
    return os.path.basename(path)


class Storage:
    """Operations every substrate must provide. Paths are scheme-qualified
    strings; directory semantics are emulated where the substrate has none
    (GCS: a 'directory' exists iff some object lives under it)."""

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def isdir(self, path: str) -> bool:
        raise NotImplementedError

    def listdir(self, path: str) -> list[str]:
        """Immediate child names (files and dirs)."""
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def walk_files(self, path: str):
        """Yield (dirpath, [filenames]) over the whole tree, like os.walk
        restricted to files (reference: HdfsUtils.getJobFolders:123)."""
        raise NotImplementedError

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def read_tail(self, path: str, n: int) -> bytes:
        """Last n bytes (history server reads only jhist tails)."""
        raise NotImplementedError

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        """``length`` bytes starting at ``offset`` (short read at EOF) —
        the data feed's block-fetch primitive (the reference reads the
        distributed filesystem in place: HdfsAvroFileSplitReader.java:201
        ``fs.open(inputPath)`` + positioned reads)."""
        raise NotImplementedError

    def size(self, path: str) -> int:
        """Object size in bytes (split math needs it without a download)."""
        raise NotImplementedError

    def open_read(self, path: str, buffer_size: int | None = None):
        """Binary seekable read stream. Local paths get the real file;
        remote substrates get a buffered ranged reader — the data feed's
        sync-scan and block walk run against storage directly, no
        pre-copy. ``buffer_size`` tunes the remote fetch granularity:
        header/magic probes pass a small one so a few-byte peek doesn't
        pull a full scan-sized chunk."""
        raise NotImplementedError

    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def open_append(self, path: str):
        """Text-mode append stream. flush() makes the bytes visible to
        readers (possibly by re-uploading the object on GCS)."""
        raise NotImplementedError

    def move(self, src: str, dst: str) -> None:
        """Rename within this storage (the .inprogress -> final publish)."""
        raise NotImplementedError

    def remove(self, path: str) -> None:
        raise NotImplementedError

    def put(self, local_path: str, path: str) -> None:
        """Upload one local file."""
        raise NotImplementedError

    def get(self, path: str, local_path: str) -> None:
        """Download one file to a local path."""
        raise NotImplementedError

    def put_tree(self, local_dir: str, path: str) -> None:
        """Upload a local directory tree (client staging)."""
        raise NotImplementedError

    def get_tree(self, path: str, local_dir: str) -> None:
        """Download a tree (executor-side localization)."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
class LocalStorage(Storage):
    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def isdir(self, path: str) -> bool:
        return os.path.isdir(path)

    def listdir(self, path: str) -> list[str]:
        return sorted(os.listdir(path))

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def walk_files(self, path: str):
        for root, _, files in os.walk(path):
            yield root, files

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def read_tail(self, path: str, n: int) -> bytes:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - n))
            return f.read()

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        with open(path, "rb") as f:
            f.seek(offset)
            return f.read(length)

    def size(self, path: str) -> int:
        return os.path.getsize(path)

    def open_read(self, path: str, buffer_size: int | None = None):
        return open(path, "rb")

    def write_bytes(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)

    def open_append(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        return open(path, "a", encoding="utf-8")

    def move(self, src: str, dst: str) -> None:
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        os.replace(src, dst)

    def remove(self, path: str) -> None:
        os.remove(path)

    def put(self, local_path: str, path: str) -> None:
        if os.path.abspath(local_path) != os.path.abspath(path):
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            shutil.copy2(local_path, path)

    def get(self, path: str, local_path: str) -> None:
        self.put(path, local_path)

    def put_tree(self, local_dir: str, path: str) -> None:
        if os.path.abspath(local_dir) != os.path.abspath(path):
            shutil.copytree(local_dir, path, dirs_exist_ok=True)

    def get_tree(self, path: str, local_dir: str) -> None:
        self.put_tree(path, local_dir)


# ---------------------------------------------------------------------------
class _GcsAppendStream(io.TextIOBase):
    """GCS objects are immutable — append is emulated by buffering the whole
    stream and re-uploading on flush. Event traffic is control-plane-rate
    (a handful of task lifecycle records per job), so whole-object rewrite
    per flush is cheap and keeps .inprogress files live-readable, matching
    the reference's HDFS append visibility."""

    def __init__(self, storage: "GcsStorage", path: str) -> None:
        super().__init__()
        self._storage = storage
        self._path = path
        self._buf: list[str] = []
        self._lock = threading.Lock()
        if storage.exists(path):
            self._buf.append(storage.read_bytes(path).decode("utf-8"))

    def write(self, s: str) -> int:
        with self._lock:
            self._buf.append(s)
        return len(s)

    def flush(self) -> None:
        with self._lock:
            data = "".join(self._buf).encode("utf-8")
        self._storage.write_bytes(self._path, data)

    def close(self) -> None:
        if not self.closed:
            self.flush()
        super().close()


class _GcsRangedReader(io.RawIOBase):
    """Seekable raw stream over ranged GCS reads. Wrapped in a
    ``BufferedReader`` by :meth:`GcsStorage.open_read`, which turns the
    data feed's byte-at-a-time parsing into chunk-sized ``readinto``
    calls — one gsutil invocation per ~4 MB of sequential scan.

    Sequential scans additionally PREFETCH: scan-sized reads (>= one
    READ_CHUNK) keep a window of ``depth`` chunk fetches in flight on a
    thread pool, so a device-rate consumer is not gated on one serial gsutil
    fork per chunk (the reference's DataFetcher thread overlapped reads
    the same way against its HDFS client,
    HdfsAvroFileSplitReader.java:176 — here each fetch is a subprocess,
    so overlap needs N of them). Small reads (header/magic probes through
    a small ``buffer_size``) bypass the window and fetch exactly what was
    asked. Memory bound: depth x READ_CHUNK."""

    def __init__(self, storage: "GcsStorage", path: str,
                 depth: int | None = None) -> None:
        super().__init__()
        self._storage = storage
        self._path = path
        self._pos = 0
        self._size = storage.size(path)
        self._depth = storage.prefetch_depth if depth is None else depth
        self._futures: dict[int, object] = {}    # chunk index -> Future
        self._pool = None

    def _chunk_future(self, j: int, c: int):
        fut = self._futures.get(j)
        if fut is None:
            fut = self._pool.submit(self._storage.read_range, self._path,
                                    j * c, min(c, self._size - j * c))
            self._futures[j] = fut
        return fut

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, offset: int, whence: int = os.SEEK_SET) -> int:
        if whence == os.SEEK_SET:
            pos = offset
        elif whence == os.SEEK_CUR:
            pos = self._pos + offset
        elif whence == os.SEEK_END:
            pos = self._size + offset
        else:
            raise ValueError(f"bad whence {whence}")
        if pos < 0:
            # validate BEFORE committing: a caught failed seek must not
            # leave the stream at a negative position (a negative offset
            # would read gsutil's tail syntax, silently wrong bytes)
            raise OSError("negative seek position")
        self._pos = pos
        return self._pos

    def tell(self) -> int:
        return self._pos

    def readinto(self, b) -> int:
        if self._pos >= self._size:
            return 0
        n = min(len(b), self._size - self._pos)
        c = self._storage.READ_CHUNK
        if self._depth <= 1 or len(b) < c:
            # serial path: probes and depth-1 configs fetch exactly n
            data = self._storage.read_range(self._path, self._pos, n)
            b[:len(data)] = data
            self._pos += len(data)
            return len(data)
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self._depth,
                thread_name_prefix="tony-gcs-prefetch")
        i = self._pos // c
        last = (self._size - 1) // c
        # evict chunks behind the cursor or beyond the window (seeks);
        # cancel() is best-effort — a running fetch just gets discarded
        for j in list(self._futures):
            if j < i or j >= i + self._depth:
                self._futures.pop(j).cancel()
        for j in range(i, min(i + self._depth, last + 1)):
            self._chunk_future(j, c)
        data = self._chunk_future(i, c).result()
        start = self._pos - i * c
        out = data[start:start + n]       # serve from chunk i only; the
        if start + len(out) >= len(data):  # BufferedReader loops on short
            self._futures.pop(i, None)     # reads
        b[:len(out)] = out
        self._pos += len(out)
        return len(out)

    def close(self) -> None:
        for fut in self._futures.values():
            fut.cancel()
        self._futures.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        super().close()


class GcsStorage(Storage):
    """``gs://`` via the gsutil CLI (override binary with $TONY_GSUTIL)."""

    #: every gsutil call is bounded — a network blackhole must never hang
    #: coordinator teardown or a history-server request forever (override
    #: with $TONY_GSUTIL_TIMEOUT, seconds)
    DEFAULT_TIMEOUT_S = 600.0

    def __init__(self, gsutil: str | None = None,
                 timeout_s: float | None = None,
                 token: str | None = None) -> None:
        self.gsutil = gsutil or os.environ.get("TONY_GSUTIL") or "gsutil"
        self.timeout_s = timeout_s if timeout_s is not None else float(
            os.environ.get("TONY_GSUTIL_TIMEOUT", self.DEFAULT_TIMEOUT_S))
        #: per-job scoped credential (tony.gcs.service-account): an
        #: explicit token, else $TONY_GCS_TOKEN read per call — the env
        #: var is how the client hands the job identity to coordinator
        #: and executors without any byte of it touching the bucket
        self.token = token
        self._size_cache: dict[str, tuple[int, float]] = {}
        #: concurrent ranged fetches per open_read stream (sequential-scan
        #: prefetch window); 1 disables the pool entirely
        self.prefetch_depth = max(1, int(
            os.environ.get("TONY_GCS_PREFETCH_DEPTH", "4")))

    # -- plumbing ----------------------------------------------------------
    def _env(self, args: tuple = ()) -> dict[str, str] | None:
        """Subprocess env: inject the job's scoped token (gcloud-suite
        tools honor CLOUDSDK_AUTH_ACCESS_TOKEN over ambient credentials);
        None → inherit, keeping the ambient-credential default. A token
        FILE wins over the env value — it is re-read per call, so
        client-pushed renewals (executor heartbeat republishing) reach
        processes that forked before the renewal.

        The credential may be a JSON ``{bucket: token}`` blob
        (multi-identity jobs, ``tony.gcs.service-account`` with
        ``bucket=sa`` pairs — the list-valued ``tony.other.namenodes``
        analog): the token is then selected by this CALL's target bucket
        (first gs:// argument), ``*`` as the fallback identity. A bucket
        with no mapped identity is a configuration error and raises —
        silently falling back to ambient credentials would defeat the
        per-job identity scoping."""
        tok = self.token
        if not tok:
            tok_file = os.environ.get("TONY_GCS_TOKEN_FILE")
            if tok_file:
                try:
                    with open(tok_file, encoding="utf-8") as f:
                        tok = f.read().strip()
                except OSError:
                    tok = None
        if not tok:
            tok = os.environ.get("TONY_GCS_TOKEN")
        if not tok:
            return None
        if tok.lstrip().startswith("{"):
            try:
                mapping = json.loads(tok)
            except ValueError:
                mapping = None
            if isinstance(mapping, dict):
                buckets = {a[len("gs://"):].split("/", 1)[0]
                           for a in args
                           if isinstance(a, str) and a.startswith("gs://")}
                toks = set()
                for bucket in buckets or {""}:
                    t = mapping.get(bucket) or mapping.get("*")
                    if not t:
                        raise StorageError(
                            f"no GCS identity mapped for bucket "
                            f"{bucket!r} (tony.gcs.service-account lists "
                            f"{sorted(mapping)}; add '{bucket}=sa' or a "
                            f"'*=sa' default)")
                    toks.add(t)
                if len(toks) > 1:
                    # a single gsutil call runs under ONE identity; a
                    # cross-bucket op spanning two would silently act on
                    # the second bucket as the first's identity — make
                    # the caller copy through read+write instead
                    raise StorageError(
                        f"one call touches buckets {sorted(buckets)} "
                        f"mapped to DIFFERENT identities; split the "
                        f"operation per bucket")
                tok = toks.pop()
        return {**os.environ, "CLOUDSDK_AUTH_ACCESS_TOKEN": tok}

    def _run(self, *args: str, input_bytes: bytes | None = None,
             ok_codes: tuple[int, ...] = (0,)) -> bytes:
        try:
            proc = subprocess.run(
                [self.gsutil, "-q", *args], input=input_bytes,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                env=self._env(args), timeout=self.timeout_s)
        except subprocess.TimeoutExpired as e:
            raise StorageError(
                f"{self.gsutil} {' '.join(args)} timed out after "
                f"{self.timeout_s:.0f}s") from e
        if proc.returncode not in ok_codes:
            raise StorageError(
                f"{self.gsutil} {' '.join(args)} failed rc={proc.returncode}: "
                f"{proc.stderr.decode('utf-8', 'replace').strip()}")
        return proc.stdout

    def _try(self, *args: str) -> bool:
        """False means the probed object genuinely is not there; a timeout
        is a backend failure and raises — silently reading a blackhole as
        'does not exist' could make callers overwrite live data."""
        try:
            proc = subprocess.run(
                [self.gsutil, "-q", *args],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                env=self._env(args), timeout=self.timeout_s)
        except subprocess.TimeoutExpired as e:
            raise StorageError(
                f"{self.gsutil} {' '.join(args)} timed out after "
                f"{self.timeout_s:.0f}s") from e
        return proc.returncode == 0

    def _ls(self, pattern: str) -> list[str]:
        """[] means nothing matches; a timeout raises (see _try)."""
        try:
            proc = subprocess.run(
                [self.gsutil, "-q", "ls", pattern],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                env=self._env(("ls", pattern)), timeout=self.timeout_s)
        except subprocess.TimeoutExpired as e:
            raise StorageError(
                f"{self.gsutil} ls {pattern} timed out after "
                f"{self.timeout_s:.0f}s") from e
        if proc.returncode != 0:
            return []
        return [l.strip() for l in proc.stdout.decode().splitlines()
                if l.strip()]

    # -- interface ---------------------------------------------------------
    def exists(self, path: str) -> bool:
        # stat matches objects; a trailing-slash ls matches "directories"
        return self._try("stat", path) or bool(
            self._ls(path.rstrip("/") + "/"))

    def isdir(self, path: str) -> bool:
        return bool(self._ls(path.rstrip("/") + "/"))

    def listdir(self, path: str) -> list[str]:
        names = set()
        for entry in self._ls(path.rstrip("/") + "/"):
            name = entry[len(path.rstrip("/")) + 1:] if entry.startswith(
                path.rstrip("/")) else sbasename(entry)
            names.add(name.strip("/").split("/")[0] if name else "")
        names.discard("")
        return sorted(names)

    def makedirs(self, path: str) -> None:
        pass    # GCS has no directories; objects create their prefixes

    def walk_files(self, path: str):
        root = path.rstrip("/")
        by_dir: dict[str, list[str]] = {}
        for entry in self._ls(root + "/**"):
            if entry.endswith("/"):
                continue
            by_dir.setdefault(sdirname(entry), []).append(sbasename(entry))
        for d in sorted(by_dir):
            yield d, sorted(by_dir[d])

    def read_bytes(self, path: str) -> bytes:
        return self._run("cat", path)

    def read_tail(self, path: str, n: int) -> bytes:
        return self._run("cat", "-r", f"-{n}", path)

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        if length <= 0:
            return b""
        # gsutil cat -r takes an INCLUSIVE byte range; an end past EOF is
        # clamped by the tool, a start at/after EOF yields empty output
        return self._run("cat", "-r", f"{offset}-{offset + length - 1}",
                         path)

    #: stat results are cached briefly: the data feed sizes, sniffs, and
    #: re-opens the same objects several times during reader setup, and
    #: each miss is a gsutil subprocess (hundreds of ms over a slow
    #: tunnel). GCS objects are immutable per generation, so the only
    #: staleness risk is an object REPLACED mid-read — bounded to this
    #: window. Set 0 to disable.
    SIZE_CACHE_TTL_S = 30.0

    def size(self, path: str) -> int:
        import time as _time
        now = _time.monotonic()
        hit = self._size_cache.get(path)
        if hit is not None and now - hit[1] < self.SIZE_CACHE_TTL_S:
            return hit[0]
        out = self._run("du", path).decode("utf-8", "replace")
        for line in out.splitlines():
            parts = line.split()
            if len(parts) >= 2 and parts[0].isdigit():
                if len(self._size_cache) > 4096:
                    self._size_cache.clear()
                self._size_cache[path] = (int(parts[0]), now)
                return int(parts[0])
        raise StorageError(f"gsutil du {path}: unparseable output {out!r}")

    def open_read(self, path: str, buffer_size: int | None = None):
        return io.BufferedReader(_GcsRangedReader(self, path),
                                 buffer_size=buffer_size or self.READ_CHUNK)

    #: ranged-read granularity for open_read streams: large enough that a
    #: sequential block scan costs one subprocess per few MB, small enough
    #: that a header probe doesn't pull the whole object
    READ_CHUNK = 4 * 1024 * 1024

    def _invalidate_size(self, *paths: str) -> None:
        """Drop cached stat results for mutated objects — a process that
        overwrites an object and sizes it within the TTL (split math right
        after staging/convert) must see the new size, not the cached one."""
        for p in paths:
            self._size_cache.pop(p, None)

    def write_bytes(self, path: str, data: bytes) -> None:
        self._run("cp", "-", path, input_bytes=data)
        self._invalidate_size(path)

    def open_append(self, path: str):
        return _GcsAppendStream(self, path)

    def move(self, src: str, dst: str) -> None:
        self._run("mv", src, dst)
        self._invalidate_size(src, dst)

    def remove(self, path: str) -> None:
        self._run("rm", path)
        self._invalidate_size(path)

    def put(self, local_path: str, path: str) -> None:
        self._run("cp", local_path, path)
        self._invalidate_size(path)

    def get(self, path: str, local_path: str) -> None:
        os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
        self._run("cp", path, local_path)

    def put_tree(self, local_dir: str, path: str) -> None:
        # rsync -r preserves relative layout on repeated stagings
        self._run("rsync", "-r", local_dir.rstrip("/"), path.rstrip("/"))
        self._size_cache.clear()    # a prefix-wide write: anything under it

    def get_tree(self, path: str, local_dir: str) -> None:
        os.makedirs(local_dir, exist_ok=True)
        self._run("rsync", "-r", path.rstrip("/"), local_dir.rstrip("/"))


# ---------------------------------------------------------------------------
_registry: dict[str, Storage] = {}
_registry_lock = threading.Lock()


def register_storage(scheme: str, storage: Storage | None) -> None:
    """Override an implementation (tests register tmpdir-backed fakes);
    None clears the override so the default is rebuilt on next use."""
    with _registry_lock:
        if storage is None:
            _registry.pop(scheme, None)
        else:
            _registry[scheme] = storage


def sopen(path: str, buffer_size: int | None = None):
    """Scheme-dispatched binary read stream (the data feed's opener: the
    reference's ``fs.open(inputPath)``, HdfsAvroFileSplitReader.java:201).
    Pass a small ``buffer_size`` for header/magic probes — a
    BufferedReader fills its WHOLE buffer on the first read, so probing
    a remote object with the default scan-sized buffer would fetch MBs
    for a few bytes."""
    return storage_for(path).open_read(path, buffer_size=buffer_size)


def ssize(path: str) -> int:
    """Scheme-dispatched object size (split math over remote listings)."""
    return storage_for(path).size(path)


def storage_for(path: str) -> Storage:
    scheme = scheme_of(path)
    with _registry_lock:
        inst = _registry.get(scheme)
        if inst is None:
            if scheme == "":
                inst = LocalStorage()
            elif scheme == "gs":
                inst = GcsStorage()
            else:
                raise StorageError(
                    f"no storage registered for scheme '{scheme}://' "
                    f"({path})")
            _registry[scheme] = inst
    return inst
