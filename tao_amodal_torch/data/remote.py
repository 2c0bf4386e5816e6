"""Remote data acquisition: retry and backoff, caching stores, the S3,
video-fetch and Scale API interfaces, and a working file transport.

Port of :mod:`tao_amodal_tpu.data.remote` (the reference's
``visualization/tao/utils/{s3,ytdl,scale}.py``), with the same classes,
exceptions, retry and backoff schedules, cache layout and URL schemes.
Standard library only.  The clients that would need the network (S3,
a video downloader, the Scale API) are injection points: without an
injected client they raise, and :func:`open_store` serves ``file://``
URLs and bare paths (NFS, FUSE-mounted buckets, air-gapped mirrors)
through :class:`FileTransport`.
"""

from __future__ import annotations

import functools
import logging
import os
import time

logger = logging.getLogger(__name__)


def retry_with_backoff(attempts=5, base_delay=0.5, max_delay=30.0,
                       retryable=(OSError,)):
    """Exponential-backoff retry decorator (capability of reference
    ``s3.py:206-268``)."""

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            delay = base_delay
            for attempt in range(attempts):
                try:
                    return fn(*args, **kwargs)
                except retryable as e:
                    if attempt == attempts - 1:
                        raise
                    logger.warning(
                        "%s failed (%s); retrying in %.1fs",
                        fn.__name__, e, delay)
                    time.sleep(delay)
                    delay = min(delay * 2, max_delay)
        return wrapper

    return decorate


class CachedStore:
    """Content-addressed local cache in front of a remote fetcher
    (capability of reference ``s3.py`` download caching)."""

    def __init__(self, cache_dir, fetcher=None):
        self.cache_dir = cache_dir
        self.fetcher = fetcher
        os.makedirs(cache_dir, exist_ok=True)

    def path_for(self, key):
        return os.path.join(self.cache_dir, key.replace("/", "_"))

    @retry_with_backoff()
    def get(self, key):
        path = self.path_for(key)
        if os.path.exists(path):
            return path
        if self.fetcher is None:
            raise FileNotFoundError(
                f"{key} not cached and no remote fetcher configured "
                f"(zero-egress build; provide fetcher=... to enable)")
        data = self.fetcher(key)
        with open(path, "wb") as f:
            f.write(data)
        return path


class S3Store(CachedStore):
    """S3 interface; needs boto3 (not in this image) -> raises with a
    clear message unless a client is injected."""

    def __init__(self, bucket, cache_dir, client=None):
        self.bucket = bucket
        self.client = client

        def fetch(key):
            if self.client is None:
                raise RuntimeError(
                    "S3 access requires a boto3-like client; inject "
                    "one via S3Store(client=...)")
            return self.client.get_object(
                Bucket=self.bucket, Key=key)["Body"].read()

        super().__init__(cache_dir, fetch)


PERMANENTLY_UNAVAILABLE = "permanently_unavailable"


def fetch_video(video_id, output_dir, downloader=None):
    """Video fetch with unavailability bookkeeping (capability of
    reference ``ytdl.py:18-48,108-230``): records permanently
    unavailable videos so re-runs skip them."""
    marker = os.path.join(output_dir, f"{video_id}.unavailable")
    if os.path.exists(marker):
        return None
    out = os.path.join(output_dir, f"{video_id}.mp4")
    if os.path.exists(out):
        return out
    if downloader is None:
        raise RuntimeError(
            "video download requires a downloader callable "
            "(zero-egress build)")
    try:
        downloader(video_id, out)
        return out
    except PermanentUnavailableError:
        with open(marker, "w") as f:
            f.write(PERMANENTLY_UNAVAILABLE)
        return None


class PermanentUnavailableError(Exception):
    pass


def list_scale_tasks(project, api_key=None, client=None):
    """Scale-API task listing interface (capability of reference
    ``scale.py``)."""
    if client is None:
        raise RuntimeError(
            "Scale API access requires an injected client "
            "(zero-egress build)")
    return client.tasks(project=project)


# ---------------------------------------------------------------------
# Working transport + store (the live half of this module).
#
# The reference's acquisition layer is S3 (s3.py:487-609 S3Wrapper:
# get/put/list_keys/exists/upload_dir with disk caching gated on a
# modification-time check, and sqrt(2)-factor retry backoff).  The
# zero-egress build ships the same store semantics over a REAL
# transport it can exercise: the local filesystem / ``file://`` URLs
# (NFS, FUSE-mounted buckets, air-gapped mirrors).  S3/HTTP stay
# injection points (S3Store above) — same interface, swap the
# transport.
# ---------------------------------------------------------------------


class TransportError(OSError):
    """Retryable transport failure (the analog of botocore's
    transient error family)."""


class FileTransport:
    """Key-value transport over a local directory tree.

    Accepts a filesystem path or a ``file://`` URL as the root; keys
    are slash-separated relative paths (the S3 key convention).
    """

    def __init__(self, root):
        if isinstance(root, str) and root.startswith("file://"):
            root = root[len("file://"):]
        self.root = os.path.abspath(root)

    def _path(self, key):
        path = os.path.abspath(os.path.join(self.root, key))
        if not path.startswith(self.root + os.sep):
            raise ValueError(f"key escapes the transport root: {key}")
        return path

    def get_bytes(self, key):
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(key) from None

    def put_bytes(self, key, data):
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic: readers never see a torn file

    def exists(self, key):
        return os.path.isfile(self._path(key))

    def mtime(self, key):
        try:
            return os.path.getmtime(self._path(key))
        except FileNotFoundError:
            raise KeyError(key) from None

    def list_keys(self, prefix="", max_keys=None):
        out = []
        base = self.root
        for dirpath, _dirs, files in os.walk(base):
            for name in files:
                rel = os.path.relpath(os.path.join(dirpath, name),
                                      base).replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        out.sort()  # S3 ListObjects key order (lexicographic)
        return out if max_keys is None else out[:max_keys]


class RemoteStore:
    """Cached, retrying store over any transport — the working
    equivalent of the reference's ``S3Wrapper``
    (``visualization/tao/utils/s3.py:487-609``): disk cache gated on a
    source modification-time check, sqrt(2)-factor exponential retry
    backoff, parallel multi-get, directory upload.
    """

    def __init__(self, transport, cache_dir=None, num_tries=5,
                 initial_delay=1.0, delay_factor=2.0 ** 0.5,
                 skip_modification_time_check=False, sleep=time.sleep,
                 max_num_threads=8):
        self.transport = transport
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        self.num_tries = num_tries
        self.initial_delay = initial_delay
        self.delay_factor = delay_factor
        self.skip_modification_time_check = skip_modification_time_check
        self._sleep = sleep  # injectable for tests
        self.max_num_threads = max_num_threads

    def _with_backoff(self, fn, *args):
        delay = self.initial_delay
        for attempt in range(self.num_tries):
            try:
                return fn(*args)
            except (TransportError, ConnectionError, TimeoutError) as e:
                if attempt == self.num_tries - 1:
                    raise
                logger.warning("%s failed (%s); retry %d/%d in %.1fs",
                               getattr(fn, "__name__", fn), e,
                               attempt + 1, self.num_tries - 1, delay)
                self._sleep(delay)
                delay *= self.delay_factor

    def _cache_path(self, key):
        return os.path.join(self.cache_dir, key.replace("/", "_"))

    def _cache_fresh(self, key):
        """Reference semantics (s3.py download_s3_file_with_caching):
        a cached file is served only if it is not older than the
        source — unless the time check is explicitly skipped."""
        path = self._cache_path(key)
        if not os.path.exists(path):
            return None
        if self.skip_modification_time_check:
            return path
        try:
            src_mtime = self._with_backoff(self.transport.mtime, key)
        except KeyError:
            return None
        return path if os.path.getmtime(path) >= src_mtime else None

    def get(self, key):
        """Bytes for ``key`` (through the cache when configured)."""
        if self.cache_dir:
            cached = self._cache_fresh(key)
            if cached is not None:
                with open(cached, "rb") as f:
                    return f.read()
        data = self._with_backoff(self.transport.get_bytes, key)
        if self.cache_dir:
            path = self._cache_path(key)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        return data

    def get_multiple(self, keys):
        """``{key: bytes}`` fetched in parallel (reference
        ``get_s3_object_bytes_parallel``)."""
        import concurrent.futures as cf

        with cf.ThreadPoolExecutor(
                max_workers=min(self.max_num_threads,
                                max(len(keys), 1))) as pool:
            return dict(zip(keys, pool.map(self.get, keys)))

    def download_file(self, key, filename):
        data = self.get(key)
        os.makedirs(os.path.dirname(os.path.abspath(filename)),
                    exist_ok=True)
        with open(filename, "wb") as f:
            f.write(data)
        return filename

    def put(self, data, key):
        self._with_backoff(self.transport.put_bytes, key, data)

    def upload_file(self, filename, key):
        with open(filename, "rb") as f:
            self.put(f.read(), key)

    def upload_dir(self, directory, prefix):
        """Reference ``S3Wrapper.upload_dir``: every file under
        ``directory`` lands at ``prefix/<relative path>``."""
        if not prefix.endswith("/"):
            prefix += "/"
        directory = os.path.abspath(directory)
        for dirpath, _dirs, files in sorted(os.walk(directory)):
            for name in sorted(files):
                full = os.path.join(dirpath, name)
                rel = os.path.relpath(full, directory).replace(
                    os.sep, "/")
                self.upload_file(full, prefix + rel)

    def exists(self, key):
        return self._with_backoff(self.transport.exists, key)

    def list_keys(self, prefix="", max_keys=None):
        return self._with_backoff(
            lambda: self.transport.list_keys(prefix, max_keys))


def open_store(url, cache_dir=None, **kwargs):
    """Store for a URL: ``file://`` (or a bare path) is live;
    ``s3://`` requires an injected client (zero-egress build)."""
    if url.startswith("s3://"):
        raise RuntimeError(
            "s3:// requires an injected client in this build; use "
            "S3Store(bucket, cache_dir, client=...) or mount the "
            "bucket and use file://")
    return RemoteStore(FileTransport(url), cache_dir=cache_dir,
                       **kwargs)
