"""The port's acquisition layer (``tao_amodal_torch/data/remote.py``)
held against the JAX package's (``tao_amodal_tpu/data/remote.py``).

Every scenario of ``tests/test_remote.py`` and
``tests/test_aux.py::test_remote_stubs`` runs on both modules, each in a
directory of its own, and records what it observed: returned bytes,
listed keys, sleeps and retry counts, the cache directory's files and
the types of the exceptions raised.  The two records must be equal, and
each must also show the behaviour the JAX tests assert.  No network is
touched: the transports are local directories.
"""

import os
import time

import pytest

import tao_amodal_torch.data.remote as port_remote

MODULES = ("jax", "port")


def module(which):
    if which == "port":
        return port_remote
    import tao_amodal_tpu.data.remote as jax_remote

    return jax_remote


def make_root(tmp_path):
    root = tmp_path / "bucket"
    (root / "videos/val").mkdir(parents=True)
    (root / "videos/val/a.mp4").write_bytes(b"AAAA")
    (root / "videos/val/b.mp4").write_bytes(b"BB")
    (root / "ann.json").write_bytes(b"{}")
    return root


def raised(fn):
    """The type name of what ``fn()`` raises (None if nothing)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is the observation
        return type(e).__name__
    return None


def files(path):
    return sorted(os.listdir(path)) if os.path.isdir(path) else None


def flaky(m, root, fail_times):
    """A transport whose first ``fail_times`` gets fail transiently."""

    class Flaky(m.FileTransport):
        def __init__(self):
            super().__init__(str(root))
            self.calls = 0

        def get_bytes(self, key):
            self.calls += 1
            if self.calls <= fail_times:
                raise m.TransportError(f"transient #{self.calls}")
            return super().get_bytes(key)

    return Flaky()


def counting(m, root):
    class Counting(m.FileTransport):
        def __init__(self):
            super().__init__(str(root))
            self.gets = 0

        def get_bytes(self, key):
            self.gets += 1
            return super().get_bytes(key)

    return Counting()


def transport_roundtrip(m, tmp):
    root = make_root(tmp)
    t = m.FileTransport(f"file://{root}")
    seen = dict(get=t.get_bytes("videos/val/a.mp4"),
                exists=(t.exists("ann.json"), t.exists("nope")),
                listed=t.list_keys("videos/"),
                first_two=t.list_keys(max_keys=2))
    t.put_bytes("out/c.bin", b"C")
    return dict(
        seen, put=(root / "out/c.bin").read_bytes(),
        missing=raised(lambda: t.get_bytes("missing")),
        escape=raised(lambda: t.get_bytes("../escape")),
        mtime_missing=raised(lambda: t.mtime("missing")))


def backoff_retries(m, tmp):
    sleeps = []
    t = flaky(m, make_root(tmp), 2)
    store = m.RemoteStore(t, initial_delay=0.5, sleep=sleeps.append)
    return dict(got=store.get("ann.json"), sleeps=sleeps, calls=t.calls)


def backoff_exhaustion(m, tmp):
    sleeps = []
    t = flaky(m, make_root(tmp), 99)
    store = m.RemoteStore(t, num_tries=3, sleep=sleeps.append)
    return dict(error=raised(lambda: store.get("ann.json")), sleeps=sleeps,
                calls=t.calls)


def nonretryable(m, tmp):
    sleeps = []
    store = m.RemoteStore(m.FileTransport(make_root(tmp)),
                          sleep=sleeps.append)
    return dict(error=raised(lambda: store.get("missing")), sleeps=sleeps)


def cache_hit(m, tmp):
    t = counting(m, make_root(tmp))
    cache = str(tmp / "cache")
    store = m.RemoteStore(t, cache_dir=cache)
    got = [store.get("videos/val/a.mp4"), store.get("videos/val/a.mp4")]
    return dict(got=got, gets=t.gets, cache=files(cache))


def cache_mtime(m, tmp):
    root = make_root(tmp)
    t = counting(m, root)
    cache = str(tmp / "cache")
    store = m.RemoteStore(t, cache_dir=cache)
    first = store.get("ann.json")
    src = root / "ann.json"
    src.write_bytes(b'{"v":2}')
    future = time.time() + 60
    os.utime(src, (future, future))
    second = store.get("ann.json")
    gets = t.gets
    skip = m.RemoteStore(t, cache_dir=cache,
                         skip_modification_time_check=True)
    return dict(got=[first, second, skip.get("ann.json")],
                gets=[gets, t.gets], cache=files(cache),
                cached=open(os.path.join(cache, "ann.json"), "rb").read())


def get_multiple(m, tmp):
    store = m.open_store(str(make_root(tmp)), cache_dir=str(tmp / "c"))
    return dict(got=store.get_multiple(["videos/val/a.mp4",
                                        "videos/val/b.mp4"]),
                empty=store.get_multiple([]), cache=files(str(tmp / "c")))


def upload_dir(m, tmp):
    root = tmp / "store"
    root.mkdir()
    src = tmp / "src"
    (src / "sub").mkdir(parents=True)
    (src / "x.txt").write_bytes(b"x")
    (src / "sub/y.txt").write_bytes(b"y")
    store = m.open_store(f"file://{root}")
    store.upload_dir(str(src), "runs/r1")
    dest = tmp / "dl" / "x.txt"
    store.download_file("runs/r1/x.txt", str(dest))
    return dict(listed=store.list_keys("runs/"),
                exists=(store.exists("runs/r1/x.txt"),
                        store.exists("runs/r1/z.txt")),
                downloaded=dest.read_bytes())


def s3_needs_client(m, tmp):
    class Client:
        def get_object(self, Bucket, Key):
            import io

            return {"Body": io.BytesIO(f"{Bucket}:{Key}".encode())}

    store = m.S3Store("bkt", str(tmp / "s3"), client=Client())
    path = store.get("a/b")
    bare = m.S3Store("bkt", str(tmp / "s3bare"))
    return dict(open_store=raised(lambda: m.open_store("s3://bucket/x")),
                injected=open(path, "rb").read(),
                path=os.path.relpath(path, tmp),
                bare=raised(lambda: bare.get("a/b")),
                scale=raised(lambda: m.list_scale_tasks("proj")),
                scale_client=m.list_scale_tasks(
                    "proj", client=type("C", (), {
                        "tasks": lambda self, project: [project]})()))


def retry_and_video_marker(m, tmp):
    calls = []

    @m.retry_with_backoff(attempts=3, base_delay=0.0)
    def sometimes(key):
        calls.append(key)
        if len(calls) < 2:
            raise OSError("flaky")
        return "ok"

    attempts = []

    def downloader(video_id, out):
        attempts.append(video_id)
        raise m.PermanentUnavailableError(video_id)

    def fetched(video_id, out):
        with open(out, "wb") as f:
            f.write(b"mp4")

    out_dir = str(tmp)
    return dict(
        retried=sometimes("k"), calls=calls,
        videos=[m.fetch_video("v1", out_dir, downloader),
                m.fetch_video("v1", out_dir, downloader)],
        attempts=attempts,
        marker=open(os.path.join(out_dir, "v1.unavailable")).read(),
        fetched=os.path.basename(m.fetch_video("v2", out_dir, fetched)),
        no_downloader=raised(lambda: m.fetch_video("v3", out_dir)),
        constant=m.PERMANENTLY_UNAVAILABLE)


def remote_stubs(m, tmp):
    calls = {"n": 0}

    @m.retry_with_backoff(attempts=3, base_delay=0.0)
    def flaky_fn():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    def always():
        raise OSError("down")

    store = m.CachedStore(str(tmp / "cache"), fetcher=lambda key: b"DATA")
    p = store.get("some/key")
    data = open(p, "rb").read()
    store.fetcher = None
    again = store.get("some/key")
    return dict(
        flaky=flaky_fn(), calls=calls["n"], data=data,
        path=os.path.relpath(p, tmp), hit=again == p,
        uncached=raised(lambda: store.get("other")),
        exhausted=raised(m.retry_with_backoff(attempts=2,
                                              base_delay=0.0)(always)))


# What tests/test_remote.py and tests/test_aux.py assert of each record.
EXPECTED = {
    transport_roundtrip: dict(
        get=b"AAAA", exists=(True, False),
        listed=["videos/val/a.mp4", "videos/val/b.mp4"],
        first_two=["ann.json", "videos/val/a.mp4"], put=b"C",
        missing="KeyError", escape="ValueError", mtime_missing="KeyError"),
    backoff_retries: dict(got=b"{}", sleeps=[0.5, 0.5 * 2 ** 0.5], calls=3),
    backoff_exhaustion: dict(error="TransportError", sleeps=[1.0, 2 ** 0.5],
                             calls=3),
    nonretryable: dict(error="KeyError", sleeps=[]),
    cache_hit: dict(got=[b"AAAA", b"AAAA"], gets=1,
                    cache=["videos_val_a.mp4"]),
    cache_mtime: dict(got=[b"{}", b'{"v":2}', b'{"v":2}'], gets=[2, 2],
                      cache=["ann.json"], cached=b'{"v":2}'),
    get_multiple: dict(got={"videos/val/a.mp4": b"AAAA",
                            "videos/val/b.mp4": b"BB"}, empty={},
                       cache=["videos_val_a.mp4", "videos_val_b.mp4"]),
    upload_dir: dict(listed=["runs/r1/sub/y.txt", "runs/r1/x.txt"],
                     exists=(True, False), downloaded=b"x"),
    s3_needs_client: dict(open_store="RuntimeError", injected=b"bkt:a/b",
                          path="s3/a_b", bare="RuntimeError",
                          scale="RuntimeError", scale_client=["proj"]),
    retry_and_video_marker: dict(
        retried="ok", calls=["k", "k"], videos=[None, None],
        attempts=["v1"], marker="permanently_unavailable",
        fetched="v2.mp4", no_downloader="RuntimeError",
        constant="permanently_unavailable"),
    remote_stubs: dict(flaky="ok", calls=3, data=b"DATA", path="cache/some_key",
                       hit=True, uncached="FileNotFoundError",
                       exhausted="OSError"),
}


@pytest.fixture(autouse=True)
def _no_sleep(monkeypatch):
    """``retry_with_backoff`` sleeps through ``time.sleep``: record the
    delays in both modules instead of waiting."""
    slept = []
    for which in MODULES:
        monkeypatch.setattr(module(which).time, "sleep", slept.append)
    return slept


@pytest.mark.parametrize("scenario", list(EXPECTED),
                         ids=[f.__name__ for f in EXPECTED])
def test_scenario_matches_jax(scenario, tmp_path):
    records = {}
    for which in MODULES:
        tmp = tmp_path / which
        tmp.mkdir()
        records[which] = scenario(module(which), tmp)
    assert records["port"] == records["jax"]
    want = EXPECTED[scenario]
    got = records["port"]
    for key, value in want.items():
        if key == "sleeps":
            assert got[key] == pytest.approx(value), key
        else:
            assert got[key] == value, key


def test_same_public_names_and_defaults():
    """The port's module has JAX's public names, its classes and functions
    the same signatures, its exceptions the same bases."""
    import inspect

    jax_remote = module("jax")
    names = {n for n in vars(jax_remote) if not n.startswith("_")} - {
        "annotations", "functools", "logging", "os", "time", "logger"}
    assert names <= set(vars(port_remote))
    for name in sorted(names):
        a, b = getattr(jax_remote, name), getattr(port_remote, name)
        if inspect.isclass(a) and issubclass(a, BaseException):
            assert [c.__name__ for c in a.__mro__] == [
                c.__name__ for c in b.__mro__], name
        elif callable(a):
            assert (str(inspect.signature(a))
                    == str(inspect.signature(b))), name
        else:
            assert a == b, name
    assert issubclass(port_remote.TransportError, OSError)
    assert issubclass(port_remote.S3Store, port_remote.CachedStore)


def test_imports_only_the_standard_library():
    """The module imports neither torch nor numpy (nor jax)."""
    import ast

    tree = ast.parse(open(port_remote.__file__).read())
    roots = {alias.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for alias in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert roots <= {"__future__", "concurrent", "functools", "logging",
                     "os", "time"}, roots
