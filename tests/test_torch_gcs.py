"""The port's GCS client and bucket mounts (``storage/gcs.py``,
``storage/volume.py`` ``CloudBucketMount``) held against the JAX package's,
over ``tests/test_gcs.py``'s fake GCS server (copied here, and taught to
record each request and to answer the metadata server's token route): the
cases of ``tests/test_gcs.py`` on the port, the same requests (method, path,
query, auth header) from both packages' clients for the same operations,
the bearer token from a ``Secret`` and from the metadata server, and the
mount's containment of object names. No request leaves this host: every
client here talks to the fake, and the metadata URL of both packages points
at it too.
"""

import json
import threading
import urllib.parse

import pytest

import modal_examples_tpu as jm
import modal_examples_tpu_torch as mtpu
from modal_examples_tpu.storage import gcs as jgcs
from modal_examples_tpu_torch.storage import gcs as pgcs
from modal_examples_tpu_torch.storage.gcs import GCSClient, GCSError, sync_dir_to_prefix, sync_prefix_to_dir
from test_torch_time_limit import share_cores, time_limits

share_cores()

#: each test talks to a local fake server (well under a second)
_limit_module, _limit_test = time_limits(test_s=60, module_s=120)


class _FakeGCS:
    """Just enough of storage.googleapis.com: list/get/upload/delete,
    pagination, bearer-token check."""

    def __init__(self, require_token: str | None = None):
        import http.server

        store = self.store = {}  # (bucket, name) -> bytes
        self.requests = []  # (method, path, sorted query, Authorization)
        outer = self

        class H(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _record(self):
                parsed = urllib.parse.urlparse(self.path)
                outer.requests.append((self.command, parsed.path, sorted(urllib.parse.parse_qsl(parsed.query)),
                                       self.headers.get("Authorization")))

            def _auth_ok(self):
                self._record()
                if outer.require_token is None:
                    return True
                return (
                    self.headers.get("Authorization")
                    == f"Bearer {outer.require_token}"
                )

            def _json(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("content-length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/computeMetadata/v1/instance/service-accounts/default/token":
                    # the metadata server of a GCE VM (the token route only)
                    ok = self.headers.get("Metadata-Flavor") == "Google"
                    return self._json(200 if ok else 403, {"access_token": "from-metadata"})
                if not self._auth_ok():
                    return self._json(401, {"error": "unauthorized"})
                parsed = urllib.parse.urlparse(self.path)
                parts = parsed.path.strip("/").split("/")
                q = {k: v[-1] for k, v in
                     urllib.parse.parse_qs(parsed.query).items()}
                # /storage/v1/b/{bucket}/o  or  .../o/{object}
                if parts[:2] == ["storage", "v1"] and parts[2] == "b":
                    bucket = urllib.parse.unquote(parts[3])
                    if len(parts) == 5 and parts[4] == "o":
                        prefix = q.get("prefix", "")
                        items = [
                            {"name": n, "size": str(len(d))}
                            for (b, n), d in sorted(outer.store.items())
                            if b == bucket and n.startswith(prefix)
                        ]
                        # exercise pagination: 2 items per page
                        start = int(q.get("pageToken", "0"))
                        page = items[start : start + 2]
                        body = {"items": page}
                        if start + 2 < len(items):
                            body["nextPageToken"] = str(start + 2)
                        return self._json(200, body)
                    if len(parts) == 6:
                        name = urllib.parse.unquote(parts[5])
                        data = outer.store.get((bucket, name))
                        if data is None:
                            return self._json(404, {"error": "not found"})
                        self.send_response(200)
                        self.send_header("content-length", str(len(data)))
                        self.end_headers()
                        self.wfile.write(data)
                        return
                self._json(404, {"error": "bad path"})

            def do_POST(self):
                if not self._auth_ok():
                    return self._json(401, {"error": "unauthorized"})
                parsed = urllib.parse.urlparse(self.path)
                parts = parsed.path.strip("/").split("/")
                q = {k: v[-1] for k, v in
                     urllib.parse.parse_qs(parsed.query).items()}
                # /upload/storage/v1/b/{bucket}/o?uploadType=media&name=..
                if parts[:1] == ["upload"]:
                    bucket = urllib.parse.unquote(parts[4])
                    name = q["name"]
                    n = int(self.headers.get("content-length") or 0)
                    outer.store[(bucket, name)] = self.rfile.read(n)
                    return self._json(200, {"name": name, "bucket": bucket})
                self._json(404, {"error": "bad path"})

            def do_DELETE(self):
                if not self._auth_ok():
                    return self._json(401, {"error": "unauthorized"})
                parts = urllib.parse.urlparse(self.path).path.strip("/").split("/")
                bucket = urllib.parse.unquote(parts[3])
                name = urllib.parse.unquote(parts[5])
                outer.store.pop((bucket, name), None)
                self._json(204, {})

        self.require_token = require_token
        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.endpoint = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture()
def srv(monkeypatch):
    """A fake server, with both packages' metadata URL on it and no token in
    the environment."""
    s = _FakeGCS()
    url = s.endpoint + "/computeMetadata/v1/instance/service-accounts/default/token"
    monkeypatch.setattr(pgcs, "METADATA_TOKEN_URL", url)
    monkeypatch.setattr(jgcs, "METADATA_TOKEN_URL", url)
    monkeypatch.delenv("GCS_TOKEN", raising=False)
    yield s
    s.stop()


class TestGCSClient:
    def test_put_list_get_delete_roundtrip(self, srv):
        c = GCSClient(endpoint=srv.endpoint)
        c.put_object("data", "a/x.txt", b"one")
        c.put_object("data", "a/y.txt", b"two")
        c.put_object("data", "b/z.txt", b"three")
        assert [o["name"] for o in c.list_objects("data", prefix="a/")] == ["a/x.txt", "a/y.txt"]
        assert c.get_object("data", "a/y.txt") == b"two"
        c.delete_object("data", "a/x.txt")
        assert [o["name"] for o in c.list_objects("data", prefix="a/")] == ["a/y.txt"]

    def test_pagination_exercised(self, srv):
        c = GCSClient(endpoint=srv.endpoint)
        for i in range(5):  # the fake serves 2 per page: 3 pages
            c.put_object("pg", f"k{i}", bytes([i]))
        assert [o["name"] for o in c.list_objects("pg")] == [f"k{i}" for i in range(5)]

    def test_bearer_token_sent_and_required(self, srv):
        srv.require_token = "sekrit"
        ok = GCSClient(endpoint=srv.endpoint, token="sekrit")
        ok.put_object("b", "k", b"v")
        assert ok.get_object("b", "k") == b"v"
        with pytest.raises(GCSError) as e:
            GCSClient(endpoint=srv.endpoint, token="wrong").get_object("b", "k")
        assert e.value.status == 401

    def test_missing_object_raises_with_status(self, srv):
        with pytest.raises(GCSError) as e:
            GCSClient(endpoint=srv.endpoint).get_object("nope", "missing")
        assert e.value.status == 404

    def test_token_from_the_environment(self, srv, monkeypatch):
        monkeypatch.setenv("GCS_TOKEN", "from-env")
        GCSClient(endpoint=srv.endpoint).put_object("b", "k", b"v")
        assert srv.requests[-1][3] == "Bearer from-env"

    def test_token_from_the_metadata_server(self, srv):
        """No token given or in the environment: the client asks the
        metadata server once, as a GPU VM's service account signs."""
        c = GCSClient(endpoint=srv.endpoint)
        c.put_object("b", "k", b"v")
        c.get_object("b", "k")
        assert [r[3] for r in srv.requests] == ["Bearer from-metadata"] * 2


class TestCloudBucketMountGCS:
    def test_pull_and_push_through_mount(self, srv):
        seed = GCSClient(endpoint=srv.endpoint)
        seed.put_object("datasets", "coco/train/0001.txt", b"imgdata")
        seed.put_object("datasets", "coco/train/0002.txt", b"imgdata2")
        seed.put_object("datasets", "other/x.txt", b"not ours")

        mount = mtpu.CloudBucketMount("datasets", key_prefix="coco", bucket_endpoint_url=srv.endpoint)
        assert mount.pull() == 2
        assert (mount.local_path / "train/0001.txt").read_bytes() == b"imgdata"

        (mount.local_path / "train/0003.txt").write_bytes(b"new")
        mount.push()
        assert seed.get_object("datasets", "coco/train/0003.txt") == b"new"

        ro = mtpu.CloudBucketMount("datasets", key_prefix="coco", bucket_endpoint_url=srv.endpoint, read_only=True)
        with pytest.raises(PermissionError):
            ro.push()

    def test_secret_token_wins(self, srv, monkeypatch):
        monkeypatch.setenv("GCS_TOKEN", "from-env")
        srv.require_token = "from-secret"
        secret = mtpu.Secret.from_dict({"GCS_TOKEN": "from-secret"})
        GCSClient(endpoint=srv.endpoint, token="from-secret").put_object("sec", "p/a.txt", b"a")
        mount = mtpu.CloudBucketMount("sec", key_prefix="p", bucket_endpoint_url=srv.endpoint, secret=secret)
        assert mount.pull() == 1
        assert {r[3] for r in srv.requests} == {"Bearer from-secret"}

    def test_sibling_prefix_and_escaping_names(self, srv, tmp_path):
        c = GCSClient(endpoint=srv.endpoint)
        c.put_object("b", "coco/a.txt", b"a")
        c.put_object("b", "coco2017/b.txt", b"not under coco/")
        assert sync_prefix_to_dir(c, "b", "coco", tmp_path / "m") == 1
        assert sorted(p.name for p in (tmp_path / "m").rglob("*")) == ["a.txt"]
        c.put_object("b", "coco/../../escape.txt", b"x")
        with pytest.raises(PermissionError, match="escapes"):
            sync_prefix_to_dir(c, "b", "coco", tmp_path / "m")


def _operations(pkg_gcs, mount_cls, endpoint: str, tmp_path, tag: str) -> None:
    """One fixed sequence of client and mount operations."""
    c = pkg_gcs.GCSClient(endpoint=endpoint, token="tok")
    c.put_object("ops", "run/x y.txt", b"1", content_type="text/plain")
    c.put_object("ops", "run/sub/z.bin", b"22")
    for i in range(3):
        c.put_object("ops", f"run/p{i}", bytes([i]))
    c.list_objects("ops", prefix="run/", max_results=2)
    c.get_object("ops", "run/x y.txt")
    c.delete_object("ops", "run/p0")
    try:
        c.get_object("ops", "missing/obj")
    except pkg_gcs.GCSError:
        pass
    src = tmp_path / f"push-{tag}"
    (src / "d").mkdir(parents=True)
    (src / "d" / "f.txt").write_bytes(b"f")
    pkg_gcs.sync_dir_to_prefix(c, src, "ops", "pushed")
    pkg_gcs.sync_prefix_to_dir(c, "ops", "run", tmp_path / f"pull-{tag}")
    mount = mount_cls("ops", key_prefix="pushed", bucket_endpoint_url=endpoint)
    mount.pull()


def test_same_operations_send_the_same_requests(tmp_path, monkeypatch):
    monkeypatch.setenv("GCS_TOKEN", "env-tok")  # the mounts' token
    port_srv, jax_srv = _FakeGCS(), _FakeGCS()
    try:
        _operations(pgcs, mtpu.CloudBucketMount, port_srv.endpoint, tmp_path, "port")
        _operations(jgcs, jm.CloudBucketMount, jax_srv.endpoint, tmp_path, "jax")
        assert port_srv.requests == jax_srv.requests
        assert port_srv.store == jax_srv.store
        assert len(port_srv.requests) >= 15
        assert {r[0] for r in port_srv.requests} == {"GET", "POST", "DELETE"}
    finally:
        port_srv.stop()
        jax_srv.stop()


def test_sync_helpers_count_objects(srv, tmp_path):
    c = GCSClient(endpoint=srv.endpoint, token="t")
    (tmp_path / "src" / "a").mkdir(parents=True)
    for name in ("a/1.txt", "a/2.txt", "3.txt"):
        (tmp_path / "src" / name).write_text(name)
    assert sync_dir_to_prefix(c, tmp_path / "src", "bk", "pre/") == 3
    assert sorted(n for (_, n) in srv.store) == ["pre/3.txt", "pre/a/1.txt", "pre/a/2.txt"]
    assert sync_prefix_to_dir(c, "bk", "pre", tmp_path / "dst") == 3
    assert (tmp_path / "dst" / "a" / "2.txt").read_text() == "a/2.txt"
