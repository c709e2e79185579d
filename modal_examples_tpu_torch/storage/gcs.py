"""Copy of ``modal_examples_tpu/storage/gcs.py``: a GCS object-store client
over the JSON API, stdlib urllib only.

CloudBucketMount's backing store is a GCS bucket
(SURVEY.md §2.1: "CloudBucketMount ... GCS native"; the reference mounts
S3/GCS in 12_datasets/coco.py:26-29 and 10_integrations/
s3_bucket_mount.py). The google-cloud-storage SDK is not in this image and
the environment has zero egress, so this is a from-scratch client for the
`storage.googleapis.com` JSON/upload API surface the mount needs: list,
get, put, delete, with bearer-token auth.

Auth resolution (in order):
1. ``GCS_TOKEN`` env (a bearer token — e.g. from a mounted Secret);
2. the GCE metadata server (the credential path of a Compute Engine VM,
   a GPU VM as much as a TPU VM: each carries a service account);
3. anonymous (public buckets).

``endpoint`` is injectable so the client is fully testable against a local
fake GCS server (tests/test_gcs.py) — the same lever the official SDKs
expose for the fake-gcs-server emulator.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request

METADATA_TOKEN_URL = (
    "http://metadata.google.internal/computeMetadata/v1/instance/"
    "service-accounts/default/token"
)


class GCSError(RuntimeError):
    def __init__(self, status: int, message: str):
        self.status = status
        super().__init__(f"GCS {status}: {message}")


class GCSClient:
    """Minimal JSON-API client: list/get/put/delete objects."""

    def __init__(
        self,
        *,
        endpoint: str = "https://storage.googleapis.com",
        token: str | None = None,
        timeout: float = 60.0,
    ):
        import os

        self.endpoint = endpoint.rstrip("/")
        self.timeout = timeout
        self._token = token or os.environ.get("GCS_TOKEN")
        self._tried_metadata = False

    # -- auth ---------------------------------------------------------------

    def _metadata_token(self) -> str | None:
        """GCE metadata-server token (how a Compute Engine VM signs)."""
        req = urllib.request.Request(
            METADATA_TOKEN_URL, headers={"Metadata-Flavor": "Google"}
        )
        try:
            with urllib.request.urlopen(req, timeout=2) as r:
                return json.load(r).get("access_token")
        except Exception:
            return None

    def _headers(self) -> dict:
        if self._token is None and not self._tried_metadata:
            self._tried_metadata = True
            self._token = self._metadata_token()
        if self._token:
            return {"Authorization": f"Bearer {self._token}"}
        return {}

    def _request(
        self, method: str, url: str, data: bytes | None = None,
        headers: dict | None = None,
    ) -> bytes:
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={**self._headers(), **(headers or {})},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            raise GCSError(e.code, e.read().decode(errors="replace")) from e

    # -- object operations --------------------------------------------------

    def list_objects(
        self, bucket: str, prefix: str = "", max_results: int = 1000
    ) -> list[dict]:
        """All objects under a prefix (paginated)."""
        out: list[dict] = []
        page_token = None
        while True:
            params = {"prefix": prefix, "maxResults": str(max_results)}
            if page_token:
                params["pageToken"] = page_token
            url = (
                f"{self.endpoint}/storage/v1/b/{urllib.parse.quote(bucket)}/o"
                f"?{urllib.parse.urlencode(params)}"
            )
            body = json.loads(self._request("GET", url))
            out.extend(body.get("items", []))
            page_token = body.get("nextPageToken")
            if not page_token:
                return out

    def get_object(self, bucket: str, name: str) -> bytes:
        url = (
            f"{self.endpoint}/storage/v1/b/{urllib.parse.quote(bucket)}/o/"
            f"{urllib.parse.quote(name, safe='')}?alt=media"
        )
        return self._request("GET", url)

    def put_object(
        self, bucket: str, name: str, data: bytes,
        content_type: str = "application/octet-stream",
    ) -> dict:
        url = (
            f"{self.endpoint}/upload/storage/v1/b/"
            f"{urllib.parse.quote(bucket)}/o?uploadType=media&name="
            f"{urllib.parse.quote(name, safe='')}"
        )
        body = self._request(
            "POST", url, data=data, headers={"Content-Type": content_type}
        )
        return json.loads(body)

    def delete_object(self, bucket: str, name: str) -> None:
        url = (
            f"{self.endpoint}/storage/v1/b/{urllib.parse.quote(bucket)}/o/"
            f"{urllib.parse.quote(name, safe='')}"
        )
        self._request("DELETE", url)


def sync_prefix_to_dir(
    client: GCSClient, bucket: str, prefix: str, dest,
) -> int:
    """Materialize gs://bucket/prefix into a local directory (the mount's
    read path: examples read through the filesystem; datasets pull once).

    The prefix is matched at a '/' boundary (prefix 'coco' must not pull
    'coco2017/...'), and object names are contained to ``dest`` — a bucket
    object named 'a/../../etc/x' must never escape the mount directory
    (the same invariant Volume._resolve enforces for volume paths).
    """
    from pathlib import Path

    dest = Path(dest).resolve()
    want = prefix.rstrip("/") + "/" if prefix else ""
    n = 0
    for obj in client.list_objects(bucket, prefix):
        name = obj["name"]
        if want:
            if not name.startswith(want):
                continue  # sibling prefix ('coco2017' under prefix 'coco')
            rel = name[len(want):]
        else:
            rel = name
        if not rel or rel.endswith("/"):
            continue
        target = (dest / rel).resolve()
        if target != dest and dest not in target.parents:
            raise PermissionError(f"object name escapes the mount: {name!r}")
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_bytes(client.get_object(bucket, name))
        n += 1
    return n


def sync_dir_to_prefix(client: GCSClient, src, bucket: str, prefix: str) -> int:
    """Upload a local directory under gs://bucket/prefix (the write-back
    path for read-write mounts)."""
    from pathlib import Path

    src = Path(src)
    n = 0
    for p in sorted(src.rglob("*")):
        if not p.is_file():
            continue
        rel = p.relative_to(src).as_posix()
        name = f"{prefix.rstrip('/')}/{rel}" if prefix else rel
        client.put_object(bucket, name, p.read_bytes())
        n += 1
    return n
