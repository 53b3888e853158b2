"""Object-store spill tier: segment offload/restore for cold namespaces.

The reference ships this as dead code — upstream `src/s3/mod.rs` is
gated on a feature that is never declared (`src/lib.rs:14-15` vs
`Cargo.toml:10-12`) — but SURVEY.md §2a marks it first-class for the
rebuild (BASELINE config #5: "S3 segment spill for cold namespaces").
Parity pieces, reimplemented:

- ``S3Location`` {key, bucket, endpoint, region} <-> URL codec
  (s3/mod.rs:9-84): ``s3://bucket/key`` and endpoint-qualified HTTP URLs
- env-configured client: S3_ENDPOINT / S3_REGION / S3_FUGU_BUCKET /
  S3_ACCESS_KEY / S3_SECRET_KEY, defaulting to DigitalOcean Spaces sfo3
  (s3/mod.rs:101-135)
- ``RemoteLocation.fetch/upload`` over local + S3 (s3/mod.rs:161-230)
- disk cache at ``./cache/{data,mdata}`` with a hashed-content metadata
  record and a 30s TTL policy; local files bypass the cache
  (s3/mod.rs:232-357)

The S3 transport uses boto3 when importable; otherwise S3 locations
raise a clear error (this image has no boto3 and no egress) while the
filesystem backend — the part exercised in CI — is fully functional.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time
from pathlib import Path
from typing import List, Optional, Union

DEFAULT_ENDPOINT = "https://sfo3.digitaloceanspaces.com"
DEFAULT_REGION = "sfo3"
DEFAULT_BUCKET = "fugu"
CACHE_TTL_SECS = 30.0


def _durable_write(path: Path, data: bytes) -> None:
    """write + fsync(file) + fsync(dir): survives the metadata-first
    journal reorder that a following unlink would otherwise win."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.write(fd, data)
        os.fsync(fd)
    finally:
        os.close(fd)
    dfd = os.open(path.parent, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


@dataclasses.dataclass
class S3Location:
    key: str
    bucket: str = DEFAULT_BUCKET
    endpoint: str = DEFAULT_ENDPOINT
    region: str = DEFAULT_REGION

    def to_url(self) -> str:
        return f"s3://{self.bucket}/{self.key}"

    def to_http_url(self) -> str:
        host = self.endpoint.split("://", 1)[-1]
        return f"https://{self.bucket}.{host}/{self.key}"

    @classmethod
    def from_url(cls, url: str) -> "S3Location":
        if url.startswith("s3://"):
            rest = url[len("s3://") :]
            bucket, _, key = rest.partition("/")
            if not bucket or not key:
                raise ValueError(f"invalid s3 url: {url}")
            return cls(key=key, bucket=bucket)
        if url.startswith("http://") or url.startswith("https://"):
            scheme, _, rest = url.partition("://")
            host, _, key = rest.partition("/")
            bucket, _, endpoint_host = host.partition(".")
            if not key or not endpoint_host:
                raise ValueError(f"invalid s3 http url: {url}")
            return cls(
                key=key, bucket=bucket, endpoint=f"{scheme}://{endpoint_host}"
            )
        raise ValueError(f"not an s3 url: {url}")

    @classmethod
    def from_env(cls, key: str) -> "S3Location":
        return cls(
            key=key,
            bucket=os.environ.get("S3_FUGU_BUCKET", DEFAULT_BUCKET),
            endpoint=os.environ.get("S3_ENDPOINT", DEFAULT_ENDPOINT),
            region=os.environ.get("S3_REGION", DEFAULT_REGION),
        )


def make_s3_client():
    """boto3 client from env (s3/mod.rs:101-135); raises if unavailable."""
    try:
        import boto3
    except ImportError as e:  # pragma: no cover - boto3 absent in CI image
        raise RuntimeError(
            "S3 backend requires boto3, which is not installed; "
            "use FileSystemLocation or install boto3"
        ) from e

    return boto3.client(
        "s3",
        endpoint_url=os.environ.get("S3_ENDPOINT", DEFAULT_ENDPOINT),
        region_name=os.environ.get("S3_REGION", DEFAULT_REGION),
        aws_access_key_id=os.environ.get("S3_ACCESS_KEY"),
        aws_secret_access_key=os.environ.get("S3_SECRET_KEY"),
    )


@dataclasses.dataclass
class FileSystemLocation:
    path: str

    def fetch(self) -> bytes:
        return Path(self.path).read_bytes()

    def upload(self, data: bytes) -> None:
        p = Path(self.path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)

    def exists(self) -> bool:
        return Path(self.path).exists()


@dataclasses.dataclass
class _CacheMeta:
    """CacheMeta {hash, last_checked} (s3/mod.rs:232-259)."""

    hash: str
    last_checked: float


class CachePolicy:
    """TTL'd local disk cache under ./cache/{data,mdata}; local files use
    the NoCache path (s3/mod.rs:262-357)."""

    def __init__(self, root: Union[str, Path] = "./cache", ttl: float = CACHE_TTL_SECS):
        self.root = Path(root)
        self.ttl = ttl
        (self.root / "data").mkdir(parents=True, exist_ok=True)
        (self.root / "mdata").mkdir(parents=True, exist_ok=True)

    def _key(self, name: str) -> str:
        return hashlib.sha256(name.encode()).hexdigest()[:32]

    def get(self, name: str) -> Optional[bytes]:
        k = self._key(name)
        data_p = self.root / "data" / k
        meta_p = self.root / "mdata" / k
        if not data_p.exists() or not meta_p.exists():
            return None
        meta = _CacheMeta(**json.loads(meta_p.read_text()))
        if time.time() - meta.last_checked > self.ttl:
            return None  # stale; caller re-fetches and re-puts
        data = data_p.read_bytes()
        if hashlib.sha256(data).hexdigest() != meta.hash:
            return None
        return data

    def put(self, name: str, data: bytes) -> None:
        k = self._key(name)
        (self.root / "data" / k).write_bytes(data)
        meta = _CacheMeta(
            hash=hashlib.sha256(data).hexdigest(), last_checked=time.time()
        )
        (self.root / "mdata" / k).write_text(json.dumps(dataclasses.asdict(meta)))


class RemoteLocation:
    """Local-or-S3 file handle with fetch/upload (s3/mod.rs:161-230)."""

    def __init__(
        self,
        location: Union[S3Location, FileSystemLocation],
        cache: Optional[CachePolicy] = None,
    ):
        self.location = location
        # local files bypass the cache (NoCache policy, s3/mod.rs:340-357)
        self.cache = cache if isinstance(location, S3Location) else None

    @classmethod
    def from_url(cls, url: str, cache: Optional[CachePolicy] = None):
        # any http(s) URL is an endpoint-qualified S3 URL (bucket.host/key
        # — S3Location.from_url parses it); treating one as a filesystem
        # path would "spill" into a junk local directory and then delete
        # the real segment files believing they were offloaded
        if url.startswith(("s3://", "http://", "https://")):
            return cls(S3Location.from_url(url), cache)
        path = url[len("file://") :] if url.startswith("file://") else url
        return cls(FileSystemLocation(path), cache)

    def raw_fetch(self) -> bytes:
        if isinstance(self.location, FileSystemLocation):
            return self.location.fetch()
        if self.cache is not None:
            cached = self.cache.get(self.location.to_url())
            if cached is not None:
                return cached
        client = make_s3_client()
        try:
            resp = client.get_object(
                Bucket=self.location.bucket, Key=self.location.key
            )
        except FileNotFoundError:
            raise
        except Exception as e:  # boto3 raises ClientError, not FileNotFoundError
            code = ""
            response = getattr(e, "response", None)
            if isinstance(response, dict):
                code = str(response.get("Error", {}).get("Code", ""))
            if code in ("NoSuchKey", "NoSuchBucket", "404"):
                raise FileNotFoundError(self.location.to_url()) from e
            raise
        data = resp["Body"].read()
        if self.cache is not None:
            self.cache.put(self.location.to_url(), data)
        return data

    def raw_upload(self, data: bytes) -> None:
        if isinstance(self.location, FileSystemLocation):
            self.location.upload(data)
            return
        client = make_s3_client()
        client.put_object(
            Bucket=self.location.bucket, Key=self.location.key, Body=data
        )
        if self.cache is not None:
            self.cache.put(self.location.to_url(), data)

    def delete(self) -> None:
        """Remove the remote object (missing objects are a no-op — S3
        DeleteObject is idempotent and the filesystem path mirrors that)."""
        if isinstance(self.location, FileSystemLocation):
            p = Path(self.location.path)
            if p.exists():
                p.unlink()
            return
        client = make_s3_client()
        client.delete_object(
            Bucket=self.location.bucket, Key=self.location.key
        )


class SegmentSpiller:
    """Spill/restore whole index segments to a remote tier.

    Cold-namespace lifecycle: ``spill`` copies a committed segment's three
    files to the remote prefix and removes the local copies (the manifest
    keeps the segment id and a ``spilled`` marker); ``restore`` brings
    them back before the namespace serves queries again.  Crash safety:
    both directions copy before deleting.
    """

    # both store formats listed: msgpack is what new segments write,
    # .store.jsonl keeps pre-round-3 spilled segments restorable (spill
    # and restore both skip absent files)
    SUFFIXES = (".npz", ".store.msgpack", ".store.jsonl", ".tomb.npy")

    def __init__(self, remote_prefix: str, cache: Optional[CachePolicy] = None):
        self.remote_prefix = remote_prefix.rstrip("/")
        self.cache = cache

    def _remote(self, name: str) -> RemoteLocation:
        return RemoteLocation.from_url(
            f"{self.remote_prefix}/{name}", self.cache
        )

    def spill(self, index_dir: Union[str, Path], segment_id: str) -> List[str]:
        index_dir = Path(index_dir)
        uploaded = []
        for suffix in self.SUFFIXES:
            p = index_dir / f"seg-{segment_id}{suffix}"
            if p.exists():
                self._remote(p.name).raw_upload(p.read_bytes())
                uploaded.append(p.name)
        if not uploaded:
            # unknown segment id / double-spill after the files are gone:
            # a marker here would record a phantom cold segment that no
            # restore can ever clear
            return uploaded
        # the marker (the durable pointer to the remote copy) must exist
        # DURABLY before the local files go away: unlink is a journaled
        # metadata op that filesystems can persist ahead of buffered
        # marker data, so a bare write_text + power loss could leave
        # neither the files nor a readable marker.  fsync file + dir
        # first (same reorder manifest._atomic_write defends against).
        marker = index_dir / f"seg-{segment_id}.spilled"
        _durable_write(marker, self.remote_prefix.encode("utf-8"))
        for name in uploaded:  # delete only after all uploads succeeded
            (index_dir / name).unlink()
        return uploaded

    def restore(self, index_dir: Union[str, Path], segment_id: str) -> List[str]:
        index_dir = Path(index_dir)
        restored = []
        for suffix in self.SUFFIXES:
            name = f"seg-{segment_id}{suffix}"
            remote = self._remote(name)
            try:
                data = remote.raw_fetch()
            except FileNotFoundError:
                continue
            # durable BEFORE the marker unlink below: a crash could
            # persist the unlink but not buffered segment data,
            # leaving the segment neither local nor recorded as cold
            _durable_write(index_dir / name, data)
            restored.append(name)
        # the marker only comes off once the segment pack itself is back
        # — a failed fetch must leave the segment recorded as cold, not
        # half-restored with its remote pointer lost
        if f"seg-{segment_id}.npz" in restored:
            marker = index_dir / f"seg-{segment_id}.spilled"
            if marker.exists():
                marker.unlink()
        return restored

    def delete_remote(self, segment_id: str) -> List[str]:
        """Remove a spilled segment's remote objects (namespace deletion:
        the local ``.spilled`` marker is the only pointer to these keys,
        so the remote copies must go before the marker does or they leak
        in the cold tier forever)."""
        deleted = []
        for suffix in self.SUFFIXES:
            name = f"seg-{segment_id}{suffix}"
            try:
                self._remote(name).delete()
                deleted.append(name)
            except FileNotFoundError:
                pass
        return deleted

    def is_spilled(self, index_dir: Union[str, Path], segment_id: str) -> bool:
        return (Path(index_dir) / f"seg-{segment_id}.spilled").exists()
