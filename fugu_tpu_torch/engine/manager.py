"""DatasetManager: namespace registry + config-driven initialization.

Parity with upstream `src/db/config.rs:90-331` and the
quick_setup/setup_from_config helpers (config.rs:366-384).  Extends the
reference with explicit create/delete namespace operations so the CLI's
``POST /namespaces`` / ``DELETE /namespaces/{ns}`` calls (which 404/405
against the reference server — SURVEY.md §2d drift) actually work.
"""

from __future__ import annotations

import shutil
import threading
from pathlib import Path
from typing import Dict, List, Optional

from fugu_tpu_torch.config import (
    ConfigError,
    NamespaceConfig,
    ServerConfig,
    validate_namespace_name,
)
from fugu_tpu_torch.engine.dataset import Dataset, DatasetStats


def _contained_ns_dir(base_path: Path, namespace: str) -> Path:
    """base_path/<namespace>, verified to stay inside base_path.

    Names are validated upstream, but mkdir/rmtree on request-supplied
    strings warrants a resolve-time containment assert too.
    """
    base = base_path.resolve()
    ns_dir = (base_path / namespace).resolve()
    if ns_dir == base or not ns_dir.is_relative_to(base):
        raise ConfigError(f"Namespace path escapes data root: {namespace!r}")
    return ns_dir


class NamespaceNotFoundError(KeyError):
    """Caller named a namespace that doesn't exist — the HTTP layer maps
    this to 404 (a 5xx would be alert noise for a typo'd namespace).
    Subclasses KeyError for pre-existing `except KeyError` callers."""

    def __str__(self) -> str:  # KeyError.__str__ adds quotes
        return self.args[0] if self.args else ""


class DatasetManager:
    def __init__(self, config: ServerConfig, use_device: bool = True,
                 device="cuda"):
        self.config = config
        self.use_device = use_device
        #: the device every namespace's indexes run on
        self.device = device
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        #: namespaces mid-deletion: creates wait (not fail) until the
        #: close+rmtree — which runs OUTSIDE the registry lock — finishes
        self._deleting: set = set()
        #: namespaces mid-creation: Dataset construction (three index
        #: opens, possibly multi-GB) runs outside the registry lock so
        #: it can't stall every other namespace; same-name callers wait
        self._creating: set = set()
        self.datasets: Dict[str, Dataset] = {}
        self._mesh = None
        if use_device and getattr(config, "shard_devices", 0):
            self._mesh = self._build_mesh(
                config.shard_devices, config.shard_slices, device
            )
        self._initialize_configured_namespaces()

    @staticmethod
    def _build_mesh(n_devices: int, n_slices: int = 1, device="cuda"):
        """The mesh of ``n_devices`` doc-range shards on ``device``'s
        kind (parallel/sharded.make_mesh: shard s on card s mod the
        cards there are, so one card may hold several shards).  Unlike
        the reference, which serves single-chip when its backend lacks
        the devices, a mesh can always be built: the config is honoured
        or the manager does not start."""
        from fugu_tpu_torch import device as device_mod
        from fugu_tpu_torch.parallel.sharded import make_mesh

        try:
            mesh = make_mesh(n_devices, n_slices=n_slices,
                             device=device_mod.resolve(device).type)
        except ValueError as e:  # e.g. shards not divisible by slices
            raise ConfigError(f"shard_devices={n_devices}, "
                              f"shard_slices={n_slices}: {e}") from e
        import logging

        logging.getLogger("fugu_tpu_torch").info(
            "serving over %d doc-range shards: %s", mesh.size, mesh)
        return mesh

    # -- constructors (config.rs:96-159) --------------------------------------

    @classmethod
    def from_config(cls, config: ServerConfig, **kw) -> "DatasetManager":
        return cls(config, **kw)

    @classmethod
    def from_config_file(cls, path: str | Path, **kw) -> "DatasetManager":
        return cls(ServerConfig.from_file(path), **kw)

    @classmethod
    def with_defaults(
        cls, data_path: str, default_namespace: str, **kw
    ) -> "DatasetManager":
        return cls(ServerConfig.with_defaults(data_path, default_namespace), **kw)

    @classmethod
    def quick_setup(cls, default_namespace: str, data_path: str, **kw) -> "DatasetManager":
        return cls.with_defaults(data_path, default_namespace, **kw)

    @classmethod
    def setup_from_config(cls, config_path: str | Path, **kw) -> "DatasetManager":
        return cls.from_config_file(config_path, **kw)

    @classmethod
    def discover(cls, cwd: str | Path = ".", **kw) -> "DatasetManager":
        """Config probe list -> env fallback -> defaults (main.rs:89-127)."""
        return cls(ServerConfig.discover(cwd), **kw)

    # -- namespace lifecycle --------------------------------------------------

    def _initialize_configured_namespaces(self) -> None:
        for ns_cfg in self.config.namespaces:
            if ns_cfg.initialize_on_startup:
                self._create(ns_cfg.name, ns_cfg)

    def _create(self, namespace: str, ns_cfg: Optional[NamespaceConfig]) -> Dataset:
        validate_namespace_name(namespace)
        base_path = Path(
            (ns_cfg.data_path if ns_cfg and ns_cfg.data_path else self.config.data_path)
        )
        if self.config.auto_create_directories:
            base_path.mkdir(parents=True, exist_ok=True)
        elif not base_path.exists():
            raise ConfigError(f"Data path {base_path} does not exist")
        _contained_ns_dir(base_path, namespace)
        ds = Dataset(
            namespace,
            base_path,
            writer_memory_budget=self.config.writer_memory_budget or 50_000_000,
            use_device=self.use_device,
            spill_prefix=getattr(self.config, "spill_prefix", None),
            compaction=getattr(self.config, "compaction", None),
            device=self.device,
        )
        ds.validate_all_schemas()
        if self._mesh is not None:
            # sharded serving reachable from config/env alone: searches
            # on the docs index route through the sharded engines
            ds.docs().enable_sharding(self._mesh)
        self.datasets[namespace] = ds
        return ds

    def get_dataset(self, namespace: str) -> Optional[Dataset]:
        return self.datasets.get(namespace)

    def _namespace_config(self, namespace: str) -> Optional[NamespaceConfig]:
        for ns_cfg in self.config.namespaces:
            if ns_cfg.name == namespace:
                return ns_cfg
        return None

    def get_or_create_dataset(self, namespace: str) -> Dataset:
        with self._lock:
            while namespace in self._deleting or namespace in self._creating:
                self._cv.wait()
            ds = self.datasets.get(namespace)
            if ds is not None:
                return ds
            self._creating.add(namespace)
        try:
            # honor the namespace's declared config (data_path etc.) even
            # for lazy creates — else a configured-but-not-startup
            # namespace opens at the default path and its existing index
            # is invisible.  Built OUTSIDE the lock: opening three
            # indexes can take seconds and must not stall the registry.
            ds = self._create(namespace, self._namespace_config(namespace))
        finally:
            with self._lock:
                self._creating.discard(namespace)
                self._cv.notify_all()
        return ds

    def default_dataset(self) -> Dataset:
        return self.get_or_create_dataset(self.config.default_namespace)

    def create_namespace(self, namespace: str) -> Dataset:
        return self.get_or_create_dataset(namespace)

    def delete_namespace(self, namespace: str, remove_files: bool = True) -> bool:
        with self._lock:
            ds = self.datasets.pop(namespace, None)
            if ds is None:
                return False
            self._deleting.add(namespace)
        try:
            # stop background compaction before the files go away — but
            # OUTSIDE the registry lock: joining an in-flight merge can
            # take tens of seconds and must not stall every other
            # namespace's create/lookup.  Concurrent creates of THIS name
            # wait on _deleting instead (so the fresh dataset's files are
            # never swept by this rmtree).
            ds.close()
            if remove_files:
                validate_namespace_name(namespace)
                ns_dir = _contained_ns_dir(ds.base_path, namespace)
                if ns_dir.exists():
                    self._delete_cold_objects(ns_dir)
                    shutil.rmtree(ns_dir)
        finally:
            with self._lock:
                self._deleting.discard(namespace)
                self._cv.notify_all()
        return True

    @staticmethod
    def _delete_cold_objects(ns_dir: Path) -> None:
        """Best-effort remote cleanup of spilled segments: the local
        ``.spilled`` markers about to be rmtree'd are the only pointers
        to the remote keys — without this, every spilled namespace
        deletion leaks its segments in the cold tier forever."""
        import logging

        from fugu_tpu_torch.storage.spill import SegmentSpiller

        for marker in ns_dir.glob("*/seg-*.spilled"):
            sid = marker.name[len("seg-") : -len(".spilled")]
            prefix = marker.read_text().strip()
            if not prefix:
                continue
            try:
                SegmentSpiller(prefix).delete_remote(sid)
            except Exception as e:
                logging.getLogger("fugu_tpu_torch").warning(
                    "remote cleanup of %s failed: %s", marker, e
                )

    def close(self) -> None:
        """Shut down background workers for every dataset (graceful
        server shutdown; joins in-flight merges)."""
        for ds in list(self.datasets.values()):
            ds.close()

    def spill_idle(self, idle_ttl_secs: Optional[float] = None) -> List[str]:
        """Offload namespaces idle longer than the TTL to the cold tier
        (requires a configured spill prefix).  Returns the spilled
        namespace names; the server's idle sweeper calls this
        periodically when ServerConfig.spill_idle_ttl_secs is set."""
        import time

        ttl = (
            idle_ttl_secs
            if idle_ttl_secs is not None  # explicit 0 = "spill all idle now"
            else getattr(self.config, "spill_idle_ttl_secs", None)
        )
        prefix = getattr(self.config, "spill_prefix", None)
        if ttl is None or not prefix:
            return []
        now = time.time()
        spilled = []
        for ns, ds in list(self.datasets.items()):
            if now - ds.last_access < ttl:
                continue
            if ds.has_cold_segments:
                continue  # already cold
            if not any(idx.segments for idx in ds.all_indexes()):
                continue  # nothing to offload
            try:
                ds.spill(prefix)
                spilled.append(ns)
            except Exception as e:
                import logging

                logging.getLogger("fugu_tpu_torch").warning(
                    "idle spill of %s failed: %s", ns, e
                )
        return spilled

    # -- introspection --------------------------------------------------------

    def list_namespaces(self) -> List[str]:
        return sorted(self.datasets.keys())

    def get_available_namespaces(self) -> List[str]:
        return sorted(self.datasets.keys())

    def get_namespace_facets(self, namespace: str, facet_root: str):
        ds = self.get_dataset(namespace)
        if ds is None:
            raise NamespaceNotFoundError(
                f"Dataset not found for namespace: {namespace}"
            )
        return ds.get_facets_at(facet_root)

    def get_filter_values_at_path(self, filter_path: str) -> List[str]:
        """Route a filter path to its namespace's dataset (config.rs:258-273)."""
        if filter_path.startswith("/namespace/"):
            namespace = filter_path[len("/namespace/") :].split("/")[0]
        else:
            namespace = self.config.default_namespace
        ds = self.get_dataset(namespace)
        if ds is None:
            raise NamespaceNotFoundError(
                f"Dataset not found for namespace: {namespace}"
            )
        return ds.get_filter_values_at_path(filter_path)

    def get_all_stats(self) -> Dict[str, DatasetStats]:
        return {ns: ds.stats() for ns, ds in self.datasets.items()}

    def validate_config(self) -> None:
        self.config.validate()
