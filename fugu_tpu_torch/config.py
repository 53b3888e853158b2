"""Config system: server/namespace/validation config + file/env loading.

Parity with upstream `src/db/config.rs:13-87` (shapes & defaults) and
upstream `src/main.rs:89-127` (probe list + env fallback):

- defaults: data_path ``./data``, default namespace ``default``, one
  startup namespace ``default``, writer budget 50MB, auto-create dirs on,
  validation {require_non_empty_id, max_text_length=1MB, validate_facet_paths}
- config file: YAML when the extension is .yaml/.yml, else JSON
- probe order: server_config.yaml, server_config.yml,
  config/server_config.yaml, config.yaml
- env fallback: FUGU_DATA_PATH (default ``./data``) and
  FUGU_DEFAULT_NAMESPACE (default ``fugu_db`` — main.rs:120-121)
- namespace-name validation: non-empty, none of ``/\\:*?"<>|``, no dups
  (config.rs:292-330)

Unlike the reference — where ``writer_memory_budget`` and
``max_text_length`` are carried but never read (SURVEY.md §5) — this
rebuild honors them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional

CONFIG_PROBE_PATHS = [
    "server_config.yaml",
    "server_config.yml",
    "config/server_config.yaml",
    "config.yaml",
]

ENV_DATA_PATH = "FUGU_DATA_PATH"
ENV_DEFAULT_NAMESPACE = "FUGU_DEFAULT_NAMESPACE"
#: multi-chip serving: number of mesh devices (0/unset = single-chip)
ENV_SHARD_DEVICES = "FUGU_SHARD_DEVICES"
#: multi-slice meshes: outer (DCN) axis size; devices must divide evenly
ENV_SHARD_SLICES = "FUGU_SHARD_SLICES"
#: cold-namespace spill tier: remote prefix (s3://bucket/prefix or a
#: file:///path for the filesystem backend); unset = spill disabled
ENV_SPILL_PREFIX = "FUGU_SPILL_PREFIX"
#: auto-spill namespaces idle longer than this many seconds (needs a
#: spill prefix); unset/0 = no idle-based auto-spill
ENV_SPILL_IDLE_TTL = "FUGU_SPILL_IDLE_TTL"
#: compaction mode of every index (background | sync | off); wins over
#: the configured value
ENV_COMPACTION = "FUGU_COMPACTION"

INVALID_NAMESPACE_CHARS = set('/\\:*?"<>|')


class ConfigError(ValueError):
    pass


def compaction_mode(configured: Optional[str]) -> str:
    """An index's compaction mode: FUGU_COMPACTION wins over the
    configured value (main.rs:118-121 pattern), default background."""
    mode = os.environ.get(ENV_COMPACTION) or configured or "background"
    if mode not in ("background", "sync", "off"):
        raise ValueError(f"unknown compaction mode: {mode!r}")
    return mode


def validate_namespace_name(name: str) -> None:
    """Reject namespace names that are unsafe as filesystem path segments.

    The reference validates config-declared names (config.rs:292-330) but
    its HTTP layer never creates/deletes namespaces; ours does (SURVEY.md
    §2d drift fix), so every name that reaches mkdir/rmtree must be a
    plain single path component: no separators, no traversal, no
    reserved characters, bounded length (object.rs:49-56 namespace rules).
    """
    if not name:
        raise ConfigError("Namespace name cannot be empty")
    if len(name) > 128:
        raise ConfigError("Namespace name cannot exceed 128 characters")
    bad = INVALID_NAMESPACE_CHARS & set(name)
    if bad:
        raise ConfigError(
            f"Invalid characters in namespace name: {name!r} ({sorted(bad)})"
        )
    if any(c.isspace() for c in name):
        raise ConfigError(f"Namespace name cannot contain whitespace: {name!r}")
    if name.startswith("."):
        raise ConfigError(f"Namespace name cannot start with '.': {name!r}")
    if any(ord(c) < 0x20 for c in name):
        raise ConfigError(f"Namespace name contains control characters: {name!r}")


@dataclasses.dataclass
class ValidationConfig:
    require_non_empty_id: bool = True
    max_text_length: Optional[int] = 1_000_000
    validate_facet_paths: bool = True

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ValidationConfig":
        return cls(
            require_non_empty_id=d.get("require_non_empty_id", True),
            max_text_length=d.get("max_text_length", 1_000_000),
            validate_facet_paths=d.get("validate_facet_paths", True),
        )


@dataclasses.dataclass
class NamespaceConfig:
    name: str
    data_path: Optional[str] = None
    initialize_on_startup: bool = True
    schema_overrides: Optional[Dict[str, List[str]]] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NamespaceConfig":
        if "name" not in d:
            raise ConfigError("namespace config requires a `name`")
        return cls(
            name=d["name"],
            data_path=d.get("data_path"),
            initialize_on_startup=d.get("initialize_on_startup", True),
            schema_overrides=d.get("schema_overrides"),
        )


@dataclasses.dataclass
class ServerConfig:
    data_path: str = "./data"
    default_namespace: str = "default"
    namespaces: List[NamespaceConfig] = dataclasses.field(
        default_factory=lambda: [NamespaceConfig(name="default")]
    )
    writer_memory_budget: Optional[int] = 50_000_000
    auto_create_directories: bool = True
    validation: ValidationConfig = dataclasses.field(default_factory=ValidationConfig)
    #: doc-range sharding over a device mesh (parallel/sharded.py);
    #: 0 = single-chip.  shard_slices > 1 builds a 2-D (DCN x ICI) mesh.
    shard_devices: int = 0
    shard_slices: int = 1
    #: compaction mode for every index: background (default) | sync | off
    #: (env FUGU_COMPACTION overrides)
    compaction: Optional[str] = None
    #: cold-namespace spill tier (storage/spill.py): remote prefix for
    #: segment offload; None disables the spill surface
    spill_prefix: Optional[str] = None
    #: idle seconds before a namespace auto-spills (requires a prefix)
    spill_idle_ttl_secs: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServerConfig":
        cfg = cls()
        if "data_path" in d:
            cfg.data_path = str(d["data_path"])
        if "default_namespace" in d:
            cfg.default_namespace = d["default_namespace"]
        if "namespaces" in d:
            cfg.namespaces = [NamespaceConfig.from_dict(n) for n in d["namespaces"]]
        if "auto_create_directories" in d:
            cfg.auto_create_directories = bool(d["auto_create_directories"])
        if "validation" in d and d["validation"] is not None:
            cfg.validation = ValidationConfig.from_dict(d["validation"])
        try:
            if "writer_memory_budget" in d and d["writer_memory_budget"]:
                # numeric like the fields below: a string budget would
                # otherwise TypeError at the first upsert, far from here
                cfg.writer_memory_budget = int(d["writer_memory_budget"])
            if "shard_devices" in d:
                cfg.shard_devices = int(d["shard_devices"] or 0)
            if "shard_slices" in d:
                cfg.shard_slices = max(int(d["shard_slices"] or 1), 1)
            if "spill_idle_ttl_secs" in d and d["spill_idle_ttl_secs"]:
                cfg.spill_idle_ttl_secs = float(d["spill_idle_ttl_secs"])
        except (TypeError, ValueError) as e:
            # keep the 'Failed to parse config' contract: a raw
            # ValueError would escape discover()'s except ConfigError
            raise ConfigError(f"Invalid numeric config value: {e}") from e
        if "compaction" in d and d["compaction"]:
            cfg.compaction = str(d["compaction"])
        if "spill_prefix" in d:
            cfg.spill_prefix = d["spill_prefix"] or None
        cfg._apply_shard_env()
        cfg.validate()
        return cfg

    def _apply_shard_env(self) -> None:
        """Env overrides win over file values (main.rs:118-121 pattern)."""
        env_dev = os.environ.get(ENV_SHARD_DEVICES)
        if env_dev is not None:
            try:
                self.shard_devices = int(env_dev)
            except ValueError:
                raise ConfigError(f"{ENV_SHARD_DEVICES} must be an int: {env_dev!r}")
        env_slices = os.environ.get(ENV_SHARD_SLICES)
        if env_slices is not None:
            try:
                self.shard_slices = max(int(env_slices), 1)
            except ValueError:
                raise ConfigError(f"{ENV_SHARD_SLICES} must be an int: {env_slices!r}")
        env_prefix = os.environ.get(ENV_SPILL_PREFIX)
        if env_prefix is not None:
            self.spill_prefix = env_prefix or None
        env_ttl = os.environ.get(ENV_SPILL_IDLE_TTL)
        if env_ttl is not None:
            try:
                self.spill_idle_ttl_secs = float(env_ttl) or None
            except ValueError:
                raise ConfigError(f"{ENV_SPILL_IDLE_TTL} must be a number: {env_ttl!r}")

    @classmethod
    def from_file(cls, path: str | Path) -> "ServerConfig":
        path = Path(path)
        try:
            content = path.read_text()
        except OSError as e:
            raise ConfigError(f"Failed to read config file {path}: {e}") from e
        if path.suffix in (".yaml", ".yml"):
            # imported here: only a YAML config needs PyYAML
            import yaml

            try:
                data = yaml.safe_load(content) or {}
            except yaml.YAMLError as e:
                raise ConfigError(f"Failed to parse YAML config: {e}") from e
        else:
            try:
                data = json.loads(content)
            except json.JSONDecodeError as e:
                raise ConfigError(f"Failed to parse JSON config: {e}") from e
        if not isinstance(data, dict):
            # a scalar/list top level parses fine but would TypeError in
            # from_dict — escaping discover()'s except-ConfigError
            # warn-and-continue contract and crashing startup
            raise ConfigError(
                f"Config file {path} must contain a mapping at the top "
                f"level, got {type(data).__name__}"
            )
        return cls.from_dict(data)

    @classmethod
    def with_defaults(cls, data_path: str, default_namespace: str) -> "ServerConfig":
        cfg = cls()
        cfg.data_path = data_path
        cfg.default_namespace = default_namespace
        cfg.namespaces = [NamespaceConfig(name=default_namespace)]
        cfg._apply_shard_env()
        return cfg

    @classmethod
    def discover(cls, cwd: str | Path = ".") -> "ServerConfig":
        """Probe the well-known file list, else env overrides, else defaults."""
        cwd = Path(cwd)
        for rel in CONFIG_PROBE_PATHS:
            p = cwd / rel
            if p.exists():
                try:
                    return cls.from_file(p)
                except ConfigError as e:
                    # a present-but-malformed config silently falling
                    # through to defaults would serve the wrong data
                    # directory with zero indication — say so loudly
                    import logging

                    logging.getLogger("fugu_tpu_torch").warning(
                        "config file %s rejected (%s); probing next "
                        "location / falling back to env+defaults",
                        p,
                        e,
                    )
                    continue
        data_path = os.environ.get(ENV_DATA_PATH, "./data")
        default_namespace = os.environ.get(ENV_DEFAULT_NAMESPACE, "fugu_db")
        return cls.with_defaults(data_path, default_namespace)

    def validate(self) -> None:
        """Namespace-name and path checks (config.rs:292-330)."""
        if not Path(self.data_path).exists() and not self.auto_create_directories:
            raise ConfigError(
                f"Data path {self.data_path!r} does not exist and "
                "auto_create_directories is false"
            )
        seen = set()
        for ns in self.namespaces:
            if not ns.name:
                raise ConfigError("Empty namespace name found in configuration")
            validate_namespace_name(ns.name)
        for ns in self.namespaces:
            if ns.name in seen:
                raise ConfigError(f"Duplicate namespace name: {ns.name}")
            seen.add(ns.name)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "data_path": self.data_path,
            "default_namespace": self.default_namespace,
            "namespaces": [dataclasses.asdict(n) for n in self.namespaces],
            "writer_memory_budget": self.writer_memory_budget,
            "auto_create_directories": self.auto_create_directories,
            "validation": dataclasses.asdict(self.validation),
            "shard_devices": self.shard_devices,
            "shard_slices": self.shard_slices,
            "compaction": self.compaction,
            "spill_prefix": self.spill_prefix,
            "spill_idle_ttl_secs": self.spill_idle_ttl_secs,
        }
