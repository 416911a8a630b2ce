"""The object-store tier's options: :class:`RemoteIoOptions` and :func:`fs_is_remote`.

Port of the options half of ``petastorm_tpu.io.remote``. Two fields are live in the
port: ``footer_cache_bytes`` (the process-wide parsed-footer cache,
:mod:`petastorm_tpu_torch.io.footercache`) and ``disk_admit`` (the tiered funnel's disk
admission policy, :mod:`petastorm_tpu_torch.io.tiers`). The ranged-GET engine the other
fields configure (parallel GETs, hedging, footer GETs against the file's tail) is
ROADMAP.md Queue 1 item 5b: ``enabled=True``, or any engine field set to anything but
its default, raises ``NotImplementedError`` naming that item. ``enabled=None`` (auto) on
an object store reads through the classic ``ParquetFile`` path, as the port did before
(a recorded divergence until item 5b).
"""
from __future__ import annotations

import os

from petastorm_tpu_torch._unported import not_ported

#: pyarrow filesystem type_names that are NOT object stores (the auto probe)
_LOCAL_TYPE_NAMES = frozenset({"local", "localfs", "mock", "subtree", "py::fsspec+file"})


def _env_int(name, default):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def _env_float(name, default):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_bool(name, default):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off")


def _env_tristate(name):
    raw = os.environ.get(name)
    if raw is None or raw == "" or raw.strip().lower() == "auto":
        return None
    return raw.strip().lower() not in ("0", "false", "no", "off")


def _env_str(name, default):
    raw = os.environ.get(name)
    return default if raw is None or raw == "" else raw.strip()


#: the ranged-GET engine's fields with their defaults: anything else raises (item 5b)
_ENGINE_DEFAULTS = {
    "target_request_bytes": 8 << 20, "max_inflight": 8, "min_gap_bytes": 512 << 10,
    "hedge": True, "hedge_quantile": 0.95, "hedge_min_s": 0.05, "hedge_min_samples": 20,
    "get_timeout_s": 300.0,
}


class RemoteIoOptions:
    """Knobs of the remote tier, riding on :class:`petastorm_tpu_torch.io.IoOptions`
    (``io_options=dict(remote=...)``). Same fields, defaults and env overrides as the
    JAX package's:

    ======================  ==============================  =====================
    field                   env var                         meaning
    ======================  ==============================  =====================
    enabled                 PTPU_REMOTE                     ``None`` (auto; reads
                                                            classically here);
                                                            True raises (item 5b)
    target_request_bytes    PTPU_REMOTE_TARGET_REQUEST_     engine (item 5b): 8 MB
                            BYTES
    max_inflight            PTPU_REMOTE_MAX_INFLIGHT        engine (item 5b): 8
    min_gap_bytes           PTPU_REMOTE_MIN_GAP_BYTES       engine (item 5b): 512 KB;
                                                            also the byte gap the
                                                            row-group run planner
                                                            bridges on an object
                                                            store
    hedge                   PTPU_REMOTE_HEDGE               engine (item 5b): on
    hedge_quantile          PTPU_REMOTE_HEDGE_QUANTILE      engine (item 5b): 0.95
    hedge_min_s             PTPU_REMOTE_HEDGE_MIN_S         engine (item 5b): 0.05
    hedge_min_samples       PTPU_REMOTE_HEDGE_MIN_SAMPLES   engine (item 5b): 20
    get_timeout_s           PTPU_REMOTE_GET_TIMEOUT_S       engine (item 5b): 300
    footer_cache_bytes      PTPU_FOOTER_CACHE_BYTES         shared parsed-footer
                                                            budget (64 MB; 0 =
                                                            per-open re-reads)
    disk_admit              PTPU_TIER_DISK_ADMIT            ``always`` or
                                                            ``scan-resistant``
    ======================  ==============================  =====================
    """

    __slots__ = ("enabled", "target_request_bytes", "max_inflight",
                 "min_gap_bytes", "hedge", "hedge_quantile", "hedge_min_s",
                 "hedge_min_samples", "get_timeout_s", "footer_cache_bytes",
                 "disk_admit")

    def __init__(self, enabled=None, target_request_bytes=None, max_inflight=None,
                 min_gap_bytes=None, hedge=None, hedge_quantile=None,
                 hedge_min_s=None, hedge_min_samples=None, get_timeout_s=None,
                 footer_cache_bytes=None, disk_admit=None):
        self.enabled = _env_tristate("PTPU_REMOTE") if enabled is None \
            else (None if enabled == "auto" else bool(enabled))
        self.target_request_bytes = max(
            64 << 10, _env_int("PTPU_REMOTE_TARGET_REQUEST_BYTES", 8 << 20)
            if target_request_bytes is None else int(target_request_bytes))
        self.max_inflight = max(1, _env_int("PTPU_REMOTE_MAX_INFLIGHT", 8)
                                if max_inflight is None else int(max_inflight))
        self.min_gap_bytes = max(0, _env_int("PTPU_REMOTE_MIN_GAP_BYTES", 512 << 10)
                                 if min_gap_bytes is None else int(min_gap_bytes))
        self.hedge = _env_bool("PTPU_REMOTE_HEDGE", True) \
            if hedge is None else bool(hedge)
        self.hedge_quantile = min(0.999, max(0.5, _env_float(
            "PTPU_REMOTE_HEDGE_QUANTILE", 0.95) if hedge_quantile is None
            else float(hedge_quantile)))
        self.hedge_min_s = max(0.0, _env_float("PTPU_REMOTE_HEDGE_MIN_S", 0.05)
                               if hedge_min_s is None else float(hedge_min_s))
        self.hedge_min_samples = max(1, _env_int(
            "PTPU_REMOTE_HEDGE_MIN_SAMPLES", 20) if hedge_min_samples is None
            else int(hedge_min_samples))
        self.get_timeout_s = max(1.0, _env_float("PTPU_REMOTE_GET_TIMEOUT_S", 300.0)
                                 if get_timeout_s is None else float(get_timeout_s))
        self.footer_cache_bytes = max(0, _env_int(
            "PTPU_FOOTER_CACHE_BYTES", 64 << 20) if footer_cache_bytes is None
            else int(footer_cache_bytes))
        disk_admit = _env_str("PTPU_TIER_DISK_ADMIT", "always") \
            if disk_admit is None else str(disk_admit)
        if disk_admit not in ("always", "scan-resistant"):
            raise ValueError("disk_admit must be 'always' or 'scan-resistant', "
                             "got %r" % disk_admit)
        self.disk_admit = disk_admit
        self._reject_engine()

    def _reject_engine(self):
        """The engine is not ported: forcing it on, or tuning it, raises."""
        if self.enabled:
            raise not_ported("RemoteIoOptions(enabled=True)", "remote_arena")
        for name, default in _ENGINE_DEFAULTS.items():
            if getattr(self, name) != default:
                raise not_ported("RemoteIoOptions(%s=%r)" % (name, getattr(self, name)),
                                 "remote_arena")

    @classmethod
    def normalize(cls, value):
        """``None`` → defaults (env-aware), dict → kwargs, instance → itself."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError("remote io options must be a RemoteIoOptions, a dict of "
                        "its fields, or None; got %r" % type(value).__name__)

    def active_for(self, fs):
        """Would the JAX package's remote tier engage on ``fs``? Explicit ``enabled``
        wins; auto probes the pyarrow ``type_name`` (local stays off). In the port this
        only picks the row-group run planner's byte-gap bridging: reads stay classic."""
        if self.enabled is not None:
            return self.enabled
        return fs_is_remote(fs)

    def __getstate__(self):
        return {name: getattr(self, name) for name in self.__slots__}

    def __setstate__(self, state):
        for name in self.__slots__:
            setattr(self, name, state.get(name, getattr(type(self)(), name)))

    def __repr__(self):
        return "RemoteIoOptions(%s)" % ", ".join(
            "%s=%r" % (name, getattr(self, name)) for name in self.__slots__)


def fs_is_remote(fs):
    """Best-effort object-store probe: pyarrow filesystems expose ``type_name``
    ('local', 'gcs', 's3', 'hdfs', 'py::fsspec+gs', ...)."""
    try:
        type_name = getattr(fs, "type_name", None)
    except Exception:  # noqa: BLE001 - exotic proxies: assume local
        return False
    if not isinstance(type_name, str):
        return False
    return type_name.lower() not in _LOCAL_TYPE_NAMES
