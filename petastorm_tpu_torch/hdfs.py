"""HDFS namenode HA: config-driven namenode resolution and a retry-on-failover client.

Port of ``petastorm_tpu.hdfs`` (the reference's ``petastorm/hdfs/namenode.py``:
``HdfsNamenodeResolver``, ``HAHdfsClient``, ``MaxFailoversExceeded``). A
high-availability nameservice lists several namenodes of which one is active; a flip
mid-epoch turns the standby's client into a brick. :class:`HAHdfsClient` wraps every
call of a ``pyarrow.fs.HadoopFileSystem`` with rotate-and-reconnect retry.

Layering with libhdfs: when the URL authority is a *nameservice id* and the Hadoop
config is visible to libhdfs, ``HadoopFileSystem('nameservice1')`` already fails over
internally. This wrapper adds the reference's guarantee where libhdfs does not cover it:
nameservices resolved from ``HADOOP_CONF_DIR`` XML when libhdfs itself is pointed
elsewhere, and flips that surface as connection errors between calls.
"""
from __future__ import annotations

import logging
import os
import threading
import xml.etree.ElementTree as ET

logger = logging.getLogger(__name__)

#: OSError subclasses that are real answers, not connection trouble: never a failover
from petastorm_tpu_torch.errors import PERMANENT_IO_ERRORS as _NON_RETRYABLE  # noqa: E402


class MaxFailoversExceeded(RuntimeError):
    """Every namenode was tried the configured number of times; all failed.

    Attributes mirror the reference (petastorm/hdfs/namenode.py ~L200):
    ``failed_exceptions`` (every error seen), ``max_failover_attempts``, ``func_name``.
    """

    def __init__(self, failed_exceptions, max_failover_attempts, func_name):
        self.failed_exceptions = list(failed_exceptions)
        self.max_failover_attempts = max_failover_attempts
        self.func_name = func_name
        last = self.failed_exceptions[-1] if self.failed_exceptions else None
        super().__init__(
            "Failover attempts exhausted (%d) calling %r; last error: %r"
            % (max_failover_attempts, func_name, last))
        self.__cause__ = last


def _hadoop_conf_dirs():
    """Candidate Hadoop config directories, reference discovery order
    (HADOOP_CONF_DIR, then <HADOOP_HOME|PREFIX|INSTALL>/etc/hadoop)."""
    dirs = []
    if os.environ.get("HADOOP_CONF_DIR"):
        dirs.append(os.environ["HADOOP_CONF_DIR"])
    for var in ("HADOOP_HOME", "HADOOP_PREFIX", "HADOOP_INSTALL"):
        root = os.environ.get(var)
        if root:
            dirs.append(os.path.join(root, "etc", "hadoop"))
    return dirs


def read_hadoop_config(conf_dir=None):
    """``{property-name: value}`` merged from ``core-site.xml`` + ``hdfs-site.xml``
    (hdfs-site wins on conflicts, matching Hadoop's own load order)."""
    props = {}
    dirs = [conf_dir] if conf_dir else _hadoop_conf_dirs()
    for d in dirs:
        found_any = False
        for fname in ("core-site.xml", "hdfs-site.xml"):
            path = os.path.join(d, fname)
            if not os.path.isfile(path):
                continue
            found_any = True
            try:
                root = ET.parse(path).getroot()
            except ET.ParseError as e:
                logger.warning("Unparseable Hadoop config %s: %s", path, e)
                continue
            for prop in root.iter("property"):
                name = prop.findtext("name")
                value = prop.findtext("value")
                if name is not None and value is not None:
                    props[name.strip()] = value.strip()
        if found_any:
            break  # first directory with config wins (reference behavior)
    return props


class HdfsNamenodeResolver:
    """Resolve nameservice ids → namenode ``(host, port)`` lists from Hadoop config
    (reference petastorm/hdfs/namenode.py ~L40)."""

    DEFAULT_PORT = 8020

    def __init__(self, config=None, conf_dir=None):
        self._config = dict(config) if config is not None \
            else read_hadoop_config(conf_dir)

    @property
    def nameservices(self):
        raw = self._config.get("dfs.nameservices", "")
        return [s.strip() for s in raw.split(",") if s.strip()]

    def resolve_hdfs_name_service(self, namespace):
        """Namenode ``[(host, port), ...]`` for a nameservice id, or None when the
        config does not define it (a plain hostname, not an HA nameservice)."""
        if namespace not in self.nameservices:
            return None
        nns = self._config.get("dfs.ha.namenodes.%s" % namespace, "")
        out = []
        for nn in (s.strip() for s in nns.split(",") if s.strip()):
            addr = self._config.get(
                "dfs.namenode.rpc-address.%s.%s" % (namespace, nn))
            if not addr:
                continue
            host, _, port = addr.partition(":")
            out.append((host, int(port) if port else self.DEFAULT_PORT))
        if not out:
            raise ValueError(
                "Nameservice %r is declared in dfs.nameservices but has no resolvable "
                "dfs.ha.namenodes / dfs.namenode.rpc-address entries" % namespace)
        return out

    def resolve_default_hdfs_service(self):
        """(nameservice, namenodes) for ``fs.defaultFS`` (reference ~L120)."""
        default = self._config.get("fs.defaultFS", "")
        if not default.startswith("hdfs://"):
            raise ValueError("fs.defaultFS is not an hdfs:// URL: %r" % default)
        from urllib.parse import urlparse

        host = urlparse(default).hostname
        nns = self.resolve_hdfs_name_service(host)
        if nns is None:
            port = urlparse(default).port or self.DEFAULT_PORT
            nns = [(host, port)]
        return host, nns


def _default_connect(host, port, storage_options=None):
    import pyarrow.fs as pafs

    return pafs.HadoopFileSystem(host, int(port), **(storage_options or {}))


class HAHdfsClient:
    """Failover proxy around ``pyarrow.fs.HadoopFileSystem`` (reference ``HAHdfsClient``
    petastorm/hdfs/namenode.py ~L200): every method call retries across the namenode
    list, reconnecting on connection/standby errors, until
    ``MAX_FAILOVER_ATTEMPTS`` full passes fail — then :class:`MaxFailoversExceeded`.

    Real answers (``FileNotFoundError`` etc.) propagate immediately — only
    connection-shaped ``OSError``/``RuntimeError`` rotate the namenode.
    """

    #: full passes over the namenode list before giving up (reference default)
    MAX_FAILOVER_ATTEMPTS = 2

    def __init__(self, namenodes, connect=None, storage_options=None):
        if not namenodes:
            raise ValueError("HAHdfsClient needs at least one namenode")
        # NOTE: attribute writes must go through __dict__ because __getattr__ proxies
        self.__dict__["_namenodes"] = [(h, int(p)) for h, p in namenodes]
        self.__dict__["_connect"] = connect or _default_connect
        self.__dict__["_storage_options"] = storage_options or {}
        self.__dict__["_index"] = 0
        self.__dict__["_fs"] = None
        #: readers share one client across worker threads — failover state needs a
        #: lock, and rotation is guarded by the connection the caller saw fail so a
        #: burst of simultaneous errors rotates ONCE, not once per thread (which
        #: would land back on the dead namenode and clobber healthy reconnects)
        self.__dict__["_lock"] = threading.RLock()

    # -- connection management ----------------------------------------------------------

    def _ensure_fs(self):
        with self._lock:
            if self._fs is None:
                host, port = self._namenodes[self._index]
                self.__dict__["_fs"] = self._connect(
                    host, port, storage_options=self._storage_options)
            return self._fs

    def _failover_from(self, failed_fs, exc):
        """Rotate namenodes — but only if ``failed_fs`` is still the active
        connection (another thread may already have rotated past it)."""
        with self._lock:
            if self._fs is not failed_fs:
                return  # someone else already failed over; retry on their connection
            old = self._namenodes[self._index]
            self.__dict__["_index"] = (self._index + 1) % len(self._namenodes)
            self.__dict__["_fs"] = None
            logger.warning("HDFS failover: %s:%d -> %s:%d after %r",
                           old[0], old[1], *self._namenodes[self._index], exc)

    # -- proxy --------------------------------------------------------------------------

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        # even the connect + attribute probe can hit a dead/standby namenode
        probe_errors = []
        attempts = self.MAX_FAILOVER_ATTEMPTS * len(self._namenodes)
        for _ in range(attempts):
            fs = None
            try:
                fs = self._ensure_fs()
                probe = getattr(fs, name)
                break
            except _NON_RETRYABLE:
                raise
            except AttributeError:
                raise
            except (OSError, RuntimeError) as e:
                probe_errors.append(e)
                self._failover_from(fs, e)
        else:
            raise MaxFailoversExceeded(probe_errors, attempts, name)
        if not callable(probe):
            return probe

        def call(*args, **kwargs):
            errors = []
            attempts = self.MAX_FAILOVER_ATTEMPTS * len(self._namenodes)
            for _ in range(attempts):
                fs = None
                try:
                    fs = self._ensure_fs()
                    return getattr(fs, name)(*args, **kwargs)
                except _NON_RETRYABLE:
                    raise
                except (OSError, RuntimeError) as e:
                    errors.append(e)
                    self._failover_from(fs, e)
            raise MaxFailoversExceeded(errors, attempts, name)

        call.__name__ = name
        return call

    def __repr__(self):
        return "HAHdfsClient(namenodes=%r, active=%d)" % (self._namenodes, self._index)


def connect_hdfs(hostname, port, storage_options=None, resolver=None, connect=None):
    """hdfs:// authority → filesystem, with HA when the config knows the authority.

    - authority is a configured *nameservice id* (no port) → :class:`HAHdfsClient`
      over its namenode list;
    - no authority (``hdfs:///path``) → the default nameservice from ``fs.defaultFS``
      when config is readable (HA client for multi-NN services), else libhdfs's
      ``'default'``;
    - explicit ``host:port`` → plain ``HadoopFileSystem`` (a single concrete namenode
      was requested; nothing to fail over to).
    """
    connect = connect or _default_connect
    if hostname and port:
        return connect(hostname, int(port), storage_options=storage_options)
    try:
        resolver = resolver or HdfsNamenodeResolver()
    except Exception:  # noqa: BLE001 — unreadable config: fall through to libhdfs
        resolver = None
    if resolver is not None:
        try:
            if hostname:
                nns = resolver.resolve_hdfs_name_service(hostname)
            else:
                _, nns = resolver.resolve_default_hdfs_service()
        except ValueError:
            nns = None
        if nns and len(nns) > 1:
            return HAHdfsClient(nns, connect=connect,
                                storage_options=storage_options)
        if nns and len(nns) == 1:
            return connect(nns[0][0], nns[0][1], storage_options=storage_options)
    # libhdfs handles 'default' / nameservice authorities from its own config
    return connect(hostname or "default", 0, storage_options=storage_options)
