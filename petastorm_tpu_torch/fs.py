"""URL → (pyarrow FileSystem, path) resolution.

Port of ``petastorm_tpu.fs``. :func:`get_filesystem_and_path_or_paths` resolves
``file://`` and bare paths, ``s3://`` and ``gs://`` through ``pyarrow.fs``, ``hdfs://`` through
:func:`petastorm_tpu_torch.hdfs.connect_hdfs` (a nameservice authority resolves through
the Hadoop config to the namenode failover client; ``hdfs:///path`` maps to
``fs.defaultFS``; an explicit ``host:port`` is a plain libhdfs connection), a
user-supplied ``filesystem``, and an fsspec bridge for other schemes.
:func:`get_dataset_path` and :class:`FilesystemResolver` are reference Petastorm's
``fs_utils`` names, which user code calls directly.
"""
from __future__ import annotations

from urllib.parse import urlparse


def get_filesystem_and_path_or_paths(url_or_urls, storage_options=None, filesystem=None):
    """Resolve a dataset URL (or list of URLs) to (pyarrow_filesystem, path_or_paths).

    All URLs in a list must share scheme+authority (reference behavior, fs_utils.py ~L200).
    """
    urls = url_or_urls if isinstance(url_or_urls, (list, tuple)) else [url_or_urls]
    if not urls:
        raise ValueError("Empty URL list")
    parsed = [urlparse(str(u)) for u in urls]
    scheme0, netloc0 = parsed[0].scheme, parsed[0].netloc
    for i, p in enumerate(parsed[1:], 1):
        if (p.scheme, p.netloc) != (scheme0, netloc0):
            raise ValueError(
                "All dataset URLs must share scheme and authority; got %r vs %r"
                % (urls[0], urls[i])
            )
    if filesystem is not None:
        paths = [_strip_scheme(p) for p in parsed]
    else:
        filesystem, paths = _resolve(parsed, urls, storage_options or {})
    result = paths if isinstance(url_or_urls, (list, tuple)) else paths[0]
    return filesystem, result


def get_dataset_path(parsed_url):
    """Path component of a parsed dataset URL (reference: fs_utils.get_dataset_path)."""
    if parsed_url.scheme in ("", "file"):
        return parsed_url.path
    return _strip_scheme(parsed_url)


class FilesystemResolver:
    """The reference resolver class (petastorm/fs_utils.py), which user code calls
    directly: ``FilesystemResolver(url).filesystem()``. New code should prefer
    :func:`get_filesystem_and_path_or_paths`.

    ``hdfs_driver`` and ``user`` are taken for signature compatibility; the driver is
    libhdfs only, as in :func:`petastorm_tpu_torch.hdfs.connect_hdfs`.
    """

    def __init__(self, dataset_url, storage_options=None, filesystem=None,
                 hdfs_driver=None, user=None):  # noqa: ARG002 — reference signature
        self._dataset_url = str(dataset_url)
        self._parsed = urlparse(self._dataset_url)
        self._filesystem, self._path = get_filesystem_and_path_or_paths(
            self._dataset_url, storage_options=storage_options, filesystem=filesystem)

    def filesystem(self):
        """The resolved ``pyarrow.fs`` filesystem."""
        return self._filesystem

    def get_dataset_path(self):
        """Filesystem-relative dataset path."""
        return self._path

    def parsed_dataset_url(self):
        """The ``urllib.parse`` result for the original URL."""
        return self._parsed


def _strip_scheme(parsed):
    if parsed.scheme in ("", "file"):
        return parsed.path
    # bucket-style schemes keep the authority as path prefix (s3/gs); hdfs does not
    if parsed.scheme in ("s3", "s3a", "s3n", "gs", "gcs"):
        return (parsed.netloc + parsed.path).rstrip("/")
    return parsed.path


def _resolve(parsed, urls, storage_options):
    import pyarrow.fs as pafs

    scheme = parsed[0].scheme
    if scheme in ("", "file"):
        return pafs.LocalFileSystem(), [p.path for p in parsed]
    if scheme in ("s3", "s3a", "s3n"):
        fs = pafs.S3FileSystem(**storage_options)
        return fs, [(p.netloc + p.path).rstrip("/") for p in parsed]
    if scheme in ("gs", "gcs"):
        fs = pafs.GcsFileSystem(**storage_options)
        return fs, [(p.netloc + p.path).rstrip("/") for p in parsed]
    if scheme == "hdfs":
        from petastorm_tpu_torch.hdfs import connect_hdfs

        fs = connect_hdfs(parsed[0].hostname, parsed[0].port,
                          storage_options=storage_options)
        return fs, [p.path for p in parsed]
    try:
        import fsspec

        fsspec_fs, _, fpaths = fsspec.get_fs_token_paths(urls, storage_options=storage_options)
        return pafs.PyFileSystem(pafs.FSSpecHandler(fsspec_fs)), list(fpaths)
    except Exception as e:  # noqa: BLE001 — any fsspec failure means: scheme unsupported
        raise ValueError("Unsupported URL scheme %r (%s)" % (scheme, e)) from e
