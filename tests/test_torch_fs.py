"""The port's reference-Petastorm ``fs_utils`` names against the JAX package's:
``get_dataset_path`` and the ``FilesystemResolver`` class, case for case with
``tests/test_fs.py``, each answer equal to the JAX package's on the same URL."""
from urllib.parse import urlparse

import pyarrow.fs as pafs
import pytest

from petastorm_tpu import fs as ref_fs
from petastorm_tpu_torch.fs import (FilesystemResolver, get_dataset_path,
                                    get_filesystem_and_path_or_paths)

URLS = ["file:///a/b", "/a/b", "s3://bucket/a/b", "gs://bucket/a/b/", "hdfs://nn/a/b",
        "hdfs:///a/b"]


def test_get_dataset_path():
    assert get_dataset_path(urlparse("file:///a/b")) == "/a/b"
    assert get_dataset_path(urlparse("s3://bucket/a/b")) == "bucket/a/b"
    assert get_dataset_path(urlparse("hdfs://nn/a/b")) == "/a/b"


@pytest.mark.parametrize("url", URLS)
def test_get_dataset_path_equals_the_jax_packages(url):
    assert get_dataset_path(urlparse(url)) == ref_fs.get_dataset_path(urlparse(url))


def test_filesystem_resolver_class_compat(tmp_path):
    """Reference public class surface: FilesystemResolver(url).filesystem() /
    get_dataset_path() / parsed_dataset_url()."""
    r = FilesystemResolver("file://" + str(tmp_path))
    assert r.get_dataset_path() == str(tmp_path)
    assert r.parsed_dataset_url().scheme == "file"
    info = r.filesystem().get_file_info(str(tmp_path))
    assert info.type == pafs.FileType.Directory


def test_filesystem_resolver_takes_the_reference_signature(tmp_path):
    """``hdfs_driver`` and ``user`` are taken (and unused) as in the JAX package; a
    user filesystem wins over the scheme, and the path is the JAX package's."""
    fs = pafs.LocalFileSystem()
    ours = FilesystemResolver("hdfs://ignored/data/ds", filesystem=fs,
                              hdfs_driver="libhdfs3", user="someone")
    theirs = ref_fs.FilesystemResolver("hdfs://ignored/data/ds", filesystem=fs,
                                       hdfs_driver="libhdfs3", user="someone")
    assert ours.filesystem() is fs
    assert ours.get_dataset_path() == theirs.get_dataset_path() == "/data/ds"
    assert ours.parsed_dataset_url() == theirs.parsed_dataset_url()


def test_mixed_scheme_urls_rejected():
    with pytest.raises(ValueError, match="share scheme"):
        get_filesystem_and_path_or_paths(["file:///a", "s3://b/c"])


def test_user_filesystem_passthrough():
    fs = pafs.LocalFileSystem()
    got_fs, path = get_filesystem_and_path_or_paths("hdfs://ignored/data/ds", filesystem=fs)
    assert got_fs is fs  # the user's filesystem wins; no constructor dispatch
    assert path == "/data/ds"
