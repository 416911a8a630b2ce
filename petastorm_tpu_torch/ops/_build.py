"""Build of the package's native code into ``petastorm_tpu_torch/_build/``.

Two libraries are built from the checkout's sources at first use: the host JPEG entropy
decoder (``ops/native/jpeg_decoder.cpp``, g++) and the CUDA kernels (``csrc/*.cu``,
nvcc for ``sm_90a``). Each is a shared library with a plain C interface, loaded with
ctypes. A hash of the sources and the compiler command keys the output file, and an
atomic rename publishes it, so concurrent builders (test workers, reader threads)
converge on one file and a changed source rebuilds.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
import time

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_ROOT, "_build")


def _tag(sources, commands):
    hasher = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            hasher.update(f.read())
    for cmd in commands:
        hasher.update(" ".join(cmd).encode("utf-8"))
    return hasher.hexdigest()[:16]


def build_shared_library(name, sources, compile_cmd, link_cmd=None, timeout=600,
                         headers=()):
    """Compile ``sources`` into ``_build/<name>-<hash>.so`` unless it exists; returns
    ``(path, log)`` where ``log`` holds the compilers' output (empty on a cache hit).
    ``headers`` are files the sources include: they key the output file too.

    ``compile_cmd(src, out)`` gives the command that compiles one source. Without
    ``link_cmd`` there must be one source and its command writes the library itself.
    With ``link_cmd(objects, out)``, every source compiles to an object at the same time
    (one process each, all started together) and the objects are linked once."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    probe_cmds = [compile_cmd("SRC", "OUT")]
    if link_cmd is not None:
        probe_cmds.append(link_cmd(["OBJ"], "OUT"))
    out_path = os.path.join(BUILD_DIR, "%s-%s.so" % (name, _tag([*sources, *headers],
                                                                 probe_cmds)))
    if os.path.exists(out_path):
        return out_path, ""
    workdir = tempfile.mkdtemp(prefix=name + "-", dir=BUILD_DIR)
    tmp_lib = os.path.join(workdir, name + ".so")
    log = []
    try:
        if link_cmd is None:
            if len(sources) != 1:
                raise ValueError("a build without a link step takes one source")
            _run([compile_cmd(sources[0], tmp_lib)], log, timeout)
        else:
            objects = [os.path.join(workdir, "%d.o" % i) for i in range(len(sources))]
            _run([compile_cmd(s, o) for s, o in zip(sources, objects)], log, timeout)
            _run([link_cmd(objects, tmp_lib)], log, timeout)
        os.replace(tmp_lib, out_path)  # atomic: concurrent builders converge on one file
    finally:
        for f in os.listdir(workdir):
            os.unlink(os.path.join(workdir, f))
        os.rmdir(workdir)
    return out_path, "\n".join(log)


def _run(commands, log, timeout):
    """Run ``commands`` in parallel; raise with the compiler output if any fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in commands]
    deadline = time.monotonic() + timeout
    failed = []
    try:
        for cmd, proc in zip(commands, procs):
            out, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            log.append("$ %s\n%s" % (" ".join(cmd), out))
            if proc.returncode != 0:
                failed.append("$ %s\n%s" % (" ".join(cmd), out))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("native build failed:\n" + "\n".join(failed))
