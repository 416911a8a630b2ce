"""Latency-injecting filesystem proxies: the object-store simulator.

Port of ``petastorm_tpu.io.latencyfs`` (pure Python over pyarrow; the same seed gives
the same delay for each request in both packages). Two layers:

- :class:`LatencyFS`: every ``read()`` call against a file pays one flat round-trip
  delay. Right for "how many read calls does this path issue" experiments.
- :class:`CloudLatencyFS`: the cloud-object-store simulator. Per-request latency is
  ``base + per_byte * nbytes + lognormal jitter``, with **seeded tail spikes** (a
  deterministic fraction of requests pays a multiplied delay: the store's fat tail that
  request hedging exists to cut) and **per-request accounting** (``requests`` records
  every GET's path, offset, bytes, delay and attempt), so a run can assert round-trip
  and footer-read counts as hard numbers, without credentials or a network.

Determinism: spike and jitter decisions are pure functions of ``(seed, path basename,
offset, nbytes, attempt)`` via crc32, so a scenario replays identically however threads
interleave, and a *hedged duplicate* of the same range (attempt 2) rolls fresh dice, as
a re-issued GET against another storage replica would.
"""
from __future__ import annotations

import math
import threading
import time
import zlib

#: one simulated GET: (path, offset, nbytes, delay_s, attempt)
_REQUEST_FIELDS = ("path", "offset", "nbytes", "delay_s", "attempt")


class LatencyFile:
    """File-object proxy paying one round-trip delay per ``read`` call —
    what a ranged GET against an object store costs. Wrapped back into a
    pyarrow file via ``pa.PythonFile`` by :meth:`LatencyFS.open_input_file`."""

    def __init__(self, inner, latency_s, counter):
        self._inner = inner
        self._latency_s = latency_s
        self._counter = counter

    def _delay(self, offset, nbytes):
        self._counter[0] += 1
        if self._latency_s > 0.0:
            time.sleep(self._latency_s)

    def read(self, nbytes=None):
        offset = self._inner.tell()
        data = self._inner.read(nbytes) if nbytes is not None else self._inner.read()
        self._delay(offset, len(data))
        return data

    def seek(self, pos, whence=0):
        return self._inner.seek(pos, whence)

    def tell(self):
        return self._inner.tell()

    def size(self):
        return self._inner.size()

    def close(self):
        self._inner.close()

    @property
    def closed(self):
        return self._inner.closed

    def readable(self):
        return True

    def seekable(self):
        return True

    def writable(self):
        return False


class LatencyFS:
    """pyarrow-filesystem proxy injecting per-read-call latency (a flat object-store
    emulation; also counts total read calls so the coalesce ratio is visible as a hard
    number)."""

    #: subclasses override to wrap reads with their own cost model
    _file_cls = LatencyFile

    def __init__(self, inner, latency_s):
        self._inner = inner
        self._latency_s = latency_s
        self.read_calls = [0]  # shared mutable cell: files outlive this scope

    def open_input_file(self, path):
        import pyarrow as pa

        inner = self._inner.open_input_file(path)
        return pa.PythonFile(
            self._make_file(inner, path), mode="r")

    def _make_file(self, inner, path):
        return self._file_cls(inner, self._latency_s, self.read_calls)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _hash01(*parts):
    """Deterministic uniform in [0, 1) from the identity of one request."""
    h = zlib.crc32("|".join(str(p) for p in parts).encode("utf-8"))
    return (h & 0xFFFFFF) / float(1 << 24)


class _CloudFile(LatencyFile):
    """Per-request cost model + accounting (built by :class:`CloudLatencyFS`)."""

    def __init__(self, inner, path, fs):
        super().__init__(inner, 0.0, fs.read_calls)
        self._path = path
        self._fs = fs

    def _delay(self, offset, nbytes):
        self._counter[0] += 1
        self._fs._account(self._path, offset, nbytes)


class CloudLatencyFS(LatencyFS):
    """Seeded cloud-object-store simulator over any pyarrow filesystem.

    ``base_latency_s`` is the same-region request floor (~5 ms for GCS/S3),
    ``per_byte_s`` the streaming cost (default ≈ 1 s/GB ≈ 8 Gbps),
    ``jitter_sigma`` the lognormal spread on the floor, and a ``tail_fraction``
    of requests pays ``tail_multiplier``× the floor — the fat tail. All
    randomness is a pure function of ``(seed, path, offset, nbytes, attempt)``
    where ``attempt`` counts repeat GETs of the identical range (a hedged
    duplicate is attempt 2 and rolls fresh dice).

    ``requests`` collects ``(path, offset, nbytes, delay_s, attempt)`` dicts;
    :meth:`request_count`/:meth:`footer_requests` turn them into the hard
    numbers a run asserts. ``type_name`` reports ``"cloudsim"`` so
    the auto-enable probe in :mod:`petastorm_tpu_torch.io.remote` treats this
    filesystem as a remote store.
    """

    type_name = "cloudsim"

    def __init__(self, inner, base_latency_s=0.005, per_byte_s=1.0 / (1 << 30),
                 jitter_sigma=0.15, tail_fraction=0.02, tail_multiplier=10.0,
                 seed=0, sleep=True):
        super().__init__(inner, 0.0)
        self._base = float(base_latency_s)
        self._per_byte = float(per_byte_s)
        self._sigma = float(jitter_sigma)
        self._tail_fraction = float(tail_fraction)
        self._tail_multiplier = float(tail_multiplier)
        self._seed = int(seed)
        self._sleep = bool(sleep)
        self._lock = threading.Lock()
        self._attempts = {}  # (path, offset, nbytes) -> GETs issued so far
        self.requests = []

    def __getstate__(self):
        # picklable for process pools: children re-create the lock and keep
        # their OWN accounting (per-process request logs, like the io counters)
        state = dict(self.__dict__)
        state["_lock"] = None
        state["_attempts"] = {}
        state["requests"] = []
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def _make_file(self, inner, path):
        return _CloudFile(inner, path, self)

    def delay_for(self, path, offset, nbytes, attempt):
        """The deterministic delay of one GET (public: tests assert on it).

        The dice roll on the path's BASENAME, not the full path: benches and
        tests write their datasets under per-run temp dirs, and a seed must
        mean the same spike pattern every run — otherwise every seeded
        assertion (hedges fire, p99 improves) is a latent CI flake."""
        name = path.rsplit("/", 1)[-1]
        u = _hash01(self._seed, name, offset, nbytes, attempt, "jitter")
        # inverse-transform a lognormal from the uniform (Box-Muller needs two;
        # a probit approximation is plenty for a latency floor's spread)
        z = _probit(min(max(u, 1e-9), 1.0 - 1e-9))
        delay = self._base * math.exp(self._sigma * z)
        if _hash01(self._seed, name, offset, nbytes, attempt,
                   "tail") < self._tail_fraction:
            delay *= self._tail_multiplier
        return delay + self._per_byte * nbytes

    def _account(self, path, offset, nbytes):
        key = (path, offset, nbytes)
        with self._lock:
            attempt = self._attempts.get(key, 0) + 1
            self._attempts[key] = attempt
        delay = self.delay_for(path, offset, nbytes, attempt)
        with self._lock:
            self.requests.append(dict(zip(
                _REQUEST_FIELDS, (path, offset, nbytes, delay, attempt))))
        if self._sleep and delay > 0.0:
            time.sleep(delay)

    # -- accounting views ---------------------------------------------------------------

    def request_count(self):
        with self._lock:
            return len(self.requests)

    def reset_accounting(self):
        with self._lock:
            self.requests = []
            self.read_calls[0] = 0

    def footer_requests(self, file_sizes, footer_window=1 << 16):
        """GETs that touched any file's footer region (its last
        ``footer_window`` bytes) — the metadata-plane round trips the footer
        cache exists to collapse. ``file_sizes`` maps path -> total bytes;
        ``footer_window`` is an int or a per-path dict (e.g. each file's
        exact footer length, so tail data GETs are never miscounted on small
        files)."""
        out = []
        with self._lock:
            reqs = list(self.requests)
        for r in reqs:
            size = file_sizes.get(r["path"])
            if size is None:
                continue
            window = footer_window.get(r["path"], 0) \
                if isinstance(footer_window, dict) else footer_window
            if r["offset"] + r["nbytes"] > max(0, size - window):
                out.append(r)
        return out


def _probit(u):
    """Acklam's inverse-normal-CDF approximation (no scipy dependency)."""
    # coefficients for the central region are enough at our precision needs
    a = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00)
    plow, phigh = 0.02425, 1 - 0.02425
    if u < plow:
        q = math.sqrt(-2 * math.log(u))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
            ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if u > phigh:
        q = math.sqrt(-2 * math.log(1 - u))
        return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
            ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    q = u - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
        (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
