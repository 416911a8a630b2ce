"""The port's graftlint (``petastorm_tpu_torch.analysis``) held against the JAX package's
(``petastorm_tpu.analysis``) on the same inputs, and the port's own capture rules.

(a) Every corpus of the JAX analyzer's tests outside the GL-J family (concurrency,
whole-program, lifecycle, schema, observability, robustness, suppressions), kept here as
strings, goes through both ``analyze_source``s: the same ``(rule, line, col, severity)``
lists, the same suppressed counts, and the same messages and hints once
``petastorm_tpu`` is mapped to ``petastorm_tpu_torch``. (b) Both ``analyze_paths`` over the
whole ``petastorm_tpu/`` and ``petastorm_tpu_torch/`` trees, GL-J deselected on both sides:
the same findings, the same suppressed findings. (c) The CLI contract, for both ``main``s.
(d) GL-J001-J003 over ``torch.compile`` bodies and CUDA graph captures: the decorator,
decorator-call, partial and call forms, a ``torch.cuda.graph`` block and
``make_graphed_callables``, each naming the rule and line it expects.
"""
import json
import os
import re
import textwrap

import pytest

import petastorm_tpu.analysis as jax_analysis
import petastorm_tpu.analysis.cli as jax_cli
import petastorm_tpu.analysis.engine as jax_engine
import petastorm_tpu_torch.analysis as port_analysis
import petastorm_tpu_torch.analysis.cli as port_cli
import petastorm_tpu_torch.analysis.engine as port_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = {"jax": jax_cli, "torch": port_cli}


def _to_port(text):
    return re.sub(r"\bpetastorm_tpu([./])", r"petastorm_tpu_torch\1", text)


def _key(findings):
    return [(f.rule_id, f.line, f.col, f.severity) for f in findings]


def _text(findings):
    return [(f.path, f.message, f.fix_hint, f.code) for f in findings]


def _assert_same(ref, got):
    """Findings of the JAX analyzer (``ref``) and the port's (``got``) agree."""
    assert _key(got) == _key(ref)
    assert _text(got) == [(p, _to_port(m), _to_port(h), c) for p, m, h, c in _text(ref)]


def _both(src):
    src = textwrap.dedent(src)
    return (jax_analysis.analyze_source(src, path="fixture.py"),
            port_analysis.analyze_source(src, path="fixture.py"))


def _lint(src):
    return port_analysis.analyze_source(textwrap.dedent(src), path="fixture.py")


def _marked_lines(src, marker):
    return [i for i, line in enumerate(textwrap.dedent(src).splitlines(), start=1)
            if marker in line]


# -- (a) the JAX analyzer's corpora outside GL-J -----------------------------------------

CORPORA = {
    "c001_positive": """
    import threading

    class Executor:
        def __init__(self):
            self._lock = threading.Lock()
            self._active = 0

        def work(self):
            with self._lock:
                self._active += 1

        def reset_counters(self):
            self._active = 0  # BUG: unguarded write
""",
    "lock_discipline_clean_when_write_is_guarded": """
        import threading

        class Executor:
            def __init__(self):
                self._lock = threading.Lock()
                self._active = 0

            def work(self):
                with self._lock:
                    self._active += 1

            def reset_counters(self):
                with self._lock:
                    self._active = 0
    """,
    "lock_discipline_ignores_self_synchronizing_types": """
        import queue
        import threading

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()
                self._stop_event = threading.Event()
                self._n = 0

            def tick(self):
                with self._lock:
                    self._n += 1
                    if self._stop_event.is_set():
                        return

            def start(self):
                self._stop_event.clear()
    """,
    "lock_discipline_closure_runs_without_the_lock": """
        import threading

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()
                self._state = None

            def read(self):
                with self._lock:
                    return self._state

            def arm(self):
                with self._lock:
                    def cb():
                        self._state = "done"  # BUG: closure write
                    return cb
    """,
    "c002_positive": """
    import queue
    import threading

    class Pool:
        def __init__(self):
            self._results = queue.Queue()
            self._worker = threading.Thread(target=print, daemon=True)

        def stop(self):
            leftover = self._results.get()  # BUG: untimed get
            self._worker.join()  # BUG: untimed join
""",
    "blocking_teardown_clean_with_timeouts": """
        import queue
        import threading

        class Pool:
            def __init__(self):
                self._results = queue.Queue()
                self._worker = threading.Thread(target=print, daemon=True)

            def stop(self):
                try:
                    self._results.get_nowait()
                except queue.Empty:
                    pass
                self._worker.join(timeout=10)

            def consume(self):
                return self._results.get()  # not a teardown path: allowed
    """,
    "blocking_teardown_fires_on_explicit_blocking_get": """
        import queue

        class Pool:
            def __init__(self):
                self._results = queue.Queue()

            def stop(self):
                a = self._results.get(True)  # BUG: get(True)
                b = self._results.get(block=True)  # BUG: block=True
                c = self._results.get(True, 5)  # timeout given: fine
    """,
    "blocking_teardown_knows_queue_get_signature": """
        import queue
        import threading

        class Pool:
            def __init__(self):
                self._results = queue.Queue()
                self._worker = threading.Thread(target=print, daemon=True)

            def stop(self):
                a = self._results.get(5)  # BUG: block=5, no timeout
                b = self._results.get(True, 5)  # timed: fine
                self._worker.join(None)  # BUG: join(None)
                self._worker.join(5)  # timed: fine
    """,
    "blocking_teardown_fires_on_thread_list_join_loop": """
        import threading

        class Pool:
            def __init__(self):
                self._threads = []

            def start(self):
                for _ in range(4):
                    t = threading.Thread(target=print, daemon=True)
                    t.start()
                    self._threads.append(t)

            def join(self):
                for t in self._threads:
                    t.join()  # BUG: untimed loop join
    """,
    "c003_positive": """
    import threading

    def fire_and_forget():
        t = threading.Thread(target=print)  # BUG: no daemon, never joined
        t.start()
""",
    "thread_handling_not_fooled_by_substring_join": """
        import threading

        def sneaky(parts):
            fmt = ","
            t = threading.Thread(target=print)  # BUG: unjoined despite fmt.join
            t.start()
            return fmt.join(parts)
    """,
    "thread_handling_clean_with_daemon_or_join": """
        import threading

        def daemonized():
            t = threading.Thread(target=print, daemon=True)
            t.start()

        def joined():
            t = threading.Thread(target=print)
            t.start()
            t.join(timeout=5)
    """,
    "c004_positive": """
    def retune(reader):
        reader._io_options.readahead_depth = 8  # BUG: frozen config mutated
""",
    "options_mutation_fires_on_bare_opts_and_augassign": """
        def widen(opts):
            opts.max_inflight += 4
    """,
    "options_mutation_fires_on_nested_options_chain": """
        def hedge_off(reader):
            reader._io_options.remote.hedge = False
    """,
    "options_mutation_clean_inside_options_class_and_knobset": """
        class FancyOptions:
            def __init__(self, depth=3):
                self.depth = depth

            def normalize(self, opts):
                opts.depth = max(1, opts.depth)

        class KnobSet:
            def apply(self, name, value, opts):
                opts.depth = value  # the sanctioned seam
                return value

        def unrelated():
            box = Box()
            box.options_list = []   # target attr, not an options base
            opts = {}
            opts["depth"] = 8       # dict, not an attribute assignment
    """,
    "options_mutation_inline_disable": """
        def legacy(opts):
            opts.readahead = False  # graftlint: disable=GL-C004
    """,
    "l001_positive": """
    from petastorm_tpu_torch import make_reader

    def leak(url):
        reader = make_reader(url)  # BUG: never closed
        return list(reader)
""",
    "lifecycle_clean_forms": """
        from petastorm_tpu_torch import make_reader
        from petastorm_tpu_torch.loader import DataLoader

        def with_block(url):
            with make_reader(url) as reader:
                return list(reader)

        def try_finally(url):
            reader = make_reader(url)
            try:
                return list(reader)
            finally:
                reader.stop()

        def ownership_transfer(url):
            reader = make_reader(url)
            with DataLoader(reader, batch_size=8) as loader:
                return list(loader)

        def returned(url):
            return make_reader(url)

        def fixture_style(url):
            reader = make_reader(url)
            yield reader
            reader.stop()
    """,
    "lifecycle_allows_constructor_expected_to_raise": """
        import pytest

        from petastorm_tpu_torch import make_reader

        def test_bad_url():
            with pytest.raises(IOError):
                make_reader("file:///nope")
    """,
    "l001_shm_positive": """
    from multiprocessing import shared_memory

    def leak_segment(nbytes):
        seg = shared_memory.SharedMemory(create=True, size=nbytes)  # BUG: no unlink path
        seg.buf[:4] = b"data"
        return bytes(seg.buf[:4])
""",
    "lifecycle_shared_memory_clean_forms": """
        from multiprocessing import shared_memory

        from petastorm_tpu_torch.parallel.shm_ring import SlabRing

        def creator_try_finally(nbytes):
            seg = shared_memory.SharedMemory(create=True, size=nbytes)
            try:
                seg.buf[0] = 1
            finally:
                seg.close()
                seg.unlink()

        def attacher_unlink_only(name):
            seg = shared_memory.SharedMemory(name=name)
            try:
                return bytes(seg.buf[:4])
            finally:
                seg.unlink()

        def ring_owned_by_pool():
            ring = SlabRing(1024, 2)
            try:
                return ring.acquire()
            finally:
                ring.close()

        class Owner:
            def start(self):
                self._seg = shared_memory.SharedMemory(create=True, size=64)
    """,
    "l001_readahead_positive": """
    from petastorm_tpu_torch.io.readahead import ReadaheadPool

    def leak_io_threads(read_fn):
        pool = ReadaheadPool(read_fn)  # BUG: IO threads never shut down
        pool.schedule([])
""",
    "l001_memcache_positive": """
    from petastorm_tpu_torch.io.memcache import MemCache

    def pin_process_bytes():
        cache = MemCache(1 << 20)  # BUG: held bytes never released
        cache.get("k", lambda: [1, 2, 3])
""",
    "lifecycle_readahead_and_memcache_clean_forms": """
        from petastorm_tpu_torch.io.memcache import MemCache
        from petastorm_tpu_torch.io.readahead import ReadaheadPool

        def pool_try_finally(read_fn, reqs):
            pool = ReadaheadPool(read_fn)
            try:
                pool.schedule(reqs)
            finally:
                pool.shutdown()

        def memcache_cleared(fill):
            cache = MemCache(1 << 20)
            try:
                return cache.get("k", fill)
            finally:
                cache.clear()

        def owned_by_worker(read_fn):
            class Worker:
                pass
            w = Worker()
            w._readahead = ReadaheadPool(read_fn)  # attribute: lifetime escapes
            return w

        def layered_into_factory(inner):
            return MemCache(1 << 20, inner=inner)  # ownership moves to caller
    """,
    "l001_remote_engine_positive": """
    from petastorm_tpu_torch.io.remote import RemoteReadEngine

    def leak_get_pool(fs):
        engine = RemoteReadEngine(fs)  # BUG: GET threads never shut down
        return engine.stats()
""",
    "l001_footer_cache_positive": """
    from petastorm_tpu_torch.io.footercache import FooterCache

    def pin_footers(fs, paths):
        cache = FooterCache()  # BUG: parsed-footer bytes never released
        for p in paths:
            cache.get(fs, p)
""",
    "lifecycle_remote_tier_clean_forms": """
        from petastorm_tpu_torch.io.footercache import FooterCache
        from petastorm_tpu_torch.io.remote import RemoteReadEngine
        from petastorm_tpu_torch.io.tiers import TieredCache

        def engine_try_finally(fs, path):
            engine = RemoteReadEngine(fs)
            try:
                return engine.footer(path)
            finally:
                engine.shutdown()

        def cache_cleared(fs, path):
            cache = FooterCache()
            try:
                return cache.get(fs, path)
            finally:
                cache.clear()

        def funnel_handed_off(mem, disk):
            return TieredCache(mem=mem, disk=disk)  # ownership moves to caller

        def owned_by_worker(fs):
            class Worker:
                pass
            w = Worker()
            w._remote = RemoteReadEngine(fs)  # attribute: lifetime escapes
            return w
    """,
    "l001_lease_leak_positive": """
    from petastorm_tpu_torch.io.lease import Lease

    def leak_slab_hold(slab_cb, batch):
        lease = Lease(release_cb=slab_cb)  # BUG: never released
        batch.use()
""",
    "l001_lease_double_release_positive": """
    def free_twice(lease, work):
        work(lease)
        lease.release()
        work.finish()
        lease.release()  # BUG: double release
""",
    "lifecycle_lease_clean_forms": """
        from petastorm_tpu_torch.io.lease import Lease, LeasedBatch
        from petastorm_tpu_torch.io.staging import PinnedStagingPool

        def released_in_finally(slab_cb, work):
            lease = Lease(release_cb=slab_cb)
            try:
                work(lease)
            finally:
                lease.release()

        def handed_off(slab_cb, batch):
            return LeasedBatch(batch, [Lease(release_cb=slab_cb)])

        def retain_rebalances(lease, work):
            lease.retain()
            work(lease)
            lease.release()
            lease.release()  # balanced: the retain() granted a second release

        def rebind_resets(make_lease):
            lease = make_lease()
            lease.release()
            lease = make_lease()
            lease.release()  # a different lease: rebind resets tracking

        def tuple_rebind_resets(make_lease, make_two):
            lease = make_lease()
            lease.release()
            lease, other = make_two()
            lease.release()  # rebound inside a tuple target: still a new lease
            other.release()

        def staging_pool_closed():
            pool = PinnedStagingPool(1 << 20, num_slabs=2)
            try:
                return pool.stage({})
            finally:
                pool.close()
    """,
    "l001_arena_positive": """
    from petastorm_tpu_torch.io.arena import CacheArena

    def leak_shm_segments(nbytes):
        arena = CacheArena(budget_bytes=nbytes)  # BUG: segments never unlinked
        arena.put(("mc", "k"), b"warm")
""",
    "lifecycle_cache_arena_clean_forms": """
        from petastorm_tpu_torch.io.arena import ArenaSpec, CacheArena

        def creator_try_finally(nbytes):
            arena = CacheArena(budget_bytes=nbytes)
            try:
                arena.put(("mc", "k"), b"warm")
            finally:
                arena.close()

        def attacher_detaches(token):
            arena = CacheArena(spec=ArenaSpec(token))
            try:
                return arena.get(("mc", "k"))
            finally:
                arena.detach()

        def handed_to_cache(nbytes, make_cache):
            return make_cache(arena=CacheArena(budget_bytes=nbytes))

        class Owner:
            def start(self, nbytes):
                self._arena = CacheArena(budget_bytes=nbytes)
    """,
    "s001_positive": """
    import numpy as np

    from petastorm_tpu_torch import types as ptypes
    from petastorm_tpu_torch.codecs import (
        CompressedImageCodec,
        NdarrayCodec,
        ScalarCodec,
    )
    from petastorm_tpu_torch.unischema import UnischemaField

    OVERFLOW = UnischemaField("big", np.int64, (),
                              ScalarCodec(ptypes.IntegerType()), False)  # BUG: overflow
    OBJ_NPY = UnischemaField("obj", np.object_, (4,), NdarrayCodec(), False)  # BUG: object npy
    FLOAT_IMG = UnischemaField("img", np.float32, (8, 8, 3),
                               CompressedImageCodec("jpeg"), False)  # BUG: float image
    TENSOR_SCALAR = UnischemaField("mat", np.float32, (3, 3),
                                   ScalarCodec(ptypes.FloatType()), False)  # BUG: tensor scalar
    NARROWING = UnischemaField("loss", np.float64, (),
                               ScalarCodec(ptypes.FloatType()), False)  # BUG: narrowing
""",
    "schema_codec_contract_accepts_compatible_fields": """
        import numpy as np

        from petastorm_tpu_torch import types as ptypes
        from petastorm_tpu_torch.codecs import (
            CompressedImageCodec,
            CompressedNdarrayCodec,
            NdarrayCodec,
            ScalarCodec,
        )
        from petastorm_tpu_torch.unischema import UnischemaField

        OK = [
            UnischemaField("id", np.int64, (), ScalarCodec(ptypes.LongType()), False),
            # widening storage (uint8 fits int16) matches the reference schemas
            UnischemaField("u8", np.uint8, (), ScalarCodec(ptypes.ShortType()), False),
            UnischemaField("name", np.str_, (), ScalarCodec(ptypes.StringType()), False),
            UnischemaField("f", np.float32, (), ScalarCodec(ptypes.DoubleType()), False),
            UnischemaField("dec", np.object_, (),
                           ScalarCodec(ptypes.DecimalType(12, 9)), False),
            UnischemaField("image", np.uint8, (16, 16, 3),
                           CompressedImageCodec("png"), False),
            UnischemaField("matrix", np.float32, (8, 4), NdarrayCodec(), False),
            UnischemaField("mz", np.float32, (4, 4), CompressedNdarrayCodec(), False),
            UnischemaField("plain", np.int32, (), None, False),
        ]
    """,
    "s001_tabular_positive": """
    import numpy as np

    from petastorm_tpu_torch.ops.tabular import (
        Bucketize,
        FeaturePipeline,
        HashField,
        Normalize,
        Standardize,
    )
    from petastorm_tpu_torch.unischema import UnischemaField

    FIELDS = [
        UnischemaField("xb", np.float32, (), None, False),
        UnischemaField("z", np.int32, (), None, False),
    ]
    PIPE = FeaturePipeline([
        HashField("x", 100, dtype=np.float32),  # BUG: float hash dtype
        Bucketize("x", num_buckets=8, out="xb"),  # BUG: float out field
        Standardize("y", out="z"),  # BUG: int out field
        Normalize("w"),  # ok: no declared field named w
    ])
""",
    "schema_contract_accepts_compatible_declarative_ops": """
        import numpy as np

        from petastorm_tpu_torch.ops.tabular import (
            Bucketize,
            FeatureCross,
            FeaturePipeline,
            HashField,
            Normalize,
            VocabLookup,
        )
        from petastorm_tpu_torch.unischema import UnischemaField

        FIELDS = [
            UnischemaField("xb", np.int32, (), None, False),
            UnischemaField("xh", np.int64, (), None, False),
            UnischemaField("xn", np.float32, (), None, False),
            UnischemaField("xc", np.int64, (), None, False),
        ]
        PIPE = FeaturePipeline([
            Normalize("x", out="xn"),
            Bucketize("x", num_buckets=8, out="xb"),
            HashField("x", 100, out="xh"),
            VocabLookup("c", vocab=[1, 2, 3], out="xc", dtype=np.int64),
            FeatureCross(("a", "b"), 64, out="xc"),
        ])
    """,
    "o001_positive": """
    import time

    def measure(fn):
        t0 = time.time()
        fn()
        dt = time.time() - t0  # BUG: wall-clock duration
        return dt
""",
    "wall_clock_duration_direct_double_call_and_from_import": """
        from time import time as now

        def measure(fn):
            start = now()
            fn()
            return now() - start  # BUG: aliased wall clock
    """,
    "wall_clock_legitimate_uses_stay_clean": """
        import os
        import time

        def stamp():
            return {"ts": time.time()}  # timestamp: fine

        def deadline_loop():
            deadline = time.time() + 10  # deadline arithmetic: fine
            while time.time() < deadline:
                pass

        def orphan_age(path):
            return time.time() - os.path.getmtime(path)  # vs mtime: wall clock is right

        def measure(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0  # the monotonic clock: the fix
    """,
    "wall_clock_nested_function_is_its_own_scope": """
        import time

        def outer():
            t0 = time.time()

            def inner(other):
                return time.time() - other  # `other` is a parameter, not a sample

            return inner
    """,
    "o002_positive": """
    def teardown(conn):
        try:
            conn.close()
        except Exception:  # BUG: silent broad swallow
            pass
""",
    "silent_swallow_fires_on_bare_and_tuple_and_base": """
        def f(x):
            try:
                x()
            except:  # BUG: bare
                pass
            try:
                x()
            except (ValueError, Exception):  # BUG: tuple hides the broad catch
                pass
            try:
                x()
            except BaseException:  # BUG: broader still
                pass
    """,
    "silent_swallow_clean_cases": """
        import logging

        logger = logging.getLogger(__name__)

        def f(x):
            try:
                x()
            except OSError:
                pass  # narrow: an expected, specific error
            try:
                x()
            except Exception as e:
                logger.warning("x failed: %s", e)  # acts: logged
            try:
                x()
            except Exception:
                raise  # acts: re-raised
            try:
                x()
            except Exception:  # graftlint: disable=GL-O002 (interpreter teardown)
                pass
    """,
    "silent_swallow_degradation_log_route_is_clean": """
        def f(x):
            try:
                x()
            except Exception as e:
                from petastorm_tpu_torch.obs.log import degradation

                degradation("x_failed", "x failed (%s)", e)
    """,
    "r001_positive": """
    import queue
    import threading
    from multiprocessing.connection import Client

    class Pump:
        def __init__(self):
            self._results = queue.Queue()
            self._done = threading.Event()

        def run(self, address, authkey):
            t = threading.Thread(target=print)
            conn = Client(address, authkey=authkey)
            item = self._results.get()  # BUG: untimed queue get
            msg = conn.recv()  # BUG: unbounded Connection.recv
            t.join()  # BUG: untimed thread join
            self._done.wait()  # BUG: untimed event wait
            return item, msg
""",
    "unbounded_blocking_tracks_self_attrs_across_methods": """
        import queue

        class Pool:
            def __init__(self):
                self._q = queue.Queue()

            def drain(self):
                return self._q.get()  # BUG: untimed get
    """,
    "unbounded_blocking_clean_cases": """
        import queue
        import threading

        def ok(listener, mapping, parts):
            q = queue.Queue()
            e = threading.Event()
            t = threading.Thread(target=print)
            q.get(timeout=1.0)
            q.get(True, 2.0)
            q.get(False)
            q.get(block=False)
            t.join(5.0)
            t.join(timeout=5.0)
            e.wait(0.5)
            conn = listener.accept()
            while not conn.poll(0.2):
                pass
            msg = conn.recv()  # graftlint: disable=GL-R001 (poll above bounds it)
            mapping.get("key")
            return ", ".join(parts), msg
    """,
    "r002_positive": """
    import os

    def serve_cached(fpath):
        size = os.path.getsize(fpath)
        if size == 0:
            return None
        with open(fpath, "rb") as f:  # BUG: stat-then-open window
            return f.read()

    class Validator:
        def check(self, fs, path):
            st = os.stat(path)
            self._seen = st.st_size
            return fs.open_input_file(path)  # BUG: fs open after stat
""",
    "stat_then_open_clean_cases": """
        import os

        def open_then_validate(fpath):
            f = open(fpath, "rb")
            os.fstat(f.fileno())  # validation AFTER the open: no window
            return f

        def different_paths(a, b):
            os.path.getsize(a)
            return open(b, "rb")

        def stat_only(fpath):
            return os.stat(fpath).st_mtime_ns

        def computed(root, name):
            os.path.getsize(os.path.join(root, name))
            return open(os.path.join(root, name), "rb")

        def justified(fpath):
            size = os.path.getsize(fpath)
            f = open(fpath, "rb")  # graftlint: disable=GL-R002 (size re-checked against the handle below)
            assert os.fstat(f.fileno()).st_size == size
            return f
    """,
    "stat_then_open_scopes_are_per_function": """
        import os

        def validate(fpath):
            return os.path.getmtime(fpath)

        def load(fpath):
            return open(fpath, "rb").read()
    """,
    "r003_positive": """
    import socket

    class Link:
        def __init__(self, host, port):
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.connect((host, port))  # BUG: unbounded connect

        def read(self):
            return self._sock.recv(4096)  # BUG: unbounded recv

    def serve():
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        conn, _addr = srv.accept()  # BUG: unbounded accept
        return conn.recv(16)  # BUG: accepted socket, still unbounded
""",
    "unbounded_socket_clean_cases": """
        import socket

        def bounded_tick_loop(host, port):
            # settimeout anywhere on the chain bounds every blocking use
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.settimeout(0.05)
            sock.connect((host, port))
            return sock.recv(4096)

        def create_connection_timeout(host, port):
            # the stdlib applies the timeout to the returned socket
            sock = socket.create_connection((host, port), timeout=5.0)
            return sock.recv(4096)

        def accepted_then_bounded(srv):
            srv.settimeout(0.2)
            conn, _addr = srv.accept()
            conn.settimeout(0.2)
            return conn.recv(16)

        def untyped_receiver(thing):
            # receivers the tracker cannot type are left alone (GL-R001's
            # philosophy: no false-positive flood)
            return thing.recv(16)
    """,
    "settimeout_none_is_still_unbounded": """
        import socket

        def forever(host, port):
            sock = socket.create_connection((host, port), timeout=5.0)
            sock.settimeout(None)  # "block forever", spelled out
            return sock.recv(4096)  # BUG: unbounded again
    """,
    "r003_inline_disable_respected": """
        import socket

        def blocking_by_design(host, port):
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.connect((host, port))  # graftlint: disable=GL-R003 (bootstrap dial; parent kills us on teardown)
            return sock.recv(4096)  # graftlint: disable=GL-R003 (same: the recv IS this process's job)
    """,
    "inline_suppression_on_multiline_statement_trailing_line": """
        import numpy as np

        from petastorm_tpu_torch import types as ptypes
        from petastorm_tpu_torch.codecs import ScalarCodec
        from petastorm_tpu_torch.unischema import UnischemaField

        F = UnischemaField(
            "big", np.int64, (),
            ScalarCodec(ptypes.IntegerType()),
            False)  # graftlint: disable=GL-S001
    """,
    "o003_begin_positive": """
    from petastorm_tpu_torch.obs import provenance as _prov

    def work(items):
        for item in items:
            _prov.begin_item(item)  # BUG: no finally-guarded end_item
            process(item)
            _prov.end_item()
""",
    "o003_handle_positive": """
    from petastorm_tpu_torch.obs import provenance as _prov

    def region():
        handle = _prov.open_span("io.remote")  # BUG: close not in a finally
        fetch()
        handle.close()
""",
    "begin_item_with_finally_end_item_is_clean": """
        from petastorm_tpu_torch.obs import provenance as _prov

        def work(items):
            for item in items:
                if _prov.ACTIVE is not None:
                    _prov.begin_item(item)
                try:
                    process(item)
                finally:
                    if _prov.ACTIVE is not None:
                        _prov.end_item()
    """,
    "open_span_closed_in_finally_or_with_is_clean": """
        from petastorm_tpu_torch.obs import provenance as _prov

        def closed_in_finally():
            handle = _prov.open_span("wire.decode")
            try:
                decode()
            finally:
                handle.close()

        def opened_as_context(recorder):
            with recorder.open_span("reader.read"):
                read()
    """,
    "nested_function_finally_does_not_cover_outer_open": """
        from petastorm_tpu_torch.obs import provenance as _prov

        def outer(item):
            _prov.begin_item(item)  # BUG: the inner finally is not ours

            def inner():
                try:
                    pass
                finally:
                    _prov.end_item()

            return inner
    """,
    "o003_inline_disable_respected": """
        from petastorm_tpu_torch.obs import provenance as _prov

        def fire_and_forget(item):
            _prov.begin_item(item)  # graftlint: disable=GL-O003 (thread dies with the item)
    """,
    "o004_cond_positive": """
    import threading
    import time

    class Watcher:
        def __init__(self):
            self._stop = threading.Event()

        def _run(self):
            while not self._stop.is_set():
                poll_once()
                time.sleep(0.5)  # BUG: stop() cannot wake this
""",
    "o004_body_positive": """
    import time

    def controller(stop_event):
        while True:
            if stop_event.is_set():  # the Event IS in sight...
                break
            retune()
            time.sleep(1.0)  # BUG: ...but the sleep ignores it
""",
    "event_wait_loop_is_clean": """
        import threading

        class Watcher:
            def __init__(self):
                self._stop = threading.Event()

            def _run(self):
                while not self._stop.wait(0.5):
                    poll_once()
    """,
    "sleep_without_event_in_sight_is_clean": """
        import time

        def wait_for_file(path, deadline):
            while time.monotonic() < deadline:
                if exists(path):
                    return True
                time.sleep(0.05)
            return False
    """,
    "o004_inline_disable_respected": """
        import time

        def drain(stop_event):
            while not stop_event.is_set():
                time.sleep(0.01)  # graftlint: disable=GL-O004 (50ms slices notice disarm)
    """,
    "o005_fires_on_pid_label": """
        import os

        def register(reg):
            reg.counter("ptpu_worker_rows_total", worker=os.getpid())
    """,
    "o005_taint_survives_str_wrapping": """
        import os

        def register(reg):
            reg.counter("x_total", worker=str(os.getpid()))
    """,
    "o005_one_hop_assignment_tracked": """
        import os

        def register(reg):
            wid = os.getpid()
            reg.gauge("x_bytes", worker=wid)
    """,
    "o005_fires_on_fstring_uuid": """
        import uuid

        def register(reg):
            reg.counter("x_total", run=f"run-{uuid.uuid4()}")
    """,
    "o005_loop_over_unbounded_iterable_fires": """
        def register(reg, paths):
            for p in paths:
                reg.counter("x_total", path=p)
    """,
    "o005_allcaps_constant_loop_is_clean": """
        TIERS = ("ram", "local", "remote")

        def register(reg):
            for t in TIERS:
                reg.counter("x_total", tier=t)
            for cause in ("timeout", "poison"):
                reg.counter("y_total", cause=cause)
    """,
    "o005_plain_parameter_label_is_clean": """
        def charge(reg, label, key):
            reg.counter("ptpu_tenant_rows_total", tenant=label)
            reg.counter("x_total", kind=str(key), help="rows by kind")
    """,
    "o005_inline_disable_respected": """
        import os

        def register(reg):
            reg.counter("x_total", worker=os.getpid())  # graftlint: disable=GL-O005 (bounded pool)
    """,
    "o006_fires_on_wall_span_endpoints": """
        import time

        def timed_decode(rec, decode, item):
            t0 = time.time()
            cols = decode(item)
            t1 = time.time()
            rec.add_span("decode", t0, t1)
            return cols
    """,
    "o006_fires_on_direct_wall_call_argument": """
        import time

        def note(rec, epoch, ordinal):
            rec.add_item_span(epoch, ordinal, "svc.wire", time.time(),
                              time.time())
    """,
    "o006_fires_on_from_import_alias": """
        from time import time as now

        def stamp(rec):
            w0 = now()
            rec.batch_span("producer_cut", w0, now())
    """,
    "o006_fires_on_wall_perf_anchor": """
        import time

        def absorb(rec, blob, pid):
            rec.absorb_child(blob, pid, wall_anchor=time.time(),
                             perf_anchor=time.time())
    """,
    "o006_perf_counter_spans_are_clean": """
        import time

        def timed_decode(rec, decode, item):
            p0 = time.perf_counter()
            cols = decode(item)
            rec.add_span("decode", p0, time.perf_counter())
            rec.annotate("wall_ts", time.time())  # a timestamp, not a span
            return cols
    """,
    "o006_wall_anchor_keyword_is_clean": """
        import time

        class Recorder:
            def __init__(self):
                self._wall_origin = time.time()
                self._origin = time.perf_counter()

            def align(self, rec, blob, pid, anchor):
                rec.absorb_child(blob, pid, wall_anchor=anchor,
                                 perf_anchor=self._origin)
    """,
    "o006_inline_disable_respected": """
        import time

        def replay(rec, t0, t1):
            w = time.time()
            rec.add_span("replay", w, w + 1.0)  # graftlint: disable=GL-O006 (historical replay on wall axis)
    """,
    "c005_controller_deadlock": """
    import queue
    import threading

    _DONE = object()

    class WorkerPool:
        def __init__(self):
            self._active_lock = threading.Lock()
            self._results = queue.Queue(64)
            self._active = 0

        def _put(self, value):
            self._results.put(value)

        def task_done(self):
            with self._active_lock:
                self._active -= 1
                if self._active == 0:
                    self._put(_DONE)  # BUG: blocks under _active_lock
""",
    "c005_clean_on_fixed_shape": """
        import queue
        import threading

        _DONE = object()

        class WorkerPool:
            def __init__(self):
                self._active_lock = threading.Lock()
                self._results = queue.Queue(64)
                self._active = 0
                self._stop_event = threading.Event()

            def _put(self, value):
                while not self._stop_event.is_set():
                    try:
                        self._results.put(value, timeout=0.1)
                        return
                    except queue.Full:
                        continue

            def task_done(self):
                with self._active_lock:
                    self._active -= 1
                    last = self._active == 0
                if last:
                    self._put(_DONE)
    """,
    "c005_fires_on_direct_blocking_get_under_lock": """
        import queue
        import threading

        class Stage:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue()

            def next_item(self):
                with self._lock:
                    return self._q.get()  # BUG: untimed get under lock
    """,
    "c005_put_on_unbounded_queue_is_clean": """
        import queue
        import threading

        class Stage:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue()

            def post(self, v):
                with self._lock:
                    self._q.put(v)
    """,
    "c005_timed_blocking_call_under_lock_is_clean": """
        import queue
        import threading

        class Stage:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue(8)

            def post(self, v):
                with self._lock:
                    self._q.put(v, timeout=0.5)
    """,
    "c005_one_hop_through_module_function_fires": """
        import time
        import threading

        def _backoff():
            time.sleep(1.0)

        class Retry:
            def __init__(self):
                self._lock = threading.Lock()

            def attempt(self):
                with self._lock:
                    _backoff()  # BUG: sleeps while holding the lock
    """,
    "c005_condition_wait_holding_only_its_own_lock_is_clean": """
        import threading

        class Gate:
            def __init__(self):
                self._cond = threading.Condition()
                self._ready = False

            def wait_ready(self):
                with self._cond:
                    while not self._ready:
                        self._cond.wait()
    """,
    "c005_condition_wait_with_second_lock_held_fires": """
        import threading

        class Gate:
            def __init__(self):
                self._cond = threading.Condition()
                self._meta = threading.Lock()

            def bad_wait(self):
                with self._meta:
                    with self._cond:
                        self._cond.wait()  # BUG: _meta stays held across the wait
    """,
    "c005_closure_defined_under_lock_is_clean": """
        import queue
        import threading

        class Scheduler:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue(4)

            def schedule(self):
                with self._lock:
                    def later():
                        self._q.put(1)
                    return later
    """,
    "c005_inline_disable_respected": """
        import queue
        import threading

        class Stage:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue(8)

            def post(self, v):
                with self._lock:
                    self._q.put(v)  # graftlint: disable=GL-C005 (consumer drains lock-free)
    """,
    "abba": """
    import threading

    class Ledger:
        def __init__(self):
            self._accounts = threading.Lock()
            self._audit = threading.Lock()

        def credit(self):
            with self._accounts:
                with self._audit:  # WITNESS: accounts -> audit
                    pass

        def reconcile(self):
            with self._audit:
                with self._accounts:
                    pass
""",
    "c006_consistent_order_is_clean": """
        import threading

        class Ledger:
            def __init__(self):
                self._accounts = threading.Lock()
                self._audit = threading.Lock()

            def credit(self):
                with self._accounts:
                    with self._audit:
                        pass

            def reconcile(self):
                with self._accounts:
                    with self._audit:
                        pass
    """,
    "c006_one_hop_acquisition_contributes_order_edge": """
        import threading

        class Pool:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def _under_b(self):
                with self._b:
                    pass

            def forward(self):
                with self._a:  # WITNESS: a -> b via helper
                    self._under_b()

            def backward(self):
                with self._b:
                    with self._a:
                        pass
    """,
    "c006_ctor_passed_lock_unifies_identity_across_classes_1": """
        import threading

        from helper import Flusher

        class Cache:
            def __init__(self):
                self._slots = threading.Lock()
                self._meta = threading.Lock()
                self._flusher = Flusher(self._slots, self._meta)

            def evict(self):
                with self._meta:
                    with self._slots:
                        pass
    """,
    "c006_ctor_passed_lock_unifies_identity_across_classes_2": """
        class Flusher:
            def __init__(self, slots_lock, meta_lock):
                self._guard = slots_lock
                self._m = meta_lock

            def flush(self):
                with self._guard:
                    with self._m:
                        pass
    """,
    "c006_three_lock_cycle_reported_once": """
        import threading

        class Triad:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()
                self._c = threading.Lock()

            def ab(self):
                with self._a:
                    with self._b:
                        pass

            def bc(self):
                with self._b:
                    with self._c:
                        pass

            def ca(self):
                with self._c:
                    with self._a:
                        pass
    """,
    "project_phase_finding_round_trips_through_baseline": """
        import queue
        import threading

        class Stage:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue(8)

            def post(self, v):
                with self._lock:
                    self._q.put(v)
    """,
    "r001_untimed_future_result_fires": """
        from concurrent.futures import ThreadPoolExecutor

        def fetch(url):
            pool = ThreadPoolExecutor(4)
            fut = pool.submit(load, url)
            return fut.result()  # BUG: untimed result
    """,
    "r001_timed_future_result_is_clean": """
        from concurrent.futures import ThreadPoolExecutor

        def fetch(url):
            pool = ThreadPoolExecutor(4)
            fut = pool.submit(load, url)
            return fut.result(timeout=30.0)
    """,
    "r001_future_list_loop_variable_is_typed": """
        from concurrent.futures import ThreadPoolExecutor

        def fetch_all(urls):
            pool = ThreadPoolExecutor(4)
            futs = [pool.submit(load, u) for u in urls]
            out = []
            for f in futs:
                out.append(f.result())  # BUG: untimed result in loop
            return out
    """,
    "r001_future_list_comprehension_variable_is_typed": """
        from concurrent.futures import ThreadPoolExecutor

        def fetch_all(urls):
            pool = ThreadPoolExecutor(4)
            futs = [pool.submit(load, u) for u in urls]
            return [f.result() for f in futs]  # BUG: untimed result in comp
    """,
    "r001_untimed_futures_wait_fires_via_import_alias": """
        from concurrent import futures

        def drain(fs):
            futures.wait(fs)  # BUG: untimed wait
    """,
    "r001_bare_wait_without_futures_import_is_clean": """
        def drain(cond):
            cond.wait()
    """,
    "r001_timed_futures_wait_is_clean": """
        import concurrent.futures

        def drain(fs):
            concurrent.futures.wait(fs, timeout=10.0)
    """,
    "c002_untimed_future_result_on_teardown_fires": """
        from concurrent.futures import ThreadPoolExecutor

        class Flusher:
            def __init__(self):
                self._pool = ThreadPoolExecutor(2)
                self._flush_future = self._pool.submit(self._flush)

            def stop(self):
                self._flush_future.result()  # BUG: untimed result in stop()
    """,
    "c002_timed_future_result_on_teardown_is_clean": """
        from concurrent.futures import ThreadPoolExecutor

        class Flusher:
            def __init__(self):
                self._pool = ThreadPoolExecutor(2)
                self._futures = []
                self._futures.append(self._pool.submit(self._flush))

            def stop(self):
                for fut in self._futures:
                    fut.result(timeout=5.0)
    """,
}


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_both_analyzers_agree_on_corpus(name):
    (ref, ref_n), (got, got_n) = _both(CORPORA[name])
    _assert_same(ref, got)
    assert got_n == ref_n
    for line in _marked_lines(CORPORA[name], "BUG"):
        assert any(f.line <= line <= max(f.line, f.end_line) for f in got), (line, got)


@pytest.mark.parametrize("tree", ["corpus", "pair"])
def test_both_analyzers_agree_across_modules(tree, tmp_path):
    """The whole-program phase over a tree of modules: every corpus as its own module,
    and the constructor-passed lock split over two (a GL-C006 cycle that only the
    corpus-level lock index sees; alone, since other corpora define a ``Cache`` too)."""
    pair = {"owner.py": "c006_ctor_passed_lock_unifies_identity_across_classes_1",
            "helper.py": "c006_ctor_passed_lock_unifies_identity_across_classes_2"}
    if tree == "pair":
        files = {fn: CORPORA[name] for fn, name in pair.items()}
    else:
        files = {name + ".py": src for name, src in CORPORA.items()
                 if name not in pair.values()}
    for fn, src in files.items():
        (tmp_path / fn).write_text(textwrap.dedent(src))
    ref, ref_n = jax_analysis.analyze_paths([str(tmp_path)])
    got, got_n = port_analysis.analyze_paths([str(tmp_path)])
    _assert_same(ref, got)
    assert got_n == ref_n
    cycles = [f for f in got if f.rule_id == "GL-C006"]
    assert cycles
    if tree == "pair":
        assert "evict" in cycles[0].message and "flush" in cycles[0].message
    else:
        assert got_n > 0


# -- (b) the whole trees ---------------------------------------------------------------


def _recording_suppressions(engine, monkeypatch):
    """Record every finding the engine suppresses inline, so the comparison covers
    the suppressed findings themselves, not only their count."""
    seen = []
    real = engine._suppressed

    def recording(finding, per_line, per_file):
        hit = real(finding, per_line, per_file)
        if hit:
            seen.append(finding)
        return hit

    monkeypatch.setattr(engine, "_suppressed", recording)
    return seen


@pytest.mark.parametrize("tree", ["petastorm_tpu", "petastorm_tpu_torch"])
def test_both_analyzers_agree_on_whole_tree(tree, monkeypatch):
    path = os.path.join(ROOT, tree)
    runs = {}
    for name, pkg, engine in (("jax", jax_analysis, jax_engine),
                              ("torch", port_analysis, port_engine)):
        suppressed = _recording_suppressions(engine, monkeypatch)
        rules = [r for r in pkg.default_rules() if not r.rule_id.startswith("GL-J")]
        findings, n = pkg.analyze_paths([path], rules=rules)
        runs[name] = (findings, n, suppressed)
    _assert_same(runs["jax"][0], runs["torch"][0])
    assert runs["torch"][1] == runs["jax"][1] == len(runs["torch"][2]) > 0
    _assert_same(runs["jax"][2], runs["torch"][2])


# -- (c) the CLI contract, for both mains -----------------------------------------------


@pytest.fixture(params=sorted(CLIS))
def cli(request):
    return CLIS[request.param]


def _write(path, src):
    path.write_text(textwrap.dedent(src))
    return path


DIRTY = CORPORA["c001_positive"]
DIRTY_LINE = _marked_lines(DIRTY, "BUG")[0]


def test_cli_exit_codes(cli, tmp_path, monkeypatch, capsys):
    clean = _write(tmp_path / "clean.py", "x = 1\n")
    assert cli.main([str(clean), "--no-baseline"]) == 0
    dirty = _write(tmp_path / "dirty.py", DIRTY)
    assert cli.main([str(dirty), "--no-baseline"]) == 1
    assert "GL-C001" in capsys.readouterr().out
    assert cli.main([str(tmp_path / "no_such_dir"), "--no-baseline"]) == 2
    not_py = tmp_path / "data.txt"
    not_py.write_text("not python")
    assert cli.main([str(not_py), "--no-baseline"]) == 2
    assert cli.main([str(clean), "--no-baseline", "--select", "GL-X999"]) == 2

    def boom(*args, **kwargs):
        raise RuntimeError("internal analyzer crash")

    monkeypatch.setattr(cli, "analyze_paths", boom)
    assert cli.main([str(clean), "--no-baseline"]) == 2


def test_cli_github_format(cli, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _write(tmp_path / "dirty.py", DIRTY)
    _write(tmp_path / "swallow.py", CORPORA["o002_positive"])
    assert cli.main(["dirty.py", "swallow.py", "--no-baseline", "--format", "github"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("::error file=dirty.py,line=%d,col=" % DIRTY_LINE)
    assert ",title=GL-C001::" in lines[0]
    warnings = [ln for ln in lines if ln.startswith("::warning file=swallow.py,")]
    assert warnings and all(",title=GL-O002::" in ln for ln in warnings)
    assert re.fullmatch(r"\d+ findings, 0 baselined, 0 suppressed inline", lines[-1])
    _write(tmp_path / "clean.py", "x = 1\n")
    assert cli.main(["clean.py", "--no-baseline", "--format", "github"]) == 0
    assert capsys.readouterr().out.strip().splitlines() == [
        "0 findings, 0 baselined, 0 suppressed inline"]


def test_cli_json_format(cli, tmp_path, capsys):
    dirty = _write(tmp_path / "dirty.py", DIRTY)
    assert cli.main([str(dirty), "--no-baseline", "--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert sorted(payload) == ["baselined", "findings", "stale_baseline_entries",
                               "suppressed_inline"]
    assert [(f["rule"], f["line"]) for f in payload["findings"]] == [
        ("GL-C001", DIRTY_LINE)]
    assert payload["baselined"] == [] and payload["suppressed_inline"] == 0


def test_cli_write_baseline_round_trip(cli, tmp_path, capsys):
    dirty = _write(tmp_path / "dirty.py", DIRTY)
    bl_path = tmp_path / ".graftlint-baseline.json"
    assert cli.main([str(dirty), "--baseline", str(bl_path), "--write-baseline"]) == 0
    payload = json.loads(bl_path.read_text())
    assert [(e["rule"], e["path"], e["count"]) for e in payload["entries"]] == [
        ("GL-C001", "dirty.py", 1)]
    capsys.readouterr()
    assert cli.main([str(dirty), "--baseline", str(bl_path), "--show-baselined"]) == 0
    out = capsys.readouterr().out
    assert "baselined findings:" in out and "0 findings, 1 baselined" in out
    # the nearest baseline above the first path is found without --baseline
    assert cli.main([str(tmp_path)]) == 0
    assert cli.main([str(tmp_path), "--no-baseline"]) == 1
    dirty.write_text(dirty.read_text() + textwrap.dedent("""
        class Second:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0

            def add(self):
                with self._lock:
                    self._n += 1

            def reset(self):
                self._n = 0
    """))
    assert cli.main([str(dirty), "--baseline", str(bl_path)]) == 1


def test_cli_select_ignore_and_list_rules(cli, tmp_path, capsys):
    dirty = _write(tmp_path / "dirty.py", DIRTY)
    assert cli.main([str(dirty), "--no-baseline", "--select", "GL-L001"]) == 0
    assert cli.main([str(dirty), "--no-baseline", "--ignore", "GL-C001"]) == 0
    assert cli.main([str(dirty), "--no-baseline", "--select", "GL-C001"]) == 1
    deadlock = _write(tmp_path / "deadlock.py", CORPORA["c005_controller_deadlock"])
    assert cli.main([str(deadlock), "--no-baseline", "--select", "GL-C005"]) == 1
    assert cli.main([str(deadlock), "--no-baseline", "--ignore", "GL-C005"]) == 0
    capsys.readouterr()
    assert cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule_id in ("GL-C001", "GL-C002", "GL-C003", "GL-C004", "GL-C005", "GL-C006",
                    "GL-L001", "GL-J001", "GL-J002", "GL-J003", "GL-S001", "GL-O001",
                    "GL-O002", "GL-O003", "GL-O004", "GL-O005", "GL-O006", "GL-R001",
                    "GL-R002", "GL-R003"):
        assert rule_id in out


def test_clis_print_the_same(tmp_path, monkeypatch, capsys):
    """Both mains print the same text, json and github output over a tree of
    corpora (messages mapped to the port's modules), and list the same rules in
    the same order at the same severities."""
    monkeypatch.chdir(tmp_path)
    for name in ("c001_positive", "o002_positive", "c005_controller_deadlock",
                 "l001_positive", "s001_positive", "o006_inline_disable_respected"):
        _write(tmp_path / (name + ".py"), CORPORA[name])
    for fmt in ("text", "json", "github"):
        outs = {}
        for name, cli_mod in CLIS.items():
            rc = cli_mod.main([".", "--no-baseline", "--format", fmt])
            outs[name] = (rc, capsys.readouterr().out)
        assert outs["torch"] == (outs["jax"][0], _to_port(outs["jax"][1]))
        assert outs["torch"][0] == 1
    listed = {}
    for name, cli_mod in CLIS.items():
        cli_mod.main(["--list-rules"])
        listed[name] = [ln.split("  ")[:2] for ln in
                        capsys.readouterr().out.strip().splitlines()]
    assert listed["torch"] == listed["jax"]


def test_port_cli_defaults_to_the_port_package(monkeypatch):
    seen = {}

    def spy(paths, rules, project_rules=None):
        seen["paths"] = paths
        return [], 0

    monkeypatch.setattr(port_cli, "analyze_paths", spy)
    assert port_cli.main(["--no-baseline"]) == 0
    assert seen["paths"] == ["petastorm_tpu_torch"]


# the JAX analyzer's baseline tests, for both mains, on a GL-C001 corpus


def test_baseline_matches_by_code_not_line(cli, tmp_path):
    fixture = _write(tmp_path / "fixture.py", DIRTY)
    bl_path = tmp_path / ".graftlint-baseline.json"
    assert cli.main([str(fixture), "--baseline", str(bl_path), "--write-baseline"]) == 0
    assert cli.main([str(fixture), "--baseline", str(bl_path)]) == 0
    fixture.write_text("# shifted\n# shifted\n" + fixture.read_text())
    assert cli.main([str(fixture), "--baseline", str(bl_path)]) == 0


def test_write_baseline_on_subset_preserves_other_files(cli, tmp_path):
    a = _write(tmp_path / "a.py", DIRTY)
    b = _write(tmp_path / "b.py", CORPORA["o002_positive"])
    bl_path = tmp_path / ".graftlint-baseline.json"
    assert cli.main([str(a), str(b), "--baseline", str(bl_path), "--write-baseline"]) == 0
    assert cli.main([str(a), "--baseline", str(bl_path), "--write-baseline"]) == 0
    entries = json.loads(bl_path.read_text())["entries"]
    assert {e["path"] for e in entries} == {"a.py", "b.py"}
    assert cli.main([str(a), str(b), "--baseline", str(bl_path)]) == 0


def test_write_baseline_with_select_preserves_other_rules(cli, tmp_path):
    fixture = _write(tmp_path / "fixture.py", DIRTY)
    bl_path = tmp_path / ".graftlint-baseline.json"
    assert cli.main([str(fixture), "--baseline", str(bl_path), "--write-baseline"]) == 0
    assert cli.main([str(fixture), "--baseline", str(bl_path), "--select", "GL-L001",
                     "--write-baseline"]) == 0
    entries = json.loads(bl_path.read_text())["entries"]
    assert [e["rule"] for e in entries] == ["GL-C001"]
    assert cli.main([str(fixture), "--baseline", str(bl_path)]) == 0


def test_partially_fixed_baseline_entry_is_reported_stale(cli, tmp_path, capsys):
    twice = DIRTY + textwrap.indent(textwrap.dedent("""
        def reset_again(self):
            self._active = 0  # BUG: unguarded write
    """), "        ")
    fixture = _write(tmp_path / "fixture.py", twice)
    bl_path = tmp_path / ".graftlint-baseline.json"
    assert cli.main([str(fixture), "--baseline", str(bl_path), "--write-baseline"]) == 0
    assert json.loads(bl_path.read_text())["entries"][0]["count"] == 2
    _write(fixture, DIRTY)
    capsys.readouterr()
    assert cli.main([str(fixture), "--baseline", str(bl_path)]) == 0
    assert "stale" in capsys.readouterr().out


def test_parse_errors_are_never_baselined(cli, tmp_path):
    broken = tmp_path / "broken.py"
    broken.write_text("def broken(:\n    pass\n")
    bl_path = tmp_path / ".graftlint-baseline.json"
    assert cli.main([str(broken), "--baseline", str(bl_path), "--write-baseline"]) == 0
    assert json.loads(bl_path.read_text())["entries"] == []
    assert cli.main([str(broken), "--baseline", str(bl_path)]) == 1


def test_overlapping_paths_deduplicate(cli, tmp_path):
    fixture = _write(tmp_path / "fixture.py", DIRTY)
    bl_path = tmp_path / ".graftlint-baseline.json"
    assert cli.main([str(tmp_path), "--baseline", str(bl_path), "--write-baseline"]) == 0
    assert json.loads(bl_path.read_text())["entries"][0]["count"] == 1
    assert cli.main([str(tmp_path), str(fixture), "--baseline", str(bl_path)]) == 0


def test_project_phase_finding_round_trips_through_baseline(cli, tmp_path):
    stage = _write(tmp_path / "stage.py", CORPORA["c005_controller_deadlock"])
    bl_path = tmp_path / ".graftlint-baseline.json"
    assert cli.main([str(stage), "--no-baseline", "--select", "GL-C005"]) == 1
    assert cli.main([str(stage), "--baseline", str(bl_path), "--write-baseline"]) == 0
    assert "GL-C005" in {e["rule"] for e in json.loads(bl_path.read_text())["entries"]}
    assert cli.main([str(stage), "--baseline", str(bl_path)]) == 0


# -- (d) GL-J001-J003 over torch.compile bodies and CUDA graph captures ---------------------

#: every region form: the four torch.compile forms, a torch.cuda.graph block and a
#: function handed to make_graphed_callables
FORMS = ("decorator", "decorator_call", "partial", "call", "graph", "graphed")
FUNCTION_FORMS = tuple(f for f in FORMS if f != "graph")

_HEAD = """\
import functools
import logging
import os
import time

import numpy as np
import torch
"""


def _region(form, body, prelude="", params="x"):
    """Module source with ``body`` (dedented lines) inside a region of ``form``. In
    the capture block, ``x`` is a tensor bound inside the block."""
    pad = " " * (8 if form == "graph" else 4)
    lines = "\n".join(pad + ln if ln else ln
                      for ln in textwrap.dedent(body).strip("\n").splitlines())
    head = _HEAD + prelude + "\n\n"
    if form == "graph":
        return (head + "def capture(g, static_x):\n    with torch.cuda.graph(g):\n"
                "        x = static_x * 2\n" + lines + "\n    return x\n")
    fn = "def step(%s):\n%s\n    return x\n" % (params, lines)
    if form == "decorator":
        return head + "@torch.compile\n" + fn
    if form == "decorator_call":
        return head + '@torch.compile(mode="reduce-overhead", fullgraph=True)\n' + fn
    if form == "partial":
        return head + "@functools.partial(torch.compile, dynamic=False)\n" + fn
    if form == "call":
        return head + fn + "\n\ncompiled = torch.compile(step)\n"
    return head + fn + ("\n\ngraphed = torch.cuda.make_graphed_callables("
                        "step, (torch.zeros(4),))\n")


def _expect(src, rule_id, suppressed=0):
    """The port reports exactly ``rule_id`` at each HAZARD line, nothing else."""
    findings, n = _lint(src)
    assert [(f.rule_id, f.line) for f in findings] == [
        (rule_id, line) for line in _marked_lines(src, "HAZARD")]
    assert n == suppressed
    return findings


_READS = {
    "np": "y = np.asarray(x)  # HAZARD",
    "item": "y = x.sum().item()  # HAZARD",
    "tolist": "y = x.tolist()  # HAZARD",
    "cpu": "y = x.cpu()  # HAZARD",
    "numpy": "y = x.numpy()  # HAZARD",
    "synchronize": "torch.cuda.synchronize()  # HAZARD",
}


@pytest.mark.parametrize("read", sorted(_READS))
@pytest.mark.parametrize("form", FORMS)
def test_host_read_in_region_fires(form, read):
    f = _expect(_region(form, _READS[read]), "GL-J001")[0]
    assert ("capturing" in f.message) == (form in ("graph", "graphed"))


@pytest.mark.parametrize("form", FORMS)
def test_host_read_outside_region_and_dtype_metadata_inside_are_clean(form):
    prelude = textwrap.dedent("""
        def host_prep(x):
            return np.asarray(x).item(), x.cpu().numpy(), x.tolist()
    """)
    _expect(_region(form, """
        info = np.iinfo(np.int32)
        kind = np.dtype(np.float32)
        x = x * info.max
    """, prelude=prelude), None)


_BRANCHES = {
    "if": "if x.sum() > 0:  # HAZARD\n    x = x + 1",
    "while": "while x.max() > 1:  # HAZARD\n    x = x / 2",
    "ifexp": "x = x + 1 if x.mean() > 0 else x - 1  # HAZARD",
    "bare": "if x:  # HAZARD\n    x = -x",
}


@pytest.mark.parametrize("branch", sorted(_BRANCHES))
@pytest.mark.parametrize("form", FORMS)
def test_tensor_branch_fires(form, branch):
    f = _expect(_region(form, _BRANCHES[branch]), "GL-J002")[0]
    assert "`x`" in f.message


_STATIC_TESTS = ("x is None", "x is not None", "x.shape[0] > 2", "x.ndim == 3",
                 "x.dtype == torch.float16", "x.device.type == 'cuda'", "x.dim() == 2",
                 "x.numel() > 4", "x.size(0) > 1", "x.size()[1] == 3",
                 "isinstance(x, torch.Tensor)", "len(x) > 2")


@pytest.mark.parametrize("test", _STATIC_TESTS)
@pytest.mark.parametrize("form", FORMS)
def test_tensor_branch_static_forms_are_clean(form, test):
    _expect(_region(form, "if %s:\n    x = x + 1" % test), None)


@pytest.mark.parametrize("form", FUNCTION_FORMS)
def test_scalar_annotated_parameter_is_static(form):
    """A parameter annotated ``int``/``bool`` is a Python scalar dynamo specialises
    on (the counterpart of ``static_argnames``); the tensor argument still fires."""
    src = _region(form, """
        if n > 2 and flag:
            x = x[:n]
        if x.sum() > n:  # HAZARD
            x = x - 1
    """, params="x, n: int, flag: bool")
    _expect(src, "GL-J002")


@pytest.mark.parametrize("form", FORMS)
def test_tensor_branch_fires_on_method_call_receiver(form):
    _expect(_region(form, "if x.any():  # HAZARD\n    x = -x"), "GL-J002")


@pytest.mark.parametrize("wrap", ["torch.compile(step)",
                                  "torch.cuda.make_graphed_callables(step, (params, batch))"])
def test_call_form_on_a_local_def_is_recognized(wrap):
    src = textwrap.dedent("""
        import torch

        def build_step(params, batch):
            def step(params, batch):
                if batch:  # HAZARD
                    return params
                return params

            return %s
    """ % wrap)
    _expect(src, "GL-J002")


def test_a_name_bound_outside_the_capture_block_is_not_a_tensor():
    """In a ``torch.cuda.graph`` block GL-J002 reads the tensors the block binds; a
    flag from outside (a Python value fixed for the capture) branches statically."""
    _expect(textwrap.dedent("""
        import torch

        def capture(g, static_x, flag):
            with torch.cuda.graph(g):
                if flag:
                    y = static_x + 1
                else:
                    y = static_x - 1
                if y.sum() > 0:  # HAZARD
                    y = y * 2
            return y
    """), "GL-J002")


_IO = {
    "print": 'print("tracing", x)  # HAZARD',
    "open": 'open("trace.log", "a").close()  # HAZARD',
    "time": "t0 = time.time()  # HAZARD",
    "logging": 'logging.info("step")  # HAZARD',
    "os": 'os.makedirs("out", exist_ok=True)  # HAZARD',
}


@pytest.mark.parametrize("io", sorted(_IO))
@pytest.mark.parametrize("form", FORMS)
def test_host_io_in_region_fires(form, io):
    f = _expect(_region(form, _IO[io]), "GL-J003")[0]
    if form in ("graph", "graphed"):
        assert "runs once at capture, not on replay" in f.message
    assert "hoist the I/O out of the compiled or captured region" in f.fix_hint


@pytest.mark.parametrize("form", FORMS)
def test_os_path_and_io_outside_the_region_are_clean(form):
    prelude = 'print("at import")\nLOG = open(os.devnull, "w")\nLOG.close()'
    _expect(_region(form, "name = os.path.join('a', 'b')", prelude=prelude), None)


_ALIASES = {
    "import_as": ("import torch as th\n\n\n@th.compile\ndef step(x):\n"
                  "    return x.item()  # HAZARD\n"),
    "from_torch": ("from torch import compile as tc\n\n\n@tc\ndef step(x):\n"
                   "    return x.item()  # HAZARD\n"),
    "from_cuda_graph": ("from torch.cuda import graph\n\n\ndef capture(g, x):\n"
                        "    with graph(g):\n        y = x.item()  # HAZARD\n"
                        "    return y\n"),
    "from_cuda_graphed": ("from torch.cuda import make_graphed_callables\n\n\n"
                          "def step(x):\n    return x.item()  # HAZARD\n\n\n"
                          "graphed = make_graphed_callables(step, (None,))\n"),
    "import_cuda": ("from torch import cuda\n\n\ndef capture(g, x):\n"
                    "    with cuda.graph(g):\n        y = x.item()  # HAZARD\n"
                    "    return y\n"),
}


@pytest.mark.parametrize("alias", sorted(_ALIASES))
def test_import_aliases_resolve(alias):
    _expect(_ALIASES[alias], "GL-J001")


def test_jax_regions_are_not_the_ports():
    """The port's analyzer lints the port: a ``jax.jit`` body is no region of its
    (the JAX analyzer reports it)."""
    src = textwrap.dedent("""
        import jax
        import numpy as np

        @jax.jit
        def bad(x):
            return np.asarray(x) + 1
    """)
    (ref, _), (got, _) = _both(src)
    assert [f.rule_id for f in ref] == ["GL-J001"]
    assert got == []


def test_capture_inside_a_compiled_function_reports_once():
    findings = _expect(textwrap.dedent("""
        import torch

        @torch.compile
        def step(g, x):
            with torch.cuda.graph(g):
                y = x.item()  # HAZARD
            return y
    """), "GL-J001")
    assert "CUDA graph capture" in findings[0].message


# suppressions (the JAX analyzer's engine tests, in each region form)


@pytest.mark.parametrize("form", FORMS)
def test_inline_suppression_same_line(form):
    _expect(_region(form, 'print("trace marker")  # graftlint: disable=GL-J003'), None,
            suppressed=1)


@pytest.mark.parametrize("form", FORMS)
def test_file_level_suppression(form):
    src = "# graftlint: disable-file=GL-J003\n" + _region(form, """
        print("a", x)
        print("b", x)
    """)
    _expect(src, None, suppressed=2)


@pytest.mark.parametrize("form", FORMS)
def test_suppression_is_rule_specific(form):
    src = _region(form, "y = np.asarray(print(x))  # HAZARD  # graftlint: disable=GL-J003")
    _expect(src, "GL-J001", suppressed=1)


@pytest.mark.parametrize("form", FORMS)
def test_inline_suppression_on_multiline_statement_trailing_line(form):
    _expect(_region(form, """
        print(
            "a",
            x)  # graftlint: disable=GL-J003
    """), None, suppressed=1)


@pytest.mark.parametrize("form", FORMS)
def test_branch_suppression_must_sit_on_the_header(form):
    _expect(_region(form, """
        if x.sum() > 0:  # HAZARD
            x = x + 1  # graftlint: disable=GL-J002
    """), "GL-J002")
    _expect(_region(form, """
        if x.sum() > 0:  # graftlint: disable=GL-J002
            x = x + 1
    """), None, suppressed=1)


@pytest.mark.parametrize("form", FORMS)
def test_suppression_inside_string_literal_is_inert(form):
    prelude = 'FIXTURE = """\n# graftlint: disable-file=GL-J003\n"""'
    _expect(_region(form, 'print("boom", x)  # HAZARD', prelude=prelude), "GL-J003")


def test_capture_finding_round_trips_through_baseline(tmp_path):
    fixture = _write(tmp_path / "fixture.py", _region("graph", 'print("x")  # HAZARD'))
    bl_path = tmp_path / ".graftlint-baseline.json"
    assert port_cli.main([str(fixture), "--no-baseline"]) == 1
    assert port_cli.main([str(fixture), "--baseline", str(bl_path),
                          "--write-baseline"]) == 0
    assert [e["rule"] for e in json.loads(bl_path.read_text())["entries"]] == ["GL-J003"]
    assert port_cli.main([str(fixture), "--baseline", str(bl_path)]) == 0
