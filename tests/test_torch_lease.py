"""The buffer-lease contract of the port (``petastorm_tpu_torch.io.lease``) against the
JAX package's (``petastorm_tpu.io.lease``): every case runs on both, with the same
inputs, and must behave the same. Refcount discipline, revocation, the batch wrapper,
read-only views, copy-on-write and the copy census."""
import gc
import importlib

import numpy as np
import pytest

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: F401

PACKAGES = ["petastorm_tpu", "petastorm_tpu_torch"]


@pytest.fixture(params=PACKAGES)
def pkg(request):
    lease = importlib.import_module(request.param + ".io.lease")
    errors = importlib.import_module(request.param + ".errors")
    return lease, errors


def test_lease_release_fires_owner_callback_exactly_once_at_zero(pkg):
    lease_mod, _ = pkg
    freed = []
    lease = lease_mod.Lease(release_cb=lambda: freed.append(1))
    lease.retain()
    lease.retain()
    lease.release()
    lease.release()
    assert freed == []
    lease.release()
    assert freed == [1]
    assert not lease.alive


def test_lease_double_release_raises_lease_error(pkg):
    lease_mod, errors = pkg
    lease = lease_mod.Lease()
    lease.release()
    with pytest.raises(errors.LeaseError):
        lease.release()


def test_lease_retain_after_full_release_raises(pkg):
    lease_mod, errors = pkg
    lease = lease_mod.Lease()
    lease.release()
    with pytest.raises(errors.LeaseError):
        lease.retain()


def test_lease_revoke_keeps_refcounts_but_fails_accessors(pkg):
    lease_mod, errors = pkg
    freed = []
    lease = lease_mod.Lease(release_cb=lambda: freed.append(1))
    lease.retain()
    lease.revoke()
    assert lease.revoked
    with pytest.raises(errors.LeaseRevoked):
        lease.check()
    lease.release()
    lease.release()
    assert freed == [1]


def test_lease_gc_reclaim_counts_leak_and_frees_owner(pkg):
    lease_mod, _ = pkg
    freed = []
    before = lease_mod.lease_stats()["leaked"]
    lease = lease_mod.Lease(release_cb=lambda: freed.append(1))  # graftlint: disable=GL-L001 (the leak IS the subject under test)
    del lease
    gc.collect()
    assert freed == [1]
    assert lease_mod.lease_stats()["leaked"] == before + 1


def _leased_batch(lease_mod):
    arr = np.arange(8, dtype=np.int64)
    view = arr.view()
    view.flags.writeable = False
    lease = lease_mod.Lease(kind="test")
    return lease_mod.LeasedBatch({"x": view, "y": np.arange(4.0)}, [lease]), lease, arr


def test_leased_batch_access_after_revoke_raises_not_garbage(pkg):
    lease_mod, errors = pkg
    batch, lease, _arr = _leased_batch(lease_mod)
    np.testing.assert_array_equal(batch["x"], np.arange(8))
    lease.revoke()
    with pytest.raises(errors.LeaseRevoked):
        batch["x"]
    batch.release()


def test_leased_batch_bulk_accessors_check_revocation(pkg):
    lease_mod, errors = pkg
    batch, lease, _arr = _leased_batch(lease_mod)
    assert set(dict(batch.items())) == {"x", "y"}
    assert len(list(batch.values())) == 2
    assert batch.get("x") is not None
    lease.revoke()
    for accessor in (batch.items, batch.values, lambda: batch.get("x")):
        with pytest.raises(errors.LeaseRevoked):
            accessor()
    batch.release()


def test_leased_batch_writable_is_cow_escalation(pkg):
    lease_mod, _ = pkg
    batch, lease, arr = _leased_batch(lease_mod)
    before = lease_mod.copy_census().get("lease_cow", 0)
    owned = batch.writable("x")
    assert owned.flags.writeable
    owned[:] = -1
    np.testing.assert_array_equal(arr, np.arange(8))
    assert batch["x"] is owned
    assert lease_mod.copy_census().get("lease_cow", 0) == before + owned.nbytes
    assert batch.writable("y") is batch["y"]
    batch.release()
    assert not lease.alive


def test_leased_batch_release_is_idempotent_at_batch_level(pkg):
    lease_mod, _ = pkg
    batch, lease, _arr = _leased_batch(lease_mod)
    batch.release()
    batch.release()  # graftlint: disable=GL-L001 (batch-level release is documented idempotent: the subject under test)
    assert not lease.alive


def test_attach_and_take_leases_roundtrip(pkg):
    lease_mod, _ = pkg
    lease = lease_mod.Lease(kind="test")
    plain = {"x": np.arange(3)}
    assert lease_mod.attach_leases(plain, []) is plain
    batch = lease_mod.attach_leases(plain, [lease])
    assert isinstance(batch, lease_mod.LeasedBatch)
    assert lease_mod.take_leases(batch) == (lease,)
    assert lease_mod.take_leases(batch) == ()
    assert lease_mod.take_leases({"x": 1}) == ()
    lease.release()


def test_readonly_view_shares_buffers_and_freezes_elements(pkg):
    lease_mod, _ = pkg
    inner = np.arange(6, dtype=np.float32)
    ragged = np.empty(2, dtype=object)
    ragged[0] = np.arange(3)
    ragged[1] = np.arange(5.0)
    src = {"flat": inner, "ragged": ragged, "rows": [{"v": np.ones(2)}], "s": "keep"}
    out = lease_mod.readonly_view(src)
    assert out["flat"].base is inner
    assert not out["flat"].flags.writeable
    assert not out["ragged"][0].flags.writeable
    assert out["s"] == "keep"
    assert not out["rows"][0]["v"].flags.writeable
    inner[0] = 42.0
    assert out["flat"][0] == 42.0
    out["ragged"][0] = None
    assert ragged[0] is not None


def test_copy_census_accumulates_per_site(pkg):
    lease_mod, _ = pkg
    before = lease_mod.copy_census().get("loader_pad", 0)
    lease_mod.count_copy("loader_pad", 128)
    lease_mod.count_copy("loader_pad", 0)
    assert lease_mod.copy_census()["loader_pad"] == before + 128


def test_lease_stats_have_the_references_keys():
    from petastorm_tpu.io.lease import lease_stats as ref_stats
    from petastorm_tpu_torch.io.lease import lease_stats

    assert set(lease_stats()) == set(ref_stats())
