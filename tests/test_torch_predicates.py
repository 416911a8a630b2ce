"""Port vs reference: row predicates. Every predicate of the port, scalar
(``do_include``) and vectorised (``do_include_vectorized``), against the JAX package's on
the same seeded columns; ``in_pseudorandom_split`` selects the reference's ids exactly;
``implied_dnf_filters`` gives the reference's clauses."""
import numpy as np
import pytest

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: F401

pytest.importorskip("torch")

from petastorm_tpu import predicates as ref  # noqa: E402
from petastorm_tpu_torch import predicates as port  # noqa: E402

N = 257


def _columns(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1000, N).astype(np.int64)
    return {
        "id": ids,
        "label": rng.randint(0, 5, N).astype(np.int32),
        "name": np.array(["user-%d" % v for v in rng.randint(0, 40, N)], dtype=object),
        "score": rng.rand(N).astype(np.float64),
        "tags": np.array([list(rng.randint(0, 12, rng.randint(0, 5))) for _ in range(N)],
                         dtype=object),
    }


def _both(build):
    """``build(module)`` for the port's module and the reference's."""
    return build(port), build(ref)


PREDICATES = {
    "in_set": lambda m: m.in_set({1, 3, 4}, "label"),
    "in_set_strings": lambda m: m.in_set({"user-3", "user-17", "nobody"}, "name"),
    "in_intersection": lambda m: m.in_intersection([2, 7], "tags"),
    "in_negate": lambda m: m.in_negate(m.in_set({0, 2}, "label")),
    "in_reduce_all": lambda m: m.in_reduce([m.in_set({1, 2, 3}, "label"),
                                            m.in_lambda(["id"], lambda r: r["id"] % 2 == 0,
                                                        lambda c: c["id"] % 2 == 0)], all),
    "in_reduce_any": lambda m: m.in_reduce([m.in_set({0}, "label"),
                                            m.in_negate(m.in_set({"user-5"}, "name"))], any),
    "in_reduce_custom": lambda m: m.in_reduce(
        [m.in_set({1, 2}, "label"), m.in_set({3, 4}, "label")],
        lambda masks: np.logical_xor(*masks) if isinstance(masks[0], np.ndarray)
        else masks[0] != masks[1]),
    "in_lambda": lambda m: m.in_lambda(["score", "label"],
                                       lambda r: r["score"] > 0.5 and r["label"] != 1),
    "in_lambda_vectorized": lambda m: m.in_lambda(
        ["score"], lambda r: r["score"] < 0.25, lambda c: c["score"] < 0.25),
    "in_pseudorandom_split_0": lambda m: m.in_pseudorandom_split([0.7, 0.2, 0.1], 0, "id"),
    "in_pseudorandom_split_1": lambda m: m.in_pseudorandom_split([0.7, 0.2, 0.1], 1, "id"),
    "in_pseudorandom_split_strings": lambda m: m.in_pseudorandom_split([0.5, 0.5], 1,
                                                                       "name"),
}


@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_predicate_scalar_and_vectorised_equal_reference(name):
    cols = _columns(seed=len(name))
    p, r = _both(PREDICATES[name])
    assert p.get_fields() == r.get_fields()
    fields = sorted(p.get_fields())
    sub = {f: cols[f] for f in fields}
    vec = np.asarray(p.do_include_vectorized(sub), dtype=bool)
    ref_vec = np.asarray(r.do_include_vectorized(sub), dtype=bool)
    scalar = np.array([bool(p.do_include({f: cols[f][i] for f in fields}))
                       for i in range(N)])
    ref_scalar = np.array([bool(r.do_include({f: cols[f][i] for f in fields}))
                           for i in range(N)])
    np.testing.assert_array_equal(vec, ref_vec)
    np.testing.assert_array_equal(scalar, ref_scalar)
    np.testing.assert_array_equal(vec, scalar)
    assert 0 < vec.sum() < N  # the case selects some rows, not all or none


@pytest.mark.parametrize("values", [np.arange(-50, 2000, dtype=np.int64),
                                    np.array(["k%d" % i for i in range(500)], dtype=object),
                                    np.linspace(-3, 3, 301)],
                         ids=["int64", "str", "float64"])
def test_unit_hash_is_the_references_byte_for_byte(values):
    got = [port.in_pseudorandom_split._unit_hash(v) for v in values]
    want = [ref.in_pseudorandom_split._unit_hash(v) for v in values]
    assert got == want


def test_pseudorandom_split_partitions_ids_like_the_reference():
    """Every id lands in exactly one band of the split, the same band as in the JAX
    package, and the bands' sizes follow the fractions."""
    ids = np.arange(20000, dtype=np.int64)
    fractions = [0.6, 0.3, 0.1]
    bands = []
    for k in range(3):
        mask = port.in_pseudorandom_split(fractions, k, "id").do_include_vectorized(
            {"id": ids})
        np.testing.assert_array_equal(
            mask, ref.in_pseudorandom_split(fractions, k, "id").do_include_vectorized(
                {"id": ids}))
        bands.append(mask)
    assert (np.sum(bands, axis=0) == 1).all()
    for mask, f in zip(bands, fractions):
        assert abs(mask.mean() - f) < 0.02


@pytest.mark.parametrize("args", [([0.5, 0.5], 2), ([0.7, 0.5], 0)],
                         ids=["index_out_of_range", "fractions_over_one"])
def test_pseudorandom_split_validation_like_the_reference(args):
    with pytest.raises(ValueError) as port_err:
        port.in_pseudorandom_split(args[0], args[1], "id")
    with pytest.raises(ValueError) as ref_err:
        ref.in_pseudorandom_split(args[0], args[1], "id")
    assert str(port_err.value) == str(ref_err.value)


IMPLIED = {
    "in_set": lambda m: m.in_set({3, 1, 2}, "a"),
    "negated_set": lambda m: m.in_negate(m.in_set({"x", "y"}, "s")),
    "and": lambda m: m.in_reduce([m.in_set({1}, "a"), m.in_set({2, 3}, "b"),
                                  m.in_lambda(["c"], lambda r: True)], all),
    "or": lambda m: m.in_reduce([m.in_set({1}, "a"), m.in_negate(m.in_set({2}, "b"))],
                                any),
    "or_untranslatable": lambda m: m.in_reduce([m.in_set({1}, "a"),
                                                m.in_lambda(["c"], lambda r: True)], any),
    "lambda": lambda m: m.in_lambda(["c"], lambda r: True),
    "split": lambda m: m.in_pseudorandom_split([0.5, 0.5], 0, "a"),
    "intersection": lambda m: m.in_intersection([1], "t"),
}


@pytest.mark.parametrize("name", sorted(IMPLIED))
def test_implied_dnf_filters_equal_reference(name):
    p, r = _both(IMPLIED[name])
    assert port.implied_dnf_filters(p) == ref.implied_dnf_filters(r)
