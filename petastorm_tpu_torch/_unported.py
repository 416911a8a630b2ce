"""Features of the JAX package whose machinery the port does not have yet.

Each maps to the ROADMAP.md queue item that ports it. A caller that asks for one gets a
``NotImplementedError`` naming that item; the port never ignores an option.
"""
from __future__ import annotations

_ITEMS = {
    "compat": "Queue 1 item 16 (reference-petastorm compatibility, HDFS, Spark)",
    "tf": "Queue 1 item 21 (adapters/tf.py, tf_utils.py and tools/)",
}

#: loader and reader options still refused (option name -> (roadmap key, the value that
#: means "not used")): none. io_options, cache_*, io_retries, recovery, trace, metrics,
#: health, slos, provenance, tenant, controller, watch and sharding are all taken.
OPTIONS = {}


def not_ported(what, key):
    """The error for a feature of the JAX package the port does not have yet."""
    return NotImplementedError(
        "%s is not ported to petastorm_tpu_torch yet: see ROADMAP.md %s"
        % (what, _ITEMS[key]))
