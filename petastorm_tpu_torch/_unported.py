"""Options of the JAX package whose machinery the port does not have yet.

Each name maps to the ROADMAP.md queue item that ports it. A caller that passes one of
them gets a ``NotImplementedError`` naming that item; the port never ignores an option.
"""
from __future__ import annotations

_ITEMS = {
    "process_pool": "Queue 1 item 4(c) (the process pool's tcp transport and framing)",
    "multi_device": "Queue 1 item 12 (multi-card placement)",
    "compat": "Queue 1 item 16 (reference-petastorm compatibility, HDFS, Spark)",
    "tf": "Queue 1 item 21 (adapters/tf.py, tf_utils.py and tools/)",
}

#: option name -> (roadmap key, the value that means "not used")
OPTIONS = {
    # io_options and cache_* are taken
    # io_retries, io_retry_backoff_s, recovery, trace and metrics are taken; so are
    # health, slos and provenance; so are tenant and controller, and watch
    "sharding": ("multi_device", None),
}


def not_ported(what, key):
    """The error for a feature of the JAX package the port does not have yet."""
    return NotImplementedError(
        "%s is not ported to petastorm_tpu_torch yet: see ROADMAP.md %s"
        % (what, _ITEMS[key]))


def reject_unported(caller, **options):
    """Raise for the first option in ``options`` set to anything but its unused value."""
    for name, value in options.items():
        key, unused = OPTIONS[name]
        if value is not unused and value != unused:
            raise not_ported("%s(%s=%r)" % (caller, name, value), key)
