"""Dataset tools (port of ``petastorm_tpu.tools``): :mod:`.copy_dataset` copies or
subsets a store and regenerates its metadata, :mod:`.generate_metadata` writes
``_common_metadata`` for a store that lacks it or carries the reference's pickled keys.
Both are console scripts (``petastorm-tpu-torch-copy-dataset``,
``petastorm-tpu-torch-generate-metadata``)."""
