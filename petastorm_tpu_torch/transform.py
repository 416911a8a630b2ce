"""User transforms applied inside workers or on the device.

Port of ``petastorm_tpu.transform``. :class:`TransformSpec` declares a function run on
decoded rows (per-row path) or pandas DataFrames (batch path) plus the schema edits it
implies, so downstream consumers see the post-transform schema.

A transform may instead run on the device: ``device=True`` declares a
``fn(batch_dict) -> batch_dict`` over torch tensors that the
:class:`~petastorm_tpu_torch.loader.DataLoader` applies after transfer; the workers skip
it.

:class:`petastorm_tpu_torch.ops.tabular.FeaturePipeline` is the declarative subclass:
instead of an opaque callable it carries an op list the reader factories validate, fuse
and compile (``declarative = True`` below is the marker the read path branches on:
declarative transforms run columnar with no pandas round trip).
"""
from __future__ import annotations

from petastorm_tpu_torch.unischema import Unischema, UnischemaField


class TransformSpec:
    #: True on declarative subclasses (FeaturePipeline): the transform is a plannable op
    #: graph, not an opaque callable, and workers apply it columnar
    declarative = False

    def __init__(self, func=None, edit_fields=None, removed_fields=None, selected_fields=None,
                 device=False):
        self.func = func
        self.edit_fields = list(edit_fields or [])
        self.removed_fields = list(removed_fields or [])
        self.selected_fields = list(selected_fields) if selected_fields is not None else None
        self.device = bool(device)
        for f in self.edit_fields:
            if not isinstance(f, (tuple, UnischemaField)):
                raise ValueError("edit_fields entries must be tuples or UnischemaField; got %r" % (f,))


def transform_schema(schema, transform_spec):
    """Apply declared edits/removals/selection to a schema."""
    fields = dict(schema.fields)
    for removed in transform_spec.removed_fields:
        fields.pop(removed, None)
    for edit in transform_spec.edit_fields:
        if isinstance(edit, UnischemaField):
            new_field = edit
        elif len(edit) == 4:
            # reference petastorm edit_fields contract: (name, numpy_dtype, shape, is_nullable)
            name, numpy_dtype, shape, nullable = edit
            new_field = UnischemaField(name, numpy_dtype, shape, None, nullable)
        else:
            new_field = UnischemaField(*edit)
        fields[new_field.name] = new_field
    ordered = [f for name, f in fields.items()]
    if transform_spec.selected_fields is not None:
        missing = set(transform_spec.selected_fields) - set(fields.keys())
        if missing:
            raise ValueError("selected_fields %r not present after transform" % sorted(missing))
        ordered = [fields[name] for name in transform_spec.selected_fields]
    return Unischema(schema.name + "_transformed", ordered)
