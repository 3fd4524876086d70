"""Workflow archive writer.

The port of ``veles_tpu/export/packager.py``: the same zip layout, so a
package written here is the JAX package's for the same workflow and
weights (``contents.json`` equal as JSON, every ``.npy`` equal byte for
byte):

- ``contents.json``: workflow name, checksum, precision, the unit list
  in the workflow's order with each unit's ``describe()``, its
  ``export_params()`` (as ``params``) and the names of its exported
  arrays;
- ``<unit>/<attr>.npy``: each exported array, cast to fp16 or fp32, in
  C order;
- extra files the caller adds (:func:`~.model.export_model` adds
  ``model.json``).

The native engine (``native/``) and both packages' ``PackageLoader``
read this format.
"""

import io
import json
import zipfile

import numpy
import torch

__all__ = ["package_export"]


def _host(value):
    """A unit attribute as a host array (device tensors are pulled)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return numpy.asarray(value)


def _exported_arrays(unit):
    out = {}
    for attr in getattr(unit, "exports", ()):
        value = getattr(unit, attr, None)
        if value is None:
            continue
        if hasattr(value, "map_read"):
            if not value:
                continue  # an empty Array (a paramless unit's weights)
            # the freshest value: after training on the card the host
            # copy may be stale
            arr = _host(value.map_read())
        else:
            arr = _host(value)
        if arr.dtype == object:
            continue  # not a tensor
        out[attr] = arr
    return out


def package_export(workflow, path, precision=32, extra_files=None):
    """Write the workflow's package archive to ``path`` (.zip).

    ``precision`` is 16 or 32: floating arrays are cast to float16 or
    float32.  ``extra_files`` maps zip names to bytes or str."""
    if precision not in (16, 32):
        raise ValueError("precision must be 16 or 32")
    fdtype = numpy.float16 if precision == 16 else numpy.float32
    units_desc = []
    arrays = []  # (zip name, ndarray)
    for unit in workflow:
        desc = unit.describe()
        exported = _exported_arrays(unit)
        desc["arrays"] = {}
        for attr, arr in exported.items():
            if numpy.issubdtype(arr.dtype, numpy.floating):
                arr = arr.astype(fdtype)
            # C order always: the native npy reader takes no
            # fortran_order files
            arr = numpy.ascontiguousarray(arr)
            zname = "%s/%s.npy" % (unit.name.replace("/", "_"), attr)
            desc["arrays"][attr] = {
                "file": zname,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
            }
            arrays.append((zname, arr))
        params = getattr(unit, "export_params", None)
        if callable(params):
            desc["params"] = params()
        units_desc.append(desc)
    contents = {
        "workflow": workflow.name,
        "checksum": workflow.checksum,
        "precision": precision,
        "units": units_desc,
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("contents.json", json.dumps(contents, indent=2,
                                                default=str))
        for zname, arr in arrays:
            buf = io.BytesIO()
            numpy.save(buf, arr)
            zf.writestr(zname, buf.getvalue())
        for zname, data in (extra_files or {}).items():
            zf.writestr(zname, data)
    return path
