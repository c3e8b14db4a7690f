"""Save/load prepared device formats (checkpoint/resume analog).

The reference's closest analog is raw/text vector dumps for offline reuse
(SURVEY.md section 5 checkpoint/resume, utils.c:135-168). Here the expensive
artifact is the *prepared device format* (row binning / diagonal extraction
over hundred-million-nnz matrices costs host seconds), so we serialize those
to .npz and restore them without re-running preparation.
"""
from __future__ import annotations

import json
from typing import Union

import jax.numpy as jnp
import numpy as np

from .binned import BinnedCSR
from .dia import DeviceDIA
from .matrix import DeviceCSR, DeviceELL

PreparedFormat = Union[BinnedCSR, DeviceDIA, DeviceELL, DeviceCSR]


def save_prepared(path: str, mat) -> None:
    import jax

    leaves, _treedef = jax.tree_util.tree_flatten(mat)
    arrs = [np.asarray(l) for l in leaves]
    # npz cannot hold ml_dtypes arrays: store bf16 as uint16 bit patterns
    bf16 = [i for i, a in enumerate(arrs) if a.dtype.name == "bfloat16"]
    arrs = [a.view(np.uint16) if i in bf16 else a for i, a in enumerate(arrs)]
    meta = {"kind": type(mat).__name__, "aux": _aux_of(mat), "bf16": bf16}
    np.savez_compressed(
        path,
        __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **{f"leaf{i}": a for i, a in enumerate(arrs)},
    )


def _aux_of(mat: PreparedFormat) -> dict:
    if isinstance(mat, BinnedCSR):
        return {
            "class_offsets": list(mat.class_offsets),
            "class_widths": [list(w) for w in mat.class_widths],
            "class_layouts": list(mat.class_layouts),
            "shape": list(mat.shape),
            "nnz": mat.nnz,
        }
    if isinstance(mat, DeviceDIA):
        return {
            "offsets": list(mat.offsets),
            "shape": list(mat.shape),
            "nnz": mat.nnz,
        }
    if isinstance(mat, DeviceELL):
        return {
            "shape": list(mat.shape),
            "nnz": mat.nnz,
            "max_row_nz": mat.max_row_nz,
            "transposed": mat.transposed,
        }
    if isinstance(mat, DeviceCSR):
        return {"shape": list(mat.shape), "nnz": mat.nnz}
    raise TypeError(type(mat))


class _LeafReader:
    def __init__(self, z, bf16=()):
        self.z = z
        self.i = 0
        self.bf16 = set(bf16)

    def _one(self, k):
        a = self.z[f"leaf{k}"]
        if k in self.bf16:
            import ml_dtypes

            a = a.view(ml_dtypes.bfloat16)
        return jnp.asarray(a)

    def take(self, n: int):
        out = [self._one(self.i + k) for k in range(n)]
        self.i += n
        return out


def load_prepared(path: str) -> PreparedFormat:
    z = np.load(path)
    meta = json.loads(bytes(z["__meta__"]).decode())
    kind, aux = meta["kind"], meta["aux"]
    r = _LeafReader(z, bf16=meta.get("bf16", ()))
    n_leaves = len(z.files) - 1
    if kind == "BinnedCSR":
        return BinnedCSR(
            *r.take(n_leaves),
            class_offsets=tuple(aux["class_offsets"]),
            class_widths=tuple(tuple(w) for w in aux["class_widths"]),
            class_layouts=tuple(aux["class_layouts"]),
            shape=tuple(aux["shape"]),
            nnz=aux["nnz"],
        )
    if kind == "DeviceDIA":
        return DeviceDIA(
            *r.take(n_leaves),
            offsets=tuple(aux["offsets"]),
            shape=tuple(aux["shape"]),
            nnz=aux["nnz"],
        )
    if kind == "DeviceELL":
        return DeviceELL(
            *r.take(n_leaves),
            shape=tuple(aux["shape"]),
            nnz=aux["nnz"],
            max_row_nz=aux["max_row_nz"],
            transposed=aux["transposed"],
        )
    if kind == "DeviceCSR":
        return DeviceCSR(*r.take(n_leaves), shape=tuple(aux["shape"]), nnz=aux["nnz"])
    raise ValueError(f"unknown kind {kind}")
