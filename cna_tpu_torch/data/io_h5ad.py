"""h5ad (AnnData-on-HDF5) reader/writer.

The reference assumes AnnData objects materialize from h5ad files written
by scanpy (demo.ipynb cell 29 ``d.write(...)``); anndata itself is an
external dependency there.  Here IO is in-framework: a direct h5py
implementation of the AnnData on-disk schema (encoding-type annotations,
v0.8+), covering what the CNA pipeline needs:

* ``X``: dense array or CSR/CSC sparse group,
* ``obs``/``var``: dataframes with numeric, boolean, string, and
  categorical columns,
* ``obsm``: dense arrays (e.g. X_pca, X_umap),
* ``obsp``: sparse pairwise matrices (the kNN graph),
* ``uns``: nested dicts of scalars/arrays.

Files written by real anndata/scanpy load here, and files written here
load in real anndata (schema-conformant encodings).

A copy of the TPU package's ``data/io_h5ad.py`` (h5py, numpy, pandas and
scipy; no device work).  ``h5py`` is imported inside the functions, so
that the package imports on a machine without it.  Lazy device faces in
``obsp`` (``DeviceConnectivities``, ``LazyDistances``) are written as the
scipy CSR their ``tocsr()`` gives; private ``uns`` keys (``_cna_tpu*``,
the device caches) are skipped.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import scipy.sparse as sp

from ..utils.profiling import global_profiler
from .celldata import CellData

# ---------------------------------------------------------------- reading


def _read_element(node):
    import h5py

    enc = node.attrs.get("encoding-type", None)
    if isinstance(node, h5py.Group):
        if enc in ("csr_matrix", "csc_matrix"):
            return _read_sparse(node, enc)
        if enc == "dataframe":
            return _read_dataframe(node)
        if enc == "categorical":
            return _read_categorical(node)
        if enc == "dict" or enc is None:
            return {k: _read_element(node[k]) for k in node.keys()}
        return {k: _read_element(node[k]) for k in node.keys()}
    # dataset
    value = node[()]
    if enc == "string-array" or (value.dtype.kind == "O" if hasattr(value, "dtype") else False):
        return np.asarray(value).astype(str)
    if enc == "string":
        return value.decode() if isinstance(value, bytes) else str(value)
    if isinstance(value, bytes):
        return value.decode()
    return value


def _read_sparse(group, enc):
    data = group["data"][()]
    indices = group["indices"][()]
    indptr = group["indptr"][()]
    shape = tuple(group.attrs["shape"])
    cls = sp.csr_matrix if enc == "csr_matrix" else sp.csc_matrix
    return cls((data, indices, indptr), shape=shape)


def _read_categorical(group):
    categories = _read_element(group["categories"])
    codes = group["codes"][()]
    return pd.Categorical.from_codes(codes, categories=categories)


def _read_dataframe(group):
    index_key = group.attrs.get("_index", "_index")
    if isinstance(index_key, bytes):
        index_key = index_key.decode()
    column_order = [
        c.decode() if isinstance(c, bytes) else c
        for c in group.attrs.get("column-order", [])
    ]
    index = _read_element(group[index_key])
    df = pd.DataFrame(index=pd.Index(index, name=index_key.strip("_") or None))
    for col in column_order:
        df[col] = _read_element(group[col])
    return df


def read_h5ad(path) -> CellData:
    """Load a CellData from an .h5ad file (anndata on-disk schema)."""
    import h5py

    with global_profiler().phase("read_h5ad"), h5py.File(path, "r") as f:
        x = _read_element(f["X"]) if "X" in f else None
        obs = _read_dataframe(f["obs"]) if "obs" in f else None
        var = _read_dataframe(f["var"]) if "var" in f else None
        obsm = {k: _read_element(v) for k, v in f["obsm"].items()} if "obsm" in f else {}
        obsp = {k: _read_element(v) for k, v in f["obsp"].items()} if "obsp" in f else {}
        uns = _read_element(f["uns"]) if "uns" in f else {}
    if sp.issparse(x):
        x_arr = x.tocsr()  # stays sparse — see CellData docstring
    else:
        x_arr = np.asarray(x) if x is not None else None
    d = CellData.__new__(CellData)
    d.X = x_arr
    d.obs = obs if obs is not None else pd.DataFrame()
    d.var = var if var is not None else pd.DataFrame()
    d.obsm = obsm
    d.obsp = obsp
    d.uns = uns if isinstance(uns, dict) else {}
    d.samplem = d.uns.pop("_samplem", None)
    d.sid_name = d.uns.pop("_sid_name", "id")
    return d


# ---------------------------------------------------------------- writing


def _write_scalar_attrs(node, enc, version="0.2.0"):
    node.attrs["encoding-type"] = enc
    node.attrs["encoding-version"] = version


def _write_array(group, key, value):
    import h5py

    value = np.asarray(value)
    if value.dtype.kind in ("U", "O"):
        dt = h5py.string_dtype(encoding="utf-8")
        ds = group.create_dataset(key, data=value.astype(object), dtype=dt)
        _write_scalar_attrs(ds, "string-array")
    elif value.dtype.kind == "b":
        ds = group.create_dataset(key, data=value)
        _write_scalar_attrs(ds, "array")
    else:
        ds = group.create_dataset(key, data=value)
        _write_scalar_attrs(ds, "array")
    return ds


def _write_sparse(parent, key, mat):
    mat = mat.tocsr() if not sp.issparse(mat) else mat
    enc = "csr_matrix" if sp.issparse(mat) and mat.format == "csr" else "csc_matrix"
    if mat.format not in ("csr", "csc"):
        mat = mat.tocsr()
        enc = "csr_matrix"
    g = parent.create_group(key)
    _write_scalar_attrs(g, enc, "0.1.0")
    g.attrs["shape"] = np.asarray(mat.shape, dtype=np.int64)
    g.create_dataset("data", data=mat.data)
    g.create_dataset("indices", data=mat.indices)
    g.create_dataset("indptr", data=mat.indptr)


def _write_categorical(parent, key, cat: pd.Categorical):
    g = parent.create_group(key)
    _write_scalar_attrs(g, "categorical", "0.2.0")
    g.attrs["ordered"] = bool(cat.ordered)
    _write_array(g, "categories", np.asarray(cat.categories))
    codes = g.create_dataset("codes", data=cat.codes.astype(np.int32))
    _write_scalar_attrs(codes, "array")


def _write_dataframe(parent, key, df: pd.DataFrame):
    import h5py

    g = parent.create_group(key)
    _write_scalar_attrs(g, "dataframe", "0.2.0")
    index_key = "_index"
    g.attrs["_index"] = index_key
    g.attrs["column-order"] = np.asarray(
        [str(c) for c in df.columns], dtype=h5py.string_dtype(encoding="utf-8"))
    _write_array(g, index_key, df.index.to_numpy().astype(str))
    for col in df.columns:
        series = df[col]
        if isinstance(series.dtype, pd.CategoricalDtype):
            _write_categorical(g, str(col), pd.Categorical(series))
        else:
            _write_array(g, str(col), series.to_numpy())


def _write_uns(parent, key, value):
    if isinstance(value, dict):
        g = parent.create_group(key)
        _write_scalar_attrs(g, "dict", "0.1.0")
        for k, v in value.items():
            if str(k).startswith("_cna_tpu"):
                continue  # device caches are not serializable
            _write_uns(g, str(k), v)
    elif sp.issparse(value):
        _write_sparse(parent, key, value)
    elif isinstance(value, str):
        ds = parent.create_dataset(key, data=value)
        _write_scalar_attrs(ds, "string")
    elif np.isscalar(value):
        ds = parent.create_dataset(key, data=value)
        _write_scalar_attrs(ds, "numeric-scalar")
    elif isinstance(value, np.ndarray):
        _write_array(parent, key, value)
    # silently skip non-serializable objects (device arrays, callables)


def write_h5ad(data: CellData, path) -> None:
    """Write a CellData to .h5ad (anndata v0.8+ on-disk schema)."""
    import h5py

    with global_profiler().phase("write_h5ad"), h5py.File(path, "w") as f:
        _write_scalar_attrs(f, "anndata", "0.1.0")
        if data.X is not None:
            if sp.issparse(data.X):
                _write_sparse(f, "X", data.X)
            else:
                _write_array(f, "X", np.asarray(data.X))
        _write_dataframe(f, "obs", data.obs)
        _write_dataframe(f, "var", data.var)
        obsm = f.create_group("obsm")
        _write_scalar_attrs(obsm, "dict", "0.1.0")
        for k, v in data.obsm.items():
            _write_array(obsm, k, np.asarray(v))
        obsp = f.create_group("obsp")
        _write_scalar_attrs(obsp, "dict", "0.1.0")
        for k, v in data.obsp.items():
            _write_sparse(obsp, k, v)
        uns = f.create_group("uns")
        _write_scalar_attrs(uns, "dict", "0.1.0")
        for k, v in data.uns.items():
            if str(k).startswith("_cna_tpu"):
                continue
            _write_uns(uns, str(k), v)
        samplem = getattr(data, "samplem", None)
        if samplem is not None:
            _write_dataframe(uns, "_samplem", samplem)
            sid = uns.create_dataset("_sid_name",
                                     data=getattr(data, "sid_name", "id"))
            _write_scalar_attrs(sid, "string")
