"""Minimal labelled-array dataset with NetCDF I/O.

A copy of ``windtpu/io/dataset.py`` (pure numpy; h5py and scipy imported
lazily), kept so the port imports nothing of the JAX package;
tests/test_torch_copies.py pins it to the original.

The reference leans on xarray + netCDF4 for every host-side data step
(api.py, cli.py, data_processing.py).  Those packages are not required, so
this module provides the small subset the framework needs:

* :class:`DataArray` — dims + numpy values (+ attrs);
* :class:`Dataset`  — named variables sharing dimensions, with ``isel``,
  nearest-neighbour ``sel``, slicing by coordinate range, merge and
  time expansion;
* NetCDF read/write: classic NetCDF-3 via ``scipy.io.netcdf_file`` and
  NetCDF-4/HDF5 via ``h5py`` (dimension scales + CF time decoding), so files
  written here are readable by xarray/netCDF4 and vice versa.

This is a deliberate re-design, not an xarray clone: only the operations on
the downscaling hot path exist, and they are all O(1)-copy numpy.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

_NC3_MAGIC = b"CDF"
_HDF5_MAGIC = b"\x89HDF"


@dataclasses.dataclass
class DataArray:
    dims: Tuple[str, ...]
    values: np.ndarray
    attrs: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.values = np.asarray(self.values)
        self.dims = tuple(self.dims)
        if len(self.dims) != self.values.ndim:
            raise ValueError(
                f"dims {self.dims} do not match array rank {self.values.ndim}"
            )

    @property
    def shape(self):
        return self.values.shape


class Dataset:
    """A dict of DataArrays sharing named dimensions."""

    def __init__(
        self,
        data_vars: Optional[Dict[str, DataArray]] = None,
        coords: Optional[Dict[str, DataArray]] = None,
        attrs: Optional[Dict] = None,
    ):
        self.data_vars: Dict[str, DataArray] = dict(data_vars or {})
        self.coords: Dict[str, DataArray] = dict(coords or {})
        self.attrs = dict(attrs or {})
        self._check()

    # -- construction helpers -------------------------------------------------
    def _check(self):
        sizes: Dict[str, int] = {}
        for name, var in {**self.coords, **self.data_vars}.items():
            for d, s in zip(var.dims, var.shape):
                if d in sizes and sizes[d] != s:
                    raise ValueError(
                        f"dim {d!r} inconsistent: {sizes[d]} vs {s} in {name}"
                    )
                sizes[d] = s
        self._sizes = sizes

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(self._sizes)

    @property
    def dims(self) -> Dict[str, int]:
        return self.sizes

    def __contains__(self, name):
        return name in self.data_vars or name in self.coords

    def __getitem__(self, name) -> DataArray:
        if isinstance(name, (list, tuple)):
            keep = set(name)
            return Dataset(
                {k: v for k, v in self.data_vars.items() if k in keep},
                self.coords, self.attrs,
            )
        if name in self.data_vars:
            return self.data_vars[name]
        return self.coords[name]

    def __setitem__(self, name, var: DataArray):
        self.data_vars[name] = var
        self._check()

    def copy(self) -> "Dataset":
        return Dataset(
            {k: DataArray(v.dims, v.values.copy(), dict(v.attrs))
             for k, v in self.data_vars.items()},
            {k: DataArray(v.dims, v.values.copy(), dict(v.attrs))
             for k, v in self.coords.items()},
            dict(self.attrs),
        )

    # -- selection -------------------------------------------------------------
    def isel(self, indexers: Optional[Dict] = None, **kw) -> "Dataset":
        """Integer/slice/fancy indexing along named dims."""
        indexers = {**(indexers or {}), **kw}

        def index_var(var: DataArray) -> DataArray:
            idx = tuple(
                indexers.get(d, slice(None)) for d in var.dims
            )
            new_dims = tuple(
                d for d, i in zip(var.dims, idx)
                if not isinstance(i, (int, np.integer))
            )
            # Apply one axis at a time to keep fancy-index semantics simple.
            vals = var.values
            offset = 0
            for axis, i in enumerate(idx):
                if isinstance(i, slice) and i == slice(None):
                    continue
                vals = np.take(vals, np.arange(vals.shape[axis - offset])[i]
                               if isinstance(i, slice) else i,
                               axis=axis - offset)
                if isinstance(i, (int, np.integer)):
                    offset += 1
            return DataArray(new_dims, vals, dict(var.attrs))

        return Dataset(
            {k: index_var(v) for k, v in self.data_vars.items()},
            {k: index_var(v) for k, v in self.coords.items()
             if all(d not in indexers or not isinstance(indexers[d], (int, np.integer))
                    for d in v.dims)},
            dict(self.attrs),
        )

    def sel_nearest(self, **targets) -> "Dataset":
        """Nearest-neighbour selection on 1-D coords (xarray
        ``.sel(..., method='nearest')`` for the regridding paths,
        reference api.py:36,42)."""
        indexers = {}
        for cname, want in targets.items():
            coord = self.coords[cname]
            if len(coord.dims) != 1:
                raise ValueError(f"sel_nearest needs 1-D coord, got {cname}")
            dim = coord.dims[0]
            want = np.asarray(want)
            idx = nearest_indices(coord.values.astype(np.float64),
                                  want.astype(np.float64))
            indexers[dim] = idx
        out = self.isel(indexers)
        # Re-label the selected coords with the requested values.
        for cname, want in targets.items():
            dim = self.coords[cname].dims[0]
            out.coords[cname] = DataArray((dim,), np.asarray(want))
        out._check()
        return out

    def sel_range(self, **ranges) -> "Dataset":
        """Slice by (lo, hi) coordinate value range on a 1-D coord;
        handles descending coords (ERA5 latitude)."""
        indexers = {}
        for cname, (lo, hi) in ranges.items():
            coord = self.coords[cname]
            dim = coord.dims[0]
            vals = coord.values
            # A value mask works for ascending and descending (ERA5
            # latitude) coords alike; the selected block stays contiguous
            # either way because the coords are monotonic.
            mask = (vals >= lo) & (vals <= hi)
            idx = np.nonzero(mask)[0]
            if len(idx) == 0:
                raise ValueError(f"range {lo}:{hi} selects nothing on {cname}")
            indexers[dim] = slice(int(idx[0]), int(idx[-1]) + 1)
        return self.isel(indexers)

    def drop_vars(self, names: Iterable[str]) -> "Dataset":
        names = set([names] if isinstance(names, str) else names)
        return Dataset(
            {k: v for k, v in self.data_vars.items() if k not in names},
            {k: v for k, v in self.coords.items() if k not in names},
            dict(self.attrs),
        )

    def rename(self, mapping: Dict[str, str]) -> "Dataset":
        def rn(d):
            return tuple(mapping.get(x, x) for x in d)

        return Dataset(
            {mapping.get(k, k): DataArray(rn(v.dims), v.values, v.attrs)
             for k, v in self.data_vars.items()},
            {mapping.get(k, k): DataArray(rn(v.dims), v.values, v.attrs)
             for k, v in self.coords.items()},
            dict(self.attrs),
        )

    def expand_time(self, time_values: np.ndarray) -> "Dataset":
        """Replicate all variables along a new leading ``time`` dim
        (xarray ``expand_dims({'time': ...})``, reference api.py:91)."""
        nt = len(time_values)
        out_vars = {
            k: DataArray(("time",) + v.dims,
                         np.broadcast_to(v.values, (nt,) + v.shape),
                         dict(v.attrs))
            for k, v in self.data_vars.items()
        }
        coords = dict(self.coords)
        coords["time"] = DataArray(("time",), np.asarray(time_values))
        return Dataset(out_vars, coords, dict(self.attrs))

    def merge(self, other: "Dataset") -> "Dataset":
        coords = {**self.coords, **other.coords}
        data_vars = {**self.data_vars, **other.data_vars}
        return Dataset(data_vars, coords, {**self.attrs, **other.attrs})

    def __repr__(self):
        lines = [f"<windtpu_torch.Dataset dims={self._sizes}>"]
        for k, v in self.coords.items():
            lines.append(f"  coord {k}{v.dims}: {v.shape} {v.values.dtype}")
        for k, v in self.data_vars.items():
            lines.append(f"  var   {k}{v.dims}: {v.shape} {v.values.dtype}")
        return "\n".join(lines)

    # -- NetCDF ---------------------------------------------------------------
    def to_netcdf(self, path: Union[str, os.PathLike]):
        """Write NetCDF-4 (HDF5 with dimension scales), xarray-compatible."""
        import h5py

        with h5py.File(path, "w") as f:
            # Dimension coordinate variables first (as dimension scales).
            for name, size in self._sizes.items():
                if name in self.coords and self.coords[name].dims == (name,):
                    data, attrs = _encode_var(self.coords[name])
                    d = f.create_dataset(name, data=data)
                    for ak, av in attrs.items():
                        d.attrs[ak] = av
                else:
                    d = f.create_dataset(name, data=np.arange(size))
                d.make_scale(name)
            for name, var in {**self.coords, **self.data_vars}.items():
                if name in f:
                    continue
                data, attrs = _encode_var(var)
                d = f.create_dataset(name, data=data)
                for i, dim in enumerate(var.dims):
                    d.dims[i].attach_scale(f[dim])
                for ak, av in attrs.items():
                    d.attrs[ak] = av
                if var.dims and name in self.coords:
                    d.attrs["_windtpu_coord"] = np.bool_(True)
            f.attrs["Conventions"] = "CF-1.7"
            for ak, av in self.attrs.items():
                try:
                    f.attrs[ak] = av
                except TypeError:
                    f.attrs[ak] = str(av)


def nearest_indices(grid: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Indices of the grid points nearest to each wanted value.
    Works for ascending and descending 1-D grids."""
    flip = len(grid) > 1 and grid[0] > grid[-1]
    g = grid[::-1] if flip else grid
    pos = np.searchsorted(g, want)
    pos = np.clip(pos, 1, len(g) - 1)
    left = g[pos - 1]
    right = g[pos]
    idx = np.where(np.abs(want - left) <= np.abs(right - want), pos - 1, pos)
    idx = np.where(want <= g[0], 0, idx)
    idx = np.where(want >= g[-1], len(g) - 1, idx)
    if flip:
        idx = len(grid) - 1 - idx
    return idx.astype(np.int64)


def _encode_var(var: DataArray):
    vals = var.values
    attrs = dict(var.attrs)
    if np.issubdtype(vals.dtype, np.datetime64):
        base = np.datetime64("1970-01-01T00:00:00", "s")
        secs = (vals.astype("datetime64[s]") - base).astype(np.int64)
        attrs["units"] = "seconds since 1970-01-01 00:00:00"
        attrs["calendar"] = "proleptic_gregorian"
        return secs, attrs
    if vals.dtype == object or vals.dtype.kind in "US":
        return np.asarray(vals, dtype="S"), attrs
    return vals, attrs


def _decode_time(values: np.ndarray, units: str) -> np.ndarray:
    m = re.match(
        r"\s*(\w+)\s+since\s+(\d{4}-\d{2}-\d{2})[T ]?(\d{2}:\d{2}(:\d{2}(\.\d+)?)?)?",
        units,
    )
    if not m:
        return values
    unit_name, date_part, time_part = m.group(1).lower(), m.group(2), m.group(3)
    base = np.datetime64(f"{date_part}T{time_part or '00:00:00'}")
    per = {
        "seconds": 1.0, "second": 1.0, "secs": 1.0, "sec": 1.0, "s": 1.0,
        "minutes": 60.0, "minute": 60.0, "mins": 60.0, "min": 60.0,
        "hours": 3600.0, "hour": 3600.0, "hrs": 3600.0, "hr": 3600.0, "h": 3600.0,
        "days": 86400.0, "day": 86400.0, "d": 86400.0,
    }.get(unit_name)
    if per is None:
        return values
    secs = np.asarray(values, dtype=np.float64) * per
    return base.astype("datetime64[s]") + secs.astype("timedelta64[s]")


def _apply_cf(values: np.ndarray, attrs: Dict) -> np.ndarray:
    """CF unpacking: scale_factor / add_offset / _FillValue / time units."""
    fill = attrs.get("_FillValue", attrs.get("missing_value"))
    scale = attrs.get("scale_factor")
    offset = attrs.get("add_offset")
    units = attrs.get("units")
    if units is not None and isinstance(units, bytes):
        units = units.decode()
    if isinstance(units, str) and "since" in units:
        return _decode_time(values, units)
    if scale is not None or offset is not None or fill is not None:
        out = values.astype(np.float64)
        if fill is not None:
            out = np.where(values == fill, np.nan, out)
        if scale is not None:
            out = out * float(np.asarray(scale).ravel()[0])
        if offset is not None:
            out = out + float(np.asarray(offset).ravel()[0])
        return out.astype(np.float32) if values.dtype.itemsize <= 4 else out
    return values


def _open_h5(path) -> Dataset:
    import h5py

    coords: Dict[str, DataArray] = {}
    data_vars: Dict[str, DataArray] = {}
    with h5py.File(path, "r") as f:
        names = []
        f.visit(lambda n: names.append(n) if isinstance(f[n], h5py.Dataset) else None)
        for name in names:
            d = f[name]
            attrs = {k: d.attrs[k] for k in d.attrs
                     if k not in ("DIMENSION_LIST", "REFERENCE_LIST",
                                  "CLASS", "NAME", "_Netcdf4Dimid",
                                  "_Netcdf4Coordinates")}
            # Determine dims via dimension scales.
            base0 = name.split("/")[-1]
            is_scale0 = d.attrs.get("CLASS") == b"DIMENSION_SCALE"
            dims = []
            for i in range(d.ndim):
                if is_scale0 and d.ndim == 1:
                    # A dimension scale IS its own dimension.
                    dims.append(base0)
                    continue
                # Dimension name resolution order: the proxy's LABEL (what
                # netCDF4/xarray set), else the attached scale dataset's
                # path basename — NOT the scale's NAME attribute, which
                # for placeholder dims is the sentinel sentence.
                label = None
                try:
                    proxy = d.dims[i]
                    lbl = proxy.label
                    if isinstance(lbl, bytes):
                        lbl = lbl.decode("utf-8", "replace")
                    if lbl:
                        label = lbl.split("/")[-1]
                    elif len(proxy) > 0:
                        label = proxy[0].name.split("/")[-1]
                except Exception:
                    pass
                dims.append(label or f"{name}_dim{i}")
            vals = _apply_cf(d[...], attrs)
            base = name.split("/")[-1]
            arr = DataArray(tuple(dims), vals, attrs)
            is_scale = d.attrs.get("CLASS") == b"DIMENSION_SCALE"
            # netCDF4/xarray write a PLACEHOLDER dimension scale (all
            # zeros) for dims that have no coordinate variable, marked by
            # this NAME attribute.  It arrives as bytes — decode before
            # matching, or every placeholder becomes a phantom zero-valued
            # coord that scrambles open_mfdataset's time sort.
            name_attr = d.attrs.get("NAME", b"")
            if isinstance(name_attr, bytes):
                name_attr = name_attr.decode("utf-8", "replace")
            is_placeholder = is_scale and name_attr.startswith(
                "This is a netCDF dimension")
            if is_scale and not is_placeholder:
                coords[base] = arr
            elif attrs.pop("_windtpu_coord", False):
                coords[base] = arr
            elif not is_scale:
                data_vars[base] = arr
            # else: placeholder dimension without values — skip.
        ds_attrs = {k: f.attrs[k] for k in f.attrs}
    return Dataset(data_vars, coords, ds_attrs)


def _open_nc3(path) -> Dataset:
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as f:
        coords = {}
        data_vars = {}
        for name, var in f.variables.items():
            attrs = {k: v for k, v in var._attributes.items()}
            vals = _apply_cf(var[...].copy(), attrs)
            arr = DataArray(tuple(var.dimensions), vals, attrs)
            if name in f.dimensions:
                coords[name] = arr
            else:
                data_vars[name] = arr
    return Dataset(data_vars, coords)


def open_dataset(path: Union[str, os.PathLike]) -> Dataset:
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic.startswith(_NC3_MAGIC):
        return _open_nc3(path)
    if magic.startswith(_HDF5_MAGIC):
        return _open_h5(path)
    raise ValueError(f"{path}: not a NetCDF-3 or NetCDF-4/HDF5 file")


def open_mfdataset(paths) -> Dataset:
    """Open several files and concatenate along ``time`` (sorted), merging
    variables — covers the reference's xr.open_mfdataset uses
    (cli.py:22, data_processing.py:94,115)."""
    if isinstance(paths, (str, os.PathLike)):
        paths = sorted(_glob.glob(str(paths)))
    paths = list(paths)
    if not paths:
        raise FileNotFoundError("open_mfdataset: no files matched")
    datasets = [open_dataset(p) for p in paths]
    if len(datasets) == 1:
        return datasets[0]
    out = datasets[0]
    for ds in datasets[1:]:
        out = concat_time(out, ds)
    return out


def concat_time(a: Dataset, b: Dataset) -> Dataset:
    if "time" not in a.coords or "time" not in b.coords:
        return a.merge(b)
    times = np.concatenate([a.coords["time"].values, b.coords["time"].values])
    # Stable sort: ties (e.g. identical timestamps across files) must
    # preserve input file order deterministically.
    order = np.argsort(times, kind="stable")
    data_vars = {}
    for name in a.data_vars:
        va = a.data_vars[name]
        if "time" in va.dims:
            if name not in b.data_vars:
                # Passing it through unconcatenated would crash later
                # with a dim-length mismatch that names neither the
                # variable nor the cause — fail here with both.
                raise ValueError(
                    f"cannot concatenate along time: variable {name!r} "
                    "has a time dimension but is missing from one of the "
                    "inputs")
            ax = va.dims.index("time")
            merged = np.concatenate(
                [va.values, b.data_vars[name].values], axis=ax)
            merged = np.take(merged, order, axis=ax)
            data_vars[name] = DataArray(va.dims, merged, va.attrs)
        else:
            data_vars[name] = va
    for name, vb in b.data_vars.items():
        if name not in data_vars:
            if "time" in vb.dims:
                raise ValueError(
                    f"cannot concatenate along time: variable {name!r} "
                    "has a time dimension but is missing from one of the "
                    "inputs")
            data_vars[name] = vb
    coords = {**b.coords, **a.coords}
    coords["time"] = DataArray(("time",), times[order])
    return Dataset(data_vars, coords, {**b.attrs, **a.attrs})
