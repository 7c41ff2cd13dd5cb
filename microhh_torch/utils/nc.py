"""Minimal netCDF4-python-compatible API backed by h5py.

The reference framework (microhh) reads its case input from ``<case>_input.nc``
(NetCDF4 files with groups ``init``/``timedep``/...) and writes statistics to
NetCDF files (see reference ``src/netcdf_interface.cxx`` and case generators such
as ``cases/drycblles/drycblles_input.py``).  This environment has no netCDF4
python module, but NetCDF-4 files *are* HDF5 files following the netCDF-4
conventions (dimension scales + attribute conventions), so this module
implements the small subset of the ``netCDF4`` API the framework and the case
generators need, on top of h5py.  Files written here are valid NetCDF-4 files
readable by the standard tools, and files written by netCDF4-python are readable
here.

Supported API surface (mirrors netCDF4-python):
    Dataset(path, mode="r"|"w"|"a"), ds.createDimension(name, size),
    ds.createVariable(name, datatype, dimensions), ds.createGroup(name),
    ds.groups / ds.variables / ds.dimensions dicts, variable slicing,
    attribute get/set via setncattr/getncattr/ncattrs and attribute-style
    access, ds.sync(), ds.close().
"""

import numpy as np


_FILL_FLOAT = 9.969209968386869e+36


class Dimension:
    def __init__(self, name, size):
        self.name = name
        self.size = size

    def __len__(self):
        return self.size

    def isunlimited(self):
        return self.size is None


class Variable:
    """Wraps an h5py dataset; resizes along unlimited dims on write."""

    def __init__(self, group, h5ds, dimensions):
        self._group = group
        self._h5 = h5ds
        self.dimensions = tuple(dimensions)

    @property
    def name(self):
        return self._h5.name.rsplit("/", 1)[-1]

    @property
    def shape(self):
        return self._h5.shape

    @property
    def dtype(self):
        return self._h5.dtype

    @property
    def ndim(self):
        return len(self._h5.shape)

    def __getitem__(self, key):
        out = self._h5[key]
        return out

    def _grow_for(self, key):
        """Resize unlimited dimensions so that `key` fits (netCDF4 semantics)."""
        if not self.dimensions:
            return
        shape = list(self._h5.shape)
        keys = key if isinstance(key, tuple) else (key,)
        grew = False
        for ax, k in enumerate(keys):
            if ax >= len(shape):
                break
            dim = self._group._find_dim(self.dimensions[ax])
            if dim is None or not dim.isunlimited():
                continue
            if isinstance(k, slice):
                stop = k.stop
                if stop is not None and stop > shape[ax]:
                    shape[ax] = stop
                    grew = True
            elif isinstance(k, (int, np.integer)):
                if k >= shape[ax]:
                    shape[ax] = int(k) + 1
                    grew = True
            elif isinstance(k, (list, np.ndarray)):
                mx = int(np.max(k))
                if mx >= shape[ax]:
                    shape[ax] = mx + 1
                    grew = True
        if grew:
            self._h5.resize(tuple(shape))

    def __setitem__(self, key, value):
        # netCDF4-python accepts var[:] = scalar on 0-d variables
        if self._h5.ndim == 0 and key in (slice(None), Ellipsis, ()):
            self._h5[()] = value
            return
        self._grow_for(key)
        self._h5[key] = value

    def setncattr(self, name, value):
        self._h5.attrs[name] = value

    def getncattr(self, name):
        return self._h5.attrs[name]

    def ncattrs(self):
        return [a for a in self._h5.attrs if not a.startswith(("_Netcdf4", "CLASS", "NAME", "REFERENCE_LIST", "DIMENSION_LIST"))]

    def __setattr__(self, name, value):
        if name.startswith("_") or name in ("dimensions",):
            object.__setattr__(self, name, value)
        else:
            self._h5.attrs[name] = value

    def __getattr__(self, name):
        # only called when normal lookup fails -> treat as nc attribute
        try:
            return self.__dict__["_h5"].attrs[name]
        except KeyError:
            raise AttributeError(name)


class Group:
    def __init__(self, parent, h5group):
        self._h5 = h5group
        self._parent = parent
        self.dimensions = {}
        self.variables = {}
        self.groups = {}
        self._load()

    def _load(self):
        """Discover dims/vars/groups for an existing file."""
        import h5py
        for name, item in self._h5.items():
            if isinstance(item, h5py.Group):
                self.groups[name] = Group(self, item)
            elif isinstance(item, h5py.Dataset):
                if item.attrs.get("CLASS", b"") in (b"DIMENSION_SCALE", "DIMENSION_SCALE"):
                    # Unlimited dims: maxshape None
                    size = item.shape[0] if len(item.shape) else 0
                    unlimited = item.maxshape and item.maxshape[0] is None
                    self.dimensions[name] = Dimension(name, None if unlimited else size)
                    # A coordinate variable exists if the scale holds real data
                    # (netCDF4 marks pure dims with NAME starting with the
                    # "This is a netCDF dimension but not a netCDF variable"
                    # sentinel).
                    nm = item.attrs.get("NAME", b"")
                    if isinstance(nm, bytes):
                        nm = nm.decode("utf-8", "ignore")
                    if not nm.startswith("This is a netCDF dimension"):
                        self.variables[name] = Variable(self, item, (name,))
                else:
                    dims = self._infer_dims(item)
                    self.variables[name] = Variable(self, item, dims)

    def _infer_dims(self, h5ds):
        dims = []
        try:
            for i in range(len(h5ds.shape)):
                labels = h5ds.dims[i]
                if len(labels) > 0:
                    dims.append(labels[0].name.rsplit("/", 1)[-1])
                else:
                    dims.append("phony_dim_%d" % i)
        except Exception:
            dims = ["phony_dim_%d" % i for i in range(len(h5ds.shape))]
        return tuple(dims)

    # -- netCDF4 API --
    def createDimension(self, name, size=None):
        dim = Dimension(name, size)
        self.dimensions[name] = dim
        # Create the backing dimension-scale dataset (pure dim for now; if a
        # coordinate variable with the same name is created later it reuses it).
        n = 0 if size is None else size
        maxshape = (None,) if size is None else (size,)
        ds = self._h5.create_dataset(name, shape=(n,), maxshape=maxshape,
                                     dtype="f4", fillvalue=_FILL_FLOAT)
        ds.make_scale("This is a netCDF dimension but not a netCDF variable." +
                      (" %d" % n))
        return dim

    def _find_dim(self, name):
        g = self
        while g is not None:
            if name in g.dimensions:
                return g.dimensions[name]
            g = g._parent
        return None

    def _find_dim_ds(self, name):
        g = self
        while g is not None:
            if name in g._h5:
                return g._h5[name]
            g = g._parent
        return None

    def createVariable(self, name, datatype, dimensions=(), fill_value=None, **kw):
        if isinstance(dimensions, str):
            dimensions = (dimensions,)
        dtype = np.dtype(datatype)
        shape, maxshape = [], []
        for d in dimensions:
            dim = self._find_dim(d)
            if dim is None:
                raise KeyError("Unknown dimension %r" % d)
            shape.append(0 if dim.size is None else dim.size)
            maxshape.append(None if dim.size is None else dim.size)

        if name in self._h5 and name in self.dimensions:
            # Coordinate variable: replace the placeholder scale with a real one.
            del self._h5[name]
            ds = self._h5.create_dataset(name, shape=tuple(shape),
                                         maxshape=tuple(maxshape), dtype=dtype)
            ds.make_scale(name)
        else:
            ds = self._h5.create_dataset(name, shape=tuple(shape),
                                         maxshape=tuple(maxshape), dtype=dtype)
            for i, d in enumerate(dimensions):
                scale = self._find_dim_ds(d)
                if scale is not None and scale != ds:
                    ds.dims[i].attach_scale(scale)
        var = Variable(self, ds, dimensions)
        self.variables[name] = var
        return var

    def createGroup(self, name):
        g = Group(self, self._h5.create_group(name))
        self.groups[name] = g
        return g

    def setncattr(self, name, value):
        self._h5.attrs[name] = value

    def getncattr(self, name):
        return self._h5.attrs[name]

    def ncattrs(self):
        return list(self._h5.attrs)

    def get_group(self, name):
        return self.groups[name]

    def sync(self):
        self._h5.file.flush()


class Dataset(Group):
    def __init__(self, filename, mode="r", datamodel="NETCDF4", clobber=True,
                 **kw):
        if mode == "w" and not clobber:
            mode = "w-"
        import h5py
        f = h5py.File(filename, mode)
        self._file = f
        Group.__init__(self, None, f)
        self.filepath_ = str(filename)

    def close(self):
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MemoryDataset:
    """The read side of a Dataset as the model uses it (``variables[name][:n]``
    and ``groups[name]``), from dicts: ``variables`` maps a name to an
    array, ``groups`` maps a group name to such a dict."""

    def __init__(self, variables=None, groups=None):
        self.variables = {n: np.asarray(a) for n, a in (variables or {}).items()}
        self.groups = {n: MemoryDataset(g) for n, g in (groups or {}).items()}
