"""The ``utils/nc`` Dataset surface over ``scipy.io.netcdf_file``, for a
machine without h5py.

The files are netCDF-3 in its 64-bit-offset form (``version=2``), which
every netCDF reader takes.  netCDF-3 has no groups: a variable created in a
group is written at the root under its own name with a ``group``
attribute, so names must be unique across groups (the statistics' are: one
dict by name holds them all).  In read mode ``groups[name]`` presents the
variables that carry that attribute again, so a reader written for the
netCDF-4 layout (``f.groups["thermo"].variables["zi"]``) reads either
file.  The one unlimited dimension is the record dimension; a record never
written holds the netCDF default fill, as ``utils/nc``'s files do.

Supported API: Dataset(path, mode="r"|"w"), createDimension,
createVariable, createGroup (one level), setncattr (and a variable's
getncattr), variables, groups, dimensions, variable slicing, sync,
close.
"""

import numpy as np

from .nc import _FILL_FLOAT

# the netCDF default fills of the types the statistics write
_FILL = {"d": _FILL_FLOAT, "f": np.float32(_FILL_FLOAT), "i": -2147483647}


class Variable:
    """A scipy netCDF variable; record rows grow with the fill value."""

    def __init__(self, root, var, dimensions):
        self._root = root
        self._var = var
        self.dimensions = tuple(dimensions)

    @property
    def isrec(self):
        return self._var.isrec

    @property
    def shape(self):
        return self._var.data.shape

    def __getitem__(self, key):
        return np.array(self._var.data[key])

    def grow(self, nrec):
        """Extend the record dimension to nrec rows of the fill value."""
        data = self._var.data
        if not self.isrec or len(data) >= nrec:
            return
        grown = np.full((nrec,) + data.shape[1:], _FILL[data.dtype.char],
                        dtype=data.dtype)
        grown[:len(data)] = data
        self._var.__dict__["data"] = grown

    def __setitem__(self, key, value):
        if self.isrec:
            k = key[0] if isinstance(key, tuple) else key
            if isinstance(k, slice):
                need = (k.start or 0) + len(np.atleast_1d(value))
            else:
                need = int(k) + 1
            self.grow(need)
            self._root._nrec = max(self._root._nrec, need)
        self._var.data[key] = value

    def setncattr(self, name, value):
        setattr(self._var, name, value)

    def getncattr(self, name):
        return self._var._attributes[name]


class Group:
    """A group of a netCDF-3 file: its variables live at the root."""

    def __init__(self, root, name):
        self._root = root
        self.name = name
        self.variables = {}
        self.dimensions = root.dimensions

    def createVariable(self, name, datatype, dimensions=(), **kw):
        if isinstance(dimensions, str):
            dimensions = (dimensions,)
        var = self._root._new_variable(name, datatype, dimensions)
        var.setncattr("group", self.name)
        self.variables[name] = var
        return var


class Dataset:
    def __init__(self, filename, mode="r", **kw):
        from scipy.io import netcdf_file
        if mode not in ("r", "w"):
            raise ValueError("nc_classic opens files in mode 'r' or 'w'")
        self.mode = mode
        self.filepath_ = str(filename)
        self._nrec = 0
        if mode == "w":
            self._f = netcdf_file(filename, "w", version=2)
        else:
            self._f = netcdf_file(filename, "r", mmap=False)
        self.dimensions = dict(self._f.dimensions)
        self.variables = {}
        self.groups = {}
        if mode == "r":
            self._load()

    def _load(self):
        for name, var in self._f.variables.items():
            v = Variable(self, var, var.dimensions)
            self.variables[name] = v
            grp = var._attributes.get("group")
            if grp is None:
                continue
            if isinstance(grp, bytes):
                grp = grp.decode()
            if grp not in self.groups:
                self.groups[grp] = Group(self, grp)
            self.groups[grp].variables[name] = v

    def createDimension(self, name, size=None):
        if size is None:
            # scipy wants the record dimension first in the file's list
            # (netCDF-3 allows one, anywhere); the order is not read back
            if None in self._f.dimensions.values():
                raise ValueError("netCDF-3 has one unlimited dimension")
            self._f.dimensions[name] = None
            self._f._dims.insert(0, name)
        else:
            self._f.createDimension(name, size)
        self.dimensions[name] = size
        return name

    def _new_variable(self, name, datatype, dimensions):
        if name in self.variables:
            raise ValueError("variable %r exists; netCDF-3 has one name "
                             "space for all groups" % name)
        var = self._f.createVariable(name, np.dtype(datatype), dimensions)
        v = Variable(self, var, dimensions)
        self.variables[name] = v
        return v

    def createVariable(self, name, datatype, dimensions=(), **kw):
        if isinstance(dimensions, str):
            dimensions = (dimensions,)
        return self._new_variable(name, datatype, dimensions)

    def createGroup(self, name):
        if name not in self.groups:
            self.groups[name] = Group(self, name)
        return self.groups[name]

    def setncattr(self, name, value):
        setattr(self._f, name, value)

    def sync(self):
        """Write the file as it stands; every record variable padded with
        the fill value to the longest one."""
        if self.mode != "w":
            return
        for v in self.variables.values():
            v.grow(self._nrec)
        self._f.flush()

    def close(self):
        self.sync()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
